"""The committed checkpoints through both packages on the CPU, and the files
that carry them to a machine without the JAX package.

`runs/ckpt_am_tsp50/best` (AM, TSP-50), `runs/ckpt_pomo_cvrp50/best` (POMO,
CVRP-50) and `runs/ckpt_amxl_tsp100/best` (AM-XL: 6 layers, instance norm,
TSP-100) are Orbax directories, which only the JAX package reads. Their
parameters are exported as flat npz files (`convert.save_params_npz`) into
`rl4co_tpu_torch/golden/`, beside the JAX package's per-instance reference
costs on the committed canonical test sets (and, for AM on TSP-50, its beam
search costs on the first 1 000 instances). `chip_smoke.py` loads them on the
card and is held to those costs.

Run this module as a script to (re)write the files, all of them or those
named (`am_tsp50`, `pomo_cvrp50`, `amxl_tsp100`, `am_tsp50_beam`):
    JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py [name ...]
(AM and POMO about five minutes on eight CPU cores, AM-XL about ten
minutes). The AM and POMO reference costs use the dispatch sizes that
`rl4co_tpu/tasks/eval.py` chooses with ``RL4CO_EVAL_BATCH_CEIL=32768``
(`runs/reeval_canonical.py`); AM-XL's and the beam search's use its default
ceiling of 8192 trajectories, given explicitly. Through batch norm an AM
cost depends on the instances that share its dispatch; instance norm (POMO,
AM-XL) makes a cost independent of it.
"""

import functools
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.checkpoint import restore_checkpoint_raw  # noqa: E402
from rl4co_tpu.data.io import load_reference_npz as jax_load_reference_npz  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy  # noqa: E402
from rl4co_tpu.models.zoo.pomo import make_pomo_policy as jax_make_pomo_policy  # noqa: E402
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate  # noqa: E402

from rl4co_tpu_torch.convert import load_params, load_params_npz  # noqa: E402
from rl4co_tpu_torch.data.io import load_reference_npz  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.models.zoo.pomo import make_pomo_policy  # noqa: E402
from rl4co_tpu_torch.tasks.eval import evaluate_policy  # noqa: E402

from _torch_port import CVRP50_FILE, ROOT, TSP50_FILE, TSP100_FILE, tree_to_numpy  # noqa: E402

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden")
AMXL = dict(num_encoder_layers=6, normalization="instance")  # runs/train_quality.py:147-153
# name -> checkpoint, env and its size, test set, instances scored, eval
# methods, the dispatch size of each method (None: the JAX package's choice
# under EVAL_BATCH_CEIL), and the policy builder of each package (called
# with ``env_name=``)
EXPORTS = {
    "am_tsp50": dict(ckpt="runs/ckpt_am_tsp50/best", env="tsp", num_loc=50, data=TSP50_FILE,
                     count=10_000, methods=("greedy", "augment_dihedral_8"), dispatch=None,
                     jax_policy=JaxPolicy, policy=AttentionModelPolicy),
    "pomo_cvrp50": dict(ckpt="runs/ckpt_pomo_cvrp50/best", env="cvrp", num_loc=50,
                        data=CVRP50_FILE, count=1_000,
                        methods=("multistart_greedy", "multistart_greedy_augment_dihedral_8"),
                        dispatch=None, jax_policy=jax_make_pomo_policy,
                        policy=make_pomo_policy),
    "amxl_tsp100": dict(ckpt="runs/ckpt_amxl_tsp100/best", env="tsp", num_loc=100,
                        data=TSP100_FILE, count=10_000,
                        methods=("greedy", "augment_dihedral_8"),
                        dispatch={"greedy": 8192, "augment_dihedral_8": 1024},
                        jax_policy=functools.partial(JaxPolicy, **AMXL),
                        policy=functools.partial(AttentionModelPolicy, **AMXL)),
}
# further cost files: name -> the checkpoint of EXPORTS they score, with
# their own count, methods and dispatch sizes (8192 // 50 beams = 163)
EXTRA_COSTS = {
    "am_tsp50_beam": dict(export="am_tsp50", count=1_000, methods=("beam_search",),
                          dispatch={"beam_search": 163}),
}
EVAL_BATCH_CEIL = "32768"
PARAM_COUNTS = {"am_tsp50": 710_144, "pomo_cvrp50": 1_272_576, "amxl_tsp100": 1_304_960}


def params_path(name):
    return os.path.join(GOLDEN, f"{name}_params.npz")


def costs_path(name):
    return os.path.join(GOLDEN, f"{name}_costs.npz")


def restored_params(name):
    """``["state"]["params"]`` of the checkpoint as restored by the JAX package."""
    return restore_checkpoint_raw(os.path.join(ROOT, EXPORTS[name]["ckpt"]))["state"]["params"]


def jax_policy(name):
    return EXPORTS[name]["jax_policy"](env_name=EXPORTS[name]["env"])


def reference_costs(name, count=None, methods=None, dispatch=None):
    """The JAX package's per-instance costs of every method of ``name`` (or of
    ``methods``) on the first ``count`` instances of its test set, at the
    dispatch sizes ``dispatch`` gives or else the JAX package's own:
    ``{method: float32 costs, method + "/dispatch": size}``."""
    spec = EXPORTS[name]
    count = count or spec["count"]
    dispatch = dispatch or spec["dispatch"] or {}
    env = jax_get_env(spec["env"], num_loc=spec["num_loc"])
    test = {k: v[:count] for k, v in jax_load_reference_npz(spec["data"], spec["env"]).items()}
    params, policy = restored_params(name), jax_policy(name)
    out = {}
    for method in methods or spec["methods"]:
        t0 = time.perf_counter()
        res = jax_evaluate(env, policy, params, test, method, check_solutions=True,
                           warmup=False, batch_size=dispatch.get(method))
        out[method] = (-res["rewards"]).astype(np.float32)
        out[method + "/dispatch"] = np.int64(res["batch_size"])
        print(f"{name} {method}: dispatch {res['batch_size']}, mean cost "
              f"{out[method].mean():.6f}, {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def write_files(names=()):
    """Write the files of ``names`` (keys of EXPORTS or EXTRA_COSTS), all by default."""
    from rl4co_tpu_torch.convert import save_params_npz

    os.environ["RL4CO_EVAL_BATCH_CEIL"] = EVAL_BATCH_CEIL
    unknown = set(names) - set(EXPORTS) - set(EXTRA_COSTS)
    if unknown:
        raise SystemExit(f"unknown names {sorted(unknown)}: "
                         f"choose from {sorted(EXPORTS) + sorted(EXTRA_COSTS)}")
    for name in names or list(EXPORTS) + list(EXTRA_COSTS):
        if name in EXPORTS:
            save_params_npz(tree_to_numpy(restored_params(name)), params_path(name))
            np.savez(costs_path(name), **reference_costs(name))
        else:
            extra = EXTRA_COSTS[name]
            np.savez(costs_path(name), **reference_costs(
                extra["export"], extra["count"], extra["methods"], extra["dispatch"]))


def port_policy(name):
    """The port's policy of ``name`` on the CPU, filled from the exported npz."""
    policy = EXPORTS[name]["policy"](env_name=EXPORTS[name]["env"], device="cpu")
    return load_params(policy, load_params_npz(params_path(name))).eval()


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_exported_params_are_the_restored_checkpoint_leaf_for_leaf(name):
    got = load_params_npz(params_path(name))
    want = tree_to_numpy(restored_params(name))

    def walk(g, w, path):
        assert isinstance(g, dict) and set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], path + (k,))
            else:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, path + (k,)
                np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(path + (k,)))

    walk(got, want, ())
    count = sum(a.size for a in np.load(params_path(name)).values())
    assert count == PARAM_COUNTS[name]


def test_reference_costs_files():
    for name, spec in EXPORTS.items():
        with np.load(costs_path(name)) as costs:
            assert set(costs.files) == {m + s for m in spec["methods"] for s in ("", "/dispatch")}
            for method in spec["methods"]:
                c = costs[method]
                assert c.dtype == np.float32 and c.shape == (spec["count"],), (name, method)
                assert np.isfinite(c).all() and (c > 0).all()
            dispatch = {m: int(costs[m + "/dispatch"]) for m in spec["methods"]}
            if name == "am_tsp50":
                assert dispatch == {"greedy": 8192, "augment_dihedral_8": 3799}
                # the means of the JAX package's run on the CPU at these sizes
                np.testing.assert_allclose(costs["greedy"].mean(), 5.79438, rtol=2e-6)
                np.testing.assert_allclose(costs["augment_dihedral_8"].mean(), 5.71949, rtol=2e-6)
            elif name == "amxl_tsp100":
                assert dispatch == spec["dispatch"] == {"greedy": 8192, "augment_dihedral_8": 1024}
                np.testing.assert_allclose(costs["greedy"].mean(), 8.525650, rtol=2e-6)
                np.testing.assert_allclose(costs["augment_dihedral_8"].mean(), 8.262778,
                                           rtol=2e-6)
                # instance norm: copy 0 of the augmented set is the plain instance
                aug, plain = costs["augment_dihedral_8"], costs["greedy"]
                assert (aug <= plain * (1 + 1e-6)).all()
            else:
                assert dispatch == {"multistart_greedy": 655,
                                    "multistart_greedy_augment_dihedral_8": 81}
                # the augmented set holds the plain one as its copy 0
                aug, plain = costs["multistart_greedy_augment_dihedral_8"], costs["multistart_greedy"]
                assert (aug <= plain * (1 + 1e-6)).all()


def test_beam_search_costs_file():
    """The JAX package's beam search (width 50) with the AM TSP-50 checkpoint
    on the first 1 000 canonical instances, in dispatches of 163."""
    extra = EXTRA_COSTS["am_tsp50_beam"]
    with np.load(costs_path("am_tsp50_beam")) as costs, np.load(costs_path("am_tsp50")) as base:
        assert set(costs.files) == {"beam_search", "beam_search/dispatch"}
        beam = costs["beam_search"]
        assert beam.dtype == np.float32 and beam.shape == (extra["count"],)
        assert int(costs["beam_search/dispatch"]) == 163 == 8192 // 50
        np.testing.assert_allclose(beam.mean(), 5.724912, rtol=2e-6)
        # a trained model's beam search beats its greedy tours on average
        assert beam.mean() < base["greedy"][: extra["count"]].mean() - 0.03


def test_beam_search_replays_the_first_dispatch():
    """The port's beam search on the reference's first dispatch (instances
    0-162, so the batch-norm statistics are the reference's): per-instance
    costs against the exported JAX costs."""
    count = 163
    locs = np.load(TSP50_FILE)["locs"][:count]
    res = evaluate_policy(get_env("tsp", num_loc=50), port_policy("am_tsp50"), {"locs": locs},
                          "beam_search", batch_size=count, check_solutions=True, warmup=False,
                          device="cpu")
    with np.load(costs_path("am_tsp50_beam")) as costs:
        want = costs["beam_search"][:count]
    rel = np.abs(-res["rewards"] - want) / want
    assert (rel <= 1e-5).mean() >= 0.98, np.sort(rel)[-5:]
    assert abs(-res["mean_reward"] - want.mean()) / want.mean() <= 1e-4


def test_amxl_checkpoint_replays_the_reference_costs():
    """AM-XL (6 layers, instance norm) at full width on the first 4 TSP-100
    instances, greedy: through instance norm each cost stands alone, so a
    dispatch of 4 gives the reference's costs (dispatch 8192), rtol 1e-5."""
    count = 4
    locs = np.load(TSP100_FILE)["locs"][:count]
    res = evaluate_policy(get_env("tsp", num_loc=100), port_policy("amxl_tsp100"),
                          {"locs": locs}, "greedy", batch_size=count, check_solutions=True,
                          warmup=False, device="cpu")
    with np.load(costs_path("amxl_tsp100")) as costs:
        np.testing.assert_allclose(-res["rewards"], costs["greedy"][:count], rtol=1e-5)


def test_committed_checkpoint_gives_the_same_greedy_tours():
    """AM at full width, greedy on the first 64 instances in one dispatch."""
    count = 64
    locs = np.load(TSP50_FILE)["locs"][:count]
    jres = jax_evaluate(jax_get_env("tsp", num_loc=50), jax_policy("am_tsp50"),
                        restored_params("am_tsp50"), {"locs": locs}, "greedy",
                        batch_size=count, return_actions=True, check_solutions=True,
                        warmup=False)
    tres = evaluate_policy(get_env("tsp", num_loc=50), port_policy("am_tsp50"), {"locs": locs},
                           "greedy", batch_size=count, check_solutions=True, warmup=False,
                           device="cpu")
    same = (tres["actions"] == jres["actions"]).all(axis=1).sum()
    assert same >= count - 1, f"only {same} of {count} tours equal"
    rel = abs(tres["mean_reward"] - jres["mean_reward"]) / abs(jres["mean_reward"])
    assert rel <= 1e-4, rel
    # a trained model: well below the ~26 of a random tour on TSP-50
    assert 5.5 < -tres["mean_reward"] < 6.2, tres["mean_reward"]


def test_committed_pomo_checkpoint_gives_the_jax_multistart_greedy_costs():
    """POMO at full width (6 layers), multistart greedy over 50 starts on the
    first 8 CVRP-50 instances: the port against the JAX package, rtol 1e-5
    per instance; the exported reference costs (dispatch 655) against both."""
    count = 8
    test = {k: v[:count] for k, v in load_reference_npz(CVRP50_FILE, "cvrp").items()}
    jres = jax_evaluate(jax_get_env("cvrp", num_loc=50), jax_policy("pomo_cvrp50"),
                        restored_params("pomo_cvrp50"), test, "multistart_greedy",
                        batch_size=count, check_solutions=True, warmup=False)
    tres = evaluate_policy(get_env("cvrp", num_loc=50), port_policy("pomo_cvrp50"), test,
                           "multistart_greedy", batch_size=count, check_solutions=True,
                           warmup=False, device="cpu")
    np.testing.assert_allclose(-tres["rewards"], -jres["rewards"], rtol=1e-5)
    with np.load(costs_path("pomo_cvrp50")) as costs:
        np.testing.assert_allclose(costs["multistart_greedy"][:count], -jres["rewards"],
                                   rtol=1e-5)
    # a trained model: a random policy's routes on CVRP-50 are several times longer
    assert 9.0 < -tres["mean_reward"] < 12.5, tres["mean_reward"]


if __name__ == "__main__":
    write_files(sys.argv[1:])
