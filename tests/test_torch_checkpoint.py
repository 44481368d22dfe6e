"""The committed checkpoints through both packages on the CPU, and the files
that carry them to a machine without the JAX package.

`runs/ckpt_am_tsp50/best` (AM, TSP-50) and `runs/ckpt_pomo_cvrp50/best`
(POMO, CVRP-50) are Orbax directories, which only the JAX package reads. Their
parameters are exported as flat npz files (`convert.save_params_npz`) into
`rl4co_tpu_torch/golden/`, beside the JAX package's per-instance reference
costs on the committed canonical test sets. `chip_smoke.py` loads both on the
card and is held to those costs.

Run this module as a script to (re)write the four files:
    JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py
(about five minutes on eight CPU cores). The reference costs use the
dispatch sizes that `rl4co_tpu/tasks/eval.py` chooses with
``RL4CO_EVAL_BATCH_CEIL=32768`` (`runs/reeval_canonical.py`): through batch
norm an AM cost depends on the instances that share its dispatch; POMO's
instance norm makes its costs independent of it.
"""

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

from _torch_port import CVRP50_FILE, ROOT, TSP50_FILE, tree_to_numpy  # noqa: E402

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden")
# name -> checkpoint, env, test set, instances scored, eval methods, and the
# policy builder of each package (called with ``env_name=``)
EXPORTS = {
    "am_tsp50": dict(ckpt="runs/ckpt_am_tsp50/best", env="tsp", data=TSP50_FILE,
                     count=10_000, methods=("greedy", "augment_dihedral_8"),
                     jax_policy=JaxPolicy, policy=AttentionModelPolicy),
    "pomo_cvrp50": dict(ckpt="runs/ckpt_pomo_cvrp50/best", env="cvrp", data=CVRP50_FILE,
                        count=1_000, methods=("multistart_greedy",
                                              "multistart_greedy_augment_dihedral_8"),
                        jax_policy=jax_make_pomo_policy, policy=make_pomo_policy),
}
EVAL_BATCH_CEIL = "32768"


def params_path(name):
    return os.path.join(GOLDEN, f"{name}_params.npz")


def costs_path(name):
    return os.path.join(GOLDEN, f"{name}_costs.npz")


def restored_params(name):
    """``["state"]["params"]`` of the checkpoint as restored by the JAX package."""
    return restore_checkpoint_raw(os.path.join(ROOT, EXPORTS[name]["ckpt"]))["state"]["params"]


def jax_policy(name):
    return EXPORTS[name]["jax_policy"](env_name=EXPORTS[name]["env"])


def reference_costs(name, count=None):
    """The JAX package's per-instance costs of every method of ``name`` on the
    first ``count`` instances of its test set, at the JAX package's own
    dispatch sizes: ``{method: float32 costs, method + "/dispatch": size}``."""
    spec = EXPORTS[name]
    count = count or spec["count"]
    env = jax_get_env(spec["env"], num_loc=50)
    test = {k: v[:count] for k, v in jax_load_reference_npz(spec["data"], spec["env"]).items()}
    params, policy = restored_params(name), jax_policy(name)
    out = {}
    for method in spec["methods"]:
        t0 = time.perf_counter()
        res = jax_evaluate(env, policy, params, test, method, check_solutions=True,
                           warmup=False)
        out[method] = (-res["rewards"]).astype(np.float32)
        out[method + "/dispatch"] = np.int64(res["batch_size"])
        print(f"{name} {method}: dispatch {res['batch_size']}, mean cost "
              f"{out[method].mean():.6f}, {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def write_files():
    from rl4co_tpu_torch.convert import save_params_npz

    os.environ["RL4CO_EVAL_BATCH_CEIL"] = EVAL_BATCH_CEIL
    for name in EXPORTS:
        save_params_npz(tree_to_numpy(restored_params(name)), params_path(name))
        np.savez(costs_path(name), **reference_costs(name))


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
    assert count == {"am_tsp50": 710_144, "pomo_cvrp50": 1_272_576}[name]


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
            else:
                assert dispatch == {"multistart_greedy": 655,
                                    "multistart_greedy_augment_dihedral_8": 81}
                # the augmented set holds the plain one as its copy 0
                aug, plain = costs["multistart_greedy_augment_dihedral_8"], costs["multistart_greedy"]
                assert (aug <= plain * (1 + 1e-6)).all()


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
    write_files()
