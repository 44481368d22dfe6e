"""`evaluate_policy` of the port against the JAX package's, for the five
methods, on 20 instances in dispatches of 8 (so the padded tail, which
enters the batch-norm statistics, is exercised). Rewards per instance rtol
1e-5, best actions equal, result keys equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.tasks.eval import EVAL_METHODS, evaluate_policy

from _torch_port import policy_pair, random_locs

torch.set_num_threads(1)

N, COUNT, BATCH = 10, 20, 8

# sampling draws cannot be matched across frameworks; with top_k=1 every draw
# is the arg-max, which makes the sampling protocol (tiling, best-of) comparable
METHODS = [
    ("greedy", {}),
    ("sampling", dict(num_samples=4, top_k=1)),
    ("multistart_greedy", {}),
    ("augment_dihedral_8", {}),
    ("multistart_greedy_augment_dihedral_8", {}),
]


def tour_length64(locs, actions):
    pts = np.take_along_axis(locs.astype(np.float64), actions[:, :, None], axis=1)
    return np.linalg.norm(pts - np.roll(pts, 1, axis=1), axis=-1).sum(-1)


def assert_same_tours_up_to_ties(locs, got, want):
    """Best actions equal. Starts or augmented copies of one instance often
    end in the same cycle, whose f32 lengths differ in the last bit between
    frameworks; the arg-max over them may then pick another rotation. Such a
    row must be an exact tie in f64, and rows like it must be few."""
    differ = (got != want).any(axis=1)
    assert differ.mean() <= 0.1, differ
    np.testing.assert_allclose(tour_length64(locs[differ], got[differ]),
                               tour_length64(locs[differ], want[differ]), rtol=1e-9)


@pytest.mark.parametrize("method,overrides", METHODS, ids=[m for m, _ in METHODS])
def test_evaluate_policy_matches_jax(method, overrides):
    jpol, jparams, tpol = policy_pair(seed=2)
    locs = random_locs(9, COUNT, N)
    jres = jax_evaluate(jax_get_env("tsp", num_loc=N), jpol, jparams, {"locs": locs},
                        method, batch_size=BATCH, return_actions=True,
                        check_solutions=True, warmup=False, **overrides)
    tres = evaluate_policy(get_env("tsp", num_loc=N), tpol, {"locs": locs}, method,
                           batch_size=BATCH, return_actions=True, check_solutions=True,
                           warmup=False, device="cpu", **overrides)
    assert set(tres) == set(jres)
    assert tres["rewards"].shape == (COUNT,) and tres["actions"].shape == (COUNT, N)
    np.testing.assert_allclose(tres["rewards"], jres["rewards"], rtol=1e-5)
    assert_same_tours_up_to_ties(locs, tres["actions"], jres["actions"])
    assert tres["method"] == method and tres["batch_size"] == BATCH
    assert abs(tres["mean_reward"] - jres["mean_reward"]) < 1e-5


def test_real_sampling_beats_or_equals_its_own_mean_and_is_seeded():
    _, _, tpol = policy_pair(seed=2)
    env, locs = get_env("tsp", num_loc=N), random_locs(9, COUNT, N)
    kw = dict(batch_size=BATCH, check_solutions=True, warmup=False, device="cpu",
              num_samples=16)
    a = evaluate_policy(env, tpol, {"locs": locs}, "sampling",
                        generator=torch.Generator().manual_seed(1), **kw)
    b = evaluate_policy(env, tpol, {"locs": locs}, "sampling",
                        generator=torch.Generator().manual_seed(1), **kw)
    np.testing.assert_array_equal(a["actions"], b["actions"])
    one = evaluate_policy(env, tpol, {"locs": locs}, "sampling",
                          generator=torch.Generator().manual_seed(1),
                          **{**kw, "num_samples": 1})
    assert a["mean_reward"] >= one["mean_reward"]


def test_default_batch_size_and_warmup_fields():
    _, _, tpol = policy_pair(seed=2)
    env, locs = get_env("tsp", num_loc=N), random_locs(9, 5, N)
    res = evaluate_policy(env, tpol, {"locs": torch.from_numpy(locs)},
                          "multistart_greedy_augment_dihedral_8", device="cpu")
    assert res["batch_size"] == 8192 // (N * 8)
    assert res["warmup_s"] > 0 and res["inference_time"] > 0
    assert "actions" not in res and res["rewards"].shape == (5,)


def test_the_tail_padding_changes_results_through_batch_norm():
    """One dispatch of 20 and dispatches of 8 normalise over other batches."""
    _, _, tpol = policy_pair(seed=2)
    env, locs = get_env("tsp", num_loc=N), random_locs(9, COUNT, N)
    small = evaluate_policy(env, tpol, {"locs": locs}, "greedy", batch_size=BATCH,
                            warmup=False, device="cpu")
    whole = evaluate_policy(env, tpol, {"locs": locs}, "greedy", batch_size=COUNT,
                            warmup=False, device="cpu")
    assert not np.allclose(small["rewards"], whole["rewards"], rtol=1e-6)


def test_methods_and_refusals():
    """The JAX package's eight methods; beam search and symmetric
    augmentation, once refused, now run (held to the JAX package in
    `test_torch_beam_search.py` and `test_torch_transforms.py`); an unknown
    method still raises."""
    from rl4co_tpu.tasks.eval import EVAL_METHODS as JAX_METHODS

    assert EVAL_METHODS.keys() == JAX_METHODS.keys()
    for name, m in JAX_METHODS.items():
        assert dataclasses.asdict(EVAL_METHODS[name]) == dataclasses.asdict(m), name
    _, _, tpol = policy_pair(seed=2)
    env, inst = get_env("tsp", num_loc=N), {"locs": random_locs(9, 4, N)}
    with pytest.raises(ValueError):
        evaluate_policy(env, tpol, inst, "nonsense", device="cpu")
    beam = evaluate_policy(env, tpol, inst, "beam_search", device="cpu", warmup=False,
                           check_solutions=True)
    sym = evaluate_policy(env, tpol, inst, "augment_dihedral_8", augment_fn="symmetric",
                          device="cpu", warmup=False, check_solutions=True)
    assert beam["rewards"].shape == sym["rewards"].shape == (4,)
    assert beam["batch_size"] == 8192 // N


def test_dihedral_augmentation_matches_jax():
    from rl4co_tpu.data.transforms import augment_instances as jax_augment
    from rl4co_tpu_torch.data.transforms import augment_instances

    locs = random_locs(3, 3, 6)
    ref = np.asarray(jax_augment({"locs": jnp.asarray(locs)}, 8, "dihedral8")["locs"])
    out = augment_instances({"locs": torch.from_numpy(locs)}, 8, "dihedral8")["locs"].numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[:3], locs)  # copy 0 is the identity
