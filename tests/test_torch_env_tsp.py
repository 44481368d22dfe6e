"""The port's TSP env against the JAX package's: random permutations
replayed through both, every step compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu_torch.data.io import load_instances_npz, save_instances_npz
from rl4co_tpu_torch.envs import ENV_REGISTRY, get_env
from rl4co_tpu_torch.utils.ops import batchify, gather_by_index, get_tour_length, unbatchify

from _torch_port import random_locs, t2n

torch.set_num_threads(1)

FIELDS = ("first_node", "current_node", "visited", "i", "done")


def assert_states_equal(ts, js):
    for f in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(ts, f)), np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("n,b,seed", [(5, 3, 0), (12, 8, 1), (20, 4, 2)])
def test_replayed_permutations_match_step_by_step(n, b, seed):
    rs = np.random.RandomState(seed)
    locs = random_locs(seed, b, n)
    perms = np.stack([rs.permutation(n) for _ in range(b)])
    tenv, jenv = get_env("tsp", num_loc=n), jax_get_env("tsp", num_loc=n)
    ts = tenv.reset({"locs": torch.from_numpy(locs)})
    js = jenv.reset_batch({"locs": jnp.asarray(locs)})
    assert_states_equal(ts, js)
    # two steps more than the episode: the state must stay frozen after done
    extra = np.concatenate([perms, perms[:, :2]], axis=1)
    for t in range(n + 2):
        np.testing.assert_array_equal(
            t2n(tenv.action_mask(ts)), np.asarray(jenv.action_mask_batch(js)))
        ts = tenv.step(ts, torch.from_numpy(extra[:, t]))
        js = jenv.step_batch(js, jnp.asarray(extra[:, t], dtype=jnp.int32))
        assert_states_equal(ts, js)
    assert t2n(ts.done).all() and (t2n(ts.i) == n).all()
    # after done only the current node is allowed
    mask = t2n(tenv.action_mask(ts))
    assert (mask.sum(-1) == 1).all()
    assert mask[np.arange(b), perms[:, -1]].all()
    np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
    # reward reads the first num_loc actions only
    r_t = t2n(tenv.reward(ts, torch.from_numpy(extra)))
    r_j = np.asarray(jenv.reward_batch(js, jnp.asarray(extra)))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)


def test_first_node_is_set_at_step_zero_only():
    env = get_env("tsp", num_loc=4)
    s = env.reset({"locs": torch.rand(2, 4, 2)})
    s = env.step(s, torch.tensor([2, 3]))
    s = env.step(s, torch.tensor([0, 1]))
    assert s.first_node.tolist() == [2, 3] and s.current_node.tolist() == [0, 1]


def test_check_solution_validity_accepts_and_refuses():
    env = get_env("tsp", num_loc=5)
    env.check_solution_validity({}, np.array([3, 1, 4, 0, 2]))
    env.check_solution_validity({}, torch.tensor([[3, 1, 4, 0, 2], [0, 1, 2, 3, 4]]))
    with pytest.raises(AssertionError):
        env.check_solution_validity({}, np.array([3, 1, 4, 0, 3]))


def test_registry_holds_tsp_only_and_names_the_roadmap():
    # the ported envs (TSP; CVRP since the POMO slice; OP, PCTSP and SPCTSP
    # since the mixed-env slice; the name dates from when TSP was the only
    # one); the rest raise
    assert sorted(ENV_REGISTRY) == ["cvrp", "op", "pctsp", "spctsp", "tsp"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_env("atsp", num_loc=10)


def test_generate_is_seeded_and_in_range():
    env = get_env("tsp", num_loc=7)
    a = env.generate(4, torch.Generator().manual_seed(3), device="cpu")["locs"]
    b = env.generate(4, torch.Generator().manual_seed(3), device="cpu")["locs"]
    assert a.shape == (4, 7, 2) and a.dtype == torch.float32
    assert torch.equal(a, b) and (a >= 0).all() and (a < 1).all()


def test_select_start_nodes_is_arange():
    env = get_env("tsp", num_loc=6)
    starts = env.select_start_nodes({"locs": torch.rand(3, 6, 2)}, 6)
    assert starts.shape == (3, 6) and starts[1].tolist() == list(range(6))


def test_batchify_is_repeat_major_and_unbatchify_inverts_it():
    x = torch.arange(6).reshape(3, 2)
    tiled = batchify({"x": x}, 4)["x"]
    assert tiled.shape == (12, 2)
    assert torch.equal(tiled[:3], x) and torch.equal(tiled[3:6], x)
    back = unbatchify(tiled, 4)
    assert back.shape == (3, 4, 2) and torch.equal(back[:, 2], x)


def test_gather_and_tour_length_match_jax():
    from rl4co_tpu.utils import ops as jops

    rs = np.random.RandomState(0)
    src = rs.standard_normal((3, 6, 4)).astype(np.float32)
    idx1, idx2 = rs.randint(0, 6, 3), rs.randint(0, 6, (3, 5))
    for idx in (idx1, idx2):
        np.testing.assert_array_equal(
            t2n(gather_by_index(torch.from_numpy(src), torch.from_numpy(idx))),
            np.asarray(jops.gather_by_index(jnp.asarray(src), jnp.asarray(idx))))
    locs = random_locs(1, 3, 9)
    np.testing.assert_allclose(
        t2n(get_tour_length(torch.from_numpy(locs))),
        np.asarray(jops.get_tour_length(jnp.asarray(locs))), rtol=1e-6)


def test_npz_round_trip(tmp_path):
    locs = random_locs(0, 4, 5)
    path = str(tmp_path / "inst.npz")
    save_instances_npz({"locs": torch.from_numpy(locs)}, path)
    back = load_instances_npz(path)
    assert list(back) == ["locs"]
    np.testing.assert_array_equal(back["locs"], locs)
