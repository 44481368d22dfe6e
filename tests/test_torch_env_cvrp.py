"""The port's CVRP env, its data loader and its augmentation against the JAX
package's: random feasible actions replayed through both envs with every
step compared, the capacity slack, the absorbing state, the reward's padded
steps, the start nodes and the validity check. Integer and boolean fields
are compared exactly; used capacity and rewards, both the same f32
arithmetic in the same order, at atol 1e-7 and rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.data.io import load_reference_npz as jax_load_reference_npz
from rl4co_tpu.data.transforms import augment_instances as jax_augment
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.envs.routing import cvrp as jax_cvrp
from rl4co_tpu_torch.data.io import load_reference_npz
from rl4co_tpu_torch.data.transforms import augment_instances
from rl4co_tpu_torch.envs import ENV_REGISTRY, get_env
from rl4co_tpu_torch.envs.routing import cvrp

from _torch_port import CVRP50_FILE, TSP50_FILE, random_cvrp, t2n

torch.set_num_threads(1)

FIELDS = ("current_node", "visited", "i", "done")


def both(n):
    return get_env("cvrp", num_loc=n), jax_get_env("cvrp", num_loc=n)


def to_torch(inst):
    return {k: torch.from_numpy(v) for k, v in inst.items()}


def to_jax(inst):
    return {k: jnp.asarray(v) for k, v in inst.items()}


def assert_states_equal(ts, js):
    for f in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(ts, f)), np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(t2n(ts.used_capacity), np.asarray(js.used_capacity), atol=1e-7)
    np.testing.assert_array_equal(t2n(ts.locs), np.asarray(js.locs))
    np.testing.assert_array_equal(t2n(ts.demand), np.asarray(js.demand))


def random_episode(rs, tenv, jenv, inst, first=None, extra=2):
    """Random feasible actions (the depot taken with odds 1/3 where allowed)
    through both envs, ``extra`` steps past the trip count; masks and states
    compared at every step. Returns the actions and both final states."""
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    assert_states_equal(ts, js)
    actions = []
    for t in range(tenv.max_steps + extra):
        mask = t2n(tenv.action_mask(ts))
        np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
        assert mask.any(axis=-1).all()
        act = np.empty(mask.shape[0], dtype=np.int64)
        for row, m in enumerate(mask):
            choices = np.flatnonzero(m)
            if m[0] and len(choices) > 1 and rs.random_sample() < 2 / 3:
                choices = choices[1:]
            act[row] = rs.choice(choices)
        if t == 0 and first is not None:
            act = first
        actions.append(act)
        ts = tenv.step(ts, torch.from_numpy(act))
        js = jenv.step_batch(js, jnp.asarray(act, dtype=jnp.int32))
        assert_states_equal(ts, js)
    return np.stack(actions, axis=1), ts, js


@pytest.mark.parametrize("n,b,seed", [(5, 4, 0), (10, 8, 1), (20, 6, 2)])
def test_random_feasible_episodes_match_step_by_step(n, b, seed):
    rs = np.random.RandomState(seed)
    tenv, jenv = both(n)
    inst = random_cvrp(seed, b, n)
    actions, ts, js = random_episode(rs, tenv, jenv, inst)
    assert t2n(ts.done).all(), "an episode outlasted 2 * num_loc steps"
    # done rows: the depot is the only action, and the state stays frozen
    mask = t2n(tenv.action_mask(ts))
    assert (mask[:, 0]).all() and (mask.sum(-1) == 1).all()
    r_t = t2n(tenv.reward(ts, torch.from_numpy(actions)))
    r_j = np.asarray(jenv.reward_batch(js, jnp.asarray(actions)))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(trip))), r_t, rtol=1e-6)
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        tenv.check_solution_validity(one, trip[row])
        jenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)  # the batched form agrees


def test_multistart_start_nodes_are_customers_and_the_episode_matches():
    n, b, s = 10, 3, 10
    tenv, jenv = both(n)
    inst = random_cvrp(3, b, n)
    starts = t2n(tenv.select_start_nodes(to_torch(inst), s))
    assert starts.shape == (b, s)
    for row in range(b):
        np.testing.assert_array_equal(starts[row], np.asarray(
            jenv.select_start_nodes({k: v[row] for k, v in inst.items()}, s)))
    np.testing.assert_array_equal(starts[0], np.arange(1, s + 1))
    assert tenv.get_num_starts() == jenv.get_num_starts() == n
    assert tenv.num_actions == jenv.num_actions == n + 1
    assert tenv.max_steps == jenv.max_steps == 2 * n
    # a forced customer first, as a multistart rollout does
    random_episode(np.random.RandomState(4), tenv, jenv, inst, first=starts[:, 1])


def test_capacity_slack_and_the_depot_rule():
    n = 4
    tenv, jenv = both(n)
    inst = {"locs": np.random.RandomState(5).random_sample((4, n, 2)).astype(np.float32),
            "depot": np.full((4, 2), 0.5, np.float32),
            "demand": np.full((4, n), 0.5, np.float32)}
    used = np.array([0.5 + 0.5e-5, 0.5 + 2e-5, 0.0, 0.25], np.float32)
    ts = tenv.reset(to_torch(inst))
    js = jenv.reset_batch(to_jax(inst))
    ts.used_capacity = torch.from_numpy(used)
    js = js.replace(used_capacity=jnp.asarray(used))
    mask = t2n(tenv.action_mask(ts))
    np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
    assert mask[0, 1:].all() and not mask[1, 1:].any()  # within / beyond the 1e-5 slack
    # at the depot with customers left: the depot is forbidden, except that a
    # row whose every customer is infeasible may only go (stay) there
    assert not mask[0, 0] and mask[1, 0]
    assert not mask[2, 0] and not mask[3, 0]


def test_a_done_row_ignores_its_actions():
    n = 3
    tenv, jenv = both(n)
    inst = random_cvrp(6, 2, n)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    for a in ([1, 3], [2, 0], [3, 1], [0, 0], [0, 0], [0, 0]):
        ts = tenv.step(ts, torch.tensor(a))
        js = jenv.step_batch(js, jnp.asarray(a, dtype=jnp.int32))
    assert t2n(ts.done).tolist() == [True, False]
    frozen = {f: t2n(getattr(ts, f)).copy() for f in FIELDS + ("used_capacity",)}
    ts = tenv.step(ts, torch.tensor([2, 1]))     # a customer for the done row
    js = jenv.step_batch(js, jnp.asarray([2, 1], dtype=jnp.int32))
    assert_states_equal(ts, js)
    for f, before in frozen.items():
        np.testing.assert_array_equal(t2n(getattr(ts, f))[0], before[0], err_msg=f)


@pytest.mark.parametrize("case", ["missing", "repeated", "over_capacity"])
def test_invalid_solutions_are_refused_by_both(case):
    n = 4
    tenv, jenv = both(n)
    inst = {"locs": np.zeros((n, 2), np.float32), "depot": np.zeros(2, np.float32),
            "demand": np.array([0.5, 0.5, 0.4, 0.3], np.float32)}
    actions = {"missing": [1, 2, 0, 3, 0, 0, 0, 0],
               "repeated": [1, 2, 0, 3, 4, 1, 0, 0],
               "over_capacity": [1, 3, 2, 0, 4, 0, 0, 0]}[case]
    tenv.check_solution_validity(inst, np.array([1, 2, 0, 3, 4, 0, 0, 0]))
    with pytest.raises(AssertionError):
        tenv.check_solution_validity(inst, np.array(actions))
    with pytest.raises(AssertionError):
        jenv.check_solution_validity(inst, np.array(actions))


def test_capacity_table_and_generated_instances():
    assert cvrp.CAPACITIES == jax_cvrp.CAPACITIES
    for n in (5, 10, 20, 45, 50, 63, 100, 700, 2000):
        assert cvrp.default_capacity(n) == jax_cvrp.default_capacity(n), n
    assert ENV_REGISTRY["cvrp"] is cvrp.CVRP
    env = get_env("cvrp", num_loc=50)
    gen = torch.Generator().manual_seed(0)
    inst = env.generate(256, gen, device="cpu")
    assert inst["locs"].shape == (256, 50, 2) and inst["depot"].shape == (256, 2)
    assert all(v.dtype == torch.float32 for v in inst.values())
    units = t2n(inst["demand"]) * 40.0
    np.testing.assert_allclose(units, np.round(units), atol=1e-5)
    assert set(np.round(units).astype(int).ravel()) == set(range(1, 10))
    assert 0 <= inst["locs"].min() and inst["locs"].max() <= 1
    assert get_env("cvrp", num_loc=50, capacity=20.0)._capacity == 20.0


def test_dihedral_8_transforms_the_depot_as_jax_does():
    inst = random_cvrp(7, 3, 6)
    got = augment_instances(to_torch(inst), 8, "dihedral8")
    want = jax_augment(to_jax(inst), 8, "dihedral8")
    assert set(got) == set(want) == set(inst)
    for k in inst:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), atol=1e-7, err_msg=k)
    depot = t2n(got["depot"]).reshape(8, 3, 2)
    np.testing.assert_array_equal(depot[0], inst["depot"])
    np.testing.assert_allclose(depot[1], np.stack([1 - inst["depot"][:, 0],
                                                   inst["depot"][:, 1]], -1), atol=1e-7)
    assert (np.abs(depot[1:] - depot[:1]) > 1e-6).any(axis=-1).all()
    # demands are not transformed
    np.testing.assert_array_equal(t2n(got["demand"]).reshape(8, 3, 6), np.stack([inst["demand"]] * 8))


def write_npz(tmp_path, name, **arrays):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **arrays)
    return path


def assert_loaded_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("path,env_name", [(CVRP50_FILE, "cvrp"), (TSP50_FILE, "tsp")],
                         ids=["cvrp50", "tsp50"])
def test_load_reference_npz_reads_the_committed_sets_as_jax_does(path, env_name):
    got = load_reference_npz(path, env_name)
    assert_loaded_equal(got, jax_load_reference_npz(path, env_name))
    if env_name == "cvrp":
        raw = np.load(path)
        np.testing.assert_allclose(got["demand"] * 40.0, raw["demand"], rtol=1e-6)
        assert got["demand"].max() <= 9 / 40 + 1e-7


def test_load_reference_npz_formats(tmp_path):
    rs = np.random.RandomState(8)
    locs, depot = rs.random_sample((3, 5, 2)), rs.random_sample((3, 2))
    integer = rs.randint(1, 10, size=(3, 5)).astype(np.float64)
    # the reference's format: integer demands and a per-instance capacity
    ref = write_npz(tmp_path, "ref", locs=locs, depot=depot, demand=integer,
                    capacity=np.array([20.0, 30.0, 40.0]))
    got = load_reference_npz(ref, "cvrp")
    assert_loaded_equal(got, jax_load_reference_npz(ref, "cvrp"))
    np.testing.assert_allclose(got["demand"][1], integer[1] / 30.0, rtol=1e-6)
    # already normalized, no capacity: passed as it is
    norm = write_npz(tmp_path, "norm", locs=locs, depot=depot, demand=integer / 40.0)
    assert_loaded_equal(load_reference_npz(norm, "sdvrp"), jax_load_reference_npz(norm, "sdvrp"))
    # integer demands without a capacity: the JAX loader passes them on
    # unnormalized, the port refuses
    bad = write_npz(tmp_path, "bad", locs=locs, depot=depot, demand=integer)
    assert jax_load_reference_npz(bad, "cvrp")["demand"].max() > 1
    with pytest.raises(ValueError, match="capacity"):
        load_reference_npz(bad, "cvrp")
    # the reference's OP and PCTSP files hold exactly the keys the JAX loader
    # picks, so the port's float32 pass-through reads them alike
    op = write_npz(tmp_path, "op", locs=locs, depot=depot, prize=integer,
                   max_length=np.ones(3))
    assert_loaded_equal(load_reference_npz(op, "op"), jax_load_reference_npz(op, "op"))
    pc = write_npz(tmp_path, "pc", locs=locs, depot=depot, penalty=integer,
                   deterministic_prize=integer, stochastic_prize=integer)
    assert_loaded_equal(load_reference_npz(pc, "pctsp"), jax_load_reference_npz(pc, "pctsp"))
    other = write_npz(tmp_path, "other", locs=locs, index=np.arange(3))
    assert_loaded_equal(load_reference_npz(other, "tsp"), jax_load_reference_npz(other, "tsp"))
