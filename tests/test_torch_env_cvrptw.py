"""The port's CVRPTW env, its AM embeddings and the Solomon loader against
the JAX package's (`rl4co_tpu/envs/routing/cvrptw.py`,
`models/nn/env_embeddings/{init,context}.py`, `data/solomon.py`).

Tolerances: states and masks exactly equal at every step of random feasible
episodes on JAX-generated instances (times and loads are the same f32
operations in the same order); rewards rtol 1e-6 (a sum over the tour in
another order); embeddings atol 1e-5 plus 1e-6 of the largest value, in
f32 and on bf16-rounded weights (unscaled coordinates and times: terms in
the hundreds, where one f32 ulp is above 1e-5);
AM's greedy, multistart greedy and replayed sampled actions: equal actions,
rewards rtol 1e-5, log-likelihoods atol 1e-4 (`test_torch_rollout.py`'s).
The port's generator draws from its own stream, so it is held to ranges and
invariants, not to JAX's numbers."""

import numpy as np
import pytest
import torch

from rl4co_tpu.data.solomon import load_solomon_instance as jax_load_solomon
from rl4co_tpu.data.solomon import solomon_to_env_batch as jax_solomon_batch
from rl4co_tpu_torch.data.solomon import load_solomon_instance, solomon_to_env_batch
from rl4co_tpu_torch.envs.routing.cvrp import default_capacity
from rl4co_tpu_torch.rl.reinforce import seeded_generator

from _torch_port import (
    am_pair,
    assert_rollouts_match,
    check_embeddings,
    env_pair,
    jax_instances,
    jax_sampled,
    port_rollout,
    rollout_pair,
    t2n,
    to_jax,
    to_torch,
)
from test_torch_env_op_pctsp import assert_states_equal, random_episode

torch.set_num_threads(1)


@pytest.mark.parametrize("n,b,seed", [(10, 8, 0), (20, 6, 1)], ids=["10", "20"])
def test_random_feasible_episodes_match_step_by_step(n, b, seed):
    tenv, jenv = env_pair("cvrptw", n)
    inst = jax_instances(jenv, seed, b)
    actions, ts, js = random_episode(np.random.RandomState(seed), tenv, jenv, inst)
    assert t2n(ts.done).all()
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        jenv.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)  # the batched form


def verdict(env, inst, tour):
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except AssertionError:
        return False


def test_validity_checks_accept_and_reject_as_jax():
    tenv, jenv = env_pair("cvrptw", 5)
    inst = jax_instances(jenv, 0, 4)
    tours = ([1, 2, 3, 4, 5, 0, 0, 0, 0, 0], [5, 4, 3, 2, 1, 0, 0, 0, 0, 0],
             [1, 0, 2, 0, 3, 0, 4, 0, 5, 0], [5, 0, 4, 0, 3, 0, 2, 0, 1, 0],
             [1, 1, 0, 2, 0, 3, 0, 4, 0, 5], [2, 0, 1, 0, 4, 0, 3, 0, 5, 0])
    seen = set()
    for row in range(4):
        one = {k: v[row] for k, v in inst.items()}
        for tour in tours:
            want = verdict(jenv, one, tour)
            assert verdict(tenv, one, tour) == want, (row, tour)
            seen.add(want)
    assert seen == {True, False}
    # a time window that closes before the vehicle can arrive, and no other rule broken
    one = {k: v[0].copy() for k, v in inst.items()}
    one["time_windows"][3, 1] = 0.0
    assert not verdict(jenv, one, tours[2]) and not verdict(tenv, one, tours[2])


def test_port_generator_ranges_and_windows():
    n, b = 20, 256
    env, jenv = env_pair("cvrptw", n)
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 3), device="cpu").items()}
    jinst = jax_instances(jenv, 0, 2)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].dtype == np.float32 and inst[k].shape[1:] == jinst[k].shape[1:], k
    assert (inst["locs"] >= 0).all() and (inst["locs"] < 150).all()
    assert inst["locs"].max() > 140  # max_loc 150, unscaled
    units = np.round(inst["demand"] * default_capacity(n))
    np.testing.assert_allclose(inst["demand"] * default_capacity(n), units, atol=1e-5)
    assert units.min() == 1 and units.max() == 9
    np.testing.assert_array_equal(inst["durations"], 0.0)
    tw = inst["time_windows"]
    np.testing.assert_array_equal(tw[:, 0], np.tile([0.0, 480.0], (b, 1)))
    np.testing.assert_array_equal(tw, np.floor(tw))  # integer windows
    dist = np.linalg.norm(inst["locs"] - inst["depot"][:, None], axis=-1)
    start, end = tw[:, 1:, 0], tw[:, 1:, 1]
    assert (start < end).all()
    assert (start >= np.floor(dist)).all()
    assert (end <= np.floor(480.0 - dist) + 1e-3).all()  # the return stays feasible
    # the two draws are uniform between the distance and the latest start:
    # the window's middle sits near the middle of that span
    mid = ((start + end) / 2 - dist) / (480.0 - 2 * dist)
    assert abs(mid.mean() - 0.5) < 0.02


SOLOMON = """C101_SMALL

VEHICLE
NUMBER     CAPACITY
  25         200

CUSTOMER
CUST NO.  XCOORD.   YCOORD.    DEMAND   READY TIME  DUE DATE   SERVICE   TIME

    0      40         50          0          0       1236          0
    1      45         68         10        912        967         90
    2      45         70         30        825        870         90
    3      42         66         10         65        146         90
    4      42         68         10        727        782         90
"""


@pytest.mark.parametrize("scale", [True, False])
def test_solomon_file_loads_as_jax(tmp_path, scale):
    path = tmp_path / "c101_small.txt"
    path.write_text(SOLOMON)
    got, want = load_solomon_instance(str(path)), jax_load_solomon(str(path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    tenv, tbatch = solomon_to_env_batch(got, scale=scale)
    jenv, jbatch = jax_solomon_batch(want, scale=scale)
    assert (tenv.num_loc, tenv.max_time, tenv.scale) == (jenv.num_loc, jenv.max_time, jenv.scale)
    for k in jbatch:
        np.testing.assert_array_equal(t2n(tbatch[k]), np.asarray(jbatch[k]), err_msg=k)
    # the loaded instance runs through the port's env
    state = tenv.reset(tbatch)
    assert t2n(tenv.action_mask(state))[0, 1:].any()
    with pytest.raises(ValueError, match="Malformed"):
        (tmp_path / "empty.txt").write_text("VEHICLE\n")
        load_solomon_instance(str(tmp_path / "empty.txt"))


def test_embeddings_match_jax():
    tenv, jenv = env_pair("cvrptw", 10)
    inst = jax_instances(jenv, 4, 6)
    rs = np.random.RandomState(4)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    tstates, jstates = [ts], [js]
    for _ in range(6):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        tstates.append(ts)
        jstates.append(js)
    assert t2n(ts.current_time).max() > 10.0  # unscaled times reach the context
    check_embeddings("cvrptw", inst, tstates, jstates)


def test_am_rollouts_match_jax():
    """Greedy (the single-query step), multistart greedy over the customers
    (the grouped step, CVRP's starts) and JAX's sampled actions replayed."""
    n, b = 10, 6
    _, jenv = env_pair("cvrptw", n)
    inst = jax_instances(jenv, 5, b)
    jpol, params, tpol = am_pair("cvrptw", seed=2)
    greedy = dict(kind="greedy", tanh_clipping=10.0)
    want, got = rollout_pair(jpol, params, tpol, "cvrptw", inst, **greedy)
    assert_rollouts_match(want, got)
    want, got = rollout_pair(jpol, params, tpol, "cvrptw", inst, multistart=True,
                             num_starts=n, **greedy)
    assert_rollouts_match(want, got)
    np.testing.assert_array_equal(t2n(got.actions)[:, 0], np.repeat(np.arange(1, n + 1), b))
    tenv, _ = env_pair("cvrptw", n)
    tenv.check_solution_validity({k: np.concatenate([v] * n) for k, v in inst.items()},
                                 t2n(got.actions))
    # sampled by JAX, replayed by the port
    sampled = jax_sampled(jpol, params, "cvrptw", inst, tanh_clipping=10.0)
    assert_rollouts_match(sampled, port_rollout(tpol, "cvrptw", inst, sampled.actions,
                                                kind="evaluate", tanh_clipping=10.0))
