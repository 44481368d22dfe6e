"""The port's SDVRP env against the JAX package's
(`rl4co_tpu/envs/routing/sdvrp.py`): random feasible episodes on
JAX-generated instances with every state field and mask exactly equal at
each step (a delivery is the same ``min`` and subtraction in f32), split
deliveries among them; rewards rtol 1e-6; the validity checks accept and
refuse as JAX's; the trip count 3N and the padding after ``done``; the
port's generator; AM's greedy rollout through the dynamic embedding (equal
actions, rewards rtol 1e-5, log-likelihoods atol 1e-4). The tiled decoder
route, multistart, beam search and gradients are
`tests/test_torch_dynamic_decode.py`'s."""

import numpy as np
import pytest
import torch

from rl4co_tpu_torch.envs.routing.cvrp import default_capacity
from rl4co_tpu_torch.rl.reinforce import seeded_generator

from _torch_port import (
    am_pair,
    assert_rollouts_match,
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
    tenv, jenv = env_pair("sdvrp", n)
    inst = jax_instances(jenv, seed, b)
    # the depot rarely: long routes fill the vehicle and split deliveries
    actions, ts, js = random_episode(np.random.RandomState(seed), tenv, jenv, inst,
                                     depot_odds=0.02)
    assert t2n(ts.done).all()
    mask = t2n(tenv.action_mask(ts))
    assert mask[:, 0].all() and (mask.sum(-1) == 1).all()  # done rows: the depot only
    visits = [np.bincount(a[a > 0], minlength=n + 1)[1:] for a in actions]
    assert max(v.max() for v in visits) > 1, "no delivery was split"
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        jenv.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)


def test_delivery_is_split_at_the_capacity():
    tenv, jenv = env_pair("sdvrp", 3)
    inst = {"locs": np.full((1, 3, 2), 0.5, np.float32), "depot": np.zeros((1, 2), np.float32),
            "demand": np.array([[0.75, 0.5, 0.25]], np.float32)}
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    for a in (1, 2, 0, 2, 3):
        ts = tenv.step(ts, torch.tensor([a]))
        js = jenv.step_batch(js, np.array([a]))
        assert_states_equal(ts, js)
        np.testing.assert_array_equal(t2n(tenv.action_mask(ts)),
                                      np.asarray(jenv.action_mask_batch(js)))
    # 0.75 then 0.25 of customer 2 (the vehicle full); the rest after a refill
    np.testing.assert_array_equal(t2n(ts.demand_with_depot), [[0.0, 0.0, 0.0, 0.0]])
    assert t2n(ts.done).all()


def verdict(env, inst, tour):
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except AssertionError:
        return False


def test_validity_checks_accept_and_reject_as_jax():
    tenv, jenv = env_pair("sdvrp", 5)
    inst = jax_instances(jenv, 2, 3)
    tours = ([1, 2, 3, 4, 5, 0, 0], [1, 2, 0, 3, 4, 5, 0], [1, 2, 3, 0, 0, 0, 0],
             [5, 4, 3, 2, 1, 1, 0], [1, 0, 2, 0, 3, 0, 4, 0, 5])
    seen = set()
    for row in range(3):
        one = {k: v[row] for k, v in inst.items()}
        one["demand"] = one["demand"] * 1.5  # larger demands: splits and refills matter
        for tour in tours:
            want = verdict(jenv, one, tour)
            assert verdict(tenv, one, tour) == want, (row, tour)
            seen.add(want)
    assert seen == {True, False}


def test_port_generator_and_trip_count():
    n, b = 20, 128
    env, jenv = env_pair("sdvrp", n)
    assert env.max_steps == jenv.max_steps == 3 * n
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 5), device="cpu").items()}
    assert set(inst) == set(jax_instances(jenv, 0, 1)) == {"locs", "depot", "demand"}
    assert (inst["locs"] >= 0).all() and (inst["locs"] < 1).all()
    units = np.round(inst["demand"] * default_capacity(n))
    assert units.min() == 1 and units.max() == 9


def test_am_greedy_and_replayed_samples_match_jax():
    n, b = 10, 6
    _, jenv = env_pair("sdvrp", n)
    inst = jax_instances(jenv, 6, b)
    jpol, params, tpol = am_pair("sdvrp", seed=4)
    assert tpol.has_dynamic_embedding
    want, got = rollout_pair(jpol, params, tpol, "sdvrp", inst, kind="greedy",
                             tanh_clipping=10.0)
    assert_rollouts_match(want, got)
    sampled = jax_sampled(jpol, params, "sdvrp", inst, tanh_clipping=10.0)
    assert_rollouts_match(sampled, port_rollout(tpol, "sdvrp", inst, sampled.actions,
                                                kind="evaluate", tanh_clipping=10.0))
