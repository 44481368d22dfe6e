"""The port's PDP, mTSP and SHPP envs and their AM embeddings against the JAX
package's (`rl4co_tpu/envs/routing/{pdp,mtsp}.py`,
`models/nn/env_embeddings/{init,context}.py`).

Tolerances: states and masks exactly equal at every step of random feasible
episodes on JAX-generated instances (mTSP's lengths are the same f32 sums in
the same order); rewards rtol 1e-6; embeddings atol 1e-5 (plus 1e-6 of the
largest value), in f32 and on bf16-rounded weights; AM's greedy rollouts and
JAX's sampled actions replayed: equal actions, rewards rtol 1e-5,
log-likelihoods atol 1e-4. The multistart hooks are the base env's, as in
the JAX package."""

import numpy as np
import pytest
import torch

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
from test_torch_env_op_pctsp import random_episode

torch.set_num_threads(1)

# (registry name, env kwargs)
ENVS = [("pdp", {}), ("mtsp", {}), ("mtsp", {"cost_type": "sum", "min_num_agents": 2,
                                             "max_num_agents": 4}), ("shpp", {})]
IDS = ["pdp", "mtsp-minmax", "mtsp-sum-2to4", "shpp"]


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_random_feasible_episodes_match_step_by_step(name, kw):
    n, b = 10, 8
    tenv, jenv = env_pair(name, n, **kw)
    inst = jax_instances(jenv, 0, b)
    actions, ts, js = random_episode(np.random.RandomState(1), tenv, jenv, inst, depot_odds=0.3)
    assert t2n(ts.done).all()
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        jenv.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)
    if name == "mtsp":  # every agent's handover was taken where allowed
        assert (t2n(ts.agent_idx) <= t2n(ts.num_agents) - 1).all()


def verdict(env, inst, tour):
    """Accepted or refused. The JAX package's mTSP check refuses a tour with
    a customer missing by a ValueError (arrays of two lengths compared); the
    port's raises AssertionError there as everywhere."""
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except (AssertionError, ValueError):
        return False


TOURS = {
    "pdp": ([1, 2, 3, 4], [1, 3, 2, 4], [3, 1, 4, 2], [1, 2, 4, 3], [1, 1, 2, 4]),
    "mtsp": ([1, 2, 3, 0, 0], [1, 0, 2, 3, 0], [1, 2, 0, 0, 0], [3, 2, 1, 1, 0], [0, 1, 2, 3, 0]),
    "shpp": ([0, 1, 2, 3], [0, 2, 1, 3], [1, 0, 2, 3], [0, 1, 3, 2], [0, 1, 1, 3]),
}


@pytest.mark.parametrize("name", ["pdp", "mtsp", "shpp"])
def test_validity_checks_accept_and_reject_as_jax(name):
    tenv, jenv = env_pair(name, 4)
    one = {k: v[0] for k, v in jax_instances(jenv, 2, 1).items()}
    verdicts = []
    for tour in TOURS[name]:
        want = verdict(jenv, one, tour)
        assert verdict(tenv, one, tour) == want, tour
        verdicts.append(want)
    assert any(verdicts) and not all(verdicts), verdicts


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_port_generator_and_the_base_starts(name, kw):
    n, b = 20, 512
    env, jenv = env_pair(name, n, **kw)
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 2), device="cpu").items()}
    jinst = jax_instances(jenv, 0, 2)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].shape[1:] == jinst[k].shape[1:], k
        assert inst[k].dtype.kind == jinst[k].dtype.kind, k
    assert (inst["locs"] >= 0).all() and (inst["locs"] < 1).all()
    if name == "mtsp":
        agents = inst["num_agents"]
        lo, hi = env.min_num_agents, env.max_num_agents
        assert agents.min() == lo and agents.max() == hi
        for a in range(lo, hi + 1):  # uniform within 5 standard deviations
            share, p = (agents == a).mean(), 1.0 / (hi - lo + 1)
            assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / b), (a, share)
    # multistart: the base env's starts 0..num_actions-1 in both packages
    assert env.get_num_starts() == jenv.get_num_starts() == env.num_actions
    starts = t2n(env.select_start_nodes(to_torch(inst), env.num_actions))
    np.testing.assert_array_equal(starts, np.tile(np.asarray(
        jenv.select_start_nodes(to_jax(jinst), env.num_actions)), (b, 1)))


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_embeddings_match_jax(name, kw):
    tenv, jenv = env_pair(name, 8, **kw)
    inst = jax_instances(jenv, 3, 4)
    rs = np.random.RandomState(3)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    tstates, jstates = [ts], [js]
    for _ in range(6):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        tstates.append(ts)
        jstates.append(js)
    check_embeddings(name, inst, tstates, jstates)


@pytest.mark.parametrize("name", ["pdp", "mtsp", "shpp"])
def test_am_greedy_and_replayed_samples_match_jax(name):
    n, b = 10, 6
    _, jenv = env_pair(name, n)
    inst = jax_instances(jenv, 7, b)
    jpol, params, tpol = am_pair(name, seed=3)
    want, got = rollout_pair(jpol, params, tpol, name, inst, kind="greedy", tanh_clipping=10.0)
    assert_rollouts_match(want, got)
    env, _ = env_pair(name, n)
    env.check_solution_validity(inst, t2n(got.actions))
    if name == "mtsp":
        sampled = jax_sampled(jpol, params, name, inst, tanh_clipping=10.0)
        assert_rollouts_match(sampled, port_rollout(tpol, name, inst, sampled.actions,
                                                    kind="evaluate", tanh_clipping=10.0))
