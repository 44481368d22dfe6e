"""The port's CVRPMVC, SVRP, mPDP and MDCPDP envs and their AM embeddings
against the JAX package's (`rl4co_tpu/envs/routing/{cvrpmvc,svrp,mpdp,
mdcpdp}.py`, `models/nn/env_embeddings/{init,context}.py`), and the golden
files of their chip phase.

Tolerances: states and masks exactly equal at every step of random feasible
episodes on JAX-generated instances; rewards rtol 1e-6;
embeddings atol 1e-5 (plus 1e-6 of the largest value), in f32 and on
bf16-rounded weights; AM's greedy (and CVRPMVC's multistart greedy)
rollouts: equal actions, rewards rtol 1e-5, log-likelihoods atol 1e-4.

`python tests/test_torch_env_svrp_mpdp.py` rewrites the golden files
(`rl4co_tpu_torch/golden/routing_envs_rest_{instances,costs}.npz`) with the
JAX package on the CPU in f32 (about a minute).
"""

import os

import jax
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
    random_params_numpy,
    rollout_pair,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
)
from test_torch_env_op_pctsp import random_episode

torch.set_num_threads(1)

# (registry name, env kwargs)
ENVS = [
    ("cvrpmvc", {}),
    ("svrp", {}),
    ("svrp", {"num_tech": 2, "tech_costs": (1.0, 4.0)}),
    ("mpdp", {}),
    ("mpdp", {"objective": "minsum", "num_agents": 2}),
    ("mdcpdp", {}),
    ("mdcpdp", {"depot_mode": "single", "dist_mode": "L1", "reward_mode": "lateness_square",
                "problem_mode": "close", "min_capacity": 1, "max_capacity": 4,
                "min_lateness_weight": 0.2, "max_lateness_weight": 0.8}),
    ("mdcpdp", {"reward_mode": "minmax", "problem_mode": "close", "min_capacity": 2}),
    ("mdcpdp", {"reward_mode": "minsum", "num_agents": 2, "max_capacity": 5}),
]
IDS = ["cvrpmvc", "svrp", "svrp-2tech", "mpdp-minmax", "mpdp-minsum-2", "mdcpdp-lateness",
       "mdcpdp-single-L1-square-close", "mdcpdp-minmax-close", "mdcpdp-minsum-2"]


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_random_feasible_episodes_match_step_by_step(name, kw):
    n, b = 10, 8
    tenv, jenv = env_pair(name, n, **kw)
    inst = jax_instances(jenv, 0, b)
    actions, ts, js = random_episode(np.random.RandomState(1), tenv, jenv, inst,
                                     depot_odds=0.3)
    assert t2n(ts.done).all()
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        jenv.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)


def verdict(env, inst, tour):
    """Accepted or refused. The JAX package's mPDP check refuses a tour with
    a customer missing by a ValueError (arrays of two lengths compared); the
    port's raises AssertionError there as everywhere."""
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except (AssertionError, ValueError):
        return False


TOURS = {  # N 4: two pairs for the PDPs; mPDP's customers are 4..7, MDCPDP's 3..6
    "cvrpmvc": ([1, 2, 3, 4, 0], [1, 0, 2, 3, 4], [1, 2, 2, 4, 0], [1, 2, 3, 0, 0]),
    "svrp": ([1, 2, 3, 4, 0, 0], [0, 0, 1, 2, 3, 4], [1, 2, 3, 3, 0, 0], [1, 2, 0, 0, 0, 0]),
    "mpdp": ([4, 5, 6, 7, 0, 0], [4, 6, 1, 5, 7, 0], [6, 4, 7, 5, 0, 0], [4, 5, 6, 0, 0, 0]),
    "mdcpdp": ([0, 3, 4, 5, 6, 0], [1, 3, 5, 0, 4, 6], [0, 5, 3, 4, 6, 0], [0, 3, 4, 5, 5, 0]),
}


@pytest.mark.parametrize("name", sorted(TOURS))
def test_validity_checks_accept_and_reject_as_jax(name):
    kw = {"max_demand": 2} if name == "cvrpmvc" else {}
    tenv, jenv = env_pair(name, 4, **kw)
    one = {k: v[0] for k, v in jax_instances(jenv, 2, 1).items()}
    if name == "svrp":  # every requirement within the first technician's skill
        one["skills"] = np.minimum(one["skills"], one["techs"][0])
    verdicts = []
    for tour in TOURS[name]:
        want = verdict(jenv, one, tour)
        assert verdict(tenv, one, tour) == want, tour
        verdicts.append(want)
    assert any(verdicts) and not all(verdicts), verdicts


def test_svrp_refuses_a_technician_without_the_skill():
    tenv, jenv = env_pair("svrp", 2)
    one = {"locs": np.zeros((2, 2), np.float32), "depot": np.zeros(2, np.float32),
           "techs": np.array([1.0, 2.0, 3.0], np.float32),
           "skills": np.array([2.5, 1.0], np.float32)}
    for tour, ok in (([2, 0, 0, 1], True), ([1, 2, 0, 0], False), ([2, 0, 1, 0], False)):
        assert verdict(tenv, one, tour) == verdict(jenv, one, tour) == ok, tour


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_port_generator_shapes_and_ranges(name, kw):
    n, b = 10, 256
    env, jenv = env_pair(name, n, **kw)
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 2), device="cpu").items()}
    jinst = jax_instances(jenv, 0, 2)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].shape[1:] == jinst[k].shape[1:], k
        assert inst[k].dtype.kind == jinst[k].dtype.kind, k
    assert (inst["locs"] >= 0).all() and (inst["locs"] < 1).all()
    if name == "svrp":
        techs = inst["techs"]
        assert (np.diff(techs, axis=-1) >= 0).all()
        assert (techs >= env.min_skill).all() and (techs < env.max_skill).all()
        assert (inst["skills"] <= techs[:, -1:]).all() and (inst["skills"] >= 0).all()
    if name == "mdcpdp":
        cap = inst["capacity"]
        assert cap.min() == env.min_capacity and cap.max() == env.max_capacity
        w = inst["lateness_weight"]
        assert (w >= env.min_lateness_weight).all() and (w <= env.max_lateness_weight).all()
        if env.depot_mode == "single":
            assert (inst["depots"] == inst["depots"][:, :1]).all()
    # multistart hooks: CVRPMVC has CVRP's, the others the base env's
    assert env.get_num_starts() == jenv.get_num_starts()
    starts = t2n(env.select_start_nodes(to_torch(inst), env.get_num_starts()))
    np.testing.assert_array_equal(starts, np.tile(np.asarray(
        jenv.select_start_nodes(to_jax(jinst), env.get_num_starts())), (b, 1)))


@pytest.mark.parametrize("name,kw", ENVS[:2] + ENVS[3:4] + ENVS[5:6],
                         ids=["cvrpmvc", "svrp", "mpdp", "mdcpdp"])
def test_embeddings_match_jax(name, kw):
    tenv, jenv = env_pair(name, 8, **kw)
    inst = jax_instances(jenv, 3, 4)
    rs = np.random.RandomState(3)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    tstates, jstates = [ts], [js]
    for _ in range(7):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        tstates.append(ts)
        jstates.append(js)
    check_embeddings(name, inst, tstates, jstates)


@pytest.mark.parametrize("name", ["cvrpmvc", "svrp", "mpdp", "mdcpdp"])
def test_am_greedy_matches_jax(name):
    n, b = 10, 8
    _, jenv = env_pair(name, n)
    inst = jax_instances(jenv, 7, b)
    jpol, params, tpol = am_pair(name, seed=3)
    want, got = rollout_pair(jpol, params, tpol, name, inst, kind="greedy", tanh_clipping=10.0)
    assert_rollouts_match(want, got)
    tenv, _ = env_pair(name, n)
    tenv.check_solution_validity(inst, t2n(got.actions))


def test_cvrpmvc_multistart_greedy_matches_jax():
    n, b = 10, 4
    _, jenv = env_pair("cvrpmvc", n)
    inst = jax_instances(jenv, 8, b)
    jpol, params, tpol = am_pair("cvrpmvc", seed=4)
    want, got = rollout_pair(jpol, params, tpol, "cvrpmvc", inst, kind="greedy",
                             multistart=True, num_starts=n, tanh_clipping=10.0)
    assert_rollouts_match(want, got)


# ------------------------------------------------------------- golden files
# AM at full width with `random_params_numpy(GOLDEN_SEED, env_name=...)`
# weights on GOLDEN_COUNT JAX-generated instances per env at N 50 (mPDP and
# MDCPDP at their default 3 agents): greedy in one dispatch, and CVRPMVC's
# multistart greedy best-of-50 on the first MULTISTART_COUNT. Rebuilt on the
# card by `chip_smoke.py` (phase `golden_routing_envs_rest`).
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rl4co_tpu_torch", "golden")
GOLDEN_ENVS = ("cvrpmvc", "svrp", "mpdp", "mdcpdp")
MULTISTART_ENVS = ("cvrpmvc",)
GOLDEN_SEED, GOLDEN_N, GOLDEN_COUNT, MULTISTART_COUNT = 0, 50, 1024, 256


def load_golden(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


def test_golden_files_shapes():
    inst = load_golden("routing_envs_rest_instances.npz")
    costs = load_golden("routing_envs_rest_costs.npz")
    assert int(costs["seed"]) == GOLDEN_SEED
    for name in GOLDEN_ENVS:
        _, jenv = env_pair(name, GOLDEN_N)
        want = jax_instances(jenv, 0, 1)
        got = {k[len(name) + 1:]: v for k, v in inst.items() if k.startswith(name + "/")}
        assert set(got) == set(want), name
        for k in want:
            assert got[k].shape == (GOLDEN_COUNT,) + want[k].shape[1:], (name, k)
        assert costs[f"{name}/greedy"].shape == (GOLDEN_COUNT,)
        assert np.isfinite(costs[f"{name}/greedy"]).all()
        actions = costs[f"{name}/greedy/actions"]
        tenv = env_pair(name, GOLDEN_N)[0]
        assert actions.shape == (GOLDEN_COUNT, tenv.max_steps)
        tenv.check_solution_validity({k: v[:16] for k, v in got.items()}, actions[:16])
    for name in MULTISTART_ENVS:
        assert costs[f"{name}/multistart_greedy"].shape == (MULTISTART_COUNT,)
        assert np.isfinite(costs[f"{name}/multistart_greedy"]).all()


@pytest.mark.parametrize("n", [10, 32, 33, 50, 100, 1000])
def test_demand_sum_has_the_jax_package_bits(n):
    """CVRPMVC's remaining demand starts from the N demands' sum in XLA's
    order (`utils.ops.xla_cpu_sum`), to the bit, under `jit` and `vmap` as
    the JAX rollout computes it."""
    tenv, jenv = env_pair("cvrpmvc", n)
    inst = jax_instances(jenv, n, 64)
    want = np.asarray(jax.jit(jenv.reset_batch)(to_jax(inst)).demand_remaining)
    np.testing.assert_array_equal(t2n(tenv.reset(to_torch(inst)).demand_remaining), want)


@pytest.mark.parametrize("name", GOLDEN_ENVS)
def test_golden_greedy_costs_on_the_cpu(name):
    """The port's full-width AM on the first 8 golden instances of each env:
    greedy costs of the JAX CPU within 1e-5 (batch norm: the 8 are their own
    dispatch, so the JAX policy is run on them here too)."""
    from rl4co_tpu_torch.models import AttentionModelPolicy
    from rl4co_tpu_torch.convert import load_params

    from _torch_port import JaxPolicy

    inst = {k[len(name) + 1:]: v[:8] for k, v in
            load_golden("routing_envs_rest_instances.npz").items() if k.startswith(name + "/")}
    tree = random_params_numpy(GOLDEN_SEED, env_name=name)
    jpol = JaxPolicy(env_name=name)
    tpol = load_params(AttentionModelPolicy(env_name=name, device="cpu"), tree).eval()
    want, got = rollout_pair(jpol, tree_to_jax(tree), tpol, name, inst, kind="greedy",
                             tanh_clipping=10.0)
    np.testing.assert_allclose(t2n(got.reward), want.reward, rtol=1e-5)
    env_pair(name, GOLDEN_N)[0].check_solution_validity(inst, t2n(got.actions))


def write_golden():
    """The golden files from the JAX package on the CPU in f32: instances
    (`generate_batch` at keys 300 + i), AM's greedy costs and actions on
    GOLDEN_COUNT in one dispatch, and CVRPMVC's multistart greedy best-of-50 costs on the
    first MULTISTART_COUNT (the encoder on them in one pass, the decoding
    in chunks of 64, which decode independently)."""
    import time

    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
    from rl4co_tpu.models.policies.constructive import rollout_from_cache

    from _torch_port import JaxPolicy

    key = jax.random.PRNGKey(0)
    greedy = JaxSpec(kind="greedy", tanh_clipping=10.0)
    multistart = JaxSpec(kind="greedy", multistart=True, num_starts=GOLDEN_N, tanh_clipping=10.0)
    t0 = time.time()
    inst_out, cost_out = {}, {"seed": np.int64(GOLDEN_SEED)}
    for i, name in enumerate(GOLDEN_ENVS):
        _, jenv = env_pair(name, GOLDEN_N)
        inst = jax_instances(jenv, 300 + i, GOLDEN_COUNT)
        inst_out.update({f"{name}/{k}": v for k, v in inst.items()})
        jpol = JaxPolicy(env_name=name)
        params = tree_to_jax(random_params_numpy(GOLDEN_SEED, env_name=name))
        out = jax_rollout(jpol, params, jenv, to_jax(inst), key, greedy)
        cost_out[f"{name}/greedy"] = -np.asarray(out.reward)
        cost_out[f"{name}/greedy/actions"] = np.asarray(out.actions).astype(np.int16)
        cost_out[f"{name}/greedy/dispatch"] = np.int64(GOLDEN_COUNT)
        print(name, "greedy", cost_out[f"{name}/greedy"].mean(), time.time() - t0, flush=True)
        if name in MULTISTART_ENVS:
            sub = to_jax({k: v[:MULTISTART_COUNT] for k, v in inst.items()})
            cache = jpol.apply(params, jpol.apply(params, sub, method="encode"),
                               method="precompute")
            best = []
            for lo in range(0, MULTISTART_COUNT, 64):
                part = jax.tree_util.tree_map(lambda x: x[lo:lo + 64], (sub, cache))
                r = rollout_from_cache(jpol, params, jenv, part[0], part[1], key,
                                       multistart).reward
                best.append(np.asarray(r).reshape(GOLDEN_N, -1).max(axis=0))
            cost_out[f"{name}/multistart_greedy"] = -np.concatenate(best)
            cost_out[f"{name}/multistart_greedy/dispatch"] = np.int64(MULTISTART_COUNT)
            print(name, "multistart", cost_out[f"{name}/multistart_greedy"].mean(),
                  time.time() - t0, flush=True)
    np.savez_compressed(os.path.join(GOLDEN, "routing_envs_rest_instances.npz"), **inst_out)
    np.savez_compressed(os.path.join(GOLDEN, "routing_envs_rest_costs.npz"), **cost_out)


if __name__ == "__main__":
    write_golden()
