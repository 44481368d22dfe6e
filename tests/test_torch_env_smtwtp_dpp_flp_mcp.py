"""The port's SMTWTP, DPP, MDPP, FLP and MCP envs and their AM embeddings
against the JAX package's (`rl4co_tpu/envs/{scheduling/smtwtp,eda/dpp,
graph/flp,graph/mcp}.py`, `models/nn/env_embeddings/{init,context}.py`), and
the golden files of their chip phase.

Sizes: SMTWTP-8; DPP and MDPP on a 4 × 4 grid with 4 decaps and 8
frequencies (synthetic PDN); FLP-12 choosing 3; MCP with 20 items and 10
sets choosing 3 (`_torch_port.SMALL_ENVS`).

Tolerances: states and masks exactly equal at every step of random feasible
episodes on JAX-generated instances; rewards rtol 1e-6 (DPP's and MDPP's
1e-5: a 4 × 4 complex-free inverse and products of another library);
embeddings atol 1e-5 (plus 1e-6 of the largest value), in f32 and on
bf16-rounded weights; AM's greedy rollouts on 8 instances: equal actions,
rewards rtol 1e-5 (DPP, MDPP 1e-4), log-likelihoods atol 1e-4.

`python tests/test_torch_env_smtwtp_dpp_flp_mcp.py` rewrites the golden files
(`rl4co_tpu_torch/golden/envs_10b_{instances,costs}.npz`) with the JAX
package on the CPU in f32.
"""

import os

import numpy as np
import pytest
import torch

from rl4co_tpu_torch.rl.reinforce import seeded_generator

from _torch_port import (
    SMALL_ENVS,
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

NAMES = sorted(SMALL_ENVS)
# the reward's relative tolerance: DPP's and MDPP's go through an inverse
REWARD_RTOL = {"dpp": 1e-5, "mdpp": 1e-5}


@pytest.mark.parametrize("name", NAMES)
def test_random_feasible_episodes_match_step_by_step(name):
    b = 8
    tenv, jenv = env_pair(name, None)
    inst = jax_instances(jenv, 0, b)
    actions, ts, js = random_episode(np.random.RandomState(1), tenv, jenv, inst, depot_odds=0.5)
    assert t2n(ts.done).all()
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)),
                               rtol=REWARD_RTOL.get(name, 1e-6), atol=1e-7)
    trip = actions[:, : tenv.max_steps]
    tenv.check_solution_validity(inst, trip)
    if name == "mdpp":
        return  # the JAX package's check reads a "probe" MDPP has not (below)
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        jenv.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])


def test_mdpp_meansum_reward_matches_jax():
    tenv, jenv = env_pair("mdpp", None, reward_type="meansum")
    inst = jax_instances(jenv, 1, 8)
    actions, ts, js = random_episode(np.random.RandomState(2), tenv, jenv, inst, depot_odds=0.5)
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-5, atol=1e-7)


def test_measured_pdn_files_are_guarded_as_in_jax(tmp_path):
    """A ``data_dir`` without the measured PDN files raises FileNotFoundError
    in both packages, as soon as the impedances are needed."""
    tenv, jenv = env_pair("dpp", None, size=10, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not found"):
        jenv._pdn()
    with pytest.raises(FileNotFoundError, match="not found"):
        tenv.pdn("cpu")


def verdict(env, inst, tour):
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("name", [n for n in NAMES if n != "mdpp"])
def test_validity_checks_accept_and_reject_as_jax(name):
    tenv, jenv = env_pair(name, None)
    one = {k: v[0] for k, v in jax_instances(jenv, 2, 1).items()}
    good = {"smtwtp": list(range(1, 9)), "flp": [4, 0, 7], "mcp": [9, 2, 5]}.get(name)
    if good is None:  # DPP: the first free cells, then one in the keep-out, then the probe
        free = np.flatnonzero(~one["keepout"] & (np.arange(16) != one["probe"]))
        good = list(free[:4])
        tours = [good, good[:3] + good[2:3], good[:3] + [int(np.flatnonzero(one["keepout"])[0])],
                 good[:3] + [int(one["probe"])]]
    else:
        tours = [good, good[:-1] + good[:1], good[::-1]]
    verdicts = [verdict(jenv, one, t) for t in tours]
    assert [verdict(tenv, one, t) for t in tours] == verdicts
    assert verdicts[0] and not all(verdicts)


def test_mdpp_check_holds_the_probe_mask():
    """The JAX package's MDPP inherits DPP's check, which reads
    ``instance["probe"]``: an MDPP instance has a ``probe_mask`` instead, so
    the JAX check raises KeyError on every tour. The port's checks the mask."""
    tenv, jenv = env_pair("mdpp", None)
    one = {k: v[0] for k, v in jax_instances(jenv, 2, 1).items()}
    blocked = one["keepout"] | one["probe_mask"]
    free = [int(c) for c in np.flatnonzero(~blocked)[:4]]
    with pytest.raises(KeyError):
        jenv.check_solution_validity(one, np.asarray(free))
    assert verdict(tenv, one, free)
    assert not verdict(tenv, one, free[:3] + [int(np.flatnonzero(one["probe_mask"])[0])])
    assert not verdict(tenv, one, free[:3] + free[:1])


@pytest.mark.parametrize("name", NAMES)
def test_port_generator_shapes_and_ranges(name):
    b = 256
    env, jenv = env_pair(name, None)
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 2), device="cpu").items()}
    jinst = jax_instances(jenv, 0, 2)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].shape[1:] == jinst[k].shape[1:], k
        assert inst[k].dtype.kind == jinst[k].dtype.kind, k
    if name == "smtwtp":
        for k in inst:
            assert (inst[k][:, 0] == 0).all() and (inst[k][:, 1:] > 0).all(), k
        assert inst["job_due_time"].max() < env.num_job / 2
    if name in ("dpp", "mdpp"):
        probes = (inst["probe_mask"].sum(-1) if name == "mdpp"
                  else np.ones(b, int))
        lo, hi = (env.num_probes_min, env.num_probes_max) if name == "mdpp" else (1, 1)
        assert probes.min() == lo and probes.max() == hi
        counts = inst["keepout"].sum(-1)
        assert counts.min() == env.num_keepout_min and counts.max() == env.num_keepout_max - 1
        probe = (inst["probe_mask"] if name == "mdpp"
                 else np.arange(16) == inst["probe"][:, None])
        assert not (inst["keepout"] & probe).any()
    if name == "mcp":
        w, m = inst["weights"], inst["membership"]
        assert set(np.unique(w)) <= set(range(env.min_weight, env.max_weight))
        sizes = (m > 0).sum(-1)
        assert sizes.min() == env.min_size and sizes.max() == env.max_size
        assert m.max() <= env.num_items


@pytest.mark.parametrize("name", NAMES)
def test_generate_refuses_to_run_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env_pair(name, None)[0].generate(2)


def test_mdpp_datasets_come_from_the_port():
    from rl4co_tpu_torch.data import generate as tgen

    data = tgen.generate_dataset("mdpp", 10, 3, 0, device="cpu")
    assert data["probe_mask"].shape == data["keepout"].shape == (3, 100)


@pytest.mark.parametrize("name", NAMES)
def test_embeddings_match_jax(name):
    tenv, jenv = env_pair(name, None)
    inst = jax_instances(jenv, 3, 4)
    rs = np.random.RandomState(3)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    tstates, jstates = [ts], [js]
    for _ in range(tenv.max_steps):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        tstates.append(ts)
        jstates.append(js)
    check_embeddings(name, inst, tstates, jstates)


@pytest.mark.parametrize("name", NAMES)
def test_am_greedy_matches_jax(name):
    _, jenv = env_pair(name, None)
    inst = jax_instances(jenv, 7, 8)
    jpol, params, tpol = am_pair(name, seed=3)
    want, got = rollout_pair(jpol, params, tpol, name, inst, kind="greedy", tanh_clipping=10.0)
    assert_rollouts_match(want, got, reward_rtol=1e-4 if name in ("dpp", "mdpp") else 1e-5)
    env_pair(name, None)[0].check_solution_validity(inst, t2n(got.actions))


# ------------------------------------------------------------- golden files
# AM at full width with `random_params_numpy(GOLDEN_SEED, env_name=...)`
# weights on GOLDEN_COUNT JAX-generated instances of each env at its default
# size (SMTWTP-50; DPP and MDPP on the 10 × 10 grid, 20 decaps, 50
# frequencies, synthetic PDN; FLP-100 choosing 10; MCP with 200 items and 100
# sets choosing 10): greedy in one dispatch, the costs and actions. Held on
# the card by `chip_smoke.py` (phase `golden_envs_10b`).
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rl4co_tpu_torch", "golden")
GOLDEN_ENVS = {
    "smtwtp": dict(num_job=50),
    "dpp": {},
    "mdpp": {},
    "flp": dict(num_loc=100, to_choose=10),
    "mcp": {},
}
GOLDEN_SEED, GOLDEN_COUNT, SELF_ORDERS = 0, 1024, 8


def golden_env_pair(name):
    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu_torch.envs import get_env

    return get_env(name, **GOLDEN_ENVS[name]), jax_get_env(name, **GOLDEN_ENVS[name])


def load_golden(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


def test_golden_files_shapes():
    inst = load_golden("envs_10b_instances.npz")
    costs = load_golden("envs_10b_costs.npz")
    assert int(costs["seed"]) == GOLDEN_SEED
    for name in GOLDEN_ENVS:
        tenv, jenv = golden_env_pair(name)
        want = jax_instances(jenv, 0, 1)
        got = {k[len(name) + 1:]: v for k, v in inst.items() if k.startswith(name + "/")}
        assert set(got) == set(want), name
        for k in want:
            assert got[k].shape == (GOLDEN_COUNT,) + want[k].shape[1:], (name, k)
        assert costs[f"{name}/greedy"].shape == (GOLDEN_COUNT,)
        assert np.isfinite(costs[f"{name}/greedy"]).all()
        actions = costs[f"{name}/greedy/actions"]
        assert actions.shape == (GOLDEN_COUNT, tenv.max_steps)
        tenv.check_solution_validity({k: v[:16] for k, v in got.items()}, actions[:16])


@pytest.mark.parametrize("name", list(GOLDEN_ENVS))
def test_golden_greedy_costs_on_the_cpu(name):
    """The port's full-width AM on the first 4 golden instances of each env:
    the JAX CPU greedy costs within 1e-5 (1e-4 for DPP and MDPP; batch norm:
    the 4 are their own dispatch, so the JAX policy is run on them here too)."""
    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models import rollout as jax_rollout
    from rl4co_tpu_torch.convert import load_params
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models import AttentionModelPolicy, rollout
    import jax

    from _torch_port import JaxPolicy

    inst = {k[len(name) + 1:]: v[:4] for k, v in
            load_golden("envs_10b_instances.npz").items() if k.startswith(name + "/")}
    tree = random_params_numpy(GOLDEN_SEED, env_name=name)
    jpol = JaxPolicy(env_name=name)
    tpol = load_params(AttentionModelPolicy(env_name=name, device="cpu"), tree).eval()
    tenv, jenv = golden_env_pair(name)
    want = jax_rollout(jpol, tree_to_jax(tree), jenv, to_jax(inst), jax.random.PRNGKey(0),
                       JaxSpec(kind="greedy", tanh_clipping=10.0))
    with torch.no_grad():
        got = rollout(tpol, tenv, inst, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                      device="cpu")
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward),
                               rtol=1e-4 if name in ("dpp", "mdpp") else 1e-5)
    tenv.check_solution_validity(inst, t2n(got.actions))
    del jax_get_env


def write_golden():
    """The golden files from the JAX package on the CPU in f32: instances
    (`generate_batch` at keys 400 + i) and AM's greedy costs and actions on
    GOLDEN_COUNT in one dispatch; and how far the reference is from itself:
    the most rows whose tours change, and the largest change of the mean
    cost, when the same dispatch runs in another order (in SELF_ORDERS
    orders where the first moves more than 1 % of the tours: MCP's; the
    others' do not)."""
    import time

    import jax

    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models.policies.constructive import rollout as jax_rollout

    from _torch_port import JaxPolicy

    key = jax.random.PRNGKey(0)
    greedy = JaxSpec(kind="greedy", tanh_clipping=10.0)
    t0 = time.time()
    inst_out, cost_out = {}, {"seed": np.int64(GOLDEN_SEED)}
    for i, name in enumerate(GOLDEN_ENVS):
        _, jenv = golden_env_pair(name)
        if name in ("dpp", "mdpp"):  # the PDN made outside any trace (a cached tracer leaks)
            jenv._pdn()
        inst = jax_instances(jenv, 400 + i, GOLDEN_COUNT)
        inst_out.update({f"{name}/{k}": v for k, v in inst.items()})
        jpol = JaxPolicy(env_name=name)
        params = tree_to_jax(random_params_numpy(GOLDEN_SEED, env_name=name))
        out = jax_rollout(jpol, params, jenv, to_jax(inst), key, greedy)
        cost_out[f"{name}/greedy"] = -np.asarray(out.reward)
        cost_out[f"{name}/greedy/actions"] = np.asarray(out.actions).astype(np.int16)
        cost_out[f"{name}/greedy/dispatch"] = np.int64(GOLDEN_COUNT)
        # the reference against itself: the same dispatch in another order;
        # where that moves more than 1 % of its tours, in SELF_ORDERS orders
        departed, drift = [], []
        for seed in range(SELF_ORDERS):
            perm = np.random.RandomState(seed).permutation(GOLDEN_COUNT)
            again = jax_rollout(jpol, params, jenv, to_jax({k: v[perm] for k, v in inst.items()}),
                                key, greedy)
            same = (np.asarray(again.actions) == cost_out[f"{name}/greedy/actions"][perm]).all(1)
            ref_mean = cost_out[f"{name}/greedy"].mean()
            departed.append(int((~same).sum()))
            drift.append(abs(-np.asarray(again.reward).mean() - ref_mean) / abs(ref_mean))
            if departed[0] <= 0.01 * GOLDEN_COUNT:
                break
        cost_out[f"{name}/greedy/self_departed"] = np.int64(max(departed))
        cost_out[f"{name}/greedy/self_mean_rel"] = np.float64(max(drift))
        print(name, "greedy", cost_out[f"{name}/greedy"].mean(), "rows off its own tours",
              departed, "mean drift", max(drift), time.time() - t0, flush=True)
    np.savez_compressed(os.path.join(GOLDEN, "envs_10b_instances.npz"), **inst_out)
    np.savez_compressed(os.path.join(GOLDEN, "envs_10b_costs.npz"), **cost_out)


if __name__ == "__main__":
    write_golden()
