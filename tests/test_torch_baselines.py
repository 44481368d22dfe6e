"""The port's REINFORCE baselines against `rl4co_tpu/rl/baselines.py` on given
rewards: `eval` and `update_step` of each, the NaN start of the exponential
value, warm-up's alpha at epochs 0, 1 and 2, the t-test and its challenge.
Tolerance: atol 1e-6 on f32 values (means taken in another order);
`paired_ttest_pvalue` to 1e-12 (the same f64 host arithmetic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.rl import baselines as jbl
from rl4co_tpu_torch.rl import baselines as tbl

from _torch_port import policy_pair, t2n

torch.set_num_threads(1)

ATOL = 1e-6
RS = np.random.RandomState(0)
REWARDS = [-(3.0 + RS.random_sample(12)).astype(np.float32) for _ in range(3)]


def tiny_policy(seed=0):
    return policy_pair(seed=seed)[2]


@pytest.mark.parametrize("name,kwargs", [
    ("no", {}), ("mean", {}), ("shared", {"num_repeats": 3}), ("exponential", {"beta": 0.7}),
])
def test_stateless_and_exponential_baselines_match_jax(name, kwargs):
    jb = jbl.get_reinforce_baseline(name, **kwargs)
    tb = tbl.get_reinforce_baseline(name, **kwargs)
    js = jb.init_state(None, None, None)
    ts = tb.init_state(tiny_policy(), None)
    if name == "exponential":
        assert torch.isnan(ts.value)  # NaN marks "no value yet"
    for r in REWARDS:
        jv, jl = jb.eval(js, None, jnp.asarray(r), None)
        tv, tl = tb.eval(ts, None, torch.from_numpy(r), None)
        assert tv.shape == r.shape
        np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=ATOL)
        assert float(tl) == float(jl) == 0.0
        js = jb.update_step(js, jnp.asarray(r))
        ts = tb.update_step(ts, torch.from_numpy(r))
        if name == "exponential":
            np.testing.assert_allclose(float(ts.value), float(js.value), atol=ATOL)


def test_shared_baseline_is_repeat_major():
    r = torch.arange(6, dtype=torch.float32)  # 3 repeats of 2 instances
    bl, _ = tbl.SharedBaseline(num_repeats=3).eval(None, None, r, None)
    assert bl.tolist() == [2.0, 3.0, 2.0, 3.0, 2.0, 3.0]


@pytest.mark.parametrize("huber", [False, True])
def test_critic_baseline_matches_jax_and_detaches_the_value(huber):
    r = REWARDS[0]
    value = (r + RS.standard_normal(12).astype(np.float32) * 2).astype(np.float32)
    tvalue = torch.from_numpy(value).requires_grad_(True)
    jb = jbl.CriticBaseline(critic_fn=lambda inst: jnp.asarray(value), huber=huber)
    tb = tbl.CriticBaseline(critic_fn=lambda inst: tvalue, huber=huber)
    jv, jl = jb.eval(None, None, jnp.asarray(r), None)
    tv, tl = tb.eval(None, None, torch.from_numpy(r), None)
    assert not tv.requires_grad and tl.requires_grad
    np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    with pytest.raises(ValueError):
        tbl.CriticBaseline().eval(None, None, torch.from_numpy(r), None)


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_warmup_blends_by_epoch_like_jax(epoch):
    """alpha = clip(epoch / n_epochs) with n_epochs = 2: 0, 0.5 and 1. The
    inner baseline is evaluated at alpha == 0 too."""
    inner_vals = -(2.5 + RS.random_sample(12)).astype(np.float32)
    calls = []
    jb = jbl.WarmupBaseline(inner=jbl.RolloutBaseline(), n_epochs=2)
    tb = tbl.WarmupBaseline(inner=tbl.RolloutBaseline(), n_epochs=2)
    policy = tiny_policy()
    ts = tb.init_state(policy, None)
    assert ts.epoch == 0 and torch.isnan(ts.value) and ts.bl_policy is not policy
    js = jbl.BaselineState(value=jnp.float32(jnp.nan), bl_params={}, epoch=jnp.int32(epoch))
    ts = dataclasses.replace(ts, epoch=epoch)

    def t_rollout(who, instances):
        calls.append(who)
        return torch.from_numpy(inner_vals)

    for step, r in enumerate(REWARDS):
        jv, jl = jb.eval(js, None, jnp.asarray(r), lambda p, i: jnp.asarray(inner_vals))
        tv, tl = tb.eval(ts, None, torch.from_numpy(r), t_rollout)
        assert len(calls) == step + 1 and calls[-1] is ts.bl_policy
        np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=ATOL)
        assert float(tl) == float(jl) == 0.0
        js = jb.update_step(js, jnp.asarray(r))
        ts = tb.update_step(ts, torch.from_numpy(r))
        np.testing.assert_allclose(float(ts.value), float(js.value), atol=ATOL)


def test_get_reinforce_baseline_wraps_rollout_in_a_one_epoch_warmup():
    b = tbl.get_reinforce_baseline("rollout")
    assert isinstance(b, tbl.WarmupBaseline) and b.n_epochs == 1
    assert isinstance(b.inner, tbl.RolloutBaseline)
    assert isinstance(tbl.get_reinforce_baseline("rollout", warmup=False), tbl.RolloutBaseline)
    assert isinstance(tbl.get_reinforce_baseline("none"), tbl.NoBaseline)
    with pytest.raises(ValueError):
        tbl.get_reinforce_baseline("nope")
    assert set(tbl.REINFORCE_BASELINES) == set(jbl.REINFORCE_BASELINES)


@pytest.mark.parametrize("case", ["better", "worse", "equal", "noisy"])
def test_paired_ttest_pvalue_equals_jax(case):
    rs = np.random.RandomState(1)
    base = -(3.0 + rs.random_sample(64))
    cand = {"better": base + 0.05 + 0.02 * rs.standard_normal(64),
            "worse": base - 0.05 + 0.02 * rs.standard_normal(64),
            "equal": base + 0.01,
            "noisy": base + 0.5 * rs.standard_normal(64)}[case]
    np.testing.assert_allclose(tbl.paired_ttest_pvalue(cand, base),
                               jbl.paired_ttest_pvalue(cand, base), rtol=0, atol=1e-12)


def test_huber_matches_jax():
    pred = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(
        t2n(tbl.optax_huber(torch.from_numpy(pred), torch.zeros(13))),
        np.asarray(jbl.optax_huber(jnp.asarray(pred), jnp.zeros(13))), atol=ATOL)


def challenge(cand_rewards, base_rewards):
    live = tiny_policy(seed=1)
    b = tbl.RolloutBaseline()
    state = b.init_state(tiny_policy(seed=0), None)
    incumbent = state.bl_policy
    host = {"eval_instances": {"locs": torch.zeros(64, 5, 2)},
            "eval_rewards": None if base_rewards is None else np.asarray(base_rewards)}
    state2, host2 = b.epoch_end(state, live, lambda who, inst: torch.as_tensor(cand_rewards),
                                host)
    assert state2.epoch == 1
    return live, incumbent, state2, host, host2


def test_ttest_challenge_accepts_a_better_candidate_and_keeps_a_worse_one():
    rs = np.random.RandomState(2)
    base = -(3.0 + rs.random_sample(64)).astype(np.float32)
    better = base + 0.05 + 0.01 * rs.standard_normal(64).astype(np.float32)
    live, incumbent, state, host, host2 = challenge(better, base)
    assert state.bl_policy is not incumbent
    for (_, a), (_, b) in zip(state.bl_policy.named_parameters(), live.named_parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(host2["eval_rewards"], better)
    np.testing.assert_array_equal(host["eval_rewards"], base)  # the old dict is not mutated

    worse = base - 0.05
    _, incumbent, state, _, host2 = challenge(worse, base)
    assert state.bl_policy is incumbent
    np.testing.assert_array_equal(host2["eval_rewards"], base)

    # better on average but not significantly: kept
    noisy = base + 0.01 + 2.0 * rs.standard_normal(64).astype(np.float32)
    noisy += 0.01 - (noisy - base).mean()
    _, incumbent, state, _, _ = challenge(noisy, base)
    assert state.bl_policy is incumbent


def test_challenge_restarts_the_incumbent_without_or_with_other_sized_rewards():
    cand = -np.ones(64, dtype=np.float32)
    for base in (None, -np.zeros(32, dtype=np.float32)):  # better rewards of another set
        live, incumbent, state, _, host2 = challenge(cand, base)
        assert state.bl_policy is not incumbent
        np.testing.assert_array_equal(host2["eval_rewards"], cand)
    # no held-out set: only the epoch moves
    b = tbl.RolloutBaseline()
    state = b.init_state(tiny_policy(), None)
    state2, host2 = b.epoch_end(state, tiny_policy(1), None, {})
    assert state2.epoch == 1 and state2.bl_policy is state.bl_policy and host2 == {}


def test_snapshot_does_not_alias_the_live_policy():
    live = tiny_policy()
    live.requires_grad_(True)
    snap = tbl.RolloutBaseline().init_state(live, None).bl_policy
    live_ptrs = {p.data_ptr() for p in live.parameters()}
    assert all(p.data_ptr() not in live_ptrs for p in snap.parameters())
    assert not any(p.requires_grad for p in snap.parameters())
    assert all(p.requires_grad for p in live.parameters())
    before = [p.clone() for p in snap.parameters()]
    with torch.no_grad():
        for p in live.parameters():
            p.add_(1.0)  # what an optimiser step does
    for p, q in zip(snap.parameters(), before):
        assert torch.equal(p, q)
