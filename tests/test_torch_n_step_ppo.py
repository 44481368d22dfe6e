"""The port's n-step PPO (`rl4co_tpu_torch/rl/n_step_ppo.py`) against the JAX
package's (`rl4co_tpu/rl/n_step_ppo.py`), for DACT, N2S and NeuOpt, and the
golden file of the chip phase `improvement_trio`.

The JAX side of a segment is its own rollout, bootstrap and loss in a Python
loop (`jax_segment`), held to `make_segment_step` on the same key (the same
moves, metrics rtol 1e-5) by the golden generator below at full width, not
in a collected test, whose compile would take a minute. The port replays its moves and is held
to: the rollout's log-probabilities atol 1e-5 and rewards atol 2e-6; the
first epoch's losses rtol 1e-4 plus atol 1e-6 and the later epochs' rtol
2e-3 (each clipped Adam step moves both sides' parameters, whose last bits
differ, and the next loss with them); the first epoch's gradients, every
one, at rtol 1e-3 plus atol 1e-4 of the largest; the parameters after the
segment's three updates in units of each group's learning rate, atol 0.1,
where the JAX gradient exceeds 1e-3 of the largest (Adam turns rounding
noise around zero into anything up to ±lr).

`python tests/test_torch_n_step_ppo.py` rewrites
`rl4co_tpu_torch/golden/improvement_trio.npz` with the JAX package on the
CPU in f32: each model at its published widths (DACT 64 wide, 3 layers, 4
heads on `TSPkopt(50, k_max=2)`; N2S 128 on `PDPRuinRepair(50)`; NeuOpt 128
on `TSPkopt(50, k_max=4)`), `NStepPPO.init(PRNGKey(seed))`'s weights, 64
instances, 20 sampled steps (actions, log-probabilities, tours and costs),
and one segment (n_step 5, 3 PPO epochs) with its losses, its first-epoch
gradients (every leaf's norm; in full the first encoder layer's and those
outside the encoder) and per-leaf update norms (about six minutes, 8 MB).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.rl.n_step_ppo import NStepPPO as JaxNStepPPO
from rl4co_tpu.models.zoo.dact import ImprovementCritic as JaxCritic
from rl4co_tpu_torch.convert import convert_params, load_params
from rl4co_tpu_torch.models.zoo.dact import ImprovementCritic
from rl4co_tpu_torch.rl.n_step_ppo import NStepPPO

from _torch_port import (ROOT, TRIO_SMALL, seeded_tree_like, t2n, trio_jax_state, trio_setup,
                         trio_state_to_torch, tree_to_numpy)

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "improvement_trio.npz")
METRICS = ("loss", "surrogate_loss", "value_loss", "value")
ACTION_DIM = {"dact": 2, "n2s": 3, "neuopt": 12}
GOLDEN_SEED = 18
GOLDEN_STEPS = 20
GOLDEN_BATCH = 64


def jax_algo(name, n, **dims):
    jenv, tenv, jpol, tcls, jact, tact, emb = trio_setup(name, n, **dims)
    algo = JaxNStepPPO(env=jenv, policy=jpol, critic=JaxCritic(embed_dim=emb), act_fn=jact,
                       action_dim=ACTION_DIM[name])
    return algo, tenv, tcls, tact, emb


def jax_segment(algo, params, opt_state, env_state, prev_action, key):
    """`NStepPPO.make_segment_step`'s segment written out, returning what it
    hides: the moves, every epoch's metrics and the first epoch's gradients."""
    tx = algo.make_optimizer()
    kroll, kboot = jax.random.split(key)
    env_state, prev_action, memory = jax.jit(algo._rollout_segment)(
        params, env_state, prev_action, kroll)
    states, actions, old_ll, rewards = memory
    r = jax.jit(lambda p, st, k: algo.critic.apply(p["critic"], algo.act_fn(
        algo.policy, p["policy"], st, k, algo.train_spec, None)[2]))(params, env_state, kboot)
    returns = []
    for t in reversed(range(algo.n_step)):
        r = r * algo.gamma + rewards[t]
        returns.append(r)
    returns = jnp.stack(returns[::-1])
    c = algo.clip_range

    def loss_fn(p, old_value, first):
        # the module's loss; ``first`` (epoch 0, no old value) as a traced
        # flag, so that one compile serves every epoch
        ll, value = algo._evaluate(p, states, actions)
        ratio = jnp.exp(ll - old_ll)
        adv = returns - jax.lax.stop_gradient(value)
        surrogate = -jnp.minimum(ratio * adv, jnp.clip(ratio, 1 - c, 1 + c) * adv).mean()
        clipped = jnp.clip(value - old_value, -c, c) + old_value
        value_loss = jnp.where(first, jnp.square(value - returns).mean(), jnp.maximum(
            jnp.square(value - returns), jnp.square(clipped - returns)).mean())
        loss = surrogate + algo.vf_lambda * value_loss
        return loss, ({"loss": loss, "surrogate_loss": surrogate, "value_loss": value_loss,
                       "value": value.mean()}, value)

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    epochs, old_value, grads0 = [], jnp.zeros_like(old_ll), None
    for k in range(algo.ppo_epochs):
        grads, (metrics, value) = grad_fn(params, old_value, k == 0)
        if k == 0:
            grads0, old_value = grads, value
        epochs.append({m: float(v) for m, v in metrics.items()})
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return dict(env_state=env_state, actions=actions, old_ll=old_ll, rewards=rewards,
                returns=returns, epochs=epochs, grads=grads0, params=params)


def seeded_params(algo, jst, seed):
    """Numpy-seeded weights of policy and critic in their Flax trees, and the
    optimiser's initial state (no JAX compile: the shapes come from
    `jax.eval_shape`)."""
    policy_shapes = jax.eval_shape(algo.policy.init, jax.random.PRNGKey(0), jst)
    embeds = jax.eval_shape(algo.policy.apply, policy_shapes, jst)[1]
    params = {"policy": seeded_tree_like(policy_shapes, seed),
              "critic": seeded_tree_like(jax.eval_shape(algo.critic.init, jax.random.PRNGKey(0),
                                                        embeds), seed + 1)}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return params, algo.make_optimizer().init(params)


def port_algo(name, tenv, tcls, tact, emb, params, dims, device="cpu"):
    tpol = load_params(tcls(**dims, device=device), tree_to_numpy(params["policy"]))
    critic = load_params(ImprovementCritic(emb, device=device), tree_to_numpy(params["critic"]))
    return NStepPPO(env=tenv, policy=tpol, critic=critic, act_fn=tact,
                    action_dim=ACTION_DIM[name])


def grads_by_name(grads):
    """The JAX gradient tree under the port's parameter names."""
    return {**{f"policy.{k}": v for k, v in convert_params(tree_to_numpy(grads["policy"])).items()},
            **{f"critic.{k}": v for k, v in convert_params(tree_to_numpy(grads["critic"])).items()}}


@pytest.mark.parametrize("name", ["dact", "n2s", "neuopt"])
def test_one_segment_matches_jax(name):
    n, b = 10, 4
    algo, tenv, tcls, tact, emb = jax_algo(name, n, **TRIO_SMALL)
    algo = dataclasses.replace(algo, n_step=3, ppo_epochs=3)
    inst = {k: v.numpy() for k, v in
            tenv.generate(b, torch.Generator().manual_seed(1), "cpu").items()}
    env_state, _ = trio_jax_state(algo.env, tenv, inst, 2)
    params, opt_state = seeded_params(algo, env_state, 0)
    prev = jnp.zeros((b, ACTION_DIM[name]), jnp.int32)
    want = jax_segment(algo, params, opt_state, env_state, prev, jax.random.PRNGKey(3))

    port = port_algo(name, tenv, tcls, tact, emb, params, TRIO_SMALL)
    port.n_step = 3
    before = {n_: p.detach().clone() for n_, p in
              [*(("policy." + k, v) for k, v in port.policy.named_parameters()),
               *(("critic." + k, v) for k, v in port.critic.named_parameters())]}
    trace = {}
    tst, _, metrics = port.segment(trio_state_to_torch(tenv, inst, env_state),
                                   torch.tensor(np.asarray(prev)).long(),
                                   torch.tensor(np.asarray(want["actions"])).long(), trace)
    np.testing.assert_array_equal(t2n(tst.rec_current), np.asarray(want["env_state"].rec_current))
    np.testing.assert_allclose(t2n(trace["old_ll"]), np.asarray(want["old_ll"]), atol=1e-5)
    np.testing.assert_allclose(t2n(trace["rewards"]), np.asarray(want["rewards"]), atol=2e-6)
    np.testing.assert_allclose(t2n(trace["returns"]), np.asarray(want["returns"]), atol=1e-5)
    for k, (got, exp) in enumerate(zip(trace["epochs"], want["epochs"])):
        for m in METRICS:
            rtol = 1e-4 if k == 0 else 2e-3
            np.testing.assert_allclose(got[m], exp[m], rtol=rtol, atol=1e-6,
                                       err_msg=f"epoch {k} {m}")
    jg = grads_by_name(want["grads"])
    assert set(jg) == set(trace["grads"]), sorted(set(jg) ^ set(trace["grads"]))
    scale = max(float(g.abs().max()) for g in jg.values())
    for k, g in jg.items():
        np.testing.assert_allclose(t2n(trace["grads"][k]), t2n(g), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    after = grads_by_name(want["params"])
    lrs = {"policy": port.optimizer.inner.param_groups[0]["lr"],
           "critic": port.optimizer.inner.param_groups[1]["lr"]}
    params_now = {**{"policy." + k: v for k, v in port.policy.named_parameters()},
                  **{"critic." + k: v for k, v in port.critic.named_parameters()}}
    for k, p in params_now.items():
        lr = lrs[k.split(".")[0]]
        big = t2n(jg[k]).__abs__() > 1e-3 * scale
        got = (t2n(p) - t2n(before[k]))[big] / lr
        exp = (t2n(after[k]) - t2n(before[k]))[big] / lr
        np.testing.assert_allclose(got, exp, atol=0.1, err_msg=k)


def test_train_on_batch_warmup_and_evaluate_run_and_improve():
    from rl4co_tpu_torch.models.zoo.dact import DACT

    algo = DACT(policy_kwargs={**TRIO_SMALL, "device": "cpu"}, n_step=2, T_train=4,
                T_test=6, ppo_epochs=2, steps_per_epoch_hint=1)
    algo.env = dataclasses.replace(algo.env, num_loc=8)
    m = algo.train_step(3)
    assert algo.calls == 1 and algo.step == 2
    assert all(np.isfinite(float(v)) for v in m.values())
    m = algo.train_step(3)   # epoch 1: a warm-up of ceil(2.0) moves
    inst = algo.env.generate(3, algo.generator, "cpu")
    e = algo.evaluate(inst)
    assert float(e["cost_bsf"]) <= float(e["cost_init"]) + 1e-6
    state = algo.state_dict()
    algo.load_state_dict(state)
    assert algo.calls == 2


def assert_replica_is_the_module(algo, ts, name, b=8):
    """`jax_segment` takes the moves and gives the metrics of the JAX
    package's own jitted segment on the same key (rtol 1e-5)."""
    inst = algo.env.generate_batch(jax.random.PRNGKey(5), b)
    env_state = algo.env.reset_batch(inst, jax.random.PRNGKey(6))
    prev = jnp.zeros((b, ACTION_DIM[name]), jnp.int32)
    want = jax_segment(algo, ts.params, ts.opt_state, env_state, prev, jax.random.PRNGKey(7))
    _, got_state, _, got = algo.make_segment_step()(ts, env_state, prev, jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(got_state.rec_current),
                                  np.asarray(want["env_state"].rec_current))
    for m in METRICS:
        np.testing.assert_allclose(float(got[m]), want["epochs"][-1][m], rtol=1e-5, atol=1e-7)


def write_golden():
    """The chip phase's golden file (see the module docstring)."""
    out = {"seed": GOLDEN_SEED, "steps": GOLDEN_STEPS}
    for name in ("dact", "n2s", "neuopt"):
        algo, *_ = jax_algo(name, 50)
        ts = algo.init(jax.random.PRNGKey(GOLDEN_SEED))
        assert_replica_is_the_module(algo, ts, name)
        for part in ("policy", "critic"):
            for k, v in jax.tree_util.tree_flatten_with_path(tree_to_numpy(ts.params[part]))[0]:
                out[f"{name}/params/{part}/" + "/".join(p.key for p in k)] = v
        inst = {k: np.asarray(v) for k, v in algo.env.generate_batch(
            jax.random.PRNGKey(GOLDEN_SEED + 1), GOLDEN_BATCH).items()}
        out.update({f"{name}/instances/{k}": v for k, v in inst.items()})
        st0 = algo.env.reset_batch(jax.tree_util.tree_map(jnp.asarray, inst),
                                   jax.random.PRNGKey(GOLDEN_SEED + 2))
        out[f"{name}/rec0"] = np.asarray(st0.rec_current).astype(np.int8)
        act = jax.jit(algo.act_fn, static_argnums=(0, 4))
        step = jax.jit(algo.env.step_batch)
        st = st0
        prev = jnp.zeros((GOLDEN_BATCH, ACTION_DIM[name]), jnp.int32)
        rec = {k: [] for k in ("actions", "logprobs", "rec_current", "rec_best", "cost_bsf",
                               "cost_current")}
        for t in range(GOLDEN_STEPS):
            a, lp, _ = act(algo.policy, ts.params["policy"], st,
                           jax.random.PRNGKey(1000 + t), algo.train_spec, prev)
            st, _ = step(st, a)
            prev = a
            for k, v in (("actions", a), ("logprobs", lp), ("rec_current", st.rec_current),
                         ("rec_best", st.rec_best), ("cost_bsf", st.cost_bsf),
                         ("cost_current", st.cost_current)):
                rec[k].append(np.asarray(v))
        for k, v in rec.items():
            v = np.stack(v)
            out[f"{name}/replay/{k}"] = v.astype(np.int8) if v.dtype.kind == "i" else v
        prev0 = jnp.zeros((GOLDEN_BATCH, ACTION_DIM[name]), jnp.int32)
        seg = jax_segment(algo, ts.params, ts.opt_state, st0, prev0,
                          jax.random.PRNGKey(GOLDEN_SEED + 3))
        out[f"{name}/segment/actions"] = np.asarray(seg["actions"]).astype(np.int8)
        for k in ("old_ll", "rewards", "returns"):
            out[f"{name}/segment/{k}"] = np.asarray(seg[k])
        out[f"{name}/segment/rec_current"] = np.asarray(seg["env_state"].rec_current).astype(
            np.int8)
        out[f"{name}/segment/epochs"] = np.array(
            [[e[m] for m in METRICS] for e in seg["epochs"]])
        grads = grads_by_name(seg["grads"])
        before = grads_by_name(ts.params)
        after = grads_by_name(seg["params"])
        scale = max(float(g.abs().max()) for g in grads.values())
        for k, g in grads.items():
            # every leaf's norm; in full the first encoder layer's and the
            # leaves outside the encoder (the rest would double the file)
            out[f"{name}/segment/grad_norm/{k}"] = np.float32(np.linalg.norm(t2n(g)))
            if not any(f"layer_{i}." in k for i in (1, 2)):
                out[f"{name}/segment/grads/{k}"] = t2n(g)
            big = t2n(g).__abs__() > 1e-3 * scale
            out[f"{name}/segment/update_norm/{k}"] = np.float32(
                np.linalg.norm((t2n(after[k]) - t2n(before[k]))[big]))
        print(name, "segment epochs", seg["epochs"], flush=True)
    np.savez_compressed(GOLDEN, **out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")


if __name__ == "__main__":
    write_golden()
