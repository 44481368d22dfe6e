"""Stepwise PPO in the port against the JAX package
(`rl4co_tpu/rl/stepwise_ppo.py`) with L2D's policy and critic on FJSP, and
the golden file of the `l2d_fjsp_jssp` chip phase.

One JAX train step is replayed: its instances, its sampled actions and its
minibatch permutations (drawn from the step's own keys) go into the port's
`StepwisePPO.update`.
- The collected transitions: per-step lower-bound rewards and the old
  log-probabilities atol 1e-5, the valid flags equal.
- The first minibatch's loss (written out from the JAX step) within 1e-5
  relative and every gradient within 1e-4 of the largest.
- The step's metrics (the last minibatch's, after the Adam steps before it)
  within 1e-3 relative, and the reward (minus the mean makespan) equal.

`python tests/test_torch_stepwise_ppo.py` rewrites
`rl4co_tpu_torch/golden/l2d_fjsp_jssp.npz` (L2DPolicy at the JAX defaults on
256 FJSP 10x5 instances and L2DAttnPolicy 128/8/4 on 256 JSSP 10x10
instances from `jax.random`: the JAX CPU greedy makespans and actions; one
JAX StepwisePPO step on 64 FJSP 10x5 instances: its draws, every
minibatch's loss, checksums of the first minibatch's gradients, and the
step's metrics); no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.decoding import process_logits_spec as jax_process  # noqa: E402
from rl4co_tpu.decoding import take_along_last as jax_take  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models.zoo.l2d import L2DAttnPolicy as JaxAttn  # noqa: E402
from rl4co_tpu.models.zoo.l2d import L2DPolicy as JaxL2D  # noqa: E402
from rl4co_tpu.models.zoo.l2d import l2d_attn_rollout as jax_attn_rollout  # noqa: E402
from rl4co_tpu.models.zoo.l2d import l2d_rollout as jax_l2d_rollout  # noqa: E402
from rl4co_tpu.rl.reinforce import TrainState  # noqa: E402
from rl4co_tpu.rl.stepwise_ppo import StepwisePPO as JaxPPO  # noqa: E402
from rl4co_tpu_torch.convert import convert_params, random_params_numpy  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models.zoo.l2d import L2DPolicy  # noqa: E402
from rl4co_tpu_torch.rl.stepwise_ppo import StepwisePPO  # noqa: E402

from _torch_port import (  # noqa: E402
    KEY,
    assert_gradients_close,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
)
from test_torch_matnet import gradient_checksums  # noqa: E402

torch.set_num_threads(1)

FJSP = dict(num_jobs=3, num_mas=2)
SMALL = dict(embed_dim=16, num_encoder_layers=1, actor_hidden_dim=16, with_critic=True)
B, MB = 4, 16
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden",
                      "l2d_fjsp_jssp.npz")


def jax_step_draws(algo: JaxPPO, params, batch: int, key, step: int = 0):
    """The instances, sampled actions ``[B, T]`` and minibatches of JAX's
    train step ``step`` (its own keys, as `make_train_step` splits them)."""
    kd, kr, kperm = jax.random.split(jax.random.fold_in(key, step), 3)
    instances = algo.env.generate_batch(kd, batch)
    _, (states, actions, old_lp, rewards, valid) = jax.jit(algo._collect)(params, instances, kr)
    total = algo.env.max_steps * batch
    mb = min(algo.mini_batch_size, total)
    num_mb = total // mb
    perms = [jax.random.permutation(jax.random.fold_in(kperm, e), total)[: num_mb * mb]
             .reshape(num_mb, mb) for e in range(algo.ppo_epochs)]
    flat = jax.tree_util.tree_map(lambda x: x.reshape((total,) + x.shape[2:]), states)
    memory = (flat, actions.reshape(-1), old_lp.reshape(-1), rewards.reshape(-1),
              valid.reshape(-1))
    return ({k: np.asarray(v) for k, v in instances.items()}, np.asarray(actions).T,
            np.asarray(jnp.concatenate(perms)), memory)


def jax_minibatch_loss(algo: JaxPPO, params, states, actions, old_lp, rewards, valid):
    """`StepwisePPO.make_train_step`'s minibatch loss, written out."""
    logits, value = algo.policy.apply(params, states)
    mask = algo.env.action_mask_batch(states)
    logprobs = jax_process(logits.astype(jnp.float32), mask, algo.train_spec)
    lp = jax_take(logprobs, actions)
    probs = jnp.exp(logprobs)
    entropy = -jnp.sum(jnp.where(probs > 0, probs * logprobs, 0.0), -1)
    w = valid.astype(jnp.float32)
    wsum = w.sum() + 1e-9
    ratios = jnp.exp(lp - old_lp)
    adv = rewards - jax.lax.stop_gradient(value)
    surr = -jnp.minimum(ratios * adv,
                        jnp.clip(ratios, 1 - algo.clip_range, 1 + algo.clip_range) * adv)
    loss = ((surr * w).sum() / wsum + algo.vf_lambda * (jnp.square(value - rewards) * w).sum()
            / wsum - algo.entropy_lambda * (entropy * w).sum() / wsum)
    return loss


def take(tree, idx):
    return jax.tree_util.tree_map(lambda x: x[idx], tree)


def replay_step(env_kw, dims, batch, mb, seed):
    """One JAX step and everything the port needs to replay it."""
    tree = random_params_numpy(seed, policy="l2d", policy_kwargs=dims)
    jenv = jax_get_env("fjsp", **env_kw)
    jalgo = JaxPPO(env=jenv, policy=JaxL2D(**dims), mini_batch_size=mb)
    params = tree_to_jax(tree)
    key = jax.random.PRNGKey(seed)
    inst, actions, minibatches, memory = jax_step_draws(jalgo, params, batch, key)
    first = minibatches[0]
    loss0, grads0 = jax.value_and_grad(
        lambda p: jax_minibatch_loss(jalgo, p, take(memory[0], first),
                                     *(m[first] for m in memory[1:])))(params)
    tx = jalgo.make_optimizer()
    state = TrainState(params=params, opt_state=tx.init(params), baseline_state=None,
                       step=jnp.int32(0))
    _, metrics = jalgo.make_train_step(batch, donate=False)(state, key)
    return tree, jalgo, inst, actions, minibatches, memory, loss0, grads0, metrics


def test_one_replayed_step_matches_jax():
    tree, jalgo, inst, actions, minibatches, memory, loss0, grads0, metrics = replay_step(
        FJSP, SMALL, B, MB, 7)
    assert minibatches.shape[0] >= 4   # several Adam steps in the step
    tpol = L2DPolicy(device="cpu", **SMALL)
    from rl4co_tpu_torch.convert import load_params

    load_params(tpol, tree)
    algo = StepwisePPO(get_env("fjsp", **FJSP), tpol, mini_batch_size=MB)
    _, states, t_actions, old_lp, rewards, valid = algo.collect(
        to_torch(inst), torch.from_numpy(actions).long())
    np.testing.assert_array_equal(t2n(t_actions), np.asarray(memory[1]))
    np.testing.assert_allclose(t2n(old_lp), np.asarray(memory[2]), atol=1e-5)
    np.testing.assert_allclose(t2n(rewards), np.asarray(memory[3]), atol=1e-5)
    np.testing.assert_array_equal(t2n(valid), np.asarray(memory[4]))
    seen = {}

    def on_minibatch(i, loss, m):
        if i == 0:
            seen["loss"] = loss.item()
            assert_gradients_close(tpol, grads0)

    got = algo.update(to_torch(inst), replay_actions=actions, minibatches=minibatches,
                      on_minibatch=on_minibatch)
    np.testing.assert_allclose(seen["loss"], float(loss0), rtol=1e-5)
    for k in ("loss", "surrogate_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["reward"].item(), float(metrics["reward"]))


def test_golden_file_holds_its_shapes():
    with np.load(GOLDEN) as g:
        assert g["fjsp_proc_times"].shape == (256, 5, 40)
        assert g["jssp_proc_times"].shape == (256, 10, 100)
        assert g["fjsp_makespan"].shape == g["jssp_makespan"].shape == (256,)
        assert g["ppo_actions"].shape == (64, 41)
        assert g["ppo_minibatches"].shape == (40, 128)   # 2 epochs x 2624 // 128
        assert len(g["ppo_grad_names"]) == g["ppo_grad_norm"].shape[0]


# ---- the golden file of the chip phase ----

GOLDEN_SEED, GOLDEN_COUNT = 19, 256
FJSP_FULL, JSSP_FULL = dict(num_jobs=10, num_mas=5), dict(num_jobs=10, num_mas=10)
ATTN_FULL = dict(embed_dim=128, num_heads=8, num_encoder_layers=4)
PPO_BATCH, PPO_MB = 64, 128


def write_golden():
    out = {"seed": GOLDEN_SEED}
    for name, env_kw, tree_name, jcls, jfn, kw in (
            ("fjsp", FJSP_FULL, "l2d", JaxL2D, jax_l2d_rollout, {}),
            ("jssp", JSSP_FULL, "l2d_attn", JaxAttn, jax_attn_rollout, ATTN_FULL)):
        jenv = jax_get_env(name, **env_kw)
        inst = {k: np.asarray(v) for k, v in jenv.generate_batch(
            jax.random.PRNGKey(GOLDEN_SEED), GOLDEN_COUNT).items()}
        jpol = jcls(**kw)
        params = tree_to_jax(random_params_numpy(GOLDEN_SEED, policy=tree_name,
                                                 policy_kwargs=kw))
        res = jax.jit(lambda p, i: jfn(jpol, p, jenv, i, KEY, JaxSpec(kind="greedy")))(
            params, to_jax(inst))
        out.update({f"{name}_{k}": v for k, v in inst.items()})
        out[f"{name}_makespan"] = -np.asarray(res.reward)
        out[f"{name}_actions"] = np.asarray(res.actions).astype(np.int16)
    dims = {"with_critic": True}
    tree, jalgo, inst, actions, minibatches, memory, loss0, grads0, metrics = replay_step(
        FJSP_FULL, dims, PPO_BATCH, PPO_MB, GOLDEN_SEED)
    named = convert_params(tree_to_numpy(grads0))
    names, norm, total, dot = gradient_checksums(named)
    out.update({f"ppo_{k}": v for k, v in inst.items()})
    out.update(ppo_actions=actions.astype(np.int16), ppo_minibatches=minibatches,
               ppo_first_loss=float(loss0), ppo_grad_names=np.array(names),
               ppo_grad_norm=norm, ppo_grad_sum=total, ppo_grad_dot=dot,
               ppo_grad_max=max(np.abs(v.numpy()).max() for v in named.values()),
               ppo_rewards=np.asarray(memory[3]), ppo_old_logp=np.asarray(memory[2]),
               **{f"ppo_metric_{k}": float(v) for k, v in metrics.items()})
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: FJSP {out['fjsp_makespan'].mean():.3f}, "
          f"JSSP {out['jssp_makespan'].mean():.3f}, PPO loss {float(metrics['loss']):.5f}")


if __name__ == "__main__":
    write_golden()
