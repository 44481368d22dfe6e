"""``DecodeSpec.remat`` and ``REINFORCE.fused_rollout_baseline`` in the port
against themselves and the JAX package (`rl4co_tpu/rl/reinforce.py:117-178`,
`rl4co_tpu/models/policies/constructive.py:234`).

- ``remat=True`` recomputes each decode step's logits in the backward pass
  (`torch.utils.checkpoint`): the same loss and the same gradients as
  ``remat=False`` from the same generator state, to the bit on the CPU, in
  f32 and under bf16 compute (the recompute runs on the rounded parameters).
- The fused rollout baseline on converted weights (live and snapshot apart):
  the loss on JAX's member-0 actions replayed within 1e-5 of its terms'
  scale, the metrics rtol 1e-5; member 1 (the snapshot at temperature 1e-9,
  drawn from the same generator state) gives JAX's member-1 rewards, rtol
  1e-5, on the tests' untied weights.
"""

import jax
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
from rl4co_tpu.rl.baselines import RolloutBaseline as JaxRolloutBaseline
from rl4co_tpu.rl.reinforce import REINFORCE as JaxREINFORCE
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.rl.baselines import get_reinforce_baseline
from rl4co_tpu_torch.rl.reinforce import REINFORCE

from _torch_port import (
    KEY,
    SMALL,
    assert_loss_close,
    policy_pair,
    random_locs,
    t2n,
    tree_to_jax,
)

torch.set_num_threads(1)

N, B = 8, 6


def loss_and_grads(remat: bool, compute_dtype=None, seed=0):
    torch.manual_seed(0)
    _, _, tpol = policy_pair(seed=seed)
    tpol.train().requires_grad_(True)
    spec = DecodeSpec(kind="sampling", tanh_clipping=10.0, remat=remat,
                      compute_dtype=compute_dtype)
    algo = REINFORCE(get_env("tsp", num_loc=N), tpol, baseline="mean", train_spec=spec)
    algo.reseed(3, 1)
    inst = {"locs": torch.tensor(random_locs(5, B, N))}
    loss, (_, out) = algo.loss(inst)
    loss.backward()
    return loss.detach(), out.actions, {k: p.grad.clone() for k, p in tpol.named_parameters()}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_remat_gives_the_loss_and_gradients_without_it(compute_dtype):
    loss0, actions0, grads0 = loss_and_grads(False, compute_dtype)
    loss1, actions1, grads1 = loss_and_grads(True, compute_dtype)
    assert torch.equal(actions0, actions1)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k


def test_remat_recomputes_each_decode_step_in_the_backward():
    from rl4co_tpu_torch.ops import pointer_kernel

    calls = []
    inner = pointer_kernel._PointerLogits.forward

    def counted(ctx, *args):
        calls.append(1)
        return inner(ctx, *args)

    pointer_kernel._PointerLogits.forward = staticmethod(counted)
    try:
        _, _, tpol = policy_pair(seed=0)
        tpol.train().requires_grad_(True)
        spec = DecodeSpec(kind="sampling", tanh_clipping=10.0, remat=True)
        algo = REINFORCE(get_env("tsp", num_loc=N), tpol, baseline="mean", train_spec=spec)
        loss, _ = algo.loss({"locs": torch.tensor(random_locs(5, B, N))})
        forward = len(calls)
        loss.backward()
    finally:
        pointer_kernel._PointerLogits.forward = staticmethod(inner)
    assert forward == N and len(calls) == 2 * N


def fused_pair(seed_live=1, seed_bl=2):
    """JAX's and the port's REINFORCE with the fused rollout baseline, the
    live weights from ``seed_live`` and the snapshot's from ``seed_bl``."""
    jpol, jlive, tpol = policy_pair(seed=seed_live)
    tpol.train().requires_grad_(True)
    jbl = tree_to_jax(random_params_numpy(seed_bl, SMALL["embed_dim"],
                                          SMALL["num_encoder_layers"],
                                          SMALL["feedforward_hidden"]))
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxREINFORCE(env=jax_get_env("tsp", num_loc=N), policy=jpol,
                         baseline=JaxRolloutBaseline(), train_spec=JaxSpec(**spec),
                         fused_rollout_baseline=True)
    talgo = REINFORCE(get_env("tsp", num_loc=N), tpol,
                      baseline=get_reinforce_baseline("rollout", warmup=False),
                      train_spec=DecodeSpec(**spec), fused_rollout_baseline=True)
    load_params(talgo.baseline_state.bl_policy,
                random_params_numpy(seed_bl, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                                    SMALL["feedforward_hidden"]))
    jstate = jalgo.baseline.init_state(KEY, jbl, jalgo.greedy_reward_fn())
    return jalgo, jlive, jstate, talgo


def jax_member_one(jalgo, jstate, locs):
    return jax_rollout(jalgo.policy, jstate.bl_params, jalgo.env,
                       {"locs": jax.numpy.asarray(locs)}, KEY, jalgo.train_spec,
                       temperature_override=jax.numpy.float32(1e-9))


def test_fused_loss_on_replayed_actions_matches_jax():
    jalgo, jlive, jstate, talgo = fused_pair()
    locs = random_locs(6, B, N)
    jloss, (jm, jout) = jalgo.loss(jlive, jstate, {"locs": jax.numpy.asarray(locs)}, KEY)
    tloss, (tm, tout) = talgo.loss({"locs": torch.tensor(locs)},
                                   replay_actions=np.asarray(jout.actions))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    advantage = np.asarray(jout.reward) - np.asarray(jax_member_one(jalgo, jstate, locs).reward)
    assert_loss_close(tloss.item(), jloss,
                      float(np.abs(advantage * np.asarray(jout.log_likelihood)).mean()))
    for k in ("reward", "bl_val", "entropy", "bl_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_fused_member_one_is_the_jax_member_one():
    jalgo, _, jstate, talgo = fused_pair()
    locs = random_locs(7, B, N)
    want = jax_member_one(jalgo, jstate, locs)
    talgo.reseed(4, 0)
    got = talgo.baseline_rollout({"locs": torch.tensor(locs)})
    greedy = talgo.greedy_reward_fn()(talgo.baseline_state.bl_policy, {"locs": torch.tensor(locs)})
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), rtol=1e-5)
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    torch.testing.assert_close(got.reward, greedy, rtol=0, atol=0)   # greedy: no tie here
    # the live rollout draws from where member 1 started: the generator is untouched
    state = talgo.generator.get_state()
    talgo.baseline_rollout({"locs": torch.tensor(locs)})
    assert torch.equal(state, talgo.generator.get_state())
