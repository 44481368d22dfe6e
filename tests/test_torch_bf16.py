"""``DecodeSpec.compute_dtype="bfloat16"`` in the port against the JAX package.

The JAX package casts every floating parameter to bf16 before the forward
pass; a Flax Dense with f32 inputs and a bf16 kernel computes in f32, so the
forward is f32 arithmetic on bf16-rounded weights, except where two bf16
operands meet (TSPContext's ``W_placeholder - 1.0``, computed and rounded in
bf16). The port runs the rollout on f32 copies rounded through bf16, with
that one site rounded as JAX rounds it.

Tolerances:
- decode-step logits rtol 2e-4, atol 2e-5 (f32 on both sides, other
  summation orders: the kernels' tolerance); rollout actions equal, rewards
  rtol 1e-5, log-likelihoods atol 1e-4, as `test_torch_rollout.py`;
- REINFORCE loss and metrics atol 2e-5, as `test_torch_reinforce.py`;
- REINFORCE gradients, each parameter on its own: rtol 2e-2 with atol one
  bf16 ulp of that parameter's largest gradient (2**-7 of it): JAX rounds
  each use's cotangent of a bf16 leaf to bf16 and sums the uses in bf16
  (8 bits of mantissa, one use per decode step); the port sums in f32 and
  rounds once, on the way back through the casts. Measured: 3.95e-3 of the
  parameter's own largest gradient at worst (the context projection), and
  13 of the 23 parameters miss the f32 tolerance of
  `test_torch_reinforce.py`. The biases that a batch norm follows (the
  attention output's and the feed-forward's second) have a gradient of zero
  in exact arithmetic, since the norm takes out any shift of its input's
  mean; there both sides must stay below 1e-5 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import rollout as jax_rollout
from rl4co_tpu.rl import baselines as jbl
from rl4co_tpu.rl.reinforce import REINFORCE as JaxREINFORCE
from rl4co_tpu.utils.dtype import cast_floating
from rl4co_tpu.utils.ops import batchify as jax_batchify
from rl4co_tpu_torch.convert import convert_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.rl import baselines as tbl
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.dtype import round_through, rounded_parameters
from rl4co_tpu_torch.utils.ops import batchify

from _torch_port import policy_pair, random_locs, t2n, tree_to_numpy

torch.set_num_threads(1)

N, B = 10, 6
KEY = jax.random.PRNGKey(0)
BF16 = "bfloat16"


def decode_logits_jax(jpol, jparams, locs, repeats, first):
    """JAX logits of the decode step after forcing ``first`` (or of step 0)."""
    env = jax_get_env("tsp", num_loc=N)
    params = cast_floating(jparams, jnp.bfloat16)
    inst = {"locs": jnp.asarray(locs)}
    cache = jpol.apply(params, jpol.apply(params, inst, method="encode"), method="precompute")
    state = env.reset_batch(jax_batchify(inst, repeats))
    if first is not None:
        state = env.step_batch(state, jnp.asarray(first))
    mask = env.action_mask_batch(state)
    return np.asarray(jpol.apply(params, cache, state, mask, repeats, method="decode_step"))


def decode_logits_port(tpol, locs, repeats, first, params):
    env = get_env("tsp", num_loc=N)
    inst = {"locs": torch.from_numpy(locs)}

    def step():
        cache = tpol.precompute(tpol.encode(inst))
        state = env.reset(batchify(inst, repeats))
        if first is not None:
            state = env.step(state, torch.from_numpy(first))
        return tpol.decode_step(cache, state, env.action_mask(state), repeats)

    with torch.no_grad():
        return t2n(torch.func.functional_call(tpol, params, (step,)))


@pytest.mark.parametrize("repeats", [1, 3], ids=["single", "grouped"])
@pytest.mark.parametrize("after", [False, True], ids=["step0", "step1"])
def test_decode_step_logits_match_jax(repeats, after):
    jpol, jparams, tpol = policy_pair(seed=3)
    locs = random_locs(4, B, N)
    first = np.random.RandomState(5).randint(0, N, size=repeats * B) if after else None
    want = decode_logits_jax(jpol, jparams, locs, repeats, first)
    params = rounded_parameters(tpol, torch.bfloat16)
    got = decode_logits_port(tpol, locs, repeats, first, params)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the placeholder's second rounding is what step 0 needs: rounding every
    # parameter once, it would miss the JAX logits there
    naive = {k: round_through(p, torch.bfloat16) for k, p in tpol.named_parameters()}
    off = np.abs(decode_logits_port(tpol, locs, repeats, first, naive) - want).max()
    assert (off > 1e-3) if not after else (off <= 2e-5 + 2e-4 * np.abs(want).max())


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("multistart", [False, True], ids=["greedy", "multistart"])
def test_rollout_matches_jax(jimpl, multistart):
    jpol, jparams, tpol = policy_pair(seed=6, jax_pointer_impl=jimpl)
    locs = random_locs(7, B, N)
    spec = dict(kind="greedy", tanh_clipping=10.0, compute_dtype=BF16)
    if multistart:
        spec.update(multistart=True, num_starts=N)
    jout = jax_rollout(jpol, jparams, jax_get_env("tsp", num_loc=N),
                       {"locs": jnp.asarray(locs)}, KEY, JaxSpec(**spec))
    tout = rollout(tpol, get_env("tsp", num_loc=N), {"locs": locs}, DecodeSpec(**spec),
                   device="cpu")
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    np.testing.assert_allclose(t2n(tout.reward), np.asarray(jout.reward), rtol=1e-5)
    np.testing.assert_allclose(t2n(tout.log_likelihood), np.asarray(jout.log_likelihood),
                               atol=1e-4)
    np.testing.assert_allclose(t2n(tout.logprobs), np.asarray(jout.logprobs), atol=1e-4)
    # and not the f32 rollout's numbers
    f32 = rollout(tpol, get_env("tsp", num_loc=N), {"locs": locs},
                  DecodeSpec(**{**spec, "compute_dtype": None}), device="cpu")
    assert np.abs(t2n(f32.log_likelihood) - t2n(tout.log_likelihood)).max() > 1e-4


def bf16_pair(seed=0):
    """(JAX REINFORCE, params, baseline state, the port's) with a bf16 greedy
    train spec and the rollout baseline behind a warm-up at epoch 1."""
    jpol, jparams, tpol = policy_pair(seed=seed)
    tpol.train().requires_grad_(True)
    spec = dict(kind="greedy", tanh_clipping=10.0, compute_dtype=BF16)
    jalgo = JaxREINFORCE(env=jax_get_env("tsp", num_loc=N), policy=jpol,
                         baseline=jbl.WarmupBaseline(inner=jbl.RolloutBaseline(), n_epochs=2),
                         train_spec=JaxSpec(**spec))
    talgo = REINFORCE(get_env("tsp", num_loc=N), tpol,
                      baseline=tbl.WarmupBaseline(inner=tbl.RolloutBaseline(), n_epochs=2),
                      train_spec=DecodeSpec(**spec))
    _, jsnap, tsnap = policy_pair(seed=seed + 1)
    jstate = jbl.BaselineState(value=jnp.float32(-3.5), bl_params=jsnap, epoch=jnp.int32(1))
    talgo.baseline_state = tbl.BaselineState(value=torch.tensor(-3.5),
                                             bl_policy=tsnap.requires_grad_(False), epoch=1)
    return jalgo, jparams, jstate, talgo


def test_reinforce_loss_and_every_gradient_match_jax():
    jalgo, jparams, jstate, talgo = bf16_pair()
    locs = random_locs(8, B, N)
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, jstate, {"locs": jnp.asarray(locs)}, KEY)
    tloss, (tmetrics, tout) = talgo.loss({"locs": torch.from_numpy(locs)})
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    for name in jmetrics:
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 1e-2
    under_batch_norm = (".mha.out_proj.bias", ".ffn.Dense_1.bias")
    for name, p in talgo.policy.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        got, leaf_max = p.grad.numpy(), np.abs(want[name]).max()
        if name.endswith(under_batch_norm):
            assert leaf_max < 1e-5 * scale and np.abs(got).max() < 1e-5 * scale, name
            continue
        assert leaf_max > 1e-3 * scale, name
        np.testing.assert_allclose(got, want[name], rtol=2e-2, atol=2**-7 * leaf_max,
                                   err_msg=name)


def test_the_baseline_rollout_and_the_step_keep_f32_masters():
    _, _, _, talgo = bf16_pair(seed=2)
    before = {k: p.detach().clone() for k, p in talgo.policy.named_parameters()}
    talgo.update({"locs": torch.from_numpy(random_locs(9, B, N))})
    for name, p in talgo.policy.named_parameters():
        assert p.dtype == torch.float32 and p.is_leaf, name
        # Adam's first step moves every parameter by up to lr, not to a bf16 grid
        assert not torch.equal(p.detach(), round_through(p.detach(), torch.bfloat16)), name
    assert any(not torch.equal(before[k], p) for k, p in talgo.policy.named_parameters())


def test_decode_spec_compute_dtype_bf16():
    """`tests/test_tasks.py::test_decode_spec_compute_dtype_bf16` in the port:
    a bf16 greedy rollout is finite, close to the f32 one in quality, and
    leaves the f32 master parameters as they were."""
    _, _, tpol = policy_pair(seed=4)
    env = get_env("tsp", num_loc=N)
    inst = env.generate(6, torch.Generator().manual_seed(1), "cpu")
    before = {k: p.detach().clone() for k, p in tpol.named_parameters()}
    out = rollout(tpol, env, inst, DecodeSpec(kind="greedy", compute_dtype=BF16), device="cpu")
    f32 = rollout(tpol, env, inst, DecodeSpec(kind="greedy"), device="cpu")
    assert out.reward.shape == (6,) and torch.isfinite(out.reward).all()
    assert abs(out.reward.mean().item() - f32.reward.mean().item()) < 0.5
    for name, p in tpol.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), before[name]), name


def test_greedy_reward_fn_carries_the_compute_dtype():
    _, _, _, talgo = bf16_pair(seed=5)
    assert talgo.train_spec.compute_dtype == BF16
    locs = {"locs": torch.from_numpy(random_locs(10, B, N))}
    got = talgo.greedy_reward_fn()(talgo.policy, locs)
    want = rollout(talgo.policy, talgo.env, locs,
                   DecodeSpec(kind="greedy", tanh_clipping=10.0, compute_dtype=BF16),
                   device="cpu").reward
    assert torch.equal(got, want) and not got.requires_grad
