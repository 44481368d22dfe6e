"""The port's decoding functions against the JAX package's (atol 1e-5, f32;
actions exact), and its sampling against the distribution it draws from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu import decoding as jdec
from rl4co_tpu_torch import decoding as tdec

from _torch_port import t2n

torch.set_num_threads(1)


def logits_and_mask(seed=0, b=6, a=12):
    rs = np.random.RandomState(seed)
    logits = (3.0 * rs.standard_normal((b, a))).astype(np.float32)
    mask = rs.random_sample((b, a)) < 0.7
    mask[:, 0] = True
    return logits, mask


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(tanh_clipping=10.0),
    dict(temperature=0.5),
    dict(top_k=3),
    dict(top_p=0.8),
    dict(tanh_clipping=10.0, temperature=1.7, top_k=5, top_p=0.6),
    dict(mask_logits=False, tanh_clipping=2.0),
], ids=lambda k: "-".join(k) or "default")
def test_process_logits_matches_jax(kwargs):
    logits, mask = logits_and_mask()
    ref = np.asarray(jdec.process_logits(jnp.asarray(logits), jnp.asarray(mask), **kwargs))
    out = t2n(tdec.process_logits(torch.from_numpy(logits), torch.from_numpy(mask), **kwargs))
    assert np.array_equal(np.isneginf(out), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("kind", ["greedy", "evaluate"])
def test_decode_action_matches_jax(kind):
    logits, mask = logits_and_mask(1)
    replay = np.argmax(mask, axis=-1)[::-1].copy() % logits.shape[1]
    jlp = jdec.process_logits(jnp.asarray(logits), jnp.asarray(mask))
    tlp = tdec.process_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    ja, jl = jdec.decode_action(jax.random.PRNGKey(0), jlp, jnp.asarray(mask),
                                jdec.DecodeSpec(kind=kind), jnp.asarray(replay))
    ta, tl = tdec.decode_action(tlp, torch.from_numpy(mask), tdec.DecodeSpec(kind=kind),
                                replay_action=torch.from_numpy(replay))
    np.testing.assert_array_equal(t2n(ta), np.asarray(ja))
    np.testing.assert_allclose(t2n(tl), np.asarray(jl), atol=1e-5)


def test_take_along_last_out_of_range_gives_zero():
    vals = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    idx = np.array([1, -1, 4])
    ref = np.asarray(jdec.take_along_last(jnp.asarray(vals), jnp.asarray(idx)))
    out = t2n(tdec.take_along_last(torch.from_numpy(vals), torch.from_numpy(idx)))
    np.testing.assert_array_equal(out, ref)
    assert out.tolist() == [2.0, 0.0, 0.0]


def test_get_log_likelihood_matches_jax():
    rs = np.random.RandomState(0)
    lp = rs.standard_normal((4, 7)).astype(np.float32)
    valid = rs.random_sample((4, 7)) < 0.5
    for vm in (None, valid):
        ref = jdec.get_log_likelihood(jnp.asarray(lp), None if vm is None else jnp.asarray(vm))
        out = tdec.get_log_likelihood(torch.from_numpy(lp),
                                      None if vm is None else torch.from_numpy(vm))
        np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=1e-6)


def test_sampling_draws_are_feasible_and_follow_the_distribution():
    logits, mask = logits_and_mask(2, b=1, a=8)
    lp = tdec.process_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    draws = 20000
    gen = torch.Generator().manual_seed(0)
    spec = tdec.DecodeSpec(kind="sampling")
    action, logprob = tdec.decode_action(
        lp.expand(draws, -1), torch.from_numpy(mask).expand(draws, -1), spec, gen)
    action = t2n(action)
    assert mask[0, action].all()
    np.testing.assert_allclose(t2n(logprob), t2n(lp)[0, action], atol=1e-6)
    p = np.exp(t2n(lp)[0])
    freq = np.bincount(action, minlength=8) / draws
    sigma = np.sqrt(p * (1 - p) / draws)
    assert (np.abs(freq - p) <= 3 * sigma + 1e-9).all(), (freq, p)


def test_sampling_is_reproducible_from_the_generator():
    logits, mask = logits_and_mask(3)
    lp = tdec.process_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    spec = tdec.DecodeSpec(kind="sampling")
    a1, _ = tdec.decode_action(lp, torch.from_numpy(mask), spec, torch.Generator().manual_seed(5))
    a2, _ = tdec.decode_action(lp, torch.from_numpy(mask), spec, torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(kind="nonsense"), ValueError),
    (dict(multistart=True, num_samples=4), ValueError),
    (dict(compute_dtype="int32"), ValueError),
])
def test_decode_spec_refuses(kwargs, exc):
    # compute_dtype="bfloat16", once refused, is taken now (below); a name
    # that is no floating dtype is refused
    with pytest.raises(exc):
        tdec.DecodeSpec(**kwargs)
    assert tdec.DecodeSpec(compute_dtype="bfloat16").compute_dtype == "bfloat16"


def test_decode_spec_keeps_the_jax_fields():
    jf = {f.name for f in jdec.DecodeSpec.__dataclass_fields__.values()}
    tf = {f.name for f in tdec.DecodeSpec.__dataclass_fields__.values()}
    assert jf == tf
