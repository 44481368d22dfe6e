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


def test_categorical_draw_is_the_inverse_cdf_at_one_uniform_per_row():
    """The sampler draws one uniform per row from the generator and takes the
    first action whose cumulative probability passes it: never an action of
    probability 0, and the distribution's frequencies over many rows."""
    p = torch.tensor([0.1, 0.0, 0.25, 0.05, 0.6])
    rows = 40000
    lp = p.log().expand(rows, -1)
    action = tdec.categorical_draw(lp, torch.Generator().manual_seed(3))
    u = torch.rand(rows, generator=torch.Generator().manual_seed(3))
    cdf = p.cumsum(0)
    want = (u[:, None] * cdf[-1] >= cdf).sum(dim=1)
    assert torch.equal(action, want)
    freq = np.bincount(t2n(action), minlength=5) / rows
    sigma = np.sqrt(t2n(p) * (1 - t2n(p)) / rows)
    assert freq[1] == 0
    assert (np.abs(freq - t2n(p)) <= 4 * sigma + 1e-9).all(), (freq, p)


@pytest.mark.parametrize("rank", [0, 1])
def test_categorical_draw_in_a_shard_keeps_the_ranks_rows_of_the_global_draw(rank):
    """On a rank's share of a global batch (two repeat-major blocks of its 3
    instances, of 2 ranks' 6), the draws are that rank's rows of the draws
    that one process makes for the whole batch from the same generator."""
    from rl4co_tpu_torch.parallel.mesh import Mesh, sharded

    b, world, repeats = 3, 2, 2
    logits, _ = logits_and_mask(4, b=repeats * b * world, a=7)
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    whole = tdec.categorical_draw(lp, torch.Generator().manual_seed(9))
    mine = lp.view(repeats, world, b, -1)[:, rank].reshape(repeats * b, -1)
    with sharded(Mesh(rank=rank, world=world), b):
        got = tdec.categorical_draw(mine, torch.Generator().manual_seed(9))
    assert torch.equal(got, whole.view(repeats, world, b)[:, rank].reshape(-1))


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


def test_tanh_clipping_is_jax_tanh_to_the_bit():
    """The port's tanh clipping computes XLA's f32 tanh: equal to `jnp.tanh`
    bit for bit on 2 million f32 spread over [-9.5, 9.5] and on every f32
    from 5 to 8.5 (where clipped logits sit within a few ulps of the clip);
    exactly +-1 from 7.99881172 on, where torch's tanh resolves logits to
    9.01, so that two saturated logits tie and greedy takes the lower index
    in both packages (SDVRP-50's golden dispatches turned on this); the
    gradient is JAX's ``(g + g·y)(1 - y)`` to 1 ulp (XLA fuses a multiply-add
    there), 0 past the clamp."""
    rs = np.random.RandomState(0)
    spread = rs.uniform(-9.5, 9.5, 2_000_000).astype(np.float32)
    window = np.arange(np.float32(5.0).view(np.int32), np.float32(8.5).view(np.int32),
                       dtype=np.int32).view(np.float32)
    xs = np.concatenate([spread, window, -window, np.float32([0.0, 3e-4, -5e-4])])
    want = np.asarray(jnp.tanh(jnp.asarray(xs)))
    got = t2n(tdec.xla_tanh(torch.from_numpy(xs)))
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[np.abs(xs) >= tdec.XLA_TANH_CLAMP]) == 1.0).all()
    logits = np.array([[-14.879343, -8.567986, -20.0]], np.float32)
    mask = np.ones_like(logits, dtype=bool)
    spec = dict(kind="greedy")
    ja, _ = jdec.decode_action(jax.random.PRNGKey(0), jdec.process_logits(
        jnp.asarray(logits), jnp.asarray(mask), tanh_clipping=10.0), jnp.asarray(mask),
        jdec.DecodeSpec(**spec), None)
    ta, _ = tdec.decode_action(tdec.process_logits(torch.from_numpy(logits),
                                                   torch.from_numpy(mask), tanh_clipping=10.0),
                               torch.from_numpy(mask), tdec.DecodeSpec(**spec))
    assert int(ta[0]) == int(ja[0]) == 0
    v = np.float32([-9.0, 8.5, 1.0, -0.3, 6.5])
    x = torch.tensor(v, requires_grad=True)
    grad = jax.grad(lambda a: (jnp.tanh(a) * jnp.arange(1.0, 6.0)).sum())(jnp.asarray(v))
    (tdec.xla_tanh(x) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_allclose(t2n(x.grad), np.asarray(grad), rtol=1e-6, atol=0)  # 1 ulp: XLA fuses
