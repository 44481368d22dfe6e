"""The grouped pointer kernel's tensor-core arithmetic, as a numpy model.

`pointer_step_grouped_mma_kernel` (`rl4co_tpu_torch/csrc/pointer_kernel.cu`)
takes its four products (scores, weighted values, projection, logits) by
`mma.sync` m16n8k8 on TF32 operands with the 3xTF32 split: every f32 operand
x becomes hi = tf32(x) and lo = tf32(x - hi), rounded by `cvt.rna` (to
nearest, ties away from zero), and a product is a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi in f32 accumulators, k8 step by k8 step. The card runs that kernel
only; this model runs the same arithmetic in the kernel's order (per head,
scores over node tiles with an online softmax, the weights times V, then the
projection, then the logits), and is held against the JAX package's
`_reference_impl` at the kernels' tolerance, rtol 2e-4 / atol 2e-5. Node
tiles of 8 make the walk cross tiles at N 13 and 20. A head width that is
not a multiple of 8 (D 20, H 2) is the zero padding of the last k8 step.
One TF32 pass per product, the precision of a plain TF32 kernel, misses that
tolerance many times over: the split is what keeps the kernel in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rl4co_tpu.ops.pointer_kernel import _reference_impl

RTOL, ATOL = 2e-4, 2e-5
F32 = np.float32
MASK_VALUE = F32(-1e9)
TILE = 8

_reference = jax.jit(_reference_impl, static_argnums=(6, 7))


def tf32(x):
    """`cvt.rna.tf32.f32`: 10 mantissa bits kept, rounded to nearest with
    ties away from zero; the result is an f32 whose low 13 bits are zero."""
    bits = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(a, b, passes):
    """a [..., M, K] . b [..., K, N] as the kernel takes it: k8 steps into f32
    accumulators, each step a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3 passes) or
    a_hi.b_hi (1 pass); a ragged last step is the zero-padded one."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3 else [(a_hi, b_hi)]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], F32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = acc + np.matmul(x[..., k0:k0 + 8], y[..., k0:k0 + 8, :])
    assert acc.dtype == F32
    return acc


def kernel_model(q, k, v, lk, bias, w, num_heads, passes=3, tile=TILE):
    """q [B, L, D]; k, v, lk [B, N, D]; bias [B, L, N]; w [D, D] -> logits."""
    b, n, d = k.shape
    hd = d // num_heads
    scale = F32(1) / np.sqrt(F32(hd))
    glimpse = np.empty(q.shape, F32)
    for h in range(num_heads):
        cols = slice(h * hd, (h + 1) * hd)
        m = s_sum = o = None
        for n0 in range(0, n, tile):
            nodes = slice(n0, min(n, n0 + tile))
            s = mma(q[..., cols], k[:, nodes, cols].transpose(0, 2, 1), passes) * scale
            s = s + bias[..., nodes]
            m_new = s.max(-1) if m is None else np.maximum(m, s.max(-1))
            p = np.exp(s - m_new[..., None])
            part = mma(p, v[:, nodes, cols], passes)
            if m is None:  # the first tile: nothing to rescale
                s_sum, o = p.sum(-1), part
            else:
                alpha = np.exp(m - m_new)
                s_sum = s_sum * alpha + p.sum(-1)
                o = o * alpha[..., None] + part
            m = m_new
        glimpse[..., cols] = o / s_sum[..., None]
    proj = mma(glimpse, w, passes)
    oscale = F32(1) / np.sqrt(F32(d))
    return np.concatenate(
        [mma(proj, lk[:, n0:n0 + tile].transpose(0, 2, 1), passes) * oscale
         for n0 in range(0, n, tile)], axis=-1)


def make_inputs(b, l, n, d, mask_kind, seed):
    rs = np.random.RandomState(seed)

    def normal(*shape):
        return rs.standard_normal(shape).astype(F32)

    q = normal(b, l, d)
    k, v, lk = normal(b, n, d), normal(b, n, d), normal(b, n, d)
    w = normal(d, d) / F32(d ** 0.5)
    if mask_kind == "one_column":
        mask = np.arange(n) == rs.randint(0, n, size=(b, l))[..., None]
    else:
        mask = rs.random_sample((b, l, n)) < 0.7
        mask[..., 0] = True
        if mask_kind == "row_all_masked":
            mask[0] = False  # every query of instance 0 sees no feasible node
    bias = np.where(mask, F32(0), MASK_VALUE).astype(F32)
    return q, k, v, lk, bias, w


@functools.lru_cache(maxsize=None)
def case(b, l, n, d, h, mask_kind):
    args = make_inputs(b, l, n, d, mask_kind, seed=n + l + d)
    ref = np.asarray(_reference(*map(jnp.asarray, args), h, 0.0))
    return args, ref


def excess(out, ref):
    """Largest |out - ref| in units of the tolerance atol + rtol |ref|."""
    return float((np.abs(out - ref) / (ATOL + RTOL * np.abs(ref))).max())


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's spacing at 1
    x = np.array([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                  1 + 3 * 2 ** -11, 3.0e-39], F32)
    want = np.array([1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0e-39], F32)
    got = tf32(x)
    np.testing.assert_array_equal(got[:5], want[:5])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # the split keeps about 22 bits: hi + lo is x to 2^-21 relative
    r = np.random.RandomState(0).standard_normal(10_000).astype(F32)
    hi, lo = split(r)
    assert (np.abs(hi + lo - r) <= 2.0 ** -21 * np.abs(r)).all()


@pytest.mark.parametrize("mask_kind", ["random", "one_column", "row_all_masked"])
@pytest.mark.parametrize("l", [5, 50])
@pytest.mark.parametrize("n", [13, 20])
@pytest.mark.parametrize("d,h", [(128, 8), (256, 16), (20, 2)],
                         ids=["d128-h8", "d256-h16", "d20-h2-width10"])
def test_split_matches_reference(d, h, n, l, mask_kind):
    b = 4 if l == 5 else 2
    args, ref = case(b, l, n, d, h, mask_kind)
    out = kernel_model(*args, h)
    assert out.dtype == F32 and out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert excess(out, ref) < 0.25  # measured: at most a few percent of the tolerance


@pytest.mark.parametrize("d,h", [(128, 8), (256, 16)], ids=["d128-h8", "d256-h16"])
def test_one_tf32_pass_misses_the_tolerance(d, h):
    args, ref = case(2, 50, 20, d, h, "random")
    assert excess(kernel_model(*args, h, passes=3), ref) < 0.25
    one = excess(kernel_model(*args, h, passes=1), ref)
    assert one > 5, one  # measured 27-32 times the tolerance
