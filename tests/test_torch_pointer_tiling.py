"""The node-tiled walk of the port's CUDA pointer kernels, as a numpy model.

Both kernels of `rl4co_tpu_torch/csrc/pointer_kernel.cu` walk the nodes in
tiles: per tile the scores, a running max and a running sum per (query,
head), the earlier tiles' glimpse rescaled by exp(m_old - m_new), the tile's
weighted values added; after the last tile the glimpse is divided by the
running sum, projected, and the logits are taken tile by tile. The kernels
run only on a card; this model runs the same steps in the same order, in
f32, and is held against the JAX package's `_reference_impl` and against
the port's `pointer_logits_plain`.

Tolerance: rtol 2e-4, atol 2e-5, f32 on all sides (the kernels' own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.ops.pointer_kernel import _reference_impl
from rl4co_tpu_torch.ops.pointer_kernel import (
    MASK_VALUE,
    mask_to_neg_bias,
    pointer_logits_plain,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
F32 = np.float32

# one compilation per shape instead of one per operation and shape
_reference = jax.jit(_reference_impl, static_argnums=(6, 7))


def tiled_pointer_logits(q, k, v, lk, bias, w, num_heads, tile):
    """The kernels' walk over node tiles of ``tile`` nodes (numpy, f32).

    q: [B, D] or [B, L, D]; k, v, lk: [B, N, D]; bias: [B, N] or [B, L, N]
    (0 / -1e9); w: [D, D]. Returns raw logits [B, N] or [B, L, N]."""
    single = q.ndim == 2
    if single:
        q, bias = q[:, None], bias[:, None]
    b, n, d = k.shape
    h = num_heads
    hd = d // h
    qh = q.reshape(b, -1, h, hd)
    scale = F32(1) / np.sqrt(F32(hd))
    m = s_sum = acc = None
    for n0 in range(0, n, tile):
        first = n0 == 0
        nt = min(tile, n - n0)
        kt = k[:, n0:n0 + nt].reshape(b, nt, h, hd)
        s = np.einsum("blhe,bnhe->blhn", qh, kt) * scale + bias[:, :, None, n0:n0 + nt]
        m_new = s.max(-1) if first else np.maximum(m, s.max(-1))
        p = np.exp(s - m_new[..., None])
        vt = v[:, n0:n0 + nt].reshape(b, nt, h, hd)
        part = np.einsum("blhn,bnhe->blhe", p, vt)
        if first:  # nothing to rescale: no exp(-inf - (-inf)) is taken
            s_sum, acc = p.sum(-1), part
        else:
            alpha = np.exp(m - m_new)
            s_sum = s_sum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + part
        m = m_new
        assert s.dtype == p.dtype == acc.dtype == F32
    glimpse = (acc / s_sum[..., None]).reshape(b, -1, d)
    proj = glimpse @ w
    oscale = F32(1) / np.sqrt(F32(d))
    logits = np.concatenate(
        [np.einsum("bld,bnd->bln", proj, lk[:, n0:n0 + tile]) * oscale
         for n0 in range(0, n, tile)], axis=-1)
    return logits[:, 0] if single else logits


@functools.lru_cache(maxsize=None)
def inputs_and_reference(b, l, n, d, h, mask_kind, seed):
    """The inputs of one case and `_reference_impl`'s logits on them (shared
    by both tile widths)."""
    q, k, v, lk, mask, bias, w = make_inputs(b, l, n, d, mask_kind, seed)
    ref = np.asarray(_reference(*map(jnp.asarray, (q, k, v, lk, bias, w)), h, 0.0))
    return (q, k, v, lk, mask, bias, w), ref


def make_inputs(b, l, n, d, mask_kind, seed):
    rs = np.random.RandomState(seed)

    def normal(*shape):
        return rs.standard_normal(shape).astype(F32)

    q = normal(b, d) if l is None else normal(b, l, d)
    k, v, lk = normal(b, n, d), normal(b, n, d), normal(b, n, d)
    w = normal(d, d) / F32(d ** 0.5)
    mshape = (b, n) if l is None else (b, l, n)
    mask = rs.random_sample(mshape) < 0.6
    if mask_kind == "leading_tiles":
        # the first tiles wholly masked: past two tiles of 64 where N allows
        mask[..., :min(n - 1, 150)] = False
        mask[..., -1] = True
    else:
        mask[..., 0] = True
        if mask_kind == "row_all_masked":
            mask[0] = False  # every query of instance 0 sees no feasible node
    bias = np.where(mask, F32(0), F32(MASK_VALUE)).astype(F32)
    return q, k, v, lk, mask, bias, w


@pytest.mark.parametrize("mask_kind", ["random", "leading_tiles", "row_all_masked"])
@pytest.mark.parametrize("d,h", [(32, 4), (20, 2)], ids=["d32-h4", "d20-h2-width10"])
@pytest.mark.parametrize("l", [None, 5], ids=["single", "grouped-l5"])
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("n", [1, 13, 63, 64, 65, 500])
def test_tiled_walk_matches_reference(n, tile, l, d, h, mask_kind):
    b = 2 if n == 500 else 4
    (q, k, v, lk, mask, bias, w), ref = inputs_and_reference(b, l, n, d, h, mask_kind, n + d)
    out = tiled_pointer_logits(q, k, v, lk, bias, w, h, tile)
    assert out.dtype == F32 and np.isfinite(out).all()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    t = [torch.from_numpy(x) for x in (q, k, v, lk)]
    plain = pointer_logits_plain(*t, mask_to_neg_bias(torch.from_numpy(mask)),
                                 torch.from_numpy(w), h).numpy()
    np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)
