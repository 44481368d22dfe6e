"""The port's pointer-step module against the JAX package's: the plain
version and the wrapper (which, on CPU tensors, computes the plain version)
against `_reference_impl` and against the Pallas kernel in interpret mode.
The CUDA kernels themselves run only on a card: `chip_smoke.py` holds them
against the same plain version there.

Tolerance: rtol 2e-4, atol 2e-5, f32 on both sides (the JAX tests' own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.ops.pointer_kernel import _reference_impl
from rl4co_tpu.ops.pointer_kernel import fused_pointer_logits as jax_fused
from rl4co_tpu_torch.ops.pointer_kernel import (
    LAUNCHES,
    MASK_VALUE,
    fused_pointer_logits,
    mask_to_neg_bias,
    pointer_logits_plain,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5

# (B, L, N, D, H, mask): L None = one query per instance. The first five are
# the shapes of tests/test_pointer_kernel.py.
CASES = [
    pytest.param(4, None, 10, 32, 4, 0.7, id="single-b4-n10-d32"),
    pytest.param(3, None, 8, 16, 2, 1.0, id="single-b3-n8-d16-nomask"),
    pytest.param(4, None, 500, 64, 4, 0.6, id="single-b4-n500-d64"),
    pytest.param(3, 5, 20, 32, 4, 0.6, id="grouped-b3-l5-n20-d32"),
    pytest.param(8, 16, 100, 128, 8, 0.7, id="grouped-b8-l16-n100-d128"),
    pytest.param(2, 37, 20, 32, 4, 0.7, id="grouped-ragged-l37"),
    pytest.param(4, None, 20, 32, 4, "one_column", id="single-one-feasible-column"),
    pytest.param(3, 6, 20, 32, 4, "one_column", id="grouped-one-feasible-column"),
]


def make_inputs(b, l, n, d, h, feasible, seed=0):
    rs = np.random.RandomState(seed)

    def normal(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    q = normal(b, d) if l is None else normal(b, l, d)
    k, v, lk = normal(b, n, d), normal(b, n, d), normal(b, n, d)
    w = normal(d, d) / np.float32(d ** 0.5)
    mshape = (b, n) if l is None else (b, l, n)
    if feasible == "one_column":
        mask = np.arange(n) == rs.randint(0, n, size=mshape[:-1])[..., None]
    else:
        mask = rs.random_sample(mshape) < feasible
        mask[..., 0] = True
    return q, k, v, lk, mask, w


def run_torch(fn, q, k, v, lk, mask, w, h):
    t = [torch.from_numpy(x) for x in (q, k, v, lk)]
    bias = mask_to_neg_bias(torch.from_numpy(mask))
    return fn(*t, bias, torch.from_numpy(w), h).numpy()


def jax_bias(mask):
    return jnp.where(jnp.asarray(mask), 0.0, MASK_VALUE).astype(jnp.float32)


@pytest.mark.parametrize("b,l,n,d,h,feasible", CASES)
def test_plain_matches_jax_reference(b, l, n, d, h, feasible):
    q, k, v, lk, mask, w = make_inputs(b, l, n, d, h, feasible)
    ref = _reference_impl(*map(jnp.asarray, (q, k, v, lk)), jax_bias(mask),
                          jnp.asarray(w), h, 0.0)
    out = run_torch(pointer_logits_plain, q, k, v, lk, mask, w, h)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,l,n,d,h,feasible", CASES)
def test_wrapper_matches_interpreted_pallas_kernel(b, l, n, d, h, feasible):
    q, k, v, lk, mask, w = make_inputs(b, l, n, d, h, feasible, seed=1)
    # on the CPU backend `fused_pointer_logits` runs the Pallas kernel in
    # interpret mode, as tests/test_pointer_kernel.py does
    ref = jax_fused(*map(jnp.asarray, (q, k, v, lk)), jax_bias(mask),
                    jnp.asarray(w), h, 0.0)
    before = dict(LAUNCHES)
    out = run_torch(fused_pointer_logits, q, k, v, lk, mask, w, h)
    assert LAUNCHES == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l", [None, 4])
def test_fully_masked_row_gives_finite_logits(l):
    q, k, v, lk, mask, w = make_inputs(3, l, 12, 32, 4, 0.7)
    mask[0] = False
    out = run_torch(fused_pointer_logits, q, k, v, lk, mask, w, 4)
    assert np.isfinite(out).all()


def test_mask_to_neg_bias_values():
    bias = mask_to_neg_bias(torch.tensor([[True, False]]))
    assert bias.dtype == torch.float32
    assert bias.tolist() == [[0.0, -1e9]]


@pytest.mark.parametrize("bad", ["heads", "q_shape", "bias_shape", "w_shape"])
def test_wrapper_refuses_wrong_shapes(bad):
    q, k, v, lk, mask, w = (torch.from_numpy(x) for x in make_inputs(2, None, 6, 16, 4, 0.7))
    bias, h = mask_to_neg_bias(mask), 4
    if bad == "heads":
        h = 3
    elif bad == "q_shape":
        q = q[:, :8]
    elif bad == "bias_shape":
        bias = bias[:, :5]
    else:
        w = w[:8]
    with pytest.raises(ValueError):
        fused_pointer_logits(q, k, v, lk, bias, w, h)
