"""The gradient of the port's `fused_pointer_logits` (a `torch.autograd.Function`
whose backward recomputes the plain version) against the JAX package's
`custom_vjp`: `jax.grad` of `fused_pointer_logits` (on the CPU the interpreted
Pallas forward plus `_bwd`) and of `_reference_impl`. Shapes are those of
`tests/test_pointer_kernel.py::test_kernel_gradients_flow` (2-D q) and
`::test_kernel_grouped_multistart_queries` (3-D q), with a masked single case
beside them.

Tolerance: rtol 2e-4, atol 2e-5, f32 on both sides (the JAX tests' own).
On the CPU the `Function`'s forward is the plain version; the CUDA kernels
under autograd are held against it on the card by `chip_smoke.py`.
"""

import jax
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
NAMES = ("q", "k", "v", "lk", "w_out")

# (B, L, N, D, H, share of feasible columns)
CASES = [
    pytest.param(3, None, 8, 16, 2, 1.0, id="single-b3-n8-d16-nomask"),
    pytest.param(4, None, 10, 32, 4, 0.6, id="single-b4-n10-d32-masked"),
    pytest.param(3, 5, 20, 32, 4, 0.6, id="grouped-b3-l5-n20-d32"),
]


def make_inputs(b, l, n, d, h, feasible, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)

    def normal(*shape):
        return rs.standard_normal(shape).astype(dtype)

    q = normal(b, d) if l is None else normal(b, l, d)
    k, v, lk = normal(b, n, d), normal(b, n, d), normal(b, n, d)
    w = (normal(d, d) / d ** 0.5).astype(dtype)
    mshape = (b, n) if l is None else (b, l, n)
    mask = rs.random_sample(mshape) < feasible
    mask[..., 0] = True
    cot = normal(*mshape)  # the cotangent of the logits
    return (q, k, v, lk, w), mask, cot


def torch_grads(fn, arrays, mask, cot, h):
    q, k, v, lk, w = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    bias = mask_to_neg_bias(torch.from_numpy(mask)).to(q.dtype).requires_grad_(True)
    out = fn(q, k, v, lk, bias, w, h)
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in (q, k, v, lk, w)], bias.grad


def jax_grads(fn, arrays, mask, cot, h):
    bias = jnp.where(jnp.asarray(mask), 0.0, MASK_VALUE).astype(jnp.float32)

    def f(q, k, v, lk, w):
        return (fn(q, k, v, lk, bias, w, h, 0.0) * jnp.asarray(cot)).sum()

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))


@pytest.mark.parametrize("jax_fn", [jax_fused, _reference_impl],
                         ids=["custom-vjp-interpreted-pallas", "reference-impl"])
@pytest.mark.parametrize("b,l,n,d,h,feasible", CASES)
def test_function_gradients_match_jax(b, l, n, d, h, feasible, jax_fn):
    arrays, mask, cot = make_inputs(b, l, n, d, h, feasible)
    before = dict(LAUNCHES)
    got, bias_grad = torch_grads(fused_pointer_logits, arrays, mask, cot, h)
    assert LAUNCHES == before  # CPU tensors launch nothing, forward or backward
    assert bias_grad is None   # neg_bias gets no gradient
    want = jax_grads(jax_fn, arrays, mask, cot, h)
    for name, g, a, gj in zip(NAMES, got, arrays, want):
        assert g.shape == a.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, np.asarray(gj), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("b,l,n,d,h,feasible", CASES)
def test_function_gradients_match_plain_autograd(b, l, n, d, h, feasible):
    """The backward is the plain version's own graph: equal to the last bits
    of a different summation order (atol 1e-6)."""
    arrays, mask, cot = make_inputs(b, l, n, d, h, feasible, seed=1)
    got, _ = torch_grads(fused_pointer_logits, arrays, mask, cot, h)
    want, _ = torch_grads(pointer_logits_plain, arrays, mask, cot, h)
    for name, g, gw in zip(NAMES, got, want):
        np.testing.assert_allclose(g, gw, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("l", [None, 3], ids=["single", "grouped"])
def test_gradcheck_in_f64(l):
    arrays, mask, _ = make_inputs(2, l, 5, 8, 2, 0.7, seed=2, dtype=np.float64)
    q, k, v, lk, w = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    bias = mask_to_neg_bias(torch.from_numpy(mask)).double()
    assert torch.autograd.gradcheck(
        lambda q, k, v, lk, w: fused_pointer_logits(q, k, v, lk, bias, w, 2),
        (q, k, v, lk, w), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_only_the_inputs_that_need_it_get_a_gradient():
    arrays, mask, cot = make_inputs(2, None, 6, 16, 4, 0.7, seed=3)
    q, k, v, lk, w = (torch.from_numpy(a) for a in arrays)
    q.requires_grad_(True)
    w.requires_grad_(True)
    bias = mask_to_neg_bias(torch.from_numpy(mask))
    out = fused_pointer_logits(q, k, v, lk, bias, w, 4)
    assert out.requires_grad
    (out * torch.from_numpy(cot)).sum().backward()
    assert q.grad is not None and w.grad is not None
    assert k.grad is None and v.grad is None and lk.grad is None
    want, _ = torch_grads(pointer_logits_plain, arrays, mask, cot, 4)
    np.testing.assert_allclose(q.grad.numpy(), want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), want[4], rtol=1e-6, atol=1e-6)


def test_a_bias_that_alone_requires_a_gradient_gets_none():
    """As the JAX vjp, which hands back `None` for the bias without error."""
    arrays, mask, cot = make_inputs(2, None, 6, 16, 4, 0.7, seed=6)
    q, k, v, lk, w = (torch.from_numpy(a) for a in arrays)
    bias = mask_to_neg_bias(torch.from_numpy(mask)).requires_grad_(True)
    out = fused_pointer_logits(q, k, v, lk, bias, w, 4)
    (out * torch.from_numpy(cot)).sum().backward()
    assert bias.grad is None
    assert all(t.grad is None for t in (q, k, v, lk, w))


def test_no_graph_without_a_gradient_or_under_no_grad():
    arrays, mask, _ = make_inputs(2, None, 6, 16, 4, 0.7, seed=4)
    q, k, v, lk, w = (torch.from_numpy(a) for a in arrays)
    bias = mask_to_neg_bias(torch.from_numpy(mask))
    assert not fused_pointer_logits(q, k, v, lk, bias, w, 4).requires_grad
    q.requires_grad_(True)
    with torch.no_grad():
        assert not fused_pointer_logits(q, k, v, lk, bias, w, 4).requires_grad


def test_saved_inputs_are_references_not_copies():
    """k, v and lk are the same three tensors at every decode step: the
    `Function` must not copy them per step."""
    arrays, mask, _ = make_inputs(2, None, 6, 16, 4, 0.7, seed=5)
    q, k, v, lk, w = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    bias = mask_to_neg_bias(torch.from_numpy(mask))
    out = fused_pointer_logits(q, k, v, lk, bias, w, 4)
    saved = out.grad_fn.saved_tensors
    for t, s in zip((q, k, v, lk, bias, w), saved):
        assert s.data_ptr() == t.data_ptr()
