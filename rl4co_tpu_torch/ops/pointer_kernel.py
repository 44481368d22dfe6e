"""Fused pointer decode step: the wrapper of `csrc/pointer_kernel.cu`.

What each CUDA kernel replaces in the JAX package
(`rl4co_tpu/ops/pointer_kernel.py`):

- ``pointer_step_single``  replaces ``_pallas_forward_single`` / ``_kernel_single``
  (one query per instance: greedy, dihedral augmentation);
- ``pointer_step_grouped`` replaces ``_pallas_forward`` / ``_kernel``
  (L queries share one instance's K/V: multistart, sampling).

Both compute, per instance and query, the masked multi-head glimpse over
K/V, its output projection and the logit-key scores, in f32, in one launch
per decode step. What was shaped by the TPU is gone: the head-indicator
matmuls, the padding of N to 128 lanes and of B/L to the block, the VMEM
budget loop and the node-count detour to the reference.

Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores). Bytes
moved once are ``4·(3·B·N·D + B·L·D + 2·B·L·N + D·D)`` and f32 operations
``B·L·(6·N·D + 2·D·D)`` (L = 1 for the single kernel). The single kernel
does 2 operations per byte and is bound by bytes; the grouped kernel reuses
K/V/LK across L queries and at L = 50 is bound by operations. Both walk the
nodes in tiles (32 nodes in the single kernel, 64 in the grouped one) with
an online softmax (a running max and sum per row, earlier tiles rescaled),
so shared memory does not grow with N and any N runs. The single kernel
runs persistent blocks, one per SM at D 128, of four groups of 128
threads, each group walking its own instances: `W_out` is staged once per
block in shared memory, and K, V and LK stream through each group's ring of
node tiles filled by asynchronous copies that run ahead across instance
boundaries. The grouped kernel stages each tile of K, then V, then LK
through one shared memory buffer per block of 16 queries, three blocks per
SM. Measured, its arithmetic phases bind it, not the staging, so each of
its 256 threads holds a register tile: 8 queries x 4 nodes of one head in
the scores, 8 queries in the glimpse and the projection, 4 queries x 2
nodes in the logits; sub-tiles of queries wholly past the last query are
skipped. Its inner loops walk the reduction axis four floats (one 16-byte
load from shared memory) at a time wherever every head starts on a 16-byte
boundary. Scores, weights, glimpse and projection never reach device
memory. Measured times stand in PERF.md; `ops/kernel_variants.py` times
patched copies of either kernel beside it.

On a CPU tensor the wrapper computes the plain version. On a CUDA tensor it
launches the kernel or raises; nothing falls back.

Gradient. The launch sits inside a `torch.autograd.Function`
(`_PointerLogits`), the counterpart of the `jax.custom_vjp` at
`rl4co_tpu/ops/pointer_kernel.py:326-368`. Its backward mirrors `_bwd`
(`:349-365`), which is no Pallas kernel either: it recomputes the plain
version on the detached saved inputs under `torch.enable_grad()` and takes
that graph's gradients of ``q``, ``k``, ``v``, ``lk`` and ``w_out``
(``neg_bias`` and ``num_heads`` get none). The backward is therefore not a
kernel, on the card as on the CPU, so nothing in it can fall back; CPU and
CUDA tensors go through the same `Function`, and the forward alone differs
(plain version against kernel). The inputs are saved by reference: ``k``,
``v`` and ``lk`` are the same three tensors at every decode step of a
rollout. For a 3-D ``q`` the gradients of ``k``, ``v`` and ``lk`` sum over
the L queries inside the recompute.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

MASK_VALUE = -1e9

# launches made by the wrapper, per kernel (plain integers; reset by the caller)
LAUNCHES = {"pointer_step_single": 0, "pointer_step_grouped": 0}

_MAX_SMEM: dict[int, int] = {}  # device index -> shared memory a block may ask for


def mask_to_neg_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool mask (True = feasible) -> additive f32 bias (0 / -1e9)."""
    return torch.where(mask, 0.0, MASK_VALUE).to(torch.float32)


def pointer_logits_plain(q, k, v, lk, neg_bias, w_out, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernels (counterpart of ``_reference_impl``).

    q: [B, L, D] (or [B, D]); k, v, lk: [B, N, D]; neg_bias: [B, L, N] (or
    [B, N]) additive; w_out: [D, D] used as ``x @ w_out``. Returns raw f32
    logits [B, L, N] (or [B, N]); output masking and tanh clipping stay in
    `process_logits`.
    """
    if q.ndim == 2:
        return pointer_logits_plain(
            q[:, None, :], k, v, lk, neg_bias[:, None, :], w_out, num_heads
        )[:, 0, :]
    b, n, d = k.shape
    hd = d // num_heads

    def split(x):
        return x.reshape(b, -1, num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)              # [B, H, ·, hd]
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / (hd ** 0.5)
    scores = scores + neg_bias[:, None, :, :].to(scores.dtype)
    attn = torch.softmax(scores, dim=-1)
    heads = torch.matmul(attn, vh)                         # [B, H, L, hd]
    glimpse = heads.transpose(1, 2).reshape(b, -1, d) @ w_out
    return torch.matmul(glimpse, lk.transpose(-1, -2)) / (d ** 0.5)


def _check_shapes(q, k, v, lk, neg_bias, w_out, num_heads):
    if q.ndim not in (2, 3):
        raise ValueError(f"q must be [B, D] or [B, L, D], got {tuple(q.shape)}")
    if k.ndim != 3:
        raise ValueError(f"k must be [B, N, D], got {tuple(k.shape)}")
    b, n, d = k.shape
    l = 1 if q.ndim == 2 else q.shape[1]
    want_q = (b, d) if q.ndim == 2 else (b, l, d)
    want_bias = (b, n) if q.ndim == 2 else (b, l, n)
    for name, t, want in (("q", q, want_q), ("v", v, (b, n, d)), ("lk", lk, (b, n, d)),
                          ("neg_bias", neg_bias, want_bias), ("w_out", w_out, (d, d))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    return b, l, n, d


def fused_pointer_logits(q, k, v, lk, neg_bias, w_out, num_heads: int) -> torch.Tensor:
    """Fused decode-step logits, differentiable in q, k, v, lk and w_out.

    Args:
        q: [B, D] single query or [B, L, D] grouped queries (already
            context-projected, graph context added).
        k, v, lk: [B, N, D] glimpse key/value and logit key caches.
        neg_bias: [B, N] / [B, L, N] additive mask bias (0 feasible / -1e9).
        w_out: [D, D] pointer output projection (no bias).
    Returns: [B, N] / [B, L, N] float32 raw logits.

    CUDA tensors: checks device, type, shape and contiguity, launches
    ``pointer_step_single`` (2-D q) or ``pointer_step_grouped`` (3-D q) on the
    current stream and raises on anything the kernel does not take or on a
    refused launch. CPU tensors: the plain version. Either way the call is
    recorded for autograd when an input requires a gradient; the backward is
    the recompute described in the module's docstring.
    """
    tensors = {"q": q, "k": k, "v": v, "lk": lk, "neg_bias": neg_bias, "w_out": w_out}
    b, l, n, d = _check_shapes(q, k, v, lk, neg_bias, w_out, num_heads)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_pointer_logits runs on cuda or cpu, not {q.device}")
    if q.device.type == "cuda":
        for name, t in tensors.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name} is {t.dtype}: the kernel takes float32 only")
            if not t.is_contiguous():
                raise ValueError(f"{name} {tuple(t.shape)} is not contiguous "
                                 f"(strides {t.stride()})")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
        if b < 1 or l < 1 or n < 1:
            raise ValueError(f"empty problem: B={b}, L={l}, N={n}")
    return _PointerLogits.apply(q, k, v, lk, neg_bias, w_out, num_heads)


class _PointerLogits(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or the plain version (CPU tensors).
    Backward: gradients of the recomputed plain version, as `_bwd` of the JAX
    package does it."""

    @staticmethod
    def forward(ctx, q, k, v, lk, neg_bias, w_out, num_heads):
        ctx.save_for_backward(q, k, v, lk, neg_bias, w_out)  # references, no copies
        ctx.num_heads = num_heads
        if q.device.type == "cpu":
            return pointer_logits_plain(q, k, v, lk, neg_bias, w_out, num_heads)
        return _launch(q, k, v, lk, neg_bias, w_out, num_heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, lk, neg_bias, w_out = ctx.saved_tensors
        # q, k, v, lk, w_out: positions 0-3 and 5 of forward's arguments
        needs = [ctx.needs_input_grad[i] for i in (0, 1, 2, 3, 5)]
        if not any(needs):  # only neg_bias asked for a gradient, and it gets none
            return (None,) * 7
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v, lk, w_out), needs)]
        with torch.enable_grad():
            out = pointer_logits_plain(*leaves[:4], neg_bias, leaves[4], ctx.num_heads)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
        dq, dk, dv, dlk, dw = (next(grads) if need else None for need in needs)
        return dq, dk, dv, dlk, None, dw, None


def _launch(q, k, v, lk, neg_bias, w_out, num_heads: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors; raises on a refused launch."""
    b, n, d = k.shape
    single = q.ndim == 2
    l = 1 if single else q.shape[1]

    from rl4co_tpu_torch.ops._build import load_library

    lib = load_library("pointer_kernel")
    name = "pointer_step_single" if single else "pointer_step_grouped"
    with torch.cuda.device(q.device):
        # past one node tile the need depends on D and H only
        need = getattr(lib, name + "_smem_bytes")(n, d, num_heads)
        have = _MAX_SMEM.get(q.device.index)
        if have is None:
            have = _MAX_SMEM[q.device.index] = lib.pointer_kernel_max_smem_bytes()
        if need > have:
            raise ValueError(
                f"{name}: N={n}, D={d}, H={num_heads} needs {need} bytes of shared "
                f"memory per block, the device allows {have}"
            )
        if not single and (l + 15) // 16 > 65535:
            raise ValueError(f"{name}: L={l} exceeds the grid's 65535 tiles of 16")
        out = torch.empty(
            (b, n) if single else (b, l, n), dtype=torch.float32, device=q.device
        )
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lk.data_ptr(),
            neg_bias.data_ptr(), w_out.data_ptr(), out.data_ptr(),
            b, l, n, d, num_heads, stream,
        )
        if err != 0:
            msg = lib.pointer_kernel_error_string(err).decode()
            raise RuntimeError(
                f"{name} launch failed with CUDA error {err} ({msg}) at "
                f"B={b}, L={l}, N={n}, D={d}, H={num_heads}"
            )
    LAUNCHES[name] += 1
    return out
