"""The yardstick's arithmetic: the chip's peaks, the pointer kernels' operations
and bytes, and the forward FLOPs of an Attention Model configuration.

Frozen here so that a change to the program cannot move it. The formulas
are those the port's `ops/pointer_kernel.py` states and `chip_smoke.py`'s
`bound_ms` uses, counted once: operations at one pass (not the 3xTF32 split
that K1 runs, which depends on the implementation) and every input and
output byte once.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense, at a power limit of 700 W
TF32_FLOPS = 495e12       # the tensor cores' rate on f32 inputs: the highest any f32 kernel reaches
HBM_BYTES_PER_S = 3.35e12


def pointer_step_ops(b: int, l: int, n: int, d: int) -> float:
    """Operations of one pointer decode step over ``b`` instances of ``n``
    nodes with ``l`` queries each at width ``d``: per query row the scores,
    the weighted values and the logits (``2·N·D`` each) and the output
    projection (``2·D²``)."""
    return float(b) * l * (6 * n * d + 2 * d * d)


def pointer_step_bytes(b: int, l: int, n: int, d: int) -> float:
    """f32 bytes in and out once: K, V and the logit keys ``[B, N, D]``, the
    queries ``[B, L, D]``, the mask bias and the logits ``[B, L, N]``, and
    ``W_out [D, D]``."""
    return 4.0 * (3 * b * n * d + b * l * d + 2 * b * l * n + d * d)


def pointer_step_least_s(b: int, l: int, n: int, d: int) -> float:
    """The least time the chip could take for one step: operations over the
    TF32 rate against bytes over the memory rate, the larger."""
    return max(pointer_step_ops(b, l, n, d) / TF32_FLOPS,
               pointer_step_bytes(b, l, n, d) / HBM_BYTES_PER_S)


def am_forward_flops(cfg: dict, instances: int, starts: int = 1) -> float:
    """Matrix-product FLOPs of one rollout of an Attention Model
    configuration over ``instances`` instances with ``starts`` trajectories
    each: the initial embedding, the encoder (q/k/v, scores, weighted values,
    output projection, FFN per layer), the decoder's projections and, at each
    of its steps and for every trajectory, the step context's projection and
    the pointer step. Normalisations, softmax and the env are not counted."""
    d, f, layers = cfg["embed_dim"], cfg["feedforward_hidden"], cfg["num_encoder_layers"]
    tsp = cfg["env"] == "tsp"
    n = cfg["num_loc"] + (0 if tsp else 1)
    steps = cfg["num_loc"] if tsp else 2 * cfg["num_loc"]
    b = float(instances)
    init = 2 * b * n * (2 if tsp else 3) * d
    per_layer = 2 * b * n * d * 3 * d + 4 * b * n * n * d + 2 * b * n * d * d + 4 * b * n * d * f
    pre = 2 * b * n * d * 3 * d + (2 * b * d * d if cfg["use_graph_context"] else 0)
    ctx_in = 2 * d if tsp else d + 1
    per_row = 2 * ctx_in * d + 6 * n * d + 2 * d * d
    decode = steps * b * starts * per_row
    return init + layers * per_layer + pre + decode
