#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, drives the port's two main paths at
full width (the Attention Model evaluated on TSP-50 through `evaluate_policy`
with and without the kernels; the same model trained with REINFORCE and the
greedy rollout baseline through `Trainer.fit`, gradients flowing through the
kernels' `autograd.Function`), drives `multistart_greedy` on TSP-500 through
the grouped kernel past its former N limit, and replays the JAX package's
golden greedy tours. It then runs the three trained checkpoints committed
under `runs/` (exported to `rl4co_tpu_torch/golden/*_params.npz`) over the
whole canonical test sets, AM on TSP-50, POMO on CVRP-50 and AM-XL on
TSP-100, held to the JAX package's per-instance costs (`*_costs.npz`), runs
beam search with the AM checkpoint through the grouped kernel (held to the
JAX package's beam costs), and trains POMO on CVRP-50 at full width through
the grouped kernel. Then the rest of the AM family: one bf16 train step of AM
(kernel path against plain path), SymNCO on TSP-50 through the grouped
kernel, and MVMoE on CVRP-50 and PolyNet on TSP-50, whose pointer heads
reach no kernel. Then the mixed OP + PCTSP configuration: the JAX package's
full-width multi-env weights held to its greedy rewards on OP-20 and
PCTSP-20, the configuration trained through the train command line
(`rl4co_tpu_torch.train.main`), PtrNet trained through it, and the eval
command line on the AM checkpoint and on OP-20 multistart. Then
BASELINE.json's NAR configuration, which reaches no pointer kernel: DeepACO's
JAX-initialised weights on TSP-500, greedy and the Ant System with the host
local search, held to the JAX package's costs; DeepACO's loss and every
gradient on the JAX package's replayed tours; DeepACO and GFACS trained
through the train command line. Then the multi-task VRP family at N 50: AM
with seeded weights on CVRPTW, SDVRP (its dynamic embedding: the cache tiled
per start, new K/V at every step), PDP, mTSP and SHPP, and POMO on MTVRP's
mixed 16 variants, held to the JAX package's CPU costs of the same weights
and instances; POMO's and AM-on-SDVRP's loss and every gradient on the JAX
package's replayed actions; MVMoE-POMO on MTVRP and AM on SDVRP trained
through the train command line. Then AM on the rest of the routing envs
(CVRPMVC, SVRP, mPDP, MDCPDP) held to the JAX package's CPU costs, and GLOP
on TSP-1000 (`runs/glop_tsp1000.py`'s recipe: cheapest insertion, then 24
rounds of segment revision by insertion and by an AM reviser on SHPP-25 that
decodes 1 280 segments per dispatch through the single-query kernel), the
JAX package's draws replayed and its CPU costs held. Then PPO and A2C with
their critic on TSP-50: the JAX package's PPO step replayed at full width
(its instances, sampled actions and minibatch blocks; the single-query kernel
50 times at B 512 and 400 times at B 128 under autograd), its A2C loss and
gradients likewise, both trained through the train command line; and AM
greedy on SMTWTP, DPP, MDPP, FLP and MCP held to the JAX package's CPU
costs. Then the transductive search and the improvement trio. Then the rest of
the zoo: MatNet at its published widths on ATSP-50 (the grouped kernel at D
256 with 16 heads: multistart greedy held to the JAX CPU costs, the POMO loss
and its gradients on JAX's sampled actions, the train command line), MDAM's
five paths on TSP-50 and HAM on PDP-50 through the single-query kernel (held
likewise, MDAM with Embedding-Glimpse and its KL loss), MatNet on FFSP20 and
L2D on FJSP and JSSP (makespans equal to the JAX package's) with one JAX
stepwise-PPO step replayed and `--model l2d-ppo` trained. Last the
infrastructure: AM trained on TSP-50 through the train CLI by two `--distributed`
ranks on the one card (gloo), held to the one-process run of the same command,
with TensorBoard, MLflow and a profile; the same training by four processes
as a (dp 2, model 2) mesh, the policy split over the model axis
(`shard_params_model_axis`: Megatron pairs, gathered column splits, the pointer
kernel on whole tensors on every process), held to that one-process run;
MVMoE-POMO's experts split over two processes, held to `train_mvmoe`'s run;
`evaluate_policy`'s dispatch sizing under a real CUDA out-of-memory error;
Reptile over POMO on TSP-20/50/100 through the grouped kernel at L = N, every
outer update recomputed; and remat and the fused rollout baseline on the AM
checkpoint. Then the port's 13
examples (`rl4co_tpu_torch/examples/`) at their default sizes, each held to
the pointer kernels its path launches. Every phase prints one
JSON line; any failure is a traceback and a non-zero exit. Without a card it
exits non-zero and prints no result. `check_kernels` and `time_kernels` also run alone, from a short
script, while a kernel is being worked on.

Weights are random, made from a seed, except the checkpoints' and the
multi-env and DeepACO golden files'; evaluation instances are the committed
`data/tsp/test50_seed1234.npz`, `data/tsp/test100_seed1234.npz` and
`data/cvrp/test50_seed1234.npz`, the golden OP/PCTSP, TSP-500 and
routing instances, and GLOP's TSP-1000 instances from a numpy seed; other
TSP-500 and OP instances and training batches are generated on the card. The local search is host C++, built with g++ like the kernels.
Needs numpy, torch, nvcc, g++ and nvidia-smi; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 2e-4, 2e-5          # kernel vs plain version, f32 on both sides
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS = 67e12                # H100 SXM f32 rate outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM dense TF32 rate of the tensor cores
KERNEL_SOURCE = "rl4co_tpu_torch/csrc/pointer_kernel.cu"
REPLACES = {
    "pointer_step_single": "rl4co_tpu/ops/pointer_kernel.py:219",
    "pointer_step_grouped": "rl4co_tpu/ops/pointer_kernel.py:277",
}
REPLACES_BODY = {
    "pointer_step_single": "rl4co_tpu/ops/pointer_kernel.py::_kernel_single",
    "pointer_step_grouped": "rl4co_tpu/ops/pointer_kernel.py::_kernel",
}
# the main path's shapes: (B, L, N, D, H); L = None is the single-query kernel
MAIN_SHAPES = {
    "pointer_step_single": (1024, None, 50, 128, 8),
    "pointer_step_grouped": (256, 50, 50, 128, 8),
}
# (B, L, N, D, H, share of feasible columns or a mask kind)
CASES = [
    (1024, None, 50, 128, 8, 0.7),
    (4, None, 10, 32, 4, 0.7),
    (4, None, 500, 64, 4, 0.6),
    (256, None, 100, 128, 8, 0.7),
    (256, None, 20, 128, 8, 0.65),
    (64, None, 50, 128, 8, "one_column"),
    (8, None, 50, 128, 8, "one_row_all_masked"),
    (5, None, 13, 20, 2, 0.7),          # head width 10: the scalar load path
    (256, 50, 50, 128, 8, 0.7),
    (3, 5, 20, 32, 4, 0.6),
    (32, 16, 100, 128, 8, 0.7),
    (32, 20, 20, 128, 8, 0.65),
    (16, 37, 50, 128, 8, 0.7),          # ragged last tile of queries
    (64, 100, 50, 128, 8, 0.7),         # the sampling path: 100 samples as queries
    (16, 50, 50, 128, 8, "one_column"),
    (4, 9, 50, 128, 8, "one_row_all_masked"),
    (3, 5, 13, 20, 2, 0.7),             # D below a warp, odd N
    (512, None, 50, 128, 8, 0.7),       # a train step's two rollouts on TSP-50
    (512, None, 20, 128, 8, 0.65),      # ... and on TSP-20
    (64, 50, 50, 128, 8, 0.7),          # a multistart train step
    # node tiles: past one tile of 64 nodes, past the grouped kernel's old
    # N <= 207 limit, and long instances
    (8, 16, 208, 128, 8, 0.7),
    (4, 5, 500, 64, 4, 0.6),            # tests/test_pointer_kernel.py::test_kernel_large_n_ragged_padding
    (4, 20, 1000, 128, 8, 0.7),
    (2, 20, 2048, 128, 8, 0.7),
    (4, 20, 300, 128, 8, "leading_tiles_masked"),
    (3, 7, 300, 20, 2, "one_row_all_masked"),
    (4, None, 2048, 128, 8, 0.7),
    (4, None, 4096, 128, 8, 0.7),
    (4, None, 300, 128, 8, "leading_tiles_masked"),
    (1, None, 50, 128, 8, 0.7),         # one instance: one block
    (4096, None, 50, 128, 8, 0.7),      # many instances per persistent block
    (64, None, 50, 256, 8, 0.7),        # W_out too large for shared memory
    (16, None, 50, 18, 3, 0.7),         # rows not 16-byte aligned
    (8, None, 130, 18, 3, "one_row_all_masked"),
    # POMO on CVRP-50: N 51 (depot + 50) is one node tile of 64 with a ragged
    # tail; a train step's rollout, the dihedral-8 dispatch (81 x 8), the
    # multistart greedy dispatch, under random masks and under masks of the
    # capacity rule's kind
    (64, 50, 51, 128, 8, 0.7),
    (648, 50, 51, 128, 8, 0.7),
    (64, 50, 51, 128, 8, "cvrp_like"),
    (655, 50, 51, 128, 8, "cvrp_like"),
    (512, 50, 51, 128, 8, "cvrp_like"),  # train_pomo's validation: 64 x 8 augments;
    # EAS-Emb's multistart rollout under autograd (64 x 8 augments, 50 starts),
    # whose replay of the incumbents is (512, None, 51) "cvrp_like" below
    # the AM checkpoint's dispatches on TSP-50: greedy, and dihedral-8 (3799 x 8)
    (8192, None, 50, 128, 8, 0.7),
    (30392, None, 50, 128, 8, 0.7),
    # K1's edges: one query (one sub-tile of 8, one logit group of 4), nine
    # (the last block's one query), 17 with N 65 (a last block of one query,
    # a last node tile of one node), a single node; one instance at POMO's
    # shape; node pairs over an odd tile (N 51) in every case at N 51
    (4, 1, 51, 128, 8, 0.7),
    (4, 9, 51, 128, 8, "cvrp_like"),
    (8, 17, 65, 128, 8, 0.7),
    (2, 3, 1, 128, 8, 0.7),
    (1, 50, 51, 128, 8, "cvrp_like"),
    # the AM-XL checkpoint's dispatches on TSP-100 (greedy 8192, dihedral-8
    # 1024 x 8), beam search of width 50 with the AM checkpoint (163
    # instances per dispatch, the beams as queries), and SymNCO's evaluation
    # (64 instances x 8 symmetric copies, 50 starts)
    (8192, None, 100, 128, 8, 0.7),
    (163, 50, 50, 128, 8, 0.7),
    (512, 50, 50, 128, 8, 0.7),
    # the mixed OP + PCTSP configuration at N 21 (20 customers + the depot):
    # a train step's sampling rollout (512), the validation's and the golden
    # phase's greedy dispatch (1024), rows after `done` where the depot alone
    # is feasible; OP's multistart greedy in the eval CLI (8192 // 20 = 409
    # instances x 20 starts)
    (512, None, 21, 128, 8, 0.7),
    (1024, None, 21, 128, 8, 0.7),
    (512, None, 21, 128, 8, "one_column"),
    (409, 20, 21, 128, 8, 0.7),
    (409, 20, 21, 128, 8, "one_column"),
    # the multi-task VRP family at N 51 (50 customers + the depot): AM greedy
    # on the routing envs (1024) and an AM train step on SDVRP (512); SDVRP's
    # multistart on 256 x 50 rows, the cache tiled per start so that every
    # row has its own K/V; CVRPTW's multistart (256 x 50 queries); POMO on
    # MTVRP-50 (512 x 50 queries) under masks of real MTVRP states (time
    # windows, backhauls, limits, open routes: sparse rows, the depot alone
    # on finished ones)
    (1024, None, 51, 128, 8, 0.7),
    (512, None, 51, 128, 8, "cvrp_like"),
    (12800, None, 51, 128, 8, "cvrp_like"),
    (256, 50, 51, 128, 8, "cvrp_like"),
    (512, 50, 51, 128, 8, "mtvrp"),
    # GLOP's reviser at TSP-1000: AM on SHPP-25 decodes the 40 segments of a
    # dispatch of 32 as 1 280 rows, the first step forced to node 0; AM
    # greedy on mPDP-50 (3 agents: 4 depot copies + 50, N 54) and MDCPDP-50
    # (3 depots + 50, N 53); CVRPMVC's multistart is (256, 50, 51) above
    (1280, None, 25, 128, 8, 0.7),
    (1280, None, 25, 128, 8, "one_column"),
    (1024, None, 54, 128, 8, 0.7),
    (1024, None, 53, 128, 8, "cvrp_like"),
    # PPO's minibatches of 128 on TSP-50 (the old rollout is (512, None, 50)
    # above); AM greedy on DPP, MDPP, FLP and MCP (100 cells, points or sets;
    # SMTWTP-50's 51 jobs are (1024, None, 51) above)
    (128, None, 50, 128, 8, 0.7),
    (128, None, 20, 128, 8, 0.7),       # ... and its train command line's, on TSP-20
    (1024, None, 100, 128, 8, 0.7),
    (1024, None, 100, 128, 8, "one_column"),
    # the rest of the zoo: MatNet's multistart on ATSP-50 at D 256 with 16
    # heads (head width 16), the evaluation dispatch (256), a train step and
    # its validation (64 x 50), the replay (8 x 50), under masks of visited
    # nodes and with one node left; K2 at that width (its W of 256 KB stays in
    # global memory: the instance without W in shared memory); MDAM's five
    # pointers at TSP-50 (1024 greedy, 256 with Embedding-Glimpse, 8
    # replayed) and HAM's at PDP-50 (N 51, 1024 and 512)
    (256, 50, 50, 256, 16, 0.7),
    (64, 50, 50, 256, 16, 0.7),
    (8, 50, 50, 256, 16, 0.3),
    (64, 50, 50, 256, 16, "one_column"),
    (1024, None, 50, 256, 16, 0.7),
    (256, None, 50, 128, 8, 0.7),
    (8, None, 50, 128, 8, 0.7),
    # infrastructure: Reptile's POMO tasks on TSP-20 and TSP-100 (64 instances,
    # N starts as queries; TSP-50's (64, 50, 50) is above); the data-parallel
    # rank's rollouts (256, None, 50) and remat's (512, None, 50) are above
    (64, 20, 20, 128, 8, 0.7),
    (64, 100, 100, 128, 8, 0.7),
    (64, 100, 100, 128, 8, "one_column"),
]
# further timed shapes, each beside its bound: (kernel, (B, L, N, D, H))
EXTRA_TIMES = [
    ("pointer_step_single", (512, None, 50, 128, 8)),    # a train step's rollouts
    ("pointer_step_single", (8192, None, 50, 128, 8)),   # the AM checkpoint's greedy dispatch
    ("pointer_step_grouped", (16, 500, 500, 128, 8)),    # multistart on TSP-500
    ("pointer_step_grouped", (64, 50, 51, 128, 8)),      # a POMO train step on CVRP-50
    ("pointer_step_grouped", (655, 50, 51, 128, 8)),     # ... its multistart greedy dispatch
    ("pointer_step_grouped", (648, 50, 51, 128, 8)),     # ... and with dihedral-8 (81 x 8)
    ("pointer_step_single", (8192, None, 100, 128, 8)),  # the AM-XL checkpoint on TSP-100
    ("pointer_step_grouped", (163, 50, 50, 128, 8)),     # beam search, width 50, TSP-50
    ("pointer_step_grouped", (512, 50, 50, 128, 8)),     # SymNCO's multistart eval, 64 x 8
    ("pointer_step_single", (512, None, 21, 128, 8)),    # a mixed OP/PCTSP-20 train step
    ("pointer_step_single", (1024, None, 21, 128, 8)),   # ... its greedy validation dispatch
    ("pointer_step_grouped", (409, 20, 21, 128, 8)),     # OP-20 multistart greedy, eval CLI
    ("pointer_step_single", (1024, None, 51, 128, 8)),   # AM greedy, the routing envs at N 50
    ("pointer_step_single", (512, None, 51, 128, 8)),    # an AM train step on SDVRP-50
    ("pointer_step_single", (12800, None, 51, 128, 8)),  # SDVRP's tiled multistart, 256 x 50
    ("pointer_step_grouped", (256, 50, 51, 128, 8)),     # CVRPTW-50 multistart greedy
    ("pointer_step_grouped", (512, 50, 51, 128, 8)),     # POMO on MTVRP-50, multistart greedy
    ("pointer_step_single", (1280, None, 25, 128, 8)),   # GLOP's reviser, TSP-1000, 32 x 40
    ("pointer_step_single", (1024, None, 54, 128, 8)),   # AM greedy on mPDP-50
    ("pointer_step_single", (1024, None, 53, 128, 8)),   # AM greedy on MDCPDP-50
    ("pointer_step_single", (128, None, 50, 128, 8)),    # a PPO minibatch on TSP-50
    ("pointer_step_single", (1024, None, 100, 128, 8)),  # AM greedy on DPP/MDPP/FLP/MCP
    ("pointer_step_grouped", (256, 50, 50, 256, 16)),    # MatNet's multistart on ATSP-50
    ("pointer_step_grouped", (64, 50, 50, 256, 16)),     # ... a MatNet train step
    ("pointer_step_single", (1024, None, 50, 256, 16)),  # K2 at MatNet's width
    ("pointer_step_single", (256, None, 50, 128, 8)),    # MDAM with Embedding-Glimpse; a dp rank
    ("pointer_step_grouped", (64, 20, 20, 128, 8)),      # Reptile's POMO on TSP-20
    ("pointer_step_grouped", (64, 50, 50, 128, 8)),      # ... on TSP-50
    ("pointer_step_grouped", (64, 100, 100, 128, 8)),    # ... on TSP-100
]


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def reset_launches():
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_case(rs, b, l, n, d, h, feasible, device, values=None):
    """Inputs of one kernel call from a frozen numpy stream; with a
    `torch.Generator` ``values`` the normal values are drawn on the device
    from it (a timing's inputs: numpy's legacy normals cost seconds per
    shape at B 8192, and a time does not depend on the values)."""
    from rl4co_tpu_torch.ops.pointer_kernel import mask_to_neg_bias

    def normal(*shape):
        if values is not None:
            return torch.randn(shape, generator=values, device=device)
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(device)

    q = normal(b, d) if l is None else normal(b, l, d)
    k, v, lk = normal(b, n, d), normal(b, n, d), normal(b, n, d)
    w = normal(d, d) / d ** 0.5
    mshape = (b, n) if l is None else (b, l, n)
    if feasible == "one_column":
        col = rs.randint(0, n, size=mshape[:-1])
        mask = np.arange(n) == col[..., None]
    elif feasible == "one_row_all_masked":
        mask = rs.random_sample(mshape) < 0.7
        mask[..., 0] = True
        mask[0] = False  # every query of instance 0 sees no feasible column
    elif feasible == "leading_tiles_masked":
        # the first 150 nodes masked: whole node tiles of either kernel (64 or
        # 32 nodes) and part of the next
        mask = rs.random_sample(mshape) < 0.7
        mask[..., :150] = False
        mask[..., -1] = True
    elif feasible == "cvrp_like":
        # CVRP's mask: the depot (column 0) masked and most customers masked
        # (visited or beyond the remaining capacity); a query with no customer
        # left, and a fifth of the others (finished routes), see the depot alone
        mask = rs.random_sample(mshape) < 0.1
        mask[..., 0] = False
        depot_only = ~mask.any(axis=-1) | (rs.random_sample(mshape[:-1]) < 0.2)
        mask[depot_only] = np.arange(n) == 0
    elif feasible == "mtvrp":
        mask = mtvrp_masks(rs, mshape[:-1], n, device)
    else:
        mask = rs.random_sample(mshape) < feasible
        mask[..., 0] = True
    bias = mask_to_neg_bias(torch.from_numpy(mask).to(device))
    return q, k, v, lk, bias, w, h


def bound_ms(b, l, n, d):
    """Least time for the step: bytes moved once over the memory rate against
    f32 operations over the f32 rate; the larger one binds."""
    ll = 1 if l is None else l
    nbytes = 4 * (3 * b * n * d + b * ll * d + 2 * b * ll * n + d * d)
    flops = b * ll * (6 * n * d + 2 * d * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound_ms(b, l, n, d):
    """Least time for the grouped step on the tensor cores, as K1 computes it:
    bytes moved once over the memory rate against its operations, taken in
    three TF32 passes (the 3xTF32 split), over the TF32 rate."""
    nbytes = 4 * (3 * b * n * d + b * l * d + 2 * b * l * n + d * d)
    flops = 3 * b * l * (6 * n * d + 2 * d * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / TF32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, warmup=20, iters=100):
    """Device time of one call: ``iters`` calls are captured into one CUDA
    graph and the replay is timed by CUDA events, so the host's time to
    enqueue a call (`host_us`) is not in it; the best of three replays. The
    inputs are not flushed from L2 between calls: in the decode loop the
    caches are re-read every step with only small tensors touched between."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def host_us(fn, warmup=20, iters=200):
    """Host time to enqueue one call (no synchronisation inside the loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def check_kernels(device, cases=CASES, seed=0):
    """Every case through the wrapper and the plain version; raises on a
    disagreement beyond RTOL/ATOL. Returns per-kernel max error and case count."""
    from rl4co_tpu_torch.ops.pointer_kernel import (
        fused_pointer_logits,
        pointer_logits_plain,
    )

    rs = np.random.RandomState(seed)
    stats = {name: {"max_abs_err": 0.0, "cases": 0} for name in MAIN_SHAPES}
    for b, l, n, d, h, feasible in cases:
        args = make_case(rs, b, l, n, d, h, feasible, device)
        out = fused_pointer_logits(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref = pointer_logits_plain(*args)
        assert out.shape == ref.shape and out.dtype == torch.float32, (out.shape, out.dtype)
        assert torch.isfinite(out).all(), f"non-finite logits at {(b, l, n, d, h, feasible)}"
        err = (out - ref).abs()
        worst = (err - (ATOL + RTOL * ref.abs())).max().item()
        assert worst <= 0, (
            f"kernel disagrees with its plain version at B={b} L={l} N={n} D={d} H={h} "
            f"mask={feasible}: max abs err {err.max().item():.3e}, "
            f"{worst:.3e} over rtol {RTOL} atol {ATOL}"
        )
        name = "pointer_step_single" if l is None else "pointer_step_grouped"
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err.max().item())
        stats[name]["cases"] += 1
    return stats


def time_kernels(device, seed=1, shapes=None):
    """Device times of kernel and plain version at ``shapes`` ([(kernel,
    (B, L, N, D, H))], by default the main path's), beside the bound (and,
    for the grouped kernel, the bound on the tensor cores)."""
    from rl4co_tpu_torch.ops.pointer_kernel import (
        fused_pointer_logits,
        pointer_logits_plain,
    )

    rs = np.random.RandomState(seed)
    values = torch.Generator(device=device).manual_seed(seed)
    times = []
    for name, (b, l, n, d, h) in shapes or list(MAIN_SHAPES.items()):
        args = make_case(rs, b, l, n, d, h, 0.7, device, values)
        # plain, kernel, kernel, plain: the two versions in turns on one card;
        # device times (graph replays), the eager enqueue times beside them
        p1 = time_ms(lambda: pointer_logits_plain(*args))
        k1 = time_ms(lambda: fused_pointer_logits(*args))
        k2 = time_ms(lambda: fused_pointer_logits(*args))
        p2 = time_ms(lambda: pointer_logits_plain(*args))
        t_bound, bound_by = bound_ms(b, l, n, d)
        times.append({
            "name": name, "shape": {"B": b, "L": l, "N": n, "D": d, "H": h},
            "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "bound_ms": t_bound, "bound_by": bound_by,
            "host_enqueue_us": host_us(lambda: fused_pointer_logits(*args)),
            "plain_host_enqueue_us": host_us(lambda: pointer_logits_plain(*args)),
        })
        if l is not None:
            times[-1]["tc_bound_ms"], times[-1]["tc_bound_by"] = tc_bound_ms(b, l, n, d)
    return times


def make_policies(device, seed=0, embed_dim=128, num_heads=8, num_encoder_layers=3,
                  feedforward_hidden=512):
    """The same seeded weights in a kernel-path and a plain-path policy."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.models import AttentionModelPolicy

    tree = random_params_numpy(seed, embed_dim, num_encoder_layers, feedforward_hidden)
    return {
        impl: load_params(
            AttentionModelPolicy(
                env_name="tsp", embed_dim=embed_dim, num_heads=num_heads,
                num_encoder_layers=num_encoder_layers,
                feedforward_hidden=feedforward_hidden, pointer_impl=impl,
                device=device,
            ), tree).eval()
        for impl in ("kernel", "plain")
    }


# method -> (instances, kernel expected to launch, extra arguments)
PATH_METHODS = [
    ("greedy", 1024, "pointer_step_single", {}),
    ("multistart_greedy", 256, "pointer_step_grouped", {}),
    ("augment_dihedral_8", 128, "pointer_step_single", {}),
    ("sampling", 64, "pointer_step_grouped", {"num_samples": 100}),
]


def drive_path(env, policies, locs, device, methods=PATH_METHODS):
    """Each method through `evaluate_policy` in one dispatch, kernel path and
    plain path; asserts valid tours, launch counts and agreement."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    steps = env.max_steps
    report, total = [], {name: 0 for name in LAUNCHES}
    for method, count, kernel, extra in methods:
        inst = {"locs": locs[:count]}
        res = {}
        for impl in ("kernel", "plain"):
            def run(warmup):
                gen = torch.Generator(device=device)
                gen.manual_seed(1234)
                return evaluate_policy(
                    env, policies[impl], inst, method, batch_size=count,
                    check_solutions=True, warmup=warmup, generator=gen,
                    device=device, **extra)
            run(False)  # untimed first pass: builds, first launches
            reset_launches()
            res[impl] = run(False)
            counts = dict(LAUNCHES)
            # the loop is bound by the host, whose clock is noisy: two more
            # timed passes (not counted as launches of the path)
            res[impl]["rates"] = sorted(
                [res[impl]["instances_per_s"]]
                + [run(False)["instances_per_s"] for _ in range(2)])
            want = {name: 0 for name in LAUNCHES}
            if impl == "kernel":
                want[kernel] = steps  # one launch per decode step of the one dispatch
                for name in total:
                    total[name] += counts[name]
            assert counts == want, f"{method}/{impl}: launches {counts}, expected {want}"
            res[impl]["launches"] = counts
        rk, rp = res["kernel"], res["plain"]
        assert np.isfinite(rk["rewards"]).all() and rk["rewards"].shape == (count,)
        entry = {
            "method": method, "instances": count,
            "mean_cost": -rk["mean_reward"], "mean_cost_plain": -rp["mean_reward"],
            "instances_per_s": rk["rates"][1],            # median of three
            "instances_per_s_plain": rp["rates"][1],
            "instances_per_s_runs": rk["rates"],
            "instances_per_s_plain_runs": rp["rates"],
            "launches": rk["launches"],
        }
        # Kernel and plain path must give the same tours, up to near-ties in
        # an argmax (or a draw next to a boundary of the cumulative
        # distribution: both paths consume one seeded stream of draws) that
        # flip under another order of f32 summation; hence 99% identical, not
        # 100%. Of a sampling run the best tour per instance is compared: 63
        # of its 64 is the nearest share below 99%.
        need = 0.98 if method == "sampling" else 0.99
        same = float((rk["actions"] == rp["actions"]).all(axis=1).mean())
        rel = abs(rk["mean_reward"] - rp["mean_reward"]) / abs(rp["mean_reward"])
        assert rel <= 1e-4, f"{method}: mean cost differs by {rel:.2e} relative"
        assert same >= need, f"{method}: only {same:.4f} of tours identical"
        entry["tours_identical"] = same
        report.append(entry)
    return report, total


def drive_tsp500(device, count=16, seed=500):
    """The grouped kernel past its old N <= 207 limit, through the entry
    point: `evaluate_policy(..., "multistart_greedy")` on ``count`` generated
    TSP-500 instances (500 starts each, one dispatch), AM at full width with
    random seeded weights, kernel path against plain path."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    env = get_env("tsp", num_loc=500)
    inst = env.generate(count, seeded_generator(device, seed), device)
    policies = make_policies(device)
    res, launches = {}, None
    for impl in ("kernel", "plain"):
        reset_launches()
        res[impl] = evaluate_policy(env, policies[impl], inst, "multistart_greedy",
                                    batch_size=count, check_solutions=True, warmup=False,
                                    device=device)
        counts = dict(LAUNCHES)
        want = {name: 0 for name in LAUNCHES}
        if impl == "kernel":
            want["pointer_step_grouped"] = env.max_steps  # one per decode step
            launches = counts
        assert counts == want, f"TSP-500 {impl}: launches {counts}, expected {want}"
    rk, rp = res["kernel"], res["plain"]
    assert np.isfinite(rk["rewards"]).all() and rk["rewards"].shape == (count,)
    same = int((rk["actions"] == rp["actions"]).all(axis=1).sum())
    rel = abs(rk["mean_reward"] - rp["mean_reward"]) / abs(rp["mean_reward"])
    # near-ties of an argmax over 500 starts x 500 steps may flip under
    # another order of f32 summation: one tour of 16 may differ
    assert same >= count - 1, f"TSP-500: only {same} of {count} best tours identical"
    assert rel <= 1e-4, f"TSP-500: mean cost differs by {rel:.2e} relative"
    return {"method": "multistart_greedy", "num_loc": env.num_loc, "instances": count,
            "starts": env.get_num_starts(), "mean_cost": -rk["mean_reward"],
            "mean_cost_plain": -rp["mean_reward"], "mean_cost_rel_err": rel,
            "tours_identical": same, "seconds": rk["inference_time"],
            "seconds_plain": rp["inference_time"], "launches": launches}, launches


def device_events(fn, host=True):
    """Run ``fn`` under `torch.profiler`; returns its result, the device's
    kernels as ``(name, start, duration)`` and the host's `record_function`
    ranges named ``part:...`` as ``{name: (start, end)}``, all in the
    profiler's microseconds. ``host=False`` traces the device alone (no
    ranges): far less overhead over some 10^5 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    torch.cuda.synchronize()
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    # the profiler's own records, read as they are: `prof.events()` first
    # builds a tree of every event in Python, minutes over the whole script
    raw = prof.profiler.kineto_results
    origin = raw.trace_start_ns()
    skip = ("[memory]", "[OutOfMemory]")
    kernels, ranges, names = [], {}, {}
    for e in raw.events():
        name = e.name()
        if name in skip or (hasattr(e, "is_hidden_event") and e.is_hidden_event()):
            continue
        if name not in names:
            names[name] = torch._C._demangle(name)
        name = names[name]
        start, end = (e.start_ns() - origin) / 1e3, (e.end_ns() - origin) / 1e3
        if e.device_type() == DeviceType.CUDA:
            # device-side kernels only: an annotated region's row on the device
            # (`Optimizer.step#...`, a `part:`) repeats its kernels' time
            if not (e.is_user_annotation() or name.startswith(("Optimizer.", "part:"))):
                kernels.append((name, start, end - start))
        elif name.startswith("part:"):
            ranges[name[len("part:"):]] = (start, end)
    return result, kernels, ranges


def top_kernels(kernels, n):
    """``(name, duration in us)`` pairs summed by name: the ``n`` largest."""
    by_name = {}
    for name, us in kernels:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:60], "ms": ms, "launches": c} for k, (ms, c) in top]


def device_profile(fn, host=True):
    """Run ``fn`` under `torch.profiler`; returns its result, the time the
    device was busy (sum over its kernels, ms; None if the profiler saw no
    device activity), the device launches and the kernels by device time."""
    result, kernels, _ = device_events(fn, host)
    busy_ms = sum(d for _, _, d in kernels) / 1e3 if kernels else None
    return result, busy_ms, len(kernels), top_kernels([(k, d) for k, _, d in kernels], 6)


def profile_dispatch(env, policy, instances, device, method, count):
    """One dispatch of the first ``count`` of ``instances`` timed plainly,
    then again under `torch.profiler`: the time the device was busy (sum over
    its kernels), launches, and the kernels that took most of the device's
    time. The busy share is taken against the wall time without the
    profiler, which slows the host."""
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    batch = {k: v[:count] for k, v in instances.items()}

    def run():
        return evaluate_policy(env, policy, batch, method, batch_size=count,
                               warmup=False, device=device)

    run()
    wall_ms = run()["inference_time"] * 1e3
    res, busy_ms, launches, top = device_profile(run)
    return {
        "method": method, "instances": count, "wall_ms": wall_ms,
        "instances_per_s": count / wall_ms * 1e3,   # one dispatch, no validity check
        "wall_ms_under_profiler": res["inference_time"] * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": None if busy_ms is None else busy_ms / wall_ms,
        "device_launches": launches,
        "top_kernels": top,
    }


def check_golden(env, policy, locs, device, path=None):
    """Replay the JAX package's greedy tours (same seeded weights, same 16
    instances in one dispatch) in `evaluate` mode through the kernel path."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models import rollout

    path = path or os.path.join(ROOT, "rl4co_tpu_torch", "golden", "am_tsp50_rs0.json")
    with open(path) as f:
        golden = json.load(f)
    actions = np.asarray(golden["actions"], dtype=np.int64)
    n = actions.shape[0]
    inst = {"locs": locs[:n]}
    with torch.no_grad():
        out = rollout(policy, env, inst, DecodeSpec(kind="evaluate", tanh_clipping=10.0),
                      replay_actions=actions, device=device)
    ll = out.log_likelihood.cpu().numpy()
    cost = -out.reward.cpu().numpy()
    # 50 summed f32 log-probs under another order of summation: atol 2e-3
    ll_err = float(np.abs(ll - np.asarray(golden["log_likelihood"])).max())
    cost_rel = float((np.abs(cost - np.asarray(golden["cost"]))
                      / np.asarray(golden["cost"])).max())
    assert ll_err <= 2e-3, f"golden log-likelihood off by {ll_err:.3e}"
    assert cost_rel <= 1e-5, f"golden cost off by {cost_rel:.3e} relative"
    with torch.no_grad():
        greedy = rollout(policy, env, inst, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                         device=device)
    same = int((greedy.actions.cpu().numpy() == actions).all(axis=1).sum())
    return {"instances": n, "log_likelihood_max_abs_err": ll_err,
            "cost_max_rel_err": cost_rel, "greedy_tours_reproduced": same}


# ------------------------------------------------------ committed checkpoints

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden")
# name -> env and its size, test set, eval methods, the port's policy builder
# (module, name; called with ``env_name`` and ``policy_kwargs``), the pointer
# kernel its decode launches, the TPU run's artifact (None: no TPU run scored
# this checkpoint), and the tolerances. ``reference_instances``: how many
# instances the exported CPU reference costs cover, over which the mean is
# held within ``mean_rtol``; where ``same_share`` is set, that share of the
# per-instance costs must lie within ``cost_rtol``; where ``tpu_rtol`` is set,
# each mean over all 10 000 within it of the TPU run's artifact, a check that
# the model is the trained one, not of rounding (else the artifact is printed
# for information). AM (batch norm) is held at the reference's dispatch sizes
# over all 10 000 instances; POMO (instance norm, no dispatch dependence) on
# the reference's first 1 000; AM-XL (instance norm; the TPU's evaluation of
# it never ran) over all 10 000 at the reference's sizes.
CHECKPOINTS = {
    "am_tsp50": dict(
        env="tsp", num_loc=50, data="data/tsp/test50_seed1234.npz",
        methods=("greedy", "augment_dihedral_8"),
        policy=("rl4co_tpu_torch.models", "AttentionModelPolicy"), policy_kwargs={},
        kernel="pointer_step_single", artifact="runs/am_tsp50_canonical_reeval.json",
        reference_instances=10_000, mean_rtol=1e-4, cost_rtol=None, same_share=None,
        tpu_rtol=None),
    "pomo_cvrp50": dict(
        env="cvrp", num_loc=50, data="data/cvrp/test50_seed1234.npz",
        methods=("multistart_greedy", "multistart_greedy_augment_dihedral_8"),
        policy=("rl4co_tpu_torch.models.zoo.pomo", "make_pomo_policy"), policy_kwargs={},
        kernel="pointer_step_grouped", artifact="runs/pomo_cvrp50_canonical_reeval.json",
        reference_instances=1_000, mean_rtol=1e-5, cost_rtol=1e-4, same_share=0.99,
        tpu_rtol=1e-3),
    "amxl_tsp100": dict(
        env="tsp", num_loc=100, data="data/tsp/test100_seed1234.npz",
        methods=("greedy", "augment_dihedral_8"),
        policy=("rl4co_tpu_torch.models", "AttentionModelPolicy"),
        policy_kwargs=dict(num_encoder_layers=6, normalization="instance"),
        kernel="pointer_step_single", artifact=None,
        reference_instances=10_000, mean_rtol=1e-5, cost_rtol=1e-4, same_share=0.99,
        tpu_rtol=None),
}
TOLERANCE_KEYS = ("reference_instances", "mean_rtol", "cost_rtol", "same_share", "tpu_rtol")


def checkpoint_policy(name, device):
    """The committed checkpoint ``name``, exported as a flat npz, in the
    port's policy on ``device`` (the kernel path)."""
    from rl4co_tpu_torch.convert import load_params, load_params_npz

    spec = CHECKPOINTS[name]
    module, builder = spec["policy"]
    policy = getattr(importlib.import_module(module), builder)(
        env_name=spec["env"], device=device, **spec["policy_kwargs"])
    tree = load_params_npz(os.path.join(GOLDEN, f"{name}_params.npz"))
    return load_params(policy, tree).eval()


def drive_checkpoint(name, device):
    """Every method of ``name`` over the whole canonical test set through
    `evaluate_policy` with `check_solutions`, at the reference's dispatch
    sizes; per-instance costs against the exported CPU reference. Returns
    the report and the pointer kernels' launches (counted from 0 here)."""
    from rl4co_tpu_torch.data.io import load_reference_npz
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    spec = CHECKPOINTS[name]
    env = get_env(spec["env"], num_loc=spec["num_loc"])
    test = load_reference_npz(os.path.join(ROOT, spec["data"]), spec["env"])
    n = len(test["locs"])
    assert n == 10_000, n
    policy = checkpoint_policy(name, device)
    kernel = spec["kernel"]
    tpu = None
    if spec["artifact"] is not None:
        with open(os.path.join(ROOT, spec["artifact"])) as f:
            tpu = json.load(f)["eval"]
    report, total = {}, {k: 0 for k in LAUNCHES}
    with np.load(os.path.join(GOLDEN, f"{name}_costs.npz")) as ref_file:
        reference = {k: ref_file[k] for k in ref_file.files}
    for method in spec["methods"]:
        ref, dispatch = reference[method], int(reference[method + "/dispatch"])
        reset_launches()
        res = evaluate_policy(env, policy, test, method, batch_size=dispatch,
                              check_solutions=True, device=device)
        counts = dict(LAUNCHES)
        # one launch per decode step of every dispatch, the warm-up's included
        want = {k: 0 for k in LAUNCHES}
        want[kernel] = (-(-n // dispatch) + 1) * env.max_steps
        assert counts == want, f"{name}/{method}: launches {counts}, expected {want}"
        for k in total:
            total[k] += counts[k]
        cost = -res["rewards"]
        assert cost.shape == (n,) and np.isfinite(cost).all(), (name, method)
        m = len(ref)
        assert m == spec["reference_instances"], (name, method, m)
        rel = np.abs(cost[:m] - ref) / ref
        mean, ref_mean = float(cost[:m].mean()), float(ref.mean())
        mean_rel = abs(mean - ref_mean) / ref_mean
        entry = {
            "dispatch": dispatch, "instances": n, "mean_cost": float(cost.mean()),
            "reference_instances": m, "mean_cost_on_reference": mean,
            "reference_mean_cost": ref_mean, "mean_rel_err": mean_rel,
            "share_equal_1e-5": float((rel <= 1e-5).mean()),
            "share_equal_1e-4": float((rel <= 1e-4).mean()),
            "max_rel_err": float(rel.max()),
            # the sweep's time holds `check_solutions`, a Python check of every
            # tour on the host: not a serving rate (that is `profile*`'s)
            "instances_per_s_with_validity_check": res["instances_per_s"],
            "seconds_with_validity_check": res["inference_time"],
            "warmup_s": res["warmup_s"], "launches": counts,
        }
        if tpu is not None:
            entry["tpu_mean_cost"] = tpu[method]["mean_cost"]
            entry["tpu_mean_rel_err"] = (abs(float(cost.mean()) - tpu[method]["mean_cost"])
                                         / tpu[method]["mean_cost"])
        assert mean_rel <= spec["mean_rtol"], f"{name}/{method}: mean off by {mean_rel:.2e}"
        if spec["same_share"] is not None:
            same = float((rel <= spec["cost_rtol"]).mean())
            assert same >= spec["same_share"], (name, method, entry)
        if spec["tpu_rtol"] is not None:
            assert entry["tpu_mean_rel_err"] <= spec["tpu_rtol"], (
                f"{name}/{method}: {entry['tpu_mean_rel_err']:.2e} from the TPU's mean")
        report[method] = entry
    return report, total


# ---------------------------------------------------------------- training

# Gradients of the kernel path against the plain path. Both run the same
# backward (the recompute of the plain version); they differ by the forward
# logits' last bits (1e-6, phase `kernels`), which 50 softmaxes and the
# encoder's batch-norm statistics carry into the loss and its gradients.
# Per parameter: |g_kernel - g_plain| <= GRAD_ATOL * max|g| + GRAD_RTOL * |g_plain|.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
LOSS_RTOL = 1e-4
# shapes at which the Function's gradients are held against plain autograd
GRAD_SHAPES = {
    "pointer_step_single": (512, None, 50, 128, 8),
    "pointer_step_grouped": (64, 50, 50, 128, 8),
}
# EAS-Emb's shapes at 64 CVRP-50 instances x 8 augments: K1 in the multistart
# rollout, K2 in the replay of the incumbents, both under autograd
EAS_GRAD_SHAPES = {
    "pointer_step_grouped_eas_multistart": (512, 50, 51, 128, 8, "cvrp_like"),
    "pointer_step_single_eas_incumbents": (512, None, 51, 128, 8, "cvrp_like"),
}
# greedy cost on TSP-20 must fall by at least this much in phase (d): half of
# the fall first measured on an H100 at this size (3.97, from 8.13 to 4.16)
LEARN_MARGIN = 2.0


def backward_bound_ms(b, l, n, d):
    """Least time for the backward of one pointer step: q, K, V, LK, W, bias
    and the logits' gradient read once, the five gradients written once;
    three times the forward's operations (the recompute, then two products
    per forward product)."""
    ll = 1 if l is None else l
    nbytes = 4 * (6 * b * n * d + 2 * b * ll * d + 2 * b * ll * n + 2 * d * d)
    flops = 3 * b * ll * (6 * n * d + 2 * d * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_function_gradients(device, seed=2, iters=20, shapes=GRAD_SHAPES):
    """The `Function` at the training shapes. Its forward is the kernel and is
    held against the plain version's logits; its five gradients are held
    against plain autograd's, which checks the `Function`'s wiring (saved
    inputs, `needs_input_grad`, the order of the gradients) and not the
    kernel: both sides take them from the plain version's graph. Also the
    device time of its backward. ``shapes``: {label: (B, L, N, D, H[, mask kind])},
    the mask kind as `make_case` takes it (0.7 feasible by default)."""
    from rl4co_tpu_torch.ops.pointer_kernel import (
        fused_pointer_logits,
        pointer_logits_plain,
    )

    rs = np.random.RandomState(seed)
    report = {}
    for name, (b, l, n, d, h, *mask) in shapes.items():
        q, k, v, lk, bias, w, _ = make_case(rs, b, l, n, d, h, mask[0] if mask else 0.7, device)
        cot = torch.from_numpy(rs.standard_normal(tuple(bias.shape)).astype(np.float32)).to(device)

        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lk, w)]
            out = fn(*leaves[:4], bias, leaves[4], h)
            return out, leaves, lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)

        out_k, _, back_k = grads(fused_pointer_logits)
        out_p, _, back_p = grads(pointer_logits_plain)
        assert out_k.grad_fn is not None and "PointerLogits" in type(out_k.grad_fn).__name__
        assert out_k.shape == out_p.shape and torch.isfinite(out_k).all(), name
        fwd_err = (out_k - out_p).detach().abs()
        over = (fwd_err - (ATOL + RTOL * out_p.detach().abs())).max().item()
        assert over <= 0, (f"{name}: under autograd the kernel's logits disagree with the "
                           f"plain version's: max abs err {fwd_err.max().item():.3e}")
        worst = 0.0
        for gname, gk, gp in zip(("q", "k", "v", "lk", "w_out"), back_k(), back_p()):
            assert gk.shape == gp.shape and torch.isfinite(gk).all(), gname
            err = (gk - gp).abs()
            over = (err - (ATOL + RTOL * gp.abs())).max().item()
            assert over <= 0, (f"{name}: gradient of {gname} disagrees with plain autograd: "
                               f"max abs err {err.max().item():.3e}")
            worst = max(worst, err.max().item())

        def many(back):
            for _ in range(iters):
                back()

        many(back_k)  # warm up
        _, busy_k, launches_k, _ = device_profile(lambda: many(back_k))
        _, busy_p, launches_p, _ = device_profile(lambda: many(back_p))
        t_bound, bound_by = backward_bound_ms(b, l, n, d)
        report[name] = {
            "shape": {"B": b, "L": l, "N": n, "D": d, "H": h},
            "mask": mask[0] if mask else 0.7,
            "forward_max_abs_err": fwd_err.max().item(),
            "grad_max_abs_err": worst,
            # the Function's backward: recompute of the plain forward + its backward
            "backward_device_ms": None if busy_k is None else busy_k / iters,
            "backward_device_launches": launches_k / iters,
            # plain autograd's backward alone (its forward's intermediates were saved)
            "plain_backward_device_ms": None if busy_p is None else busy_p / iters,
            "plain_backward_device_launches": launches_p / iters,
            "backward_bound_ms": t_bound, "backward_bound_by": bound_by,
        }
    return report


def replayed_loss_pair(env, device, batch, compute_dtype=None, seed=11):
    """The kernel-path policy samples under grad and gives a REINFORCE loss
    against a rollout-baseline snapshot with other weights (its greedy
    rollout included: 100 single-query launches on TSP-50); the plain-path
    policy, same weights, replays the same actions with the same baseline
    values. Both losses are backpropagated. Returns the policies, the
    kernel-path algorithm, both losses, its rollout, the instances, and the
    kernel path's launches and ms for its loss and backward (host clock,
    synchronised)."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.baselines import RolloutBaseline
    from rl4co_tpu_torch.rl.reinforce import REINFORCE, seeded_generator

    spec = DecodeSpec(kind="sampling", tanh_clipping=10.0, compute_dtype=compute_dtype)
    live = make_policies(device, seed=0)
    snapshot = make_policies(device, seed=1)["kernel"].requires_grad_(False)
    inst = env.generate(batch, seeded_generator(device, seed), device)

    algo_k = REINFORCE(env, live["kernel"], baseline=RolloutBaseline(), train_spec=spec)
    algo_k.baseline_state = dataclasses.replace(algo_k.baseline_state, bl_policy=snapshot)
    algo_k.reseed(seed + 1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    loss_k, (metrics_k, out_k) = algo_k.loss(inst)
    loss_k.backward()
    launches = dict(LAUNCHES)
    if device.type == "cuda":
        torch.cuda.synchronize()
    kernel_ms = (time.perf_counter() - t0) * 1e3
    assert launches == {"pointer_step_single": 2 * env.max_steps,
                        "pointer_step_grouped": 0}, launches
    bl_val, _ = algo_k.baseline.eval(algo_k.baseline_state, inst, out_k.reward,
                                     algo_k.greedy_reward_fn())
    assert torch.allclose(bl_val.mean(), metrics_k["bl_val"], rtol=1e-6)  # it repeats

    algo_p = REINFORCE(env, live["plain"], baseline=given_baseline(bl_val), train_spec=spec)
    reset_launches()
    loss_p, (_, out_p) = algo_p.loss(inst, replay_actions=out_k.actions)
    loss_p.backward()
    assert sum(LAUNCHES.values()) == 0, dict(LAUNCHES)
    assert torch.equal(out_p.actions, out_k.actions)
    env.check_solution_validity({}, out_k.actions)
    return live, algo_k, loss_k, loss_p, out_k, inst, launches, kernel_ms


def check_training_gradients(env, device, batch=64):
    """(a) `replayed_loss_pair` in f32: loss and every parameter's gradient of
    the kernel path must agree with the plain path's."""
    live, _, loss_k, loss_p, *_ = replayed_loss_pair(env, device, batch)
    return {"batch": batch, **compare_gradients(live, loss_k, loss_p)}


def given_baseline(values):
    """A baseline that hands back ``values`` (the kernel path's), so that the
    plain path's loss is taken against the same baseline values."""
    from rl4co_tpu_torch.rl.baselines import Baseline

    class GivenBaseline(Baseline):
        def eval(self, state, instances, reward, rollout_fn):
            return values, torch.zeros((), device=reward.device)

    return GivenBaseline()


def compare_gradients(live, loss_k, loss_p, grad_rtol=GRAD_RTOL):
    """Loss and every parameter's gradient of the kernel-path policy against
    the plain-path one's (same weights, same actions), at LOSS_RTOL and
    ``grad_rtol`` / GRAD_ATOL."""
    lk, lp = loss_k.item(), loss_p.item()
    report = check_gradients({n: p.grad for n, p in live["kernel"].named_parameters()},
                             {n: p.grad for n, p in live["plain"].named_parameters()},
                             lk, lp, grad_rtol, "the kernel and the plain path")
    return {"loss_kernel": lk, "loss_plain": lp, **report}


def check_gradients(got, want, loss_got, loss_want, grad_rtol=GRAD_RTOL, what="",
                    loss_scale=None, grad_atol=GRAD_ATOL):
    """Loss at LOSS_RTOL of ``loss_scale`` (default: the loss itself) and
    every gradient of ``got`` ({name: grad}) against ``want``'s at
    ``grad_rtol`` / ``grad_atol`` of the largest gradient. A gradient of None (a
    parameter the loss does not reach) must be matched by a None or an exact
    zero."""
    loss_scale = abs(loss_want) if loss_scale is None else loss_scale
    assert np.isfinite(loss_got) and abs(loss_got - loss_want) <= LOSS_RTOL * loss_scale, (
        loss_got, loss_want, loss_scale)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    scale = max(g.abs().max().item() for g in want.values() if g is not None)
    assert scale > 1e-3, f"gradients vanish (max {scale:.3e}): the check would be vacuous"
    worst_abs, worst_name = 0.0, None
    for name, gk in got.items():
        gp = want[name]
        if gk is None or gp is None:
            other = gp if gk is None else gk
            assert other is None or not other.any(), f"{name}: one side has no gradient"
            continue
        assert torch.isfinite(gk).all(), name
        err = (gk - gp).abs()
        over = (err - (grad_atol * scale + grad_rtol * gp.abs())).max().item()
        assert over <= 0, (f"gradient of {name} differs between {what}: "
                           f"max abs err {err.max().item():.3e} at scale {scale:.3e}")
        if err.max().item() > worst_abs:
            worst_abs, worst_name = err.max().item(), name
    return {"loss_rel_err": abs(loss_got - loss_want) / abs(loss_want),
            "loss_err_over_scale": abs(loss_got - loss_want) / loss_scale, "grad_scale": scale,
            "grad_max_abs_err": worst_abs, "grad_max_abs_err_at": worst_name,
            "grad_max_err_over_scale": worst_abs / scale,
            "parameters": len(want), "loss_rtol": LOSS_RTOL,
            "grad_rtol": grad_rtol, "grad_atol_of_scale": grad_atol}


def split_step(algo, batch_size):
    """One `algo.train_step`, the entry point itself, with marks where it
    calls its parts: `loss`, inside it the baseline's rollout function, and
    the optimiser's `step`. Each mark synchronises the device on entry and on
    exit, so a part's kernels run between its marks. The sampling rollout is
    `loss` without the baseline's rollout; the backward is what lies between
    the end of `loss` and the optimiser's `step`; the rest of the step
    (generating the batch, `zero_grad`, the baseline's update) is `other`.
    One step is timed plainly (host clock), one more under the profiler:
    wall ms, device busy ms, device launches and top device kernels per part."""
    from torch.profiler import record_function

    marks = {}

    def marked(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("part:" + name):
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
            marks[name] = (t0 * 1e3, time.perf_counter() * 1e3)
            return result
        return wrapper

    def derive(ranges):
        """Start and end of every part from the marked ranges."""
        step, loss, bl, opt = (ranges[k] for k in ("step", "loss", "baseline_rollout",
                                                   "optimizer"))
        assert step[0] <= loss[0] <= bl[0] <= bl[1] <= loss[1] <= opt[0] <= opt[1] <= step[1]
        return {"sampling_rollout": [(loss[0], bl[0]), (bl[1], loss[1])],
                "baseline_rollout": [bl], "backward": [(loss[1], opt[0])],
                "optimizer": [opt], "other": [(step[0], loss[0]), (opt[1], step[1])]}

    reward_fn = algo.greedy_reward_fn
    patched = {  # instance attributes that shadow the methods `update` calls
        algo: {"loss": marked("loss", algo.loss),
               "greedy_reward_fn": lambda: marked("baseline_rollout", reward_fn())},
        algo.optimizer: {"step": marked("optimizer", algo.optimizer.step)},
    }
    # the class's `train_step`: `timed_steps` may have wrapped the instance's
    step = marked("step", lambda: type(algo).train_step(algo, batch_size))
    for obj, attrs in patched.items():
        for attr, fn in attrs.items():
            assert attr not in vars(obj), attr
            setattr(obj, attr, fn)
    steps_before = algo.step
    step()                                   # plain pass
    spans = derive(marks)
    report = {name: {"wall_ms": sum(t1 - t0 for t0, t1 in parts)}
              for name, parts in spans.items()}
    marks.clear()
    _, kernels, ranges = device_events(step)  # profiled pass
    for obj, attrs in patched.items():
        for attr in attrs:
            delattr(obj, attr)
    assert algo.step == steps_before + 2 and not marks.keys() - ranges.keys()

    spans = derive(ranges)
    seen = 0
    for name, parts in spans.items():
        mine = [(k, d) for k, start, d in kernels
                if any(t0 <= start < t1 for t0, t1 in parts)]
        report[name].update({
            "device_busy_ms": sum(d for _, d in mine) / 1e3, "device_launches": len(mine),
            "top_kernels": top_kernels(mine, 4),
            "pointer_step_single": sum("pointer_step_single" in k for k, _ in mine)})
        seen += len(mine)
    # the host's ranges and the device's kernels share one clock only if every
    # kernel falls into a part, and each rollout's 50 pointer steps into its own
    assert kernels and seen == len(kernels), (seen, len(kernels))
    assert [report[n]["pointer_step_single"] for n in spans] == [
        algo.env.max_steps, algo.env.max_steps, 0, 0, 0], report
    wall = sum(r["wall_ms"] for r in report.values())
    busy = sum(r["device_busy_ms"] for r in report.values())
    report["step"] = {"wall_ms": wall, "device_busy_ms": busy,
                      "device_busy_share": busy / wall, "device_launches": len(kernels)}
    return report


def timed_steps(algo):
    """Wrap ``algo.train_step`` so that every step is synchronised, timed and
    its kernel launches counted; returns the lists it fills."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    inner, ms, launches = algo.train_step, [], []

    def train_step(batch_size):
        torch.cuda.synchronize()
        before, t0 = dict(LAUNCHES), time.perf_counter()
        metrics = inner(batch_size)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        return metrics

    algo.train_step = train_step
    return ms, launches


def train_full_width(env, locs, device, batch=512, steps=12, val=1024):
    """(b) `AttentionModel(env)` with its defaults through `Trainer.fit()`:
    one epoch, validation on committed instances, `epoch_end` with the t-test
    on a held-out set. Launch counts start at 0 here and are read at the end."""
    from rl4co_tpu_torch.models.zoo.am import AttentionModel
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.trainer import Trainer, TrainerConfig

    torch.manual_seed(1234)
    algo = AttentionModel(env)
    assert algo.device.type == device.type and algo.policy.pointer.impl == "kernel"
    before = [p.detach().clone() for p in algo.policy.parameters()]
    step_ms, step_launches = timed_steps(algo)
    logged = []
    trainer = Trainer(algo, TrainerConfig(
        epochs=1, batch_size=batch, train_data_size=steps * batch, val_data_size=val,
        val_batch_size=val, seed=1234, log_every=steps - 1), logger=logged.append)
    reset_launches()
    trainer.fit(val_datasets={"tsp50": {"locs": locs[:val]}})
    launches = dict(LAUNCHES)

    per_step = {"pointer_step_single": 2 * env.max_steps, "pointer_step_grouped": 0}
    assert algo.step == steps and len(step_ms) == steps
    assert all(l == per_step for l in step_launches), step_launches
    # + the held-out set's incumbent and candidate rollouts and one validation batch
    assert launches == {"pointer_step_single": (2 * steps + 3) * env.max_steps,
                        "pointer_step_grouped": 0}, launches
    losses = [r["loss"] for r in logged if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses), losses
    grad_norm = algo.optimizer.grad_norm.item()
    assert np.isfinite(grad_norm) and grad_norm > 0, grad_norm
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(algo.policy.parameters(), before))
    assert moved > 1e-5 and all(torch.isfinite(p).all() for p in algo.policy.parameters())
    assert algo.baseline_state.epoch == 1
    rec = trainer.history[-1]
    assert np.isfinite(rec["val/tsp50/reward"])
    median = statistics.median(step_ms)
    report = {
        "model": "AM 128/8/3/512 batch norm, TSP-50, REINFORCE, rollout baseline, Adam 1e-4",
        "batch": batch, "steps": steps,
        "step_ms_median": median, "step_ms_runs": step_ms,
        "instances_per_s": batch / median * 1e3,
        "env_steps_per_s": batch * env.max_steps / median * 1e3,
        "epoch_env_steps_per_s": rec["env_steps_per_s"], "epoch_s": rec["time/epoch_s"],
        "launches_per_step": per_step, "launches": launches,
        "loss_first_last_logged": losses, "grad_norm_last": grad_norm,
        "max_parameter_change": moved, "val_cost": -rec["val/tsp50/reward"],
        "split": split_step(algo, batch),
    }
    return report, launches


def train_grouped(env, device, batch=64, steps=3):
    """(c) The grouped kernel under grad: multistart sampling with the shared
    baseline. Launch counts start at 0 here and are read at the end."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.baselines import SharedBaseline
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    starts = env.get_num_starts()
    policy = make_policies(device, seed=0)["kernel"]
    before = [p.detach().clone() for p in policy.parameters()]
    algo = REINFORCE(env, policy, baseline=SharedBaseline(num_repeats=starts),
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0,
                                           multistart=True, num_starts=starts))
    algo.reseed(21)
    step_ms, step_launches = timed_steps(algo)
    reset_launches()
    metrics = [algo.train_step(batch) for _ in range(steps)]
    launches = dict(LAUNCHES)
    per_rollout = {"pointer_step_single": 0, "pointer_step_grouped": env.max_steps}
    assert all(l == per_rollout for l in step_launches), step_launches
    losses = [m["loss"].item() for m in metrics]
    assert all(np.isfinite(x) and x != 0.0 for x in losses), losses
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(policy.parameters(), before))
    assert moved > 1e-5
    return {"batch": batch, "starts": starts, "steps": steps, "step_ms_runs": step_ms,
            "launches_per_rollout": per_rollout, "launches": launches, "losses": losses,
            "grad_norm_last": algo.optimizer.grad_norm.item(),
            "max_parameter_change": moved}, launches


def train_learns(device, num_loc=20, batch=512, steps=100, val=1024):
    """(d) Full width on TSP-20 at the default learning rate: greedy cost on a
    fixed seeded set before and after one epoch of `Trainer.fit()`."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.am import AttentionModel
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.trainer import Trainer, TrainerConfig

    env = get_env("tsp", num_loc=num_loc)
    torch.manual_seed(4321)
    algo = AttentionModel(env)
    fixed = env.generate(val, seeded_generator(device, 4321, 0), device)
    eval_step = algo.make_eval_step()
    before = -eval_step(fixed)["reward"].item()
    trainer = Trainer(algo, TrainerConfig(
        epochs=1, batch_size=batch, train_data_size=steps * batch, val_data_size=val,
        val_batch_size=val, seed=4321, log_every=10 ** 9), logger=lambda m: None)
    t0 = time.perf_counter()
    trainer.fit(val_datasets={"fixed": fixed})
    seconds = time.perf_counter() - t0
    after = -eval_step(fixed)["reward"].item()
    assert abs(after + trainer.history[-1]["val/fixed/reward"]) <= 1e-5 * after
    assert before - after >= LEARN_MARGIN, (
        f"greedy cost on TSP-{num_loc} fell from {before:.4f} to {after:.4f}: "
        f"less than the margin {LEARN_MARGIN}")
    return {"num_loc": num_loc, "batch": batch, "steps": steps, "instances": val,
            "greedy_cost_before": before, "greedy_cost_after": after,
            "fall": before - after, "margin": LEARN_MARGIN, "seconds": seconds,
            "env_steps_per_s": trainer.history[-1]["env_steps_per_s"]}


def train_resumes(device, num_loc=20, batch=64, steps_per_epoch=2):
    """(e) A checkpoint written on the card restores there: one epoch, a new
    process's worth of fresh objects resumed for the second epoch, then one
    further step, against two epochs straight and the same further step."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.am import AttentionModel
    from rl4co_tpu_torch.trainer import Trainer, TrainerConfig

    env = get_env("tsp", num_loc=num_loc)

    def make(epochs, ckpt_dir):
        torch.manual_seed(99)
        algo = AttentionModel(env, train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
        cfg = TrainerConfig(epochs=epochs, batch_size=batch,
                            train_data_size=steps_per_epoch * batch, val_data_size=128,
                            val_batch_size=128, seed=7, ckpt_dir=ckpt_dir)
        return algo, Trainer(algo, cfg, logger=lambda m: None)

    def further_step(algo):
        algo.reseed(7, 12345)
        return algo.train_step(batch)["loss"].item()

    full, trainer = make(2, None)
    trainer.fit()
    loss_full = further_step(full)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        _, trainer = make(1, ckpt_dir)
        trainer.fit()
        resumed, trainer = make(2, ckpt_dir)
        trainer.fit(resume_from=os.path.join(ckpt_dir, "last.pt"))
    assert [r["epoch"] for r in trainer.history] == [1]
    assert resumed.step == full.step - 1 == 2 * steps_per_epoch
    assert all(p.device.type == device.type for p in resumed.policy.parameters())
    assert all(p.device.type == device.type
               for p in resumed.baseline_state.bl_policy.parameters())
    loss_resumed = further_step(resumed)
    # gather's backward adds with atomics on the card, in an order that changes
    # from run to run: the two runs agree to f32 rounding, not to the bit
    rel = abs(loss_resumed - loss_full) / abs(loss_full)
    assert np.isfinite(loss_full) and rel <= 1e-4, (loss_full, loss_resumed)
    return {"loss_uninterrupted": loss_full, "loss_resumed": loss_resumed, "rel_err": rel,
            "rtol": 1e-4, "steps_before_the_compared_one": resumed.step - 1}


def pomo_algorithm(env, device, seed, pointer_impl="kernel"):
    """`POMO(env)` at full width (6 layers, 128/8/512, instance norm) with
    weights from ``torch.manual_seed(seed)``, as the checkpoint was trained:
    multistart sampling with tanh clipping 10, AdamW (`runs/train_quality.py`,
    preset pomo_cvrp50)."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.zoo.pomo import POMO

    torch.manual_seed(seed)
    return POMO(env, policy_kwargs=dict(pointer_impl=pointer_impl, device=device),
                train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0),
                optimizer="adamw")


def check_pomo_gradients(env, device, batch=64):
    """The kernel-path POMO samples under grad (100 grouped launches); the
    plain-path one, same weights, replays its actions. Loss and every
    parameter's gradient must agree, at the tolerances of AM's check."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import seeded_generator

    algos = {impl: pomo_algorithm(env, device, seed=7, pointer_impl=impl)
             for impl in ("kernel", "plain")}
    live = {impl: a.policy for impl, a in algos.items()}
    assert all(torch.equal(p, q) for p, q in zip(live["kernel"].parameters(),
                                                 live["plain"].parameters()))
    inst = env.generate(batch, seeded_generator(device, 31), device)
    algos["kernel"].reseed(32)
    reset_launches()
    loss_k, (_, out_k) = algos["kernel"].loss(inst)
    loss_k.backward()
    assert dict(LAUNCHES) == {"pointer_step_single": 0,
                              "pointer_step_grouped": env.max_steps}, dict(LAUNCHES)
    reset_launches()
    loss_p, (_, out_p) = algos["plain"].loss(inst, replay_actions=out_k.actions)
    loss_p.backward()
    assert sum(LAUNCHES.values()) == 0, dict(LAUNCHES)
    assert torch.equal(out_p.actions, out_k.actions)
    env.check_solution_validity({"demand": inst["demand"].repeat(env.get_num_starts(), 1)},
                                out_k.actions)
    return {"batch": batch, "starts": algos["kernel"].num_starts,
            **compare_gradients(live, loss_k, loss_p)}


def train_pomo(env, locs_depot_demand, device, batch=64, steps=4, val=64):
    """POMO on CVRP-50 at full width through `Trainer.fit()`: one epoch of
    ``steps`` train steps at ``batch`` x 50 starts, validation (multistart
    greedy on dihedral-8) on committed instances; then one more step under
    the profiler. Launch counts start at 0 here and are read after `fit`."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.trainer import Trainer, TrainerConfig

    algo = pomo_algorithm(env, device, seed=1234)
    assert algo.policy.pointer.impl == "kernel" and algo.policy.num_encoder_layers == 6
    before = [p.detach().clone() for p in algo.policy.parameters()]
    step_ms, step_launches = timed_steps(algo)
    logged = []
    trainer = Trainer(algo, TrainerConfig(
        epochs=1, batch_size=batch, train_data_size=steps * batch, val_data_size=val,
        val_batch_size=val, seed=1234, log_every=1), logger=logged.append)
    reset_launches()
    trainer.fit(val_datasets={"cvrp50": {k: v[:val] for k, v in locs_depot_demand.items()}})
    launches = dict(LAUNCHES)
    per_rollout = {"pointer_step_single": 0, "pointer_step_grouped": env.max_steps}
    assert algo.step == steps and step_launches == [per_rollout] * steps, step_launches
    # + one validation rollout (val instances x 8 augments as the batch)
    assert launches == {"pointer_step_single": 0,
                        "pointer_step_grouped": (steps + 1) * env.max_steps}, launches
    losses = [r["loss"] for r in logged if "loss" in r]
    assert len(losses) == steps and all(np.isfinite(x) and x != 0.0 for x in losses), losses
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(algo.policy.parameters(), before))
    assert moved > 1e-5 and all(torch.isfinite(p).all() for p in algo.policy.parameters())
    rec = trainer.history[-1]
    assert rec["val/cvrp50/max_aug_reward"] >= rec["val/cvrp50/max_reward"] >= rec["val/cvrp50/reward"]
    _, busy_ms, device_launches, top = device_profile(lambda: algo.train_step(batch))
    median = statistics.median(step_ms[:steps])
    return {
        "model": "POMO 128/8/6/512 instance norm, CVRP-50, 50 starts, AdamW 1e-4",
        "batch": batch, "starts": algo.num_starts, "steps": steps,
        "step_ms_median": median, "step_ms_runs": step_ms[:steps],
        "instances_per_s": batch / median * 1e3,
        "profiled_step": {"wall_ms_under_profiler": step_ms[-1], "device_busy_ms": busy_ms,
                          "device_busy_share_of_median_step":
                              None if busy_ms is None else busy_ms / median,
                          "device_launches": device_launches, "top_kernels": top},
        "launches_per_rollout": per_rollout, "launches": launches, "losses": losses,
        "grad_norm_last": algo.optimizer.grad_norm.item(), "max_parameter_change": moved,
        "val_cost": -rec["val/cvrp50/reward"],
        "val_cost_best_of_starts_and_augments": -rec["val/cvrp50/max_aug_reward"],
    }, launches


# ------------------------------------------------- the rest of the AM family

BEAM_MEAN_RTOL, BEAM_COST_RTOL, BEAM_SAME_SHARE = 1e-4, 1e-5, 0.98


def drive_beam(device, count=1_000):
    """`evaluate_policy(..., "beam_search")` (width 50, the beams as the
    grouped kernel's queries) with the AM TSP-50 checkpoint on the first
    ``count`` canonical instances, in the reference's dispatches of 163,
    every best tour checked; costs against the JAX package's. Launch counts
    start at 0 here and are read at the end."""
    from rl4co_tpu_torch.data.io import load_reference_npz
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    env = get_env("tsp", num_loc=50)
    test = {k: v[:count] for k, v in load_reference_npz(
        os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz"), "tsp").items()}
    with np.load(os.path.join(GOLDEN, "am_tsp50_beam_costs.npz")) as f:
        ref, dispatch = f["beam_search"], int(f["beam_search/dispatch"])
    assert len(ref) == count, len(ref)
    policy = checkpoint_policy("am_tsp50", device)
    reset_launches()
    res = evaluate_policy(env, policy, test, "beam_search", batch_size=dispatch,
                          check_solutions=True, device=device)
    launches = dict(LAUNCHES)
    # one grouped launch per decode step of every dispatch, the warm-up's included
    want = {"pointer_step_single": 0,
            "pointer_step_grouped": (-(-count // dispatch) + 1) * env.max_steps}
    assert launches == want, f"beam search: launches {launches}, expected {want}"
    cost = -res["rewards"]
    assert cost.shape == (count,) and np.isfinite(cost).all()
    rel = np.abs(cost - ref) / ref
    mean_rel = abs(float(cost.mean()) - float(ref.mean())) / float(ref.mean())
    same = float((rel <= BEAM_COST_RTOL).mean())
    assert mean_rel <= BEAM_MEAN_RTOL, f"beam search: mean off by {mean_rel:.2e}"
    assert same >= BEAM_SAME_SHARE, f"beam search: only {same:.4f} of costs within 1e-5"
    return {"model": "AM TSP-50 checkpoint (runs/ckpt_am_tsp50/best)", "width": 50,
            "dispatch": dispatch, "instances": count, "mean_cost": float(cost.mean()),
            "reference_mean_cost": float(ref.mean()), "mean_rel_err": mean_rel,
            "share_equal_1e-5": same, "share_equal_1e-4": float((rel <= 1e-4).mean()),
            "max_rel_err": float(rel.max()),
            "instances_per_s_with_validity_check": res["instances_per_s"],
            "seconds_with_validity_check": res["inference_time"], "warmup_s": res["warmup_s"],
            "tolerances": {"mean_rtol": BEAM_MEAN_RTOL, "cost_rtol": BEAM_COST_RTOL,
                           "same_share": BEAM_SAME_SHARE},
            "launches": launches}, launches


# A bf16 step's gradients, kernel path against plain path: both round the
# same f32 masters through bf16, so they differ by the kernel's last bits (as
# in phase (a)), and where those bits move a gradient across a bf16 rounding
# boundary on its way back through the casts, by one bf16 ulp (2**-7 of it).
BF16_GRAD_RTOL = GRAD_RTOL + 2 ** -7


def train_bf16(env, device, batch=512):
    """One AM train step at ``batch`` on TSP-50 with ``compute_dtype="bfloat16"``:
    `replayed_loss_pair` in bf16 (the baseline's greedy rollout in bf16 too),
    loss and every gradient compared at BF16_GRAD_RTOL, then the kernel
    path's optimiser step, after which the masters must still be f32 leaves."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models import rollout

    live, algo_k, loss_k, loss_p, out_k, inst, launches, kernel_ms = replayed_loss_pair(
        env, device, batch, compute_dtype="bfloat16", seed=41)
    report = compare_gradients(live, loss_k, loss_p, grad_rtol=BF16_GRAD_RTOL)
    before = [p.detach().clone() for p in algo_k.policy.parameters()]
    algo_k.optimizer.step()
    for p in algo_k.policy.parameters():
        assert p.dtype == torch.float32 and p.is_leaf and torch.isfinite(p).all()
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(algo_k.policy.parameters(), before))
    assert moved > 1e-5
    # the bf16 rollout is not the f32 one: the sampled tours' log-likelihoods
    # under the f32 weights differ
    with torch.no_grad():
        f32 = rollout(live["plain"], env, inst,
                      DecodeSpec(kind="evaluate", tanh_clipping=10.0),
                      replay_actions=out_k.actions, device=device)
    ll_gap = (f32.log_likelihood - out_k.log_likelihood.detach()).abs().max().item()
    assert ll_gap > 1e-5, ll_gap
    return {"model": "AM 128/8/3/512 batch norm, TSP-50, REINFORCE, rollout baseline, bf16",
            "batch": batch, "launches": launches,
            "loss_and_backward_ms": kernel_ms, **report,
            "max_parameter_change": moved, "masters": "float32",
            "ll_gap_to_f32_weights": ll_gap}, launches


def train_zoo(algo, batch, steps, eval_fn, want_step, want_eval):
    """``steps`` train steps of ``algo`` at ``batch``, then ``eval_fn()``, with
    the pointer kernels' launches counted from 0 over the steps and over the
    evaluation and asserted equal to ``want_step`` (per step) and
    ``want_eval``. Returns the report and the launches."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    before = [p.detach().clone() for p in algo.policy.parameters()]
    step_ms, step_launches = timed_steps(algo)
    reset_launches()
    metrics = [algo.train_step(batch) for _ in range(steps)]
    train_launches = dict(LAUNCHES)
    assert step_launches == [want_step] * steps, step_launches
    losses = {k: [m[k].item() for m in metrics] for k in metrics[0] if k.startswith("loss")}
    assert all(np.isfinite(v) for vs in losses.values() for v in vs), losses
    assert losses["loss"][0] != 0.0, losses
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(algo.policy.parameters(), before))
    assert moved > 1e-5 and all(torch.isfinite(p).all() for p in algo.policy.parameters())
    reset_launches()
    evaluation = eval_fn()
    eval_launches = dict(LAUNCHES)
    assert eval_launches == want_eval, eval_launches
    launches = {k: train_launches[k] + eval_launches[k] for k in LAUNCHES}
    return {"batch": batch, "steps": steps, "step_ms_runs": step_ms, "losses": losses,
            "reward": [m["reward"].item() for m in metrics],
            "grad_norm_last": algo.optimizer.grad_norm.item(), "max_parameter_change": moved,
            "evaluation": evaluation, "launches_per_step": want_step,
            "launches_evaluation": eval_launches, "launches": launches}, launches


def train_symnco(env, locs, device, batch=64, steps=2, val=64):
    """SymNCO on TSP-50 at AM's widths (batch norm): ``batch`` instances x 4
    symmetric copies x 50 starts, two steps (the grouped kernel at B 256,
    L 50, N 50: one launch per decode step), then `multistart_greedy_augment`
    on ``val`` committed instances (B 512: 8 copies of each)."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.zoo.symnco import SymNCO
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    torch.manual_seed(1234)
    algo = SymNCO(env, policy_kwargs=dict(device=device), num_augment=4,
                  num_starts=env.get_num_starts(),
                  train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    algo.reseed(51)
    per_step = {"pointer_step_single": 0, "pointer_step_grouped": env.max_steps}

    def evaluate():
        res = evaluate_policy(env, algo.policy, {"locs": locs[:val]}, "multistart_greedy_augment",
                              batch_size=val, check_solutions=True, warmup=False, device=device,
                              generator=torch.Generator(device=device).manual_seed(52))
        return {"method": "multistart_greedy_augment", "instances": val,
                "mean_cost": -res["mean_reward"]}

    report, launches = train_zoo(algo, batch, steps, evaluate, per_step, per_step)
    nonzero = {k for k in ("loss_ps", "loss_ss", "loss_inv") if report["losses"][k][0] != 0.0}
    assert nonzero == {"loss_ps", "loss_ss", "loss_inv"}, report["losses"]
    return {"model": "SymNCO: AM 128/8/3/512 batch norm + projection head, TSP-50, "
                     "4 symmetric augments x 50 starts", **report}, launches


def train_mvmoe(env, cvrp, device, batch=64, steps=2, val=64):
    """`MVMoE_POMO` on CVRP-50 at published widths (embed 128, 6 MoE layers, 8
    heads, FFN 512, 4 experts, top-2, instance norm): ``batch`` x 50 starts,
    two steps, then POMO's evaluation step (multistart greedy on dihedral-8)
    on ``val`` committed instances. Its pointer head is `pointer_logits` with
    an MoE projection: no kernel launches. Also returns the record of its
    first ``EP_STEPS`` steps (`record_updates`), which
    `drive_ep_mvmoe_cvrp50` replays."""
    algo = mvmoe_algorithm(env, device)
    p = algo.policy
    assert (p.num_encoder_layers, p.num_experts, p.moe_topk) == (6, 4, 2)
    algo.reseed(61)
    record = record_updates(algo, EP_STEPS)
    none = {"pointer_step_single": 0, "pointer_step_grouped": 0}
    eval_step = algo.make_eval_step()

    def evaluate():
        m = eval_step({k: v[:val] for k, v in cvrp.items()})
        return {"method": "multistart_greedy_augment_dihedral_8 (POMO's eval step)",
                "instances": val, "mean_cost": -m["reward"].item(),
                "cost_best_of_starts": -m["max_reward"].item(),
                "cost_best_of_starts_and_augments": -m["max_aug_reward"].item()}

    report, launches = train_zoo(algo, batch, steps, evaluate, none, none)
    return {"model": "MVMoE-POMO 128/8/6/512, 4 experts top-2, instance norm, CVRP-50, "
                     "50 starts", **report}, launches, record


def train_polynet(env, locs, device, batch=64, steps=2, val=64):
    """PolyNet on TSP-50 at AM's widths (k 64, poly layer 256): ``batch`` x 64
    samples, two steps, then its evaluation step (64 samples) on ``val``
    committed instances. Its pointer head is `pointer_logits` with the poly
    layers: no kernel launches."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.zoo.polynet import PolyNet

    torch.manual_seed(1234)
    algo = PolyNet(env, k=64, policy_kwargs=dict(poly_layer_dim=256, device=device),
                   train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    algo.reseed(71)
    none = {"pointer_step_single": 0, "pointer_step_grouped": 0}
    eval_step = algo.make_eval_step()

    def evaluate():
        m = eval_step({"locs": locs[:val]})
        return {"samples": algo.val_num_solutions, "instances": val,
                "mean_cost": -m["reward"].item(), "cost_best_of_samples": -m["max_reward"].item()}

    report, launches = train_zoo(algo, batch, steps, evaluate, none, none)
    return {"model": "PolyNet: AM 128/8/3/512 batch norm, k 64, poly layer 256, TSP-50",
            **report}, launches


# ---------------------------------- the mixed OP + PCTSP configuration, CLIs

MULTIENV_NAMES = ("op", "pctsp")
# per-instance and mean rewards against the JAX package's CPU greedy rewards
MULTIENV_ATOL, MULTIENV_SAME_SHARE = 1e-5, 0.99
# OP's greedy reward on the validation set must rise by at least this much
# over the 100 steps (50 OP, then 50 PCTSP) of `cli_train_multienv`; stated in
# PERF.md before the first run (JAX CPU: the untrained JAX policy's greedy
# reward on OP-20 is 1.41; the TPU run's sampled OP reward went from 1.49 to
# 3.76 in its first 200 steps, `runs/mixed_op_pctsp.jsonl`)
OP_GAIN_MARGIN = 0.5
# the JAX package's greedy mean cost of the AM TSP-50 checkpoint on the
# canonical 10 000 instances (`golden/am_tsp50_costs.npz`, dispatch 8192)
AM_TSP50_GREEDY = 5.794379


def record_launch_shapes():
    """Wrap the kernels' launch function so that every launch also records
    its ``(kernel, B, L, N)``; returns the list it fills and the undo."""
    from rl4co_tpu_torch.ops import pointer_kernel

    inner, seen = pointer_kernel._launch, []

    def launch(q, k, *args):
        b, n, _ = k.shape
        seen.append(("pointer_step_single", b, None, n) if q.ndim == 2
                    else ("pointer_step_grouped", b, q.shape[1], n))
        return inner(q, k, *args)

    pointer_kernel._launch = launch

    def undo():
        pointer_kernel._launch = inner

    return seen, undo


def drive_golden_multienv(device):
    """The JAX package's full-width multi-env parameters
    (`golden/multienv_op_pctsp_params.npz`) in `MultiEnvAttentionPolicy`:
    greedy on the 1 024 OP-20 and 1 024 PCTSP-20 golden instances, one
    dispatch each through ``for_env``, every tour checked; rewards against
    the JAX CPU rewards. Launch counts start at 0 here and are read at the end."""
    from rl4co_tpu_torch.convert import load_params, load_params_npz
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.policies.multi_env import MultiEnvAttentionPolicy
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    policy = load_params(MultiEnvAttentionPolicy(device=device),
                         load_params_npz(os.path.join(GOLDEN, "multienv_op_pctsp_params.npz")))
    policy.eval()
    with np.load(os.path.join(GOLDEN, "multienv_op_pctsp_costs.npz")) as f:
        golden = {k: f[k] for k in f.files}
    dispatch = int(golden["dispatch"])
    report, total = {}, {k: 0 for k in LAUNCHES}
    for name in MULTIENV_NAMES:
        env = get_env(name, num_loc=20)
        inst = {k.split("/", 1)[1]: v for k, v in golden.items()
                if k.startswith(name + "/") and k != f"{name}/greedy"}
        ref = golden[f"{name}/greedy"]
        reset_launches()
        res = evaluate_policy(env, policy.for_env(name), inst, "greedy", batch_size=dispatch,
                              check_solutions=True, warmup=False, device=device)
        counts = dict(LAUNCHES)
        want = {"pointer_step_single": env.max_steps, "pointer_step_grouped": 0}
        assert counts == want, f"golden {name}: launches {counts}, expected {want}"
        for k in total:
            total[k] += counts[k]
        r = res["rewards"]
        assert r.shape == ref.shape == (dispatch,) and np.isfinite(r).all()
        err = np.abs(r - ref)
        mean_err = abs(float(r.mean()) - float(ref.mean()))
        same = float((err <= MULTIENV_ATOL).mean())
        assert mean_err <= MULTIENV_ATOL, f"golden {name}: mean off by {mean_err:.2e}"
        assert same >= MULTIENV_SAME_SHARE, f"golden {name}: only {same:.4f} within 1e-5"
        report[name] = {"instances": dispatch, "dispatch": dispatch,
                        "mean_reward": float(r.mean()), "reference_mean_reward": float(ref.mean()),
                        "mean_abs_err": mean_err, "share_within_1e-5": same,
                        "max_abs_err": float(err.max()), "tours_valid": 1.0,
                        "seconds_with_validity_check": res["inference_time"],
                        "launches": counts}
    return {"model": "multi-env AM 128/8/3/512 batch norm, OP-20 + PCTSP-20, "
                     "JAX-initialised weights (key 0)",
            "tolerances": {"atol": MULTIENV_ATOL, "same_share": MULTIENV_SAME_SHARE},
            "envs": report, "launches": total}, total


def instrument_updates(cls):
    """Wrap ``cls.update`` so that every train step is synchronised, timed and
    its kernel launches counted (``args[0]``, the env's name where the
    algorithm takes one, is recorded); returns the list it fills and the undo."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    inner, steps = cls.update, []

    def update(self, *args, **kwargs):
        torch.cuda.synchronize()
        before, t0 = dict(LAUNCHES), time.perf_counter()
        metrics = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        steps.append({"env": args[0] if isinstance(args[0], str) else None,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "loss": metrics["loss"].item(),
                      "metrics": {k: v.item() for k, v in metrics.items()
                                  if isinstance(v, torch.Tensor)},
                      "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}})
        return metrics

    cls.update = update

    def undo():
        cls.update = inner

    return steps, undo


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_cli_multienv(device, tmp, batch=512, steps=100, val=1024, margin=OP_GAIN_MARGIN):
    """BASELINE.json's mixed configuration through the train CLI in-process:
    ``--model am-multienv --env op,pctsp`` at OP-20 / PCTSP-20, batch 512,
    51 200 instances (100 steps, dispatched in two blocks of 50: OP, then
    PCTSP), validation on 1 024, the default bf16-mixed. OP's greedy reward
    on the trainer's validation set, with the untrained policy that `build`
    gives for the same spec and seed and with the trained one, must rise by
    OP_GAIN_MARGIN. Then one more step per env under the profiler. Launch
    counts start at 0 just before `main` and are read just after."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.multi_env import MultiEnvREINFORCE
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.trainer import _STREAM_VAL

    size = steps * batch
    log = os.path.join(tmp, "multienv.jsonl")
    argv = ["--model", "am-multienv", "--env", "op,pctsp", "--num-loc", "20",
            "--batch-size", str(batch), "--train-size", str(size), "--epochs", "1",
            "--val-size", str(val), "--ckpt-dir", os.path.join(tmp, "multienv"),
            "--log-file", log, "--device", str(device)]
    spec = train.WorkloadSpec(env_name="op,pctsp", env_kwargs=(("num_loc", 20),),
                              model="am-multienv", epochs=1, batch_size=batch,
                              train_data_size=size, val_data_size=val, device=str(device))
    untrained, _ = train.build(spec)
    assert untrained.train_spec.compute_dtype == "bfloat16"
    op = untrained.envs["op"]
    fixed = op.generate(val, seeded_generator(device, spec.seed, _STREAM_VAL), device)
    before = untrained.make_eval_step()(fixed)["reward"].item()
    del untrained
    done, undo = instrument_updates(MultiEnvREINFORCE)
    try:
        reset_launches()
        algo = train.main(argv)
        launches = dict(LAUNCHES)
    finally:
        undo()
    per_step = {"pointer_step_single": op.max_steps, "pointer_step_grouped": 0}
    # blocks of the largest divisor of the steps up to `log_every` (50), the
    # envs in turns from the first: 50 OP steps, then 50 PCTSP steps
    chunk = max(c for c in range(1, min(50, steps) + 1) if steps % c == 0)
    blocks = [(MULTIENV_NAMES[d % 2], chunk) for d in range(steps // chunk)]
    sequence = [s["env"] for s in done]
    assert sequence == [n for n, c in blocks for _ in range(c)], sequence
    assert all(s["launches"] == per_step for s in done), [s["launches"] for s in done]
    # + the one greedy validation dispatch of OP
    assert launches == {"pointer_step_single": (len(done) + 1) * op.max_steps,
                        "pointer_step_grouped": 0}, launches
    assert all(np.isfinite(s["loss"]) for s in done)
    records = read_jsonl(log)
    epoch = [r for r in records if "val/reward" in r][-1]
    after = algo.make_eval_step()(fixed)["reward"].item()
    assert abs(after - epoch["val/reward"]) <= 1e-5 * max(1.0, abs(after)), (after, epoch)
    assert after - before >= margin, (
        f"OP's greedy reward went from {before:.4f} to {after:.4f}: less than the margin {margin}")
    ms = {name: statistics.median(s["ms"] for s in done if s["env"] == name)
          for name in MULTIENV_NAMES}
    profiled = {}
    for name in MULTIENV_NAMES:
        env = algo.envs[name]
        inst = env.generate(batch, algo.generator, device)
        _, busy, n_launches, top = device_profile(lambda: algo.update(name, inst))
        profiled[name] = {"device_busy_ms": busy, "device_launches": n_launches,
                          "device_busy_share_of_median_step":
                              None if busy is None else busy / ms[name],
                          "top_kernels": top}
    return {"model": "am-multienv 128/8/3/512 batch norm, OP-20 + PCTSP-20, bf16-mixed, "
                     "exponential baseline per env, Adam 1e-4",
            "argv": argv, "steps": len(done), "env_blocks": blocks,
            "step_ms_median": ms,
            "env_steps_per_s": {n: batch * algo.envs[n].max_steps / ms[n] * 1e3 for n in ms},
            "epoch_env_steps_per_s": epoch["env_steps_per_s"], "epoch_s": epoch["time/epoch_s"],
            "step_ms_runs": [round(s["ms"], 3) for s in done],
            "losses_first_last_per_block": [(done[i]["loss"], done[i + c - 1]["loss"])
                                            for i, (_, c) in zip(range(0, steps, chunk), blocks)],
            "op_greedy_reward_before": before, "op_greedy_reward_after": after,
            "op_gain": after - before, "margin": margin,
            "launches_per_step": per_step, "launches": launches,
            "profiled_step": profiled}, launches


def train_cli_ptrnet(device, tmp):
    """PtrNet (embed and hidden 128: Bello et al.'s widths, the JAX defaults)
    on TSP-50 through the train CLI: batch 512, two steps, validation on 1
    024. Its LSTMs and additive pointer reach no kernel. Launch counts start
    at 0 just before `main` and are read just after."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.models.zoo.ptrnet import PointerNetworkModel
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    argv = ["--model", "ptrnet", "--env", "tsp", "--num-loc", "50", "--batch-size", "512",
            "--train-size", "1024", "--epochs", "1", "--val-size", "1024",
            "--log-file", os.path.join(tmp, "ptrnet.jsonl"), "--device", str(device)]
    steps, undo = instrument_updates(PointerNetworkModel)
    try:
        reset_launches()
        algo = train.main(argv)
        launches = dict(LAUNCHES)
    finally:
        undo()
    assert sum(launches.values()) == 0, launches
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps), steps
    assert (algo.policy.embed_dim, algo.policy.hidden_dim) == (128, 128)
    assert np.isfinite(algo.baseline_value.item())
    epoch = [r for r in read_jsonl(os.path.join(tmp, "ptrnet.jsonl")) if "val/reward" in r][-1]
    assert np.isfinite(epoch["val/reward"])
    return {"model": "PtrNet embed 128 hidden 128, TSP-50, moving baseline, Adam 1e-4, f32",
            "argv": argv, "step_ms_runs": [s["ms"] for s in steps],
            "losses": [s["loss"] for s in steps], "val_cost": -epoch["val/reward"],
            "launches": launches}, launches


def eval_cli_checkpoint(device, ckpt_greedy_mean_cost, ckpt_rel_tol):
    """The eval CLI in-process on the AM TSP-50 checkpoint's params npz and
    the committed test set, at the dispatch of phase `ckpt_am_tsp50`'s greedy
    sweep, whose mean it must repeat. Launch counts start at 0 just before
    `main` and are read just after."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks import eval_cli

    argv = ["--problem", "tsp", "--num-loc", "50", "--method", "greedy",
            "--ckpt-path", os.path.join(GOLDEN, "am_tsp50_params.npz"),
            "--data-path", os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz"),
            "--batch-size", "8192", "--device", str(device)]
    reset_launches()
    res = eval_cli.main(argv)
    counts = dict(LAUNCHES)
    # the warm-up, one full dispatch and the padded tail: 50 steps each
    assert counts == {"pointer_step_single": 3 * 50, "pointer_step_grouped": 0}, counts
    diff = abs(res["mean_reward"] + ckpt_greedy_mean_cost)
    assert diff <= 1e-6, f"eval CLI: {res['mean_reward']} against {-ckpt_greedy_mean_cost}"
    golden_rel = abs(-res["mean_reward"] - AM_TSP50_GREEDY) / AM_TSP50_GREEDY
    assert golden_rel <= ckpt_rel_tol, golden_rel
    return {"argv": argv, "mean_reward": res["mean_reward"],
            "phase_ckpt_am_tsp50_mean_cost": ckpt_greedy_mean_cost, "abs_diff": diff,
            "golden_mean_cost": AM_TSP50_GREEDY, "golden_rel_err": golden_rel,
            "instances_per_s": res["instances_per_s"], "launches": counts}, counts


def eval_cli_op_multistart(device, size=1000):
    """The eval CLI in-process: OP-20 multistart greedy on ``size`` generated
    instances, randomly initialised AM, at the default dispatch (8192 // 20 =
    409 instances x 20 starts through the grouped kernel). Launch counts
    start at 0 just before `main` and are read just after."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks import eval_cli

    argv = ["--problem", "op", "--num-loc", "20", "--method", "multistart_greedy",
            "--size", str(size), "--device", str(device)]
    shapes, undo = record_launch_shapes()
    try:
        reset_launches()
        res = eval_cli.main(argv)
        counts = dict(LAUNCHES)
    finally:
        undo()
    dispatch = 8192 // 20
    assert res["batch_size"] == dispatch and res["rewards"].shape == (size,)
    assert np.isfinite(res["rewards"]).all()
    # the warm-up, the full dispatches and the padded tail: 22 steps each
    want = (1 + -(-size // dispatch)) * 22
    assert counts == {"pointer_step_single": 0, "pointer_step_grouped": want}, counts
    assert set(shapes) == {("pointer_step_grouped", dispatch, 20, 21)}, set(shapes)
    return {"argv": argv, "mean_reward": res["mean_reward"], "dispatch": res["batch_size"],
            "kernel_shapes": sorted(set(shapes)), "instances_per_s": res["instances_per_s"],
            "launches": counts}, counts


# ------------------------------------------- the NAR configuration, TSP-500

# BASELINE.json's NAR configuration: DeepACO on TSP-500 (`runs/nar_tsp500.py`).
# The JAX package's initial weights and its 128 evaluation instances, with the
# JAX CPU costs, are `golden/deepaco_tsp500_{params,costs}.npz`
# (`python tests/test_torch_deepaco.py`). Greedy costs: the mean within
# NAR_MEAN_RTOL of the JAX CPU mean and NAR_SAME_SHARE of the costs within
# NAR_COST_RTOL, in the reference's dispatches of 32 (batch norm). The Ant
# System (20 ants, 10 iterations, the local search between iterations) draws
# from the port's own random stream: its mean best cost must fall inside the
# band the golden file records from three JAX seeds (their range widened by
# the larger of three standard deviations of the seed means and 0.2 % of
# their mean; stated in PERF.md before the first run).
NAR_MEAN_RTOL, NAR_COST_RTOL, NAR_SAME_SHARE = 1e-4, 1e-5, 0.99
# per-ant log-likelihoods and rewards of the replayed tours against JAX's
NAR_REPLAY_RTOL = 1e-5
ACO_PROFILED_ITERATIONS = 2   # of an ACO dispatch's 10, under the profiler
# the TPU run's artifact (`runs/nar_tsp500.json`, TPU v5e): printed beside the
# result, not asserted: it polished only the best ant once, after the loop
NAR_TPU_ARTIFACT = {"untrained": 17.4788, "trained": 17.3602,
                    "protocol": "ACO without local search in the loop, the best ant "
                                "polished by 2-opt after it"}


def nar_golden():
    from rl4co_tpu_torch.convert import load_params_npz

    with np.load(os.path.join(GOLDEN, "deepaco_tsp500_costs.npz")) as f:
        golden = {k: f[k] for k in f.files}
    return load_params_npz(os.path.join(GOLDEN, "deepaco_tsp500_params.npz")), golden


def nar_algorithm(algo_cls, tree, device, **kw):
    """``algo_cls`` (DeepACO) on TSP-500 at the published widths with the
    golden weights."""
    from rl4co_tpu_torch.convert import load_params
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.nargnn import NARGNNEncoder

    encoder = load_params(NARGNNEncoder("tsp", device=device), tree)
    return algo_cls(get_env("tsp", num_loc=500), encoder=encoder, device=device, **kw)


def sync_ms(fn):
    """``fn()`` and its wall ms, the device synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def drive_golden_deepaco(device, count=128):
    """The JAX package's initial DeepACO weights on its TSP-500 evaluation
    instances, in its dispatches of 32: (a) the NAR greedy rollout, costs
    against the JAX CPU costs, every tour checked; (b) the Ant System with the
    host local search between iterations, its mean best cost against the
    JAX seeds' band, every best tour checked; one ACO dispatch under the
    profiler. No pointer kernel lies on this path: launch counts start at 0
    here and must stay 0."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.policies.nonautoregressive import nar_rollout
    from rl4co_tpu_torch.models.zoo.deepaco import DeepACO, run_ant_system
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import seeded_generator

    tree, golden = nar_golden()
    algo = nar_algorithm(DeepACO, tree, device, n_ants_eval=20, n_iterations_eval=10,
                         use_local_search=True)
    env, dispatch = algo.env, int(golden["greedy/dispatch"])
    locs = golden["locs"][:count]
    chunks = [{"locs": locs[i:i + dispatch]} for i in range(0, count, dispatch)]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()

    greedy, greedy_ms = [], []
    for chunk in chunks:
        def run(chunk=chunk):
            with torch.no_grad():
                return nar_rollout(env, chunk, algo.heatmap(chunk), DecodeSpec(kind="greedy"))
        out, ms = sync_ms(run)
        greedy_ms.append(ms)
        actions = out.actions.cpu().numpy()
        for b in range(actions.shape[0]):
            env.check_solution_validity({}, actions[b])
        greedy.append(-out.reward.cpu().numpy())
    greedy = np.concatenate(greedy)
    ref = golden["greedy"][:count]
    rel = np.abs(greedy - ref) / ref
    mean_rel = abs(float(greedy.mean()) - float(ref.mean())) / float(ref.mean())
    same = float((rel <= NAR_COST_RTOL).mean())
    assert np.isfinite(greedy).all() and greedy.shape == ref.shape
    assert mean_rel <= NAR_MEAN_RTOL, f"NAR greedy mean off by {mean_rel:.2e} relative"
    assert same >= NAR_SAME_SHARE, f"only {same:.4f} of the greedy costs within 1e-5"

    gen = seeded_generator(device, 4321)
    host_ls, ls_seconds = algo.local_search_fn(), []

    def ls(*args):  # the host local search, timed
        t0 = time.perf_counter()
        out = host_ls(*args)
        ls_seconds.append(time.perf_counter() - t0)
        return out

    def aco(chunk):
        with torch.no_grad():
            return run_ant_system(env, chunk, algo.heatmap(chunk), gen, n_ants=20,
                                  n_iterations=10, local_search_fn=ls)

    t_aco = time.perf_counter()
    aco_costs, aco_ms = [], []
    for chunk in chunks:
        (best_actions, best_reward, trace), ms = sync_ms(lambda chunk=chunk: aco(chunk))
        aco_ms.append(ms)
        assert (torch.diff(trace) >= 0).all()
        best_actions = best_actions.cpu().numpy()
        for b in range(best_actions.shape[0]):
            env.check_solution_validity({}, best_actions[b])
        aco_costs.append(-best_reward.cpu().numpy())
    aco_costs = np.concatenate(aco_costs)
    peak = torch.cuda.max_memory_allocated()
    aco_s, ls_s = time.perf_counter() - t_aco, sum(ls_seconds)
    seeds = {k: float(v.mean()) for k, v in golden.items() if k.startswith("aco/seed")}
    lo, hi = (float(x) for x in golden["aco/band"])
    aco_mean = float(aco_costs.mean())
    assert np.isfinite(aco_costs).all()
    if count == len(golden["locs"]):  # the band is that of the seeds' means over all
        assert lo <= aco_mean <= hi, (
            f"ACO mean cost {aco_mean:.5f} outside the JAX seeds' band [{lo:.5f}, {hi:.5f}]")
    launches = dict(LAUNCHES)
    assert sum(launches.values()) == 0, launches

    # under the profiler a dispatch's first ACO_PROFILED_ITERATIONS of its 10
    # iterations (the whole dispatch took a minute under it, 8 s without),
    # beside their wall time without it
    def aco_part():
        with torch.no_grad():
            return run_ant_system(env, chunks[0], algo.heatmap(chunks[0]), gen, n_ants=20,
                                  n_iterations=ACO_PROFILED_ITERATIONS, local_search_fn=ls)

    t_profile = time.perf_counter()
    _, part_ms = sync_ms(aco_part)
    _, busy, n_launches, top = device_profile(aco_part, host=False)
    profile_s = time.perf_counter() - t_profile
    return {"model": "DeepACO NARGNN embed 64, 15 GNN layers, 5 heatmap layers, k 100, "
                     "TSP-500, JAX-initialised weights (key 1234)",
            "instances": count, "dispatch": dispatch,
            "greedy": {"mean_cost": float(greedy.mean()),
                       "reference_mean_cost": float(ref.mean()), "mean_rel_err": mean_rel,
                       "share_within_1e-5": same, "max_rel_err": float(rel.max()),
                       "tours_valid": 1.0, "wall_ms_per_dispatch": greedy_ms},
            "aco": {"ants": 20, "iterations": 10, "local_search": "neighbour-list 2-opt + "
                    "Or-opt on every ant, between iterations (host)",
                    "mean_cost": aco_mean, "band": [lo, hi], "jax_seed_means": seeds,
                    "tours_valid": 1.0, "wall_s_per_dispatch": [ms / 1e3 for ms in aco_ms],
                    "host_local_search_share_of_wall": ls_s / aco_s},
            "seconds": {"aco": aco_s, "profiled_dispatch": profile_s},
            "tpu_artifact_for_information": NAR_TPU_ARTIFACT,
            "peak_memory_bytes": peak,
            "profiled_aco_dispatch": {
                "iterations": ACO_PROFILED_ITERATIONS, "wall_ms_unprofiled": part_ms,
                "device_busy_ms": busy, "device_launches": n_launches,
                "device_busy_share": None if busy is None else busy / part_ms,
                "top_kernels": top},
            "tolerances": {"mean_rtol": NAR_MEAN_RTOL, "cost_rtol": NAR_COST_RTOL,
                           "same_share": NAR_SAME_SHARE},
            "launches": launches}, launches


def check_deepaco_gradients(device):
    """The loss and every gradient of DeepACO at full width on the golden
    file's two instances x 20 ants, the JAX package's sampled tours replayed,
    against its loss and gradients (LOSS_RTOL; GRAD_RTOL plus GRAD_ATOL of the
    largest gradient)."""
    from rl4co_tpu_torch.convert import convert_params
    from rl4co_tpu_torch.models.zoo.deepaco import DeepACO

    tree, golden = nar_golden()
    algo = nar_algorithm(DeepACO, tree, device, n_ants_train=20)
    inst = {"locs": golden["locs"][golden["replay/instances"]]}
    grad_tree: dict = {}
    for key, leaf in golden.items():
        if key.startswith("grad/"):
            *parents, name = key[len("grad/"):].split("/")
            node = grad_tree
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
    want = {k: v.to(device) for k, v in convert_params(grad_tree).items()}
    (loss, (_, out)), ms = sync_ms(lambda: algo.loss(inst, golden["replay/actions"]))
    _, backward_ms = sync_ms(loss.backward)
    assert np.array_equal(out.actions.cpu().numpy(), golden["replay/actions"])
    per_ant = {}
    for key in ("log_likelihood", "reward"):
        got, ref = getattr(out, key).detach().cpu().numpy(), golden[f"replay/{key}"]
        per_ant[f"{key}_max_rel_err"] = float((np.abs(got - ref) / np.abs(ref)).max())
        assert per_ant[f"{key}_max_rel_err"] <= NAR_REPLAY_RTOL, (key, per_ant)
    # the loss -mean(advantage · log-likelihood) cancels: about 6 from terms of
    # about 900 (log-likelihoods near -1 750, rewards near 67), so one f32 ulp of
    # a reward moves it by 1e-3 of itself; its tolerance is relative to the
    # mean magnitude of its terms
    reward = golden["replay/reward"].reshape(20, -1)
    terms = (reward - reward.mean(axis=0)) * golden["replay/log_likelihood"].reshape(20, -1)
    report = check_gradients({n: p.grad for n, p in algo.policy.named_parameters()}, want,
                             loss.item(), float(golden["replay/loss"]),
                             what="the port and the JAX package",
                             loss_scale=float(np.abs(terms).mean()))
    return {"instances": 2, "ants": 20, "loss": loss.item(),
            "reference_loss": float(golden["replay/loss"]), "loss_ms": ms,
            "backward_ms": backward_ms, "per_ant_rtol": NAR_REPLAY_RTOL, **per_ant, **report}


def train_cli_nar(device, tmp, model, steps, batch=12, val=12, num_loc=500):
    """``--model deepaco|gfacs --env tsp --num-loc 500`` through the train
    CLI in-process (`train_cli`): ``steps`` steps at ``batch``
    (`runs/nar_tsp500.py`'s), one epoch, the trainer's ACO validation on
    ``val`` instances, no pointer kernel launched."""
    from rl4co_tpu_torch.models.zoo.deepaco import DeepACO

    report, launches = train_cli(device, tmp, model, "tsp", num_loc,
                                 ["--batch-size", str(batch), "--train-size", str(steps * batch),
                                  "--val-size", str(val)], steps, DeepACO)
    assert sum(launches.values()) == 0, launches
    algo = report.pop("algo")
    return {"model": f"{model} NARGNN embed 64, 15 GNN layers, TSP-{num_loc}, "
                     f"{algo.n_ants_train} ants, Adam 1e-4, f32", **report}, launches


# ------------------------------ the multi-task VRP family at N 50 (+ depot)

# AM (Kool et al.'s widths) on 1 024 instances of each routing env in one
# dispatch, and multistart greedy (50 starts) on the first 256 of the two
# envs with CVRP's starts; POMO (Kwon et al.'s) on 1 024 MTVRP-50 instances of
# the "all" preset in dispatches of 512. Weights: `random_params_numpy` at the
# golden files' seed; instances and JAX CPU costs: the golden files
# (`python tests/test_torch_env_mtvrp.py`). Held as the checkpoints are: the
# mean within ROUTING_MEAN_RTOL of the JAX mean, ROUTING_SAME_SHARE of the
# costs within ROUTING_COST_RTOL, every tour valid.
ROUTING_ENVS = ("cvrptw", "sdvrp", "pdp", "mtsp", "shpp")
ROUTING_MULTISTART = ("cvrptw", "sdvrp")
# the rest of the routing envs, CVRPMVC (multistart through K1), SVRP, mPDP
# and MDCPDP (3 agents each): `python tests/test_torch_env_svrp_mpdp.py`
ROUTING_REST = ("cvrpmvc", "svrp", "mpdp", "mdcpdp")
ROUTING_REST_MULTISTART = ("cvrpmvc",)
ROUTING_MEAN_RTOL, ROUTING_COST_RTOL, ROUTING_SAME_SHARE = 1e-4, 1e-5, 0.99
POMO_ARCH = dict(num_encoder_layers=6, normalization="instance", use_graph_context=False)


def golden_npz(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


def by_prefix(flat, prefix):
    """``{"<prefix>/<key>": array}`` -> ``{key: array}``."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def mtvrp_masks(rs, shape, n, device):
    """Masks ``shape + (n,)`` of real MTVRP-(n-1) states (preset ``all``: time
    windows, backhauls, limits, open routes): each row's instance is walked
    by random feasible actions for a number of steps drawn in [0, 2(n-1));
    finished rows see the depot alone."""
    from rl4co_tpu_torch.envs import get_env

    rows = int(np.prod(shape))
    env = get_env("mtvrp", num_loc=n - 1)
    gen = torch.Generator(device=device).manual_seed(int(rs.randint(2**31)))
    state = env.reset(env.generate(rows, gen, device=device))
    stop = torch.from_numpy(rs.randint(0, env.max_steps, size=rows)).to(device)
    out = torch.zeros((rows, n), dtype=torch.bool, device=device)
    for t in range(env.max_steps):
        mask = env.action_mask(state)
        out[stop == t] = mask[stop == t]
        scores = torch.where(mask, torch.rand(mask.shape, generator=gen, device=device), -1.0)
        state = env.step(state, scores.argmax(dim=-1))
    return out.reshape(*shape, n).cpu().numpy()


def hold_costs(cost, ref, what):
    """Per-instance costs against the JAX CPU costs at the routing tolerances."""
    assert cost.shape == ref.shape and np.isfinite(cost).all(), (what, cost.shape, ref.shape)
    rel = np.abs(cost - ref) / np.abs(ref)
    mean, ref_mean = float(cost.mean()), float(ref.mean())
    mean_rel = abs(mean - ref_mean) / abs(ref_mean)
    same = float((rel <= ROUTING_COST_RTOL).mean())
    assert mean_rel <= ROUTING_MEAN_RTOL, f"{what}: mean off by {mean_rel:.2e}"
    assert same >= ROUTING_SAME_SHARE, f"{what}: only {same:.4f} of costs within 1e-5"
    return {"instances": len(ref), "mean_cost": mean, "reference_mean_cost": ref_mean,
            "mean_rel_err": mean_rel, "share_within_1e-5": same,
            "share_within_1e-4": float((rel <= 1e-4).mean()), "max_rel_err": float(rel.max())}


# a tour that leaves the JAX package's where the port's two best actions lie
# within this many nats of each other left it at a near-tie of f32 rounding
ROUTING_TIE_ATOL = 1e-5


def greedy_departures(env, policy, inst, jax_actions, device):
    """The JAX package's greedy tours replayed through ``policy`` in one
    dispatch (the encoder on all of ``inst``, as the golden dispatch): per
    row, the first step where the port's own greedy choice leaves JAX's
    tour (-1: never) and the log-probability gap there between the two."""
    from rl4co_tpu_torch.decoding import DecodeSpec, process_logits_spec

    spec = DecodeSpec(kind="greedy", tanh_clipping=10.0)
    inst = {k: torch.as_tensor(v).to(device) for k, v in inst.items()}
    acts = torch.as_tensor(jax_actions.astype(np.int64)).to(device)
    with torch.no_grad():
        cache = policy.precompute(policy.encode(inst))
        state = env.reset(inst)
        first = torch.full((acts.shape[0],), -1, dtype=torch.long, device=device)
        gap = torch.zeros((acts.shape[0],), device=device)
        for t in range(acts.shape[1]):
            mask = env.action_mask(state)
            lp = process_logits_spec(policy.decode_step(cache, state, mask).float(), mask, spec)
            own = lp.argmax(dim=-1)
            leave = (own != acts[:, t]) & (first < 0) & ~state.done
            g = (lp.gather(1, own[:, None]) - lp.gather(1, acts[:, t:t + 1]))[:, 0]
            gap = torch.where(leave, g, gap)
            first = torch.where(leave, t, first)
            state = env.step(state, acts[:, t])
    return first.cpu().numpy(), gap.cpu().numpy()


def hold_costs_at_ties(cost, ref, first, gap, what):
    """Per-instance costs against the JAX CPU costs, each departure from
    JAX's tour accounted for: every row that never leaves it within
    ROUTING_COST_RTOL, every departure at a near-tie (gap at most
    ROUTING_TIE_ATOL), at most 1 - ROUTING_SAME_SHARE of the rows departed,
    ROUTING_SAME_SHARE of all costs within ROUTING_COST_RTOL, and the mean of
    the rows not departed at a near-tie within ROUTING_MEAN_RTOL of theirs."""
    rel = np.abs(cost - ref) / np.abs(ref)
    left = first >= 0
    assert (gap[left] <= ROUTING_TIE_ATOL).all(), (
        f"{what}: left JAX's tour {int((gap[left] > ROUTING_TIE_ATOL).sum())} times with "
        f"gaps up to {gap[left].max():.3e}")
    assert (rel[~left] <= ROUTING_COST_RTOL).all(), f"{what}: a tour as JAX's, another cost"
    assert left.mean() <= 1 - ROUTING_SAME_SHARE, f"{what}: {int(left.sum())} rows departed"
    report = hold_costs(cost[~left], ref[~left], what)
    same = float((rel <= ROUTING_COST_RTOL).mean())
    assert same >= ROUTING_SAME_SHARE, f"{what}: only {same:.4f} of costs within 1e-5"
    return {**report, "instances": len(ref), "share_within_1e-5": same,
            "near_tie_departures": int(left.sum()),
            "near_tie_gaps": [float(x) for x in gap[left]],
            "departed_rel_err": [float(x) for x in rel[left]],
            "mean_rel_err_all": float(abs(cost.mean() - ref.mean()) / abs(ref.mean()))}


def hold_costs_unstable(cost, ref, first, gap, self_departed, self_mean_rel, what):
    """Per-instance costs against the JAX CPU costs where the reference does
    not reproduce its own tours: the JAX package's greedy dispatch on the
    same instances in another order (the same sums, in another order) leaves
    its own tours on ``self_departed`` rows and moves the mean by
    ``self_mean_rel`` (MCP with seeded weights: its sets' embeddings reach
    the hundreds and the encoder's attention turns an ulp into 1e-4 of a
    logit). Every row whose tour is JAX's within ROUTING_COST_RTOL, and the
    mean within ROUTING_MEAN_RTOL raised to NOISE_FACTOR times the
    reference's own largest drift ``self_mean_rel``; the departures and
    their gaps are reported beside the reference's own count."""
    rel = np.abs(cost - ref) / np.abs(ref)
    left = first >= 0
    assert (rel[~left] <= ROUTING_COST_RTOL).all(), f"{what}: a tour as JAX's, another cost"
    mean_rel = float(abs(cost.mean() - ref.mean()) / abs(ref.mean()))
    bound = max(ROUTING_MEAN_RTOL, NOISE_FACTOR * self_mean_rel)
    assert mean_rel <= bound, f"{what}: mean off by {mean_rel:.2e}, bound {bound:.2e}"
    return {"instances": len(ref), "mean_cost": float(cost.mean()),
            "reference_mean_cost": float(ref.mean()), "mean_rel_err": mean_rel,
            "mean_bound": bound, "share_within_1e-5": float((rel <= ROUTING_COST_RTOL).mean()),
            "departed_rows": int(left.sum()), "reference_self_departed_rows": int(self_departed),
            "reference_self_mean_rel": float(self_mean_rel),
            "departure_gap_max": float(gap[left].max()) if left.any() else 0.0,
            "departure_gap_median": float(np.median(gap[left])) if left.any() else 0.0}


def routing_policy(name, device, seed, pointer_impl="kernel", **arch):
    """AM (or POMO with ``arch``) on ``name`` at full width, the golden seed's
    weights, in eval mode on ``device``."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.models import AttentionModelPolicy

    policy = AttentionModelPolicy(env_name=name, device=device, pointer_impl=pointer_impl,
                                  **arch)
    return load_params(policy, random_params_numpy(seed, env_name=name, **arch)).eval()


def check_xla_tanh(device, seed=5):
    """`decoding.xla_tanh` (the JAX package's f32 tanh, held bit for bit to
    `jnp.tanh` on the CPU by `tests/test_torch_decoding.py`) gives on the card
    what it gives on the CPU, bit for bit: every f32 from 5 to 8.5, both
    signs, where clipped logits sit within a few ulps of the clip, and 2
    million spread over [-9.5, 9.5]."""
    from rl4co_tpu_torch.decoding import xla_tanh

    window = np.arange(np.float32(5.0).view(np.int32), np.float32(8.5).view(np.int32),
                       dtype=np.int32).view(np.float32)
    spread = np.random.RandomState(seed).uniform(-9.5, 9.5, 2_000_000).astype(np.float32)
    x = torch.from_numpy(np.concatenate([window, -window, spread]))
    want = xla_tanh(x).numpy()
    got = xla_tanh(x.to(device)).cpu().numpy()
    differ = int((got != want).sum())
    assert differ == 0, f"xla_tanh differs between the card and the CPU in {differ} values"
    return {"values": len(want), "differ": differ}


def drive_golden_routing(device, envs=ROUTING_ENVS, multistart=ROUTING_MULTISTART,
                         golden="routing_envs", env_kwargs=None):
    """AM on CVRPTW-50, SDVRP-50, PDP-50, mTSP-50 (5 agents) and SHPP-50:
    greedy on 1 024 in one dispatch, multistart greedy on 256 of CVRPTW (the
    grouped kernel, 50 queries per instance) and SDVRP (its dynamic embedding:
    the cache tiled per start, the single-query kernel on 12 800 rows with new
    K/V at every step), `evaluate_policy` with `check_solutions`; with
    ``envs``, ``multistart`` and ``golden`` (the files' prefix) another set of
    envs, CVRPMVC, SVRP, mPDP and MDCPDP (`ROUTING_REST`), or SMTWTP, DPP,
    MDPP, FLP and MCP (`ENVS_10B`, each at the size ``env_kwargs`` gives it,
    N 50 for the routing envs). Launch counts
    start at 0 before each dispatch and are read after it, with the shapes
    each kernel was launched at."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    insts, costs = golden_npz(f"{golden}_instances.npz"), golden_npz(f"{golden}_costs.npz")
    seed = int(costs["seed"])
    report, total = {}, {k: 0 for k in LAUNCHES}
    shapes, undo = record_launch_shapes()
    try:
        for name in envs:
            env = get_env(name, **(env_kwargs or {}).get(name, {"num_loc": 50}))
            inst, policy = by_prefix(insts, name), routing_policy(name, device, seed)
            for method in ("greedy", "multistart_greedy") if name in multistart \
                    else ("greedy",):
                ref = costs[f"{name}/{method}"]
                dispatch = int(costs[f"{name}/{method}/dispatch"])
                batch = {k: v[:len(ref)] for k, v in inst.items()}
                del shapes[:]
                reset_launches()
                res = evaluate_policy(env, policy, batch, method, batch_size=dispatch,
                                      check_solutions=True, warmup=False, device=device)
                counts = dict(LAUNCHES)
                grouped = method == "multistart_greedy" and not policy.has_dynamic_embedding
                kernel = "pointer_step_grouped" if grouped else "pointer_step_single"
                want = {k: 0 for k in LAUNCHES}
                want[kernel] = env.max_steps  # one dispatch: one launch per decode step
                assert counts == want, f"{name}/{method}: launches {counts}, expected {want}"
                rows = dispatch * (env.get_num_starts() if method != "greedy" else 1)
                want_shape = ((kernel, dispatch, env.get_num_starts(), env.num_actions)
                              if grouped else (kernel, rows, None, env.num_actions))
                assert set(shapes) == {want_shape}, (name, method, set(shapes))
                for k in total:
                    total[k] += counts[k]
                self_departed = int(costs.get(f"{name}/{method}/self_departed", 0))
                if self_departed > (1 - ROUTING_SAME_SHARE) * len(ref):
                    held = hold_costs_unstable(-res["rewards"], ref, *greedy_departures(
                        env, policy, batch, costs[f"{name}/{method}/actions"], device),
                        self_departed, float(costs[f"{name}/{method}/self_mean_rel"]),
                        f"{name}/{method}")
                elif f"{name}/{method}/actions" in costs:
                    held = hold_costs_at_ties(-res["rewards"], ref, *greedy_departures(
                        env, policy, batch, costs[f"{name}/{method}/actions"], device),
                        f"{name}/{method}")
                else:
                    held = hold_costs(-res["rewards"], ref, f"{name}/{method}")
                report[f"{name}/{method}"] = {
                    **held,
                    "dispatch": dispatch, "kernel_shape": list(want_shape),
                    "tours_valid": 1.0, "seconds_with_validity_check": res["inference_time"],
                    "launches": counts}
    finally:
        undo()
    return report, total


def drive_golden_pomo_mtvrp(device):
    """POMO on MTVRP-50 (preset ``all``): multistart greedy with 50 starts on
    the 1 024 golden instances in dispatches of 512 (the grouped kernel at B
    512, L 50, N 51 under the 16 variants' masks), every tour checked; costs
    overall and per variant against the JAX CPU costs."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.envs.routing.mtvrp import variant_name
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    inst, costs = golden_npz("pomo_mtvrp50_instances.npz"), golden_npz("pomo_mtvrp50_costs.npz")
    env = get_env("mtvrp", num_loc=50)
    policy = routing_policy("mtvrp", device, int(costs["seed"]), **POMO_ARCH)
    ref, dispatch = costs["multistart_greedy"], int(costs["multistart_greedy/dispatch"])
    reset_launches()
    res = evaluate_policy(env, policy, inst, "multistart_greedy", batch_size=dispatch,
                          check_solutions=True, warmup=False, device=device)
    counts = dict(LAUNCHES)
    want = {"pointer_step_single": 0,
            "pointer_step_grouped": len(ref) // dispatch * env.max_steps}
    assert counts == want, f"POMO MTVRP: launches {counts}, expected {want}"
    cost = -res["rewards"]
    names = variant_name(inst)
    variants = {v: {"instances": int((names == v).sum()),
                    "mean_cost": float(cost[names == v].mean()),
                    "reference_mean_cost": float(ref[names == v].mean())}
                for v in sorted(set(names))}
    assert len(variants) == 16, sorted(variants)
    profiled = profile_dispatch(env, policy, inst, device, "multistart_greedy", dispatch)
    return {"model": "POMO 128/8/6/512 instance norm, MTVRP-50 preset all, random weights "
                     f"(seed {int(costs['seed'])})",
            "method": "multistart_greedy", "dispatch": dispatch,
            **hold_costs(cost, ref, "POMO MTVRP-50"), "variants": variants,
            "tours_valid": 1.0, "seconds_with_validity_check": res["inference_time"],
            "profiled_dispatch": profiled, "launches": counts}, counts


def replayed_gradients(device, make_algo, inst, actions, grads_file, ref_loss, kernel, steps):
    """``make_algo(impl)`` on the kernel and the plain path (same weights)
    replays ``actions`` on ``inst`` under grad; both losses are
    backpropagated. The kernel path launches ``kernel`` once per decode step
    (``steps``; counted from 0, returned under ``launches``), the plain one
    nothing. Loss and every gradient: the kernel
    path against the plain path (`compare_gradients`) and against the JAX
    package's (`check_gradients`, the loss at LOSS_RTOL of the mean magnitude
    of its terms: the advantage-weighted sum cancels)."""
    from rl4co_tpu_torch.convert import convert_params, load_params_npz
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    algos = {impl: make_algo(impl) for impl in ("kernel", "plain")}
    live = {impl: a.policy for impl, a in algos.items()}
    losses, outs, ms, launches = {}, {}, {}, {}
    for impl, algo in algos.items():
        reset_launches()
        (loss, (_, out)), ms[impl] = sync_ms(lambda: algo.loss(inst, replay_actions=actions))
        _, backward_ms = sync_ms(loss.backward)
        want = {k: 0 for k in LAUNCHES}
        if impl == "kernel":
            want[kernel] = steps
            ms["backward"] = backward_ms
        launches[impl] = dict(LAUNCHES)
        assert launches[impl] == want, (impl, launches[impl], want)
        assert np.array_equal(out.actions.cpu().numpy(), np.asarray(actions))
        losses[impl], outs[impl] = loss, out
    paths = compare_gradients(live, losses["kernel"], losses["plain"])
    want = {k: v.to(device) for k, v in convert_params(load_params_npz(
        os.path.join(GOLDEN, grads_file))).items()}
    out = outs["kernel"]
    advantage = out.reward - out.reward.mean()  # the scale of the loss's terms
    scale = float((advantage * out.log_likelihood).detach().abs().mean())
    jax_side = check_gradients({n: p.grad for n, p in live["kernel"].named_parameters()}, want,
                               losses["kernel"].item(), ref_loss,
                               what="the port and the JAX package", loss_scale=scale)
    return live, {"loss": losses["kernel"].item(), "reference_loss": ref_loss,
                  "loss_ms": ms["kernel"], "backward_ms": ms["backward"],
                  "kernel_against_plain": paths, "kernel_against_jax": jax_side,
                  "launches": launches["kernel"]}


def check_pomo_mtvrp_gradients(device):
    """POMO's loss and every gradient at full width on the golden file's
    first two MTVRP-50 instances x 50 starts, the JAX greedy actions
    replayed (the grouped kernel under grad, K3's recompute backward)."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.pomo import POMO

    inst, costs = golden_npz("pomo_mtvrp50_instances.npz"), golden_npz("pomo_mtvrp50_costs.npz")
    actions = costs["replay/actions"]
    few = {k: v[:actions.shape[0] // 50] for k, v in inst.items()}
    env = get_env("mtvrp", num_loc=50)

    def make_algo(impl):
        policy = routing_policy("mtvrp", device, int(costs["seed"]), pointer_impl=impl,
                                **POMO_ARCH).train()
        return POMO(env, policy=policy, train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))

    _, report = replayed_gradients(device, make_algo, few, actions, "pomo_mtvrp50_grads.npz",
                                   float(costs["replay/loss"]), "pointer_step_grouped",
                                   env.max_steps)
    return {"instances": len(few["locs"]), "starts": 50, **report}


def check_am_sdvrp_gradients(device):
    """AM's REINFORCE loss and every gradient at full width on the golden
    file's 8 SDVRP-50 instances, the JAX package's sampled tours replayed
    against their mean reward: the single-query kernel on new K/V at every
    step under grad; ``dynamic_embedding.projection`` must get a gradient,
    and a nonzero one, through K3's backward."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    insts, costs = golden_npz("routing_envs_instances.npz"), golden_npz("routing_envs_costs.npz")
    replay = by_prefix(costs, "sdvrp/replay")
    actions = replay["actions"]
    inst = {k: v[:len(actions)] for k, v in by_prefix(insts, "sdvrp").items()}
    env = get_env("sdvrp", num_loc=50)
    values = torch.full((len(actions),), float(replay["baseline"]), device=device)

    def make_algo(impl):
        policy = routing_policy("sdvrp", device, int(costs["seed"]), pointer_impl=impl).train()
        return REINFORCE(env, policy, baseline=given_baseline(values),
                         train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))

    live, report = replayed_gradients(device, make_algo, inst, actions, "am_sdvrp50_grads.npz",
                                      float(replay["loss"]), "pointer_step_single",
                                      env.max_steps)
    proj = live["kernel"].dynamic_embedding.projection.weight.grad
    assert proj is not None and proj.abs().max().item() > 0, "no gradient reached the projection"
    return {"instances": len(actions), "projection_grad_max_abs": proj.abs().max().item(),
            **report}


def train_cli(device, tmp, model, name, num_loc, argv_tail, steps, instrumented,
              profile_host=True):
    """``--model <model> --env <name> --num-loc <num_loc> <argv_tail>``
    through the train CLI in-process, one epoch: every train step
    (``instrumented.update``) synchronised, timed and its launches counted;
    then one more step under the profiler (``profile_host=False``: the
    device alone, far cheaper over 10^4 launches), with the peak device
    memory of that step. Launch counts start at 0 just before `main` and are read just
    after. The report holds the trained algorithm under ``algo``."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    log = os.path.join(tmp, f"{model}-{name}.jsonl")
    argv = ["--model", model, "--env", name, "--num-loc", str(num_loc), *argv_tail,
            "--epochs", "1", "--ckpt-dir", os.path.join(tmp, f"{model}-{name}"),
            "--log-file", log, "--dp", "1", "--device", str(device)]
    done, undo = instrument_updates(instrumented)
    t0 = time.perf_counter()
    try:
        reset_launches()
        algo = train.main(argv)
        launches = dict(LAUNCHES)
    finally:
        undo()
    cli_s = time.perf_counter() - t0
    assert len(done) == steps, len(done)
    for s in done:
        assert all(np.isfinite(v) for v in s["metrics"].values()), s["metrics"]
    epoch = [r for r in read_jsonl(log) if "val/reward" in r][-1]
    assert np.isfinite(epoch["val/reward"])
    assert os.path.exists(os.path.join(tmp, f"{model}-{name}", "last.pt"))
    inst = algo.env.generate(int(argv[argv.index("--batch-size") + 1]), algo.generator, device)
    torch.cuda.reset_peak_memory_stats()
    _, busy, n_launches, top = device_profile(lambda: algo.update(inst), host=profile_host)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(s["ms"] for s in done)
    return {"algo": algo, "argv": argv, "steps": len(done),
            "step_ms_runs": [s["ms"] for s in done], "step_ms_median": ms,
            "metrics_per_step": [s["metrics"] for s in done],
            "launches_per_step": [s["launches"] for s in done],
            "val_cost": -epoch["val/reward"], "epoch_s": epoch["time/epoch_s"],
            "cli_seconds": cli_s,
            "profiled_step": {"device_busy_ms": busy, "device_launches": n_launches,
                              "device_busy_share_of_median_step":
                                  None if busy is None else busy / ms,
                              "top_kernels": top, "peak_memory_bytes": peak},
            "launches": launches}, launches


# GLOP at `runs/glop_tsp1000.py`'s recipe: 128 TSP-1000 instances from a
# numpy seed, in dispatches of 32, segments of 25, 24 rounds; the reviser AM
# (Kool et al.'s widths) on SHPP-25 with the golden seed's random weights
# (no trained reviser is committed). Each variant replays the JAX package's
# draws from the golden file (`python tests/test_torch_glop.py`) and is held
# to its CPU costs: the mean within GLOP_MEAN_RTOL, GLOP_SAME_SHARE of the
# instances within GLOP_COST_RTOL (a near-tie decided otherwise sends the
# rest of that instance's rounds elsewhere), every tour a permutation.
GLOP_N, GLOP_COUNT, GLOP_DISPATCH, GLOP_SEG, GLOP_ROUNDS = 1000, 128, 32, 25, 24
GLOP_MEAN_RTOL, GLOP_COST_RTOL, GLOP_SAME_SHARE = 1e-4, 1e-5, 0.95


def glop_instances(seed):
    return np.random.RandomState(seed).random_sample(
        (GLOP_COUNT, GLOP_N, 2)).astype(np.float32)


def drive_glop_tsp1000(device):
    """Construction alone, revision by insertion alone, and revision with
    the reviser: each dispatch run once untimed (the first, warm-up), then
    all four timed (synchronised host clock), one of them again under
    `torch.profiler`. Launch counts start at 0 before each dispatch and are
    read after it: the reviser's dispatch launches K2 once per decode step,
    24 rounds x 25 steps, at (1 280, None, 25). Tours checked as
    permutations, lengths recomputed on the host in f64 from the tours."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.models import AttentionModelPolicy
    from rl4co_tpu_torch.models.zoo.glop import GLOP
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    golden = golden_npz("glop_tsp1000.npz")
    locs_np = glop_instances(int(golden["locs_seed"]))
    reviser = AttentionModelPolicy(env_name="shpp", device=device)
    reviser = load_params(reviser, random_params_numpy(int(golden["seed"]),
                                                       env_name="shpp")).eval()
    variants = {"construct": GLOP(seg_len=GLOP_SEG, n_rounds=0),
                "insertion": GLOP(seg_len=GLOP_SEG, n_rounds=GLOP_ROUNDS),
                "reviser": GLOP(seg_len=GLOP_SEG, n_rounds=GLOP_ROUNDS, subsolver_policy=reviser)}
    rows_per_dispatch = GLOP_DISPATCH * GLOP_N // GLOP_SEG

    def draws(d):
        sl = slice(d * GLOP_DISPATCH, (d + 1) * GLOP_DISPATCH)
        return {"construction_orders": torch.from_numpy(
                    golden["construction_orders"][sl].astype(np.int64)).to(device),
                "offsets": torch.from_numpy(golden["offsets"][d].astype(np.int64)).to(device),
                "insertion_orders": torch.from_numpy(
                    golden["insertion_orders"][d].astype(np.int64)).to(device)}

    dispatches = GLOP_COUNT // GLOP_DISPATCH
    batches = [torch.from_numpy(locs_np[d * GLOP_DISPATCH:(d + 1) * GLOP_DISPATCH]).to(device)
               for d in range(dispatches)]
    replay = [draws(d) for d in range(dispatches)]
    report, total, first_tours = {}, {k: 0 for k in LAUNCHES}, {}
    shapes, undo = record_launch_shapes()
    try:
        for name, glop in variants.items():
            with torch.no_grad():
                glop.solve(batches[0], draws=replay[0])            # warm-up
                torch.cuda.synchronize()
                tours, lengths, wall_ms, counts = [], [], [], []
                for d in range(dispatches):
                    del shapes[:]
                    reset_launches()
                    t0 = time.perf_counter()
                    t, ln = glop.solve(batches[d], draws=replay[d])
                    torch.cuda.synchronize()
                    wall_ms.append((time.perf_counter() - t0) * 1e3)
                    counts.append(dict(LAUNCHES))
                    want = {k: 0 for k in LAUNCHES}
                    if glop.subsolver_policy is not None:
                        want["pointer_step_single"] = GLOP_ROUNDS * GLOP_SEG
                        assert set(shapes) == {("pointer_step_single", rows_per_dispatch,
                                                None, GLOP_SEG)}, set(shapes)
                    assert counts[-1] == want, (name, d, counts[-1], want)
                    tours.append(t.cpu().numpy())
                    lengths.append(ln.cpu().numpy())
                _, busy_ms, device_launches, top = device_profile(
                    lambda: glop.solve(batches[1], draws=replay[1]), host=False)
            for k in total:
                total[k] += sum(c[k] for c in counts)
            first_tours[name] = tours[0]
            tours, lengths = np.concatenate(tours), np.concatenate(lengths)
            assert (np.sort(tours, axis=1) == np.arange(GLOP_N)).all(), f"{name}: not a tour"
            ordered = np.take_along_axis(locs_np.astype(np.float64),
                                         tours[..., None].repeat(2, -1), 1)
            host = np.linalg.norm(ordered - np.roll(ordered, -1, axis=1), axis=-1).sum(1)
            assert np.allclose(host, lengths, rtol=1e-5), f"{name}: lengths off the tours"
            ref = golden[f"{name}/cost"]
            rel = np.abs(host - ref) / ref
            mean_rel = abs(host.mean() - ref.mean()) / ref.mean()
            same = float((rel <= GLOP_COST_RTOL).mean())
            assert mean_rel <= GLOP_MEAN_RTOL, f"{name}: mean off by {mean_rel:.2e}"
            assert same >= GLOP_SAME_SHARE, f"{name}: only {same:.4f} of costs within 1e-5"
            med = statistics.median(wall_ms)
            report[name] = {
                "instances": GLOP_COUNT, "dispatch": GLOP_DISPATCH,
                "rounds": glop.n_rounds, "seg_len": GLOP_SEG,
                "mean_cost": float(host.mean()), "reference_mean_cost": float(ref.mean()),
                "mean_rel_err": float(mean_rel), "share_within_1e-5": same,
                "instances_diverged": int((rel > GLOP_COST_RTOL).sum()),
                "max_rel_err": float(rel.max()), "tours_valid": 1.0,
                "wall_ms_per_dispatch": wall_ms, "wall_ms_median": med,
                "instances_per_s": GLOP_COUNT / sum(wall_ms) * 1e3,
                "profiled_dispatch": {"device_busy_ms": busy_ms,
                                      "device_busy_share": (None if busy_ms is None
                                                            else busy_ms / med),
                                      "device_launches": device_launches,
                                      "top_kernels": top},
                "kernel_launches_per_dispatch": counts[0],
            }
        report["reviser_orders"] = glop_reviser_orders(variants["reviser"], locs_np, golden,
                                                       first_tours["construct"], device)
    finally:
        undo()
    for name in ("insertion", "reviser"):
        assert report[name]["mean_cost"] < report["construct"]["mean_cost"], report
    return report, total


def glop_reviser_orders(glop, locs_np, golden, tours, device):
    """The reviser's own greedy orders of the first round's 1 280 segments
    of dispatch 0 (cut from the construction's tours as the round cuts
    them) against the JAX package's: the share of segments ordered alike
    (held to GLOP_SAME_SHARE), and the segments' mean internal length under
    each candidate: a random-weight reviser's orders are longer than
    insertion's, so acceptance never takes them and the revised costs are
    insertion's."""
    from rl4co_tpu_torch.models.zoo.glop import (
        _segment_lengths,
        batched_random_insertion_path,
        segments,
    )

    offsets = torch.from_numpy(golden["offsets"][0][0].astype(np.int64)).to(device)
    _, seg = segments(torch.from_numpy(locs_np[:GLOP_DISPATCH]).to(device),
                      torch.from_numpy(tours).to(device), offsets, GLOP_SEG)
    with torch.no_grad():
        orders = glop._solve_segments(seg)
        insertion = batched_random_insertion_path(seg, torch.from_numpy(
            golden["insertion_orders"][0][0].astype(np.int64)).to(device))
        identity = torch.arange(GLOP_SEG, device=device).expand(seg.shape[:2])
        lengths = {name: float(_segment_lengths(seg, o).mean())
                   for name, o in (("identity", identity), ("insertion", insertion),
                                   ("reviser", orders))}
    same = float((orders.cpu().numpy() == golden["reviser/orders_d0_r0"]).all(axis=1).mean())
    assert same >= GLOP_SAME_SHARE, f"the reviser orders only {same:.4f} of segments as JAX"
    return {"segments": int(seg.shape[0]), "share_ordered_as_jax": same,
            "mean_segment_length": lengths}


# PPO and A2C with their critic on TSP-50. `python tests/test_torch_ppo_a2c.py`
# writes the golden files with the JAX package on the CPU in f32: AM from the
# committed TSP-50 checkpoint, a critic from `random_params_numpy(critic_seed,
# policy="critic")`, the instances, sampled actions and minibatch blocks of one
# PPO step and the sampled actions of one A2C step at batch 512, each PPO
# minibatch's losses, the first minibatch's gradients, each leaf's update
# norm over the PPO step, and the A2C loss and its gradients.
PPO_METRICS = ("loss", "surrogate_loss", "value_loss", "entropy")
A2C_METRICS = ("loss", "reinforce_loss", "bl_loss", "reward", "bl_val", "entropy")
# Against the JAX CPU reference. f32 does not fix these quantities closer than
# its own noise, which the AM checkpoint's weights make large: last-bit changes
# of the batch-norm sums flip ReLU gates in the FFNs and move the encoder's
# gradients by up to 2.7e-3 of the largest, and Adam's first step, lr·g/|g|,
# turns every last-bit difference into a full ±lr step for the minibatches
# after it. On the CPU the port's plain path disagrees with itself, the same
# step on the batch in another order, by 2.7e-3 of the largest PPO gradient
# (A2C's: 8.4e-5), 1.35e-3 in a later minibatch's loss and 1.1e-2 in a leaf's
# update norm; on an NVIDIA H100 by 1.6e-4, 8.1e-3 and 3.7e-3. The floors
# differ up to 16x between the two machines, so each bound sits at 2.5-4x the
# largest floor or error either showed; the check prints the card's floor
# beside each error.
ACTOR_CRITIC_LOSS_RTOL = 1e-4   # A2C's metrics; PPO's first minibatch's losses
PPO_LATER_LOSS_RTOL = 2e-2      # PPO's losses after the first Adam step
PPO_GRAD_GAUGE = 1e-2           # PPO's first-minibatch gradients, of the largest
A2C_GRAD_GAUGE = 5e-4           # A2C's gradients, of the largest
UPDATE_NORM_RTOL = 5e-2         # each leaf's update norm over the PPO step
# MCP's mean: times the largest drift of the reference against itself over 8
# orders of the dispatch (2.9e-4); the port's products differ from the
# reference's everywhere, not only in the batch-norm sums' order, and drifted
# 3.4e-4 on the CPU and 7.1e-4 on an NVIDIA H100
NOISE_FACTOR = 5.0
# an element whose JAX gradient lies below this share of the largest is
# rounding noise around an exact zero (a bias in front of batch norm, a key
# bias under the softmax; the JAX package's reaches 1.2e-6 of the largest on
# this step): Adam turns it into anything up to ±lr, so the update norms are
# taken over the other elements, on both sides
UPDATE_NOISE_SHARE = 1e-5
# PPO through the train CLI at its defaults on TSP-20: the greedy cost on the
# trainer's validation set must fall by PPO_LEARN_MARGIN over PPO_CLI_STEPS
# steps (on the CPU the port's fell 6.03 -> 4.20 in 60 steps; on the card 6.03 -> 4.12 in 60,
# the sampled cost 8.73 -> 4.83 by step 40, the greedy cost 6.029 -> 4.400 in 40: cut to 40
# steps to keep the script inside its 1 200 s on a slow host, then to 30 when the
# infrastructure phases came). TSP-50 does not learn in the phase's time: the
# critic starts near 0 against rewards near -21, so every advantage is
# negative and the first steps push the sampled tours down (on the CPU the
# greedy cost rose 13.85 -> 18.30 in 40 steps); TSP-50 runs in the replay.
PPO_CLI_LOC, PPO_CLI_STEPS, PPO_LEARN_MARGIN = 20, 30, 1.0
A2C_CLI_STEPS = 4
# SMTWTP, DPP, MDPP, FLP and MCP at their published sizes:
# `python tests/test_torch_env_smtwtp_dpp_flp_mcp.py` writes the golden files
ENVS_10B = {"smtwtp": dict(num_job=50), "dpp": {}, "mdpp": {},
            "flp": dict(num_loc=100, to_choose=10), "mcp": {}}


def actor_critic_golden(device, algo_cls):
    """``algo_cls`` (PPO or A2C) on TSP-50: the AM checkpoint's weights, the
    golden critic, f32, sampling with tanh clipping 10; and the golden file."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.rl.critic import CriticNetwork

    g = golden_npz("ppo_a2c_tsp50.npz")
    critic = load_params(CriticNetwork(device=device),
                         random_params_numpy(int(g["critic_seed"]), policy="critic"))
    algo = algo_cls(get_env("tsp", num_loc=50), checkpoint_policy("am_tsp50", device).train(),
                    critic=critic, train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    return algo, g


def named_parameters(algo):
    """``{"policy.<name>" | "critic.<name>": parameter}``."""
    return {f"{branch}.{n}": p for branch, mod in (("policy", algo.policy),
                                                   ("critic", algo.critic))
            for n, p in mod.named_parameters()}


def golden_gradients(name, device):
    """A golden gradient file in `named_parameters`'s names, on ``device``."""
    from rl4co_tpu_torch.convert import convert_params, load_params_npz

    tree = load_params_npz(os.path.join(GOLDEN, name))
    return {f"{branch}.{k}": v.to(device) for branch in ("policy", "critic")
            for k, v in convert_params(tree[branch]).items()}


def count_backward_recomputes():
    """Wrap the pointer step's backward (`_PointerLogits.backward`, the
    recompute of the plain version) so that each call is counted; returns
    the list it fills and the undo."""
    from rl4co_tpu_torch.ops import pointer_kernel

    inner, calls = pointer_kernel._PointerLogits.backward, []

    def backward(ctx, grad_out):
        calls.append(tuple(grad_out.shape))
        return inner(ctx, grad_out)

    pointer_kernel._PointerLogits.backward = staticmethod(backward)

    def undo():
        pointer_kernel._PointerLogits.backward = staticmethod(inner)

    return calls, undo


def rel_errors(got, want, names):
    """``{name: |got - want| / |want|}`` over ``names``."""
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in names}


def ppo_golden_step(device, g, blocks):
    """One PPO step of the port at full width on the golden instances and
    sampled actions with minibatch blocks ``blocks``: every minibatch's
    metrics, the first minibatch's gradients (before the clip), each leaf's
    update, its wall ms, and its launches, launch shapes and backward
    recomputes (counted from 0 just before the step, read just after)."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.ppo import PPO

    algo, _ = actor_critic_golden(device, PPO)
    params = named_parameters(algo)
    before = {k: p.detach().clone() for k, p in params.items()}
    recorded, first = [], {}
    inner_loss, inner_step = algo.minibatch_loss, algo.optimizer.step

    def minibatch_loss(*args):
        loss, metrics = inner_loss(*args)
        recorded.append(metrics)
        return loss, metrics

    def step():
        if not first:
            first.update({k: p.grad.clone() for k, p in params.items()})
        inner_step()

    algo.minibatch_loss, algo.optimizer.step = minibatch_loss, step
    shapes, undo_shapes = record_launch_shapes()
    recomputes, undo_backward = count_backward_recomputes()
    try:
        reset_launches()
        _, ms = sync_ms(lambda: algo.update(
            {"locs": g["locs"]}, replay_actions=torch.as_tensor(g["ppo/actions"].astype(np.int64)),
            minibatches=torch.as_tensor(blocks.astype(np.int64))))
        launches = dict(LAUNCHES)
    finally:
        undo_shapes()
        undo_backward()
        del algo.minibatch_loss, algo.optimizer.step
    metrics = [{k: m[k].item() for k in PPO_METRICS} for m in recorded]
    updates = {k: p.detach() - before[k] for k, p in params.items()}
    return metrics, first, updates, ms, launches, shapes, recomputes


def check_ppo_golden(device):
    """One PPO step of the port at full width on the JAX package's
    instances, sampled actions and minibatch blocks: K2 50 times at B 512
    (the old rollout, no graph) and 400 times at B 128 under autograd (8
    minibatches × 50 steps, each with its recompute backward). Every
    minibatch's losses, the first minibatch's every gradient (policy and
    critic) and each leaf's update norm over the step against the JAX CPU's;
    beside each error, the port's disagreement with itself when every
    minibatch is reordered (the same step, its sums in another order)."""
    from collections import Counter

    g = golden_npz("ppo_a2c_tsp50.npz")
    blocks = g["ppo/blocks"]
    metrics, first, updates, ms, launches, shapes, recomputes = ppo_golden_step(device, g, blocks)
    assert launches == {"pointer_step_single": 450, "pointer_step_grouped": 0}, launches
    assert Counter(shapes) == {("pointer_step_single", 512, None, 50): 50,
                               ("pointer_step_single", 128, None, 50): 400}, Counter(shapes)
    assert len(recomputes) == 400 and set(recomputes) == {(128, 50)}, Counter(recomputes)
    assert len(metrics) == 8
    rs = np.random.RandomState(0)
    shuffled = np.stack([row[rs.permutation(len(row))] for row in blocks])
    metrics_b, first_b, updates_b, *_ = ppo_golden_step(device, g, shuffled)
    torch.cuda.reset_peak_memory_stats()
    _, busy, n_launches, top = device_profile(lambda: ppo_golden_step(device, g, blocks))
    profiled = {"device_busy_ms": busy, "device_launches": n_launches,
                "device_busy_share_of_step": None if busy is None else busy / ms,
                "top_kernels": top, "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    want = golden_gradients("ppo_tsp50_grads.npz", device)
    scale = max(w.abs().max().item() for w in want.values())
    # the losses of every minibatch
    errors = [rel_errors(m, dict(zip(PPO_METRICS, ref)), PPO_METRICS)
              for m, ref in zip(metrics, g["ppo/metrics"])]
    floors = [rel_errors(b, a, PPO_METRICS) for a, b in zip(metrics, metrics_b)]
    assert max(errors[0].values()) <= ACTOR_CRITIC_LOSS_RTOL, ("PPO minibatch 0", errors[0])
    loss_err = max(max(e.values()) for e in errors)
    loss_floor = max(max(f.values()) for f in floors)
    assert loss_err <= PPO_LATER_LOSS_RTOL, ("PPO minibatch losses", errors, floors)
    # the first minibatch's gradients
    grad_floor = max((first[k] - first_b[k]).abs().max().item() for k in want) / scale
    grads = check_gradients(first, want, metrics[0]["loss"], float(g["ppo/metrics"][0][0]),
                            grad_rtol=0.0, what="the port and the JAX package",
                            grad_atol=PPO_GRAD_GAUGE)
    # each leaf's update norm over the step, on the elements that are not noise
    norm_err, norm_floor, noise_elements = {}, 0.0, 0
    for name, upd in updates.items():
        clear = want[name].abs() > UPDATE_NOISE_SHARE * scale
        noise_elements += int((~clear).sum())
        if not clear.any():  # a bias in front of batch norm: noise alone
            continue
        got = upd[clear].double().norm().item()
        other = updates_b[name][clear].double().norm().item()
        ref = float(g[f"ppo/update_norm/{name}"])
        norm_err[name] = abs(got - ref) / ref
        norm_floor = max(norm_floor, abs(other - got) / got)
    worst = max(norm_err, key=norm_err.get)
    assert norm_err[worst] <= UPDATE_NORM_RTOL, (worst, norm_err[worst], norm_floor)
    return {"model": "AM 128/8/3/512 batch norm from the TSP-50 checkpoint + critic "
                     "128/8/3/512 -> 256 -> 1 (random weights), TSP-50, f32, batch 512, "
                     "2 epochs x 4 minibatches of 128, clip 0.2, Adam 1e-4, clip-norm 0.5",
            "step_ms": ms, "profiled_step": profiled, "minibatch_metrics": metrics,
            "minibatch_loss_max_rel_err": loss_err,
            "minibatch_loss_max_rel_err_first": max(errors[0].values()),
            "minibatch_loss_reorder_floor": loss_floor,
            "first_minibatch_gradients": grads, "gradient_reorder_floor_of_scale": grad_floor,
            "update_norm_max_rel_err": norm_err[worst], "update_norm_max_rel_err_at": worst,
            "update_norm_reorder_floor": norm_floor,
            "update_norm_leaves": len(norm_err), "update_noise_elements_left_out": noise_elements,
            "tolerances": {"first_minibatch_loss_rtol": ACTOR_CRITIC_LOSS_RTOL,
                           "later_loss_rtol": PPO_LATER_LOSS_RTOL, "grad_gauge": PPO_GRAD_GAUGE,
                           "update_norm_rtol": UPDATE_NORM_RTOL,
                           "update_noise_share": UPDATE_NOISE_SHARE},
            "launch_shapes": {f"B{b} N{n}": c for (_, b, _, n), c in Counter(shapes).items()},
            "backward_recomputes": len(recomputes), "launches": launches}, launches


def a2c_golden_loss(device, g, order):
    """The port's A2C loss and backward at full width on the golden
    instances and sampled actions in ``order``: metrics, gradients, wall ms
    of each, and the launches, shapes and recomputes (counted from 0 just
    before the loss, read just after its backward)."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.a2c import A2C

    algo, _ = actor_critic_golden(device, A2C)
    actions = torch.as_tensor(g["a2c/actions"][order].astype(np.int64))
    shapes, undo_shapes = record_launch_shapes()
    recomputes, undo_backward = count_backward_recomputes()
    try:
        reset_launches()
        (loss, (metrics, _)), loss_ms = sync_ms(
            lambda: algo.loss({"locs": g["locs"][order]}, replay_actions=actions))
        _, backward_ms = sync_ms(loss.backward)
        launches = dict(LAUNCHES)
    finally:
        undo_shapes()
        undo_backward()
    grads = {k: p.grad for k, p in named_parameters(algo).items()}
    return ({k: v.item() for k, v in metrics.items()}, grads, loss_ms, backward_ms, launches,
            shapes, recomputes)


def check_a2c_golden(device):
    """One A2C loss and backward of the port at full width on the JAX
    package's instances and sampled actions: K2 50 times at B 512 under
    autograd, 50 recomputes; the six metrics and every gradient of the
    policy and the critic against the JAX CPU's; beside each error, the
    port's disagreement with itself on the batch reordered."""
    g = golden_npz("ppo_a2c_tsp50.npz")
    got, grads, loss_ms, backward_ms, launches, shapes, recomputes = a2c_golden_loss(
        device, g, np.arange(len(g["locs"])))
    assert launches == {"pointer_step_single": 50, "pointer_step_grouped": 0}, launches
    assert set(shapes) == {("pointer_step_single", 512, None, 50)} and len(recomputes) == 50
    other, grads_b, *_ = a2c_golden_loss(
        device, g, np.random.RandomState(0).permutation(len(g["locs"])))
    want = golden_gradients("a2c_tsp50_grads.npz", device)
    scale = max(w.abs().max().item() for w in want.values())
    errors = rel_errors(got, {k: float(g[f"a2c/{k}"]) for k in A2C_METRICS}, A2C_METRICS)
    floor = max(rel_errors(other, got, A2C_METRICS).values())
    assert max(errors.values()) <= ACTOR_CRITIC_LOSS_RTOL, (errors, floor)
    grad_floor = max((grads[k] - grads_b[k]).abs().max().item() for k in want) / scale
    report = check_gradients(grads, want, got["loss"], float(g["a2c/loss"]), grad_rtol=0.0,
                             what="the port and the JAX package", grad_atol=A2C_GRAD_GAUGE)
    return {"model": "AM 128/8/3/512 batch norm from the TSP-50 checkpoint + critic "
                     "(random weights), TSP-50, f32, batch 512",
            "metrics": got, "metric_max_rel_err": max(errors.values()),
            "metric_reorder_floor": floor, "loss_ms": loss_ms, "backward_ms": backward_ms,
            "gradients": report, "gradient_reorder_floor_of_scale": grad_floor,
            "tolerances": {"loss_rtol": ACTOR_CRITIC_LOSS_RTOL, "grad_gauge": A2C_GRAD_GAUGE},
            "backward_recomputes": len(recomputes), "launches": launches}, launches


def train_cli_actor_critic(device, tmp, model, steps, algo_cls, margin=None, num_loc=50):
    """``--model ppo|a2c --env tsp --num-loc <num_loc>`` through the train CLI at
    its defaults (bf16-mixed, batch 512, Adam 1e-4), ``steps`` steps, one
    validation dispatch of 1 024 (`train_cli`: every step timed and its
    launches counted, one more under the profiler with its peak memory).
    Each PPO step launches K2 450 times (50 at B 512, 400 at B 128 under
    autograd), each A2C step 50 times. With ``margin``, the greedy cost on
    the trainer's validation set (logged at the end of the epoch) must fall
    by it from the untrained policy's that `build` gives for the same spec
    and seed."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.trainer import _STREAM_VAL

    batch, val = 512, 1024
    spec = train.WorkloadSpec(env_name="tsp", env_kwargs=(("num_loc", num_loc),), model=model,
                              epochs=1, batch_size=batch, train_data_size=steps * batch,
                              val_data_size=val, device=str(device))
    untrained, _ = train.build(spec)
    assert untrained.train_spec.compute_dtype == "bfloat16"
    env = untrained.env
    fixed = env.generate(val, seeded_generator(device, spec.seed, _STREAM_VAL), device)
    before = -untrained.make_eval_step()(fixed)["reward"].item()
    del untrained
    shapes, undo = record_launch_shapes()
    try:
        report, launches = train_cli(
            device, tmp, model, "tsp", num_loc, ["--batch-size", str(batch), "--train-size",
                                            str(steps * batch), "--val-size", str(val)],
            steps, algo_cls)
    finally:
        undo()
    algo = report.pop("algo")
    # K2 at every decode step: PPO's old rollout and its 8 minibatches, A2C's rollout
    per_step = (9 if model == "ppo" else 1) * env.max_steps
    assert all(s == {"pointer_step_single": per_step, "pointer_step_grouped": 0}
               for s in report["launches_per_step"]), report["launches_per_step"]
    # + the one greedy validation dispatch
    assert launches == {"pointer_step_single": steps * per_step + env.max_steps,
                        "pointer_step_grouped": 0}, launches
    rows = {512, 1024} | ({128} if model == "ppo" else set())
    assert {b for _, b, _, _ in shapes} == rows, set(shapes)
    # the trainer validated on `fixed` (its seed's validation stream) before
    # `train_cli`'s profiled step moved the weights once more
    after = report["val_cost"]
    del algo
    if margin is not None:
        assert before - after >= margin, (
            f"{model}: greedy cost on TSP-{num_loc} fell from {before:.4f} to {after:.4f}: "
            f"less than the margin {margin}")
    return {"model": f"{model.upper()}: AM 128/8/3/512 batch norm + critic, TSP-{num_loc}, "
                     "bf16-mixed, Adam 1e-4",
            **report, "greedy_cost_before": before, "greedy_cost_after": after,
            "fall": before - after, "margin": margin}, launches


# EAS and Active Search on the POMO CVRP-50 checkpoint (`rl4co_tpu_torch/
# models/zoo/eas.py`). The golden file (`python tests/test_torch_eas.py`)
# holds the JAX package's iterations on the first EAS_GOLDEN_COUNT instances:
# the port replays their sampled actions under autograd, K1 in the multistart
# rollout and K2 in the replay of the incumbents, and is held to the losses,
# every gradient, AdamW's update and the incumbents (tolerances as
# `tests/test_torch_eas.py`, the test of the same replay at a small size).
EAS_LOSS_RTOL = 1e-4
EAS_GRAD_GAUGE = 1.7e-4       # of the largest gradient
AS_GRAD_GAUGE = 1e-3          # Active Search: its gradient runs through the encoder
EAS_UPDATE_ATOL = 0.05        # in units of the learning rate ...
EAS_BIG_GRAD = 1e-3           # ... where |g| exceeds this share of the largest
EAS_UPDATE_NORM_RTOL = 5e-2   # Active Search's per-leaf update norms
EAS_TIE_RTOL = 1e-6           # best rewards; two incumbents this close are a tie
# 10 iterations (cut from 20 for the script's time; 5 already beat POMO's dihedral-8 greedy)
EAS_RUN_COUNT, EAS_RUN_ITERS = 64, 10


def eas_instances(device, count):
    from rl4co_tpu_torch.data.io import load_reference_npz

    test = load_reference_npz(os.path.join(ROOT, "data", "cvrp", "test50_seed1234.npz"), "cvrp")
    return {k: torch.from_numpy(np.ascontiguousarray(v[:count])).to(device)
            for k, v in test.items()}


def hold_eas_iteration(got, gold, pre, lr, before, after, gauge):
    """One replayed iteration against the golden one; returns its errors."""
    losses = {"rl_loss": float(gold[pre + "rl_loss"]), "il_loss": float(gold[pre + "il_loss"])}
    report = {}
    for k, want in losses.items():
        if k not in got:
            continue
        err = abs(got[k].item() - want)
        assert err <= EAS_LOSS_RTOL * abs(want) + 1e-6, (pre, k, got[k].item(), want)
        report[f"{k}_abs_err"] = err
    grads = by_prefix(gold, pre + "grads")
    scale = max(float(np.abs(g).max()) for g in grads.values())
    worst = 0.0
    for k, want in grads.items():
        err = float(np.abs(got["grads"][k].cpu().numpy() - want).max())
        assert err <= gauge * scale, (pre, k, err, scale)
        worst = max(worst, err)
        if k in after:
            big = np.abs(want) > EAS_BIG_GRAD * scale
            trained = gold.get(pre + "trained/" + k)
            if trained is not None:
                d = ((after[k] - before[k]) - (trained - before[k]))[big] / lr
                assert np.abs(d).max(initial=0) <= EAS_UPDATE_ATOL, (pre, k, np.abs(d).max())
    report.update(grad_scale=scale, grad_max_err_over_scale=worst / scale, gauge=gauge)
    return report


def hold_incumbents(state, gold, pre):
    """The incumbents against the golden ones: have_best equal, the best
    rewards within EAS_TIE_RTOL, the best actions equal but where two tours
    tie (the starts of one instance that reach tours of one cost, or the
    same tour in another rotation, whose costs differ in their last bits:
    which one the arg-max takes is a tie), which the equal best rewards prove."""
    best, want = state.best.cpu().numpy(), gold[pre + "best"]
    assert (state.have_best.cpu().numpy() == gold[pre + "have_best"]).all(), pre
    assert np.allclose(best, want, rtol=EAS_TIE_RTOL, atol=0), (pre, np.abs(best - want).max())
    differ = (state.best_actions.cpu().numpy() != gold[pre + "best_actions"]).any(-1)
    assert differ.mean() <= 0.25, (pre, int(differ.sum()), "incumbents departed")
    return {"incumbents_departed_at_ties": int(differ.sum()),
            "best_max_rel_err": float((np.abs(best - want) / np.abs(want)).max())}


def check_eas_golden(device):
    """EAS-Emb's and EAS-Lay's two golden iterations and Active Search's one,
    replayed on the card; Active Search's f32 floor: the same replay with the
    instances in another order, against the port itself."""
    from rl4co_tpu_torch.convert import convert_eas_params
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.eas import ActiveSearch, EASEmb, EASLay
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    gold = golden_npz("eas_cvrp50.npz")
    count = int(gold["count"])
    env = get_env("cvrp", num_loc=50)
    inst = eas_instances(device, count)
    policy = checkpoint_policy("pomo_cvrp50", device)
    flat = lambda tr: {k: v.detach().cpu().numpy().copy() for k, v in tr.items()}  # noqa: E731
    reset_launches()
    report = {}
    for kind, cls, lr in (("emb", EASEmb, 4.1e-3), ("lay", EASLay, 4.1e-3)):
        search = cls(env, policy)
        if kind == "lay":
            state = search.init_state(inst, eas_init=convert_eas_params(by_prefix(gold,
                                                                                 "lay/init")))
        else:
            state = search.init_state(inst)
        its = []
        for i in range(2):
            pre = f"{kind}/{i}/"
            before = flat(state.trainable)
            got = search.step(state, replay_actions=torch.from_numpy(
                gold[pre + "actions"].astype(np.int64)).to(device), keep_grads=True)
            it = hold_eas_iteration(got, gold, pre, lr, before, flat(state.trainable),
                                    EAS_GRAD_GAUGE)
            it.update(hold_incumbents(state, gold, pre))
            its.append(it)
            with torch.no_grad():   # carry JAX's trained tensors and incumbents on
                for k, v in by_prefix(gold, pre + "trained").items():
                    state.trainable[k].copy_(torch.from_numpy(v).to(device))
                state.best = torch.from_numpy(gold[pre + "best"]).to(device)
                state.best_actions = torch.from_numpy(
                    gold[pre + "best_actions"].astype(np.int64)).to(device)
                state.have_best = torch.from_numpy(gold[pre + "have_best"]).to(device)
        report[kind] = its
    # Active Search: one iteration, and its floor on a reordered batch
    search = ActiveSearch(env, policy)
    actions = torch.from_numpy(gold["as/0/actions"].astype(np.int64)).to(device)
    state = search.init_state(inst)
    before = {k: v.detach().clone() for k, v in state.trainable.items()}
    got = search.step(state, replay_actions=actions, keep_grads=True)
    perm = torch.randperm(count, generator=torch.Generator().manual_seed(0)).to(device)
    s = env.get_num_starts()
    rows = (torch.arange(s, device=device)[:, None] * count + perm[None, :]).reshape(-1)
    search_p = ActiveSearch(env, policy)
    state_p = search_p.init_state({k: v[perm] for k, v in inst.items()})
    got_p = search_p.step(state_p, replay_actions=actions[rows], keep_grads=True)
    grads = by_prefix(gold, "as/0/grads")
    norms = by_prefix(gold, "as/0/grad_norm")
    scale = max(float(v.abs().max()) for v in got["grads"].values())
    floor = max(float((got["grads"][k] - got_p["grads"][k]).abs().max())
                for k in got["grads"]) / scale
    err = max(float(np.abs(got["grads"][k].cpu().numpy() - g).max()) for k, g in grads.items())
    assert err <= AS_GRAD_GAUGE * scale, ("active search gradients", err / scale, floor)
    norm_err = max(abs(float(got["grads"][k].norm()) - float(v)) / max(float(v), 1e-12)
                   for k, v in norms.items() if float(v) > EAS_BIG_GRAD * scale)
    assert norm_err <= 1e-2, ("active search gradient norms", norm_err)
    upd = by_prefix(gold, "as/0/update_norm")
    upd_err = 0.0
    for k, want in upd.items():
        g = got["grads"][k]
        big = g.abs() > EAS_BIG_GRAD * scale
        d = float((state.trainable[k].detach() - before[k])[big].norm())
        if float(want) > 0:
            upd_err = max(upd_err, abs(d - float(want)) / float(want))
    assert upd_err <= EAS_UPDATE_NORM_RTOL, ("active search update norms", upd_err)
    loss_err = abs(got["loss"].item() - float(gold["as/0/rl_loss"]))
    assert loss_err <= EAS_LOSS_RTOL * abs(float(gold["as/0/rl_loss"])) + 1e-6, loss_err
    report["active_search"] = {
        "loss_abs_err": loss_err, "grad_scale": scale,
        "grad_max_err_over_scale": err / scale, "gauge": AS_GRAD_GAUGE,
        "reordered_batch_floor_over_scale": floor, "grad_norm_max_rel_err": norm_err,
        "update_norm_max_rel_err": upd_err, "leaves_in_full": len(grads),
        "leaves": len(norms)}
    report["instances"] = count
    return report, dict(LAUNCHES)


def drive_eas_pomo_cvrp50(device, count=EAS_RUN_COUNT, iters=EAS_RUN_ITERS, seed=18):
    """EAS-Emb with the POMO checkpoint on the first ``count`` canonical
    CVRP-50 instances (×8 augments: B 512, 50 starts), ``iters`` seeded
    iterations: per-iteration time, the device's busy share of one iteration,
    peak memory, launches, the mean best cost every 5 iterations, and the
    backward recomputes of both kernels (the proof that they ran under
    autograd). The final mean best cost must lie below the POMO dihedral-8
    multistart greedy mean of the same instances (the JAX CPU costs)."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.eas import EASEmb
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.utils.ops import unbatchify

    env = get_env("cvrp", num_loc=50)
    inst = eas_instances(device, count)
    greedy = golden_npz("pomo_cvrp50_costs.npz")["multistart_greedy_augment_dihedral_8"][:count]
    search = EASEmb(env, checkpoint_policy("pomo_cvrp50", device), max_iters=iters)
    gen = seeded_generator(device, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls, undo = count_backward_recomputes()
    try:
        reset_launches()
        state = search.init_state(inst)
        ms, curve = [], []
        for it in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search.step(state, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if (it + 1) % 5 == 0:
                best = unbatchify(state.best, 8).max(dim=-1).values
                curve.append({"iteration": it + 1, "mean_best_cost": -best.mean().item()})
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        _, busy, n_launches, top = device_profile(lambda: search.step(state, gen))
    finally:
        undo()
    shapes = sorted(set(calls))
    assert (8 * count, 50, 51) in shapes and (8 * count, 51) in shapes, shapes
    assert launches["pointer_step_grouped"] > 0 and launches["pointer_step_single"] > 0, launches
    final = curve[-1]["mean_best_cost"]
    assert np.isfinite(final) and final < float(greedy.mean()), (
        f"EAS-Emb's mean best cost {final:.5f} after {iters} iterations is not below POMO's "
        f"dihedral-8 multistart greedy {float(greedy.mean()):.5f}")
    med = statistics.median(ms)
    return {"model": "POMO CVRP-50 checkpoint (128/8/6/512, instance norm), EAS-Emb, "
                     f"{count} instances x 8 augments, 50 starts, lr 4.1e-3, lambda 0.013",
            "iterations": iters, "iteration_ms_runs": ms, "iteration_ms_median": med,
            "profiled_iteration": {"device_busy_ms": busy, "device_launches": n_launches,
                                   "device_busy_share_of_median":
                                       None if busy is None else busy / med,
                                   "top_kernels": top},
            "peak_memory_bytes": peak, "backward_recompute_shapes": [list(s) for s in shapes],
            "backward_recomputes": len(calls), "mean_best_cost": curve,
            "pomo_dihedral8_multistart_greedy_mean": float(greedy.mean()),
            "launches": launches}, launches


def search_cli_eas_lay(device, tmp, iters=2, size=64):
    """``--model pomo --env cvrp --num-loc 50 --search eas-lay --search-iters
    <iters>`` through the train command line: one train step at batch 64,
    validation on 64, then EAS-Lay on ``size`` generated instances; its JSON
    line is read back."""
    import contextlib
    import io

    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    argv = ["--model", "pomo", "--env", "cvrp", "--num-loc", "50", "--batch-size", "64",
            "--train-size", "64", "--val-size", "64", "--epochs", "1", "--baseline", "shared",
            "--search", "eas-lay", "--search-iters", str(iters), "--search-size", str(size),
            "--ckpt-dir", os.path.join(tmp, "pomo-eas-lay"), "--device", str(device)]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith('{"search"')]
    assert len(lines) == 1 and lines[0]["search"] == "eas-lay", lines
    assert np.isfinite(lines[0]["best_reward"]) and lines[0]["best_reward"] < 0, lines
    assert launches["pointer_step_grouped"] > 0 and launches["pointer_step_single"] > 0
    return {"argv": argv, "search_line": lines[0], "cli_seconds": seconds,
            "launches": launches}, launches


# The improvement trio at their published widths, batch 64, N 50. The golden
# file (`python tests/test_torch_n_step_ppo.py`) holds the JAX package's
# seeded initialisation, 20 of its sampled steps and one n-step PPO segment.
TRIO_BATCH, TRIO_STEPS = 64, 20
TRIO_LOGP_ATOL = 1e-4
TRIO_TIE_RTOL = 1e-6            # a departure of rec_best must be a tie this close
TRIO_COST_RTOL = 4.8e-7         # 4 ulps: XLA's fused square root
TRIO_FIRST_LOSS_RTOL, TRIO_LATER_LOSS_RTOL = 1e-4, 2e-2
TRIO_GRAD_GAUGE = 1e-3          # of the largest gradient
TRIO_GRAD_NORM_RTOL = 1e-2      # every leaf's gradient norm (those above 1e-3 of the largest)
TRIO_UPDATE_NORM_RTOL = 5e-2
TRIO_MODELS = {"dact": ("rl4co_tpu_torch.models.zoo.dact", "DACT"),
               "n2s": ("rl4co_tpu_torch.models.zoo.n2s", "N2S"),
               "neuopt": ("rl4co_tpu_torch.models.zoo.neuopt", "NeuOpt")}
# The command line's runs are cut from 20 DACT steps and 2 each of N2S and NeuOpt to 1, 1
# and 1: a step (250 moves in 50 segments, about 270 000 launches) takes 7-15 s on an NVIDIA
# H100 80GB HBM3 at 700.00 W, host-bound, and each validation 1 000 moves (12-24 s); the full
# depth would take the script past 1 100 s of its 1 200
TRIO_CLI_STEPS = {"dact": 1, "n2s": 1, "neuopt": 1}
TRIO_EVAL_T = 100   # 200 before the infrastructure phases came


def trio_algo(name, device, tree=None):
    """The model's `NStepPPO` at its defaults (on N 50), from the golden
    weights when ``tree`` (``{"policy": ..., "critic": ...}``) is given."""
    from rl4co_tpu_torch.convert import load_params

    module, ctor = TRIO_MODELS[name]
    algo = getattr(importlib.import_module(module), ctor)(device=device)
    algo.env = dataclasses.replace(algo.env, num_loc=50)
    if tree is not None:
        load_params(algo.policy, tree["policy"])
        load_params(algo.critic, tree["critic"])
    return algo


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def check_trio_golden(device):
    """Per model: the JAX package's 20 sampled steps replayed (log-probabilities,
    tours, best tours but for proven ties, costs), then one segment replayed
    (its rollout, every epoch's losses, the first epoch's gradients, each
    leaf's update norm)."""
    gold = golden_npz("improvement_trio.npz")
    report = {}
    for name in TRIO_MODELS:
        g = by_prefix(gold, name)
        algo = trio_algo(name, device, unflatten(by_prefix(g, "params")))
        env = algo.env
        inst = {k: torch.from_numpy(v).to(device) for k, v in by_prefix(g, "instances").items()}
        rec0 = torch.from_numpy(g["rec0"].astype(np.int64)).to(device)
        st = env.reset_from(inst, rec0)
        spec = dataclasses.replace(algo.train_spec, kind="evaluate")
        rp = by_prefix(g, "replay")
        prev = torch.zeros(TRIO_BATCH, algo.action_dim, dtype=torch.long, device=device)
        logp_err, departed, ties = 0.0, np.zeros(TRIO_BATCH, bool), []
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(int(gold["steps"])):
                a = torch.from_numpy(rp["actions"][t].astype(np.int64)).to(device)
                got_a, logp, _ = algo.act_fn(algo.policy, st, spec, None, prev, a)
                assert torch.equal(got_a, a), (name, t, "packed action")
                logp_err = max(logp_err, float((logp.cpu() - torch.from_numpy(
                    rp["logprobs"][t])).abs().max()))
                bsf = st.cost_bsf.cpu().numpy()
                st, _ = env.step(st, a)
                prev = a
                assert (st.rec_current.cpu().numpy() == rp["rec_current"][t]).all(), (name, t)
                cur, want_bsf = st.cost_current.cpu().numpy(), rp["cost_bsf"][t]
                assert np.allclose(cur, rp["cost_current"][t], rtol=TRIO_COST_RTOL, atol=0)
                assert np.allclose(st.cost_bsf.cpu().numpy(), want_bsf, rtol=TRIO_COST_RTOL,
                                   atol=0)
                differs = (st.rec_best.cpu().numpy() != rp["rec_best"][t]).any(-1)
                new = differs & ~departed
                for b in np.flatnonzero(new):   # a departure starts only at a tie
                    gap = abs(float(rp["cost_current"][t][b]) - float(bsf[b])) / float(bsf[b])
                    assert gap <= TRIO_TIE_RTOL, (name, t, b, gap)
                    ties.append(gap)
                departed = differs
        replay_s = time.perf_counter() - t0
        assert logp_err <= TRIO_LOGP_ATOL, (name, logp_err)
        # one segment from the initial tour, its moves replayed
        seg = by_prefix(g, "segment")
        trace = {}
        before = {n: p.detach().clone() for n, p in [
            *(("policy." + k, v) for k, v in algo.policy.named_parameters()),
            *(("critic." + k, v) for k, v in algo.critic.named_parameters())]}
        st0 = env.reset_from(inst, rec0)
        st_end, _, _ = algo.segment(st0, torch.zeros_like(prev), torch.from_numpy(
            seg["actions"].astype(np.int64)).to(device), trace)
        assert (st_end.rec_current.cpu().numpy() == seg["rec_current"]).all(), name
        old_ll_err = float((trace["old_ll"].cpu() - torch.from_numpy(seg["old_ll"])).abs().max())
        assert old_ll_err <= TRIO_LOGP_ATOL, (name, old_ll_err)
        ret_err = float((trace["returns"].cpu() - torch.from_numpy(seg["returns"])).abs().max())
        assert ret_err <= 1e-4, (name, ret_err)
        loss_errs = []
        for k, (got, want) in enumerate(zip(trace["epochs"], seg["epochs"])):
            rtol = TRIO_FIRST_LOSS_RTOL if k == 0 else TRIO_LATER_LOSS_RTOL
            errs = {m: abs(got[m] - float(w)) / max(abs(float(w)), 1e-6)
                    for m, w in zip(("loss", "surrogate_loss", "value_loss", "value"), want)}
            assert all(e <= rtol for e in errs.values()), (name, k, errs, got, want)
            loss_errs.append(max(errs.values()))
        grads, norms = by_prefix(seg, "grads"), by_prefix(seg, "grad_norm")
        assert set(norms) == set(trace["grads"]), sorted(set(norms) ^ set(trace["grads"]))
        scale = max(float(v.abs().max()) for v in trace["grads"].values())
        grad_err = max(float(np.abs(trace["grads"][k].cpu().numpy() - v).max())
                       for k, v in grads.items())
        assert grad_err <= TRIO_GRAD_GAUGE * scale, (name, grad_err / scale)
        norm_err = max(abs(float(trace["grads"][k].norm()) - float(v)) / float(v)
                       for k, v in norms.items() if float(v) > 1e-3 * scale)
        assert norm_err <= TRIO_GRAD_NORM_RTOL, (name, norm_err)
        params = {**{"policy." + k: v for k, v in algo.policy.named_parameters()},
                  **{"critic." + k: v for k, v in algo.critic.named_parameters()}}
        upd_err = 0.0
        for k, want in by_prefix(seg, "update_norm").items():
            big = trace["grads"][k].abs() > 1e-3 * scale
            d = float((params[k].detach() - before[k])[big].norm())
            if float(want) > 0:
                upd_err = max(upd_err, abs(d - float(want)) / float(want))
        assert upd_err <= TRIO_UPDATE_NORM_RTOL, (name, upd_err)
        report[name] = {"steps": int(gold["steps"]), "logp_max_abs_err": logp_err,
                        "rec_best_departures_at_ties": len(ties), "tie_gaps": ties,
                        "replay_seconds": replay_s,
                        "segment": {"old_ll_max_abs_err": old_ll_err,
                                    "returns_max_abs_err": ret_err,
                                    "epoch_loss_max_rel_err": loss_errs,
                                    "grad_scale": scale, "grad_max_err_over_scale":
                                        grad_err / scale, "grad_leaves_in_full": len(grads),
                                    "grad_norm_max_rel_err": norm_err,
                                    "update_norm_max_rel_err": upd_err}}
    return report


def train_cli_trio(device, tmp, batch=TRIO_BATCH, val=TRIO_BATCH):
    """``--model dact`` (TRIO_CLI_STEPS steps), then ``n2s`` and ``neuopt``,
    through the train command line at batch ``batch`` (each step a fresh
    batch improved for T_train = 250 moves in 50 segments; validation runs
    T_test = 1 000 moves on ``val`` instances), every step timed; then each
    trained model evaluated at T_TEST 200 on a fresh batch, the best cost
    no worse than the initial one, and 20 of its improvement steps under the
    profiler (ms, busy share and device launches per step)."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.rl.n_step_ppo import NStepPPO
    from rl4co_tpu_torch.rl.reinforce import seeded_generator

    report = {}
    inner = NStepPPO.train_step
    for name, steps in TRIO_CLI_STEPS.items():
        done = []

        def timed(self, batch_size, done=done):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = inner(self, batch_size)
            torch.cuda.synchronize()
            done.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "metrics": {k: float(v) for k, v in m.items()}})
            return m

        log = os.path.join(tmp, f"{name}.jsonl")
        argv = ["--model", name, "--batch-size", str(batch), "--train-size", str(steps * batch),
                "--val-size", str(val), "--epochs", "1", "--log-file", log,
                "--ckpt-dir", os.path.join(tmp, name), "--device", str(device)]
        NStepPPO.train_step = timed
        t0 = time.perf_counter()
        try:
            algo = train.main(argv)
        finally:
            NStepPPO.train_step = inner
        cli_s = time.perf_counter() - t0
        assert len(done) == steps, (name, len(done))
        assert all(np.isfinite(v) for s in done for v in s["metrics"].values()), name
        epoch = [r for r in read_jsonl(log) if "val/reward" in r][-1]
        assert np.isfinite(epoch["val/reward"]), epoch
        # evaluation at T_TEST moves from random tours
        env = algo.env
        inst = env.generate(batch, seeded_generator(device, 7), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = algo.evaluate(inst, TRIO_EVAL_T, seeded_generator(device, 8))
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        cost_init, cost_bsf = ev["cost_init"].item(), ev["cost_bsf"].item()
        assert cost_bsf <= cost_init, (name, cost_bsf, cost_init)
        g = seeded_generator(device, 9)
        _, busy, n_launches, top = device_profile(
            lambda: algo.evaluate(inst, 20, g), host=False)
        step_ms = eval_ms / TRIO_EVAL_T
        report[name] = {
            "argv": argv, "steps": steps, "step_ms_runs": [s["ms"] for s in done],
            "metrics_first_last": [done[0]["metrics"], done[-1]["metrics"]],
            "val_cost": -epoch["val/reward"], "cli_seconds": cli_s,
            "eval": {"t_max": TRIO_EVAL_T, "instances": batch, "cost_init": cost_init,
                     "cost_bsf": cost_bsf, "ms_per_improvement_step": step_ms,
                     "device_busy_ms_per_step": None if busy is None else busy / 20,
                     "device_busy_share": None if busy is None else busy / 20 / step_ms,
                     "device_launches_per_step": n_launches / 20, "top_kernels": top}}
    return report


# ---- the rest of the zoo: MatNet on ATSP-50, MDAM on TSP-50, HAM on PDP-50,
# MatNet on FFSP-20, L2D on FJSP and JSSP with stepwise PPO. The weights are
# `random_params_numpy(ZOO_SEED, policy=...)`; the golden files hold the JAX
# package's CPU results on the same weights (`python tests/test_torch_{matnet,
# mdam,ham,matnet_ffsp,stepwise_ppo}.py`).

ZOO_SEED = 19
MATNET_FULL = dict(embed_dim=256, num_heads=16, num_encoder_layers=5, feedforward_hidden=512)
FFSP20 = dict(num_stage=3, num_machine=4, num_job=20, min_time=2, max_time=10)
FFSP_FULL = dict(num_stage=3, num_machine=4, embed_dim=256, num_heads=16,
                 num_encoder_layers=3, feedforward_hidden=512)
L2D_ATTN_FULL = dict(embed_dim=128, num_heads=8, num_encoder_layers=4)
ZOO_LOSS_RTOL = 1e-5     # of the loss's terms' scale (mean |advantage · log-likelihood|)
ZOO_GRAD_GAUGE = 1e-4    # of the largest gradient, per element (checked through checksums)
PPO_METRIC_RTOL = 1e-3   # the last minibatch's metrics, after the Adam steps before it


def zoo_policy(tree_name, cls, device, **kwargs):
    """The port's policy ``cls`` with the zoo seed's weights, in eval mode."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy

    tree = random_params_numpy(ZOO_SEED, policy=tree_name, policy_kwargs=kwargs)
    return load_params(cls(device=device, **kwargs), tree).eval()


def record_launch_widths():
    """Wrap the kernels' launch function so that every launch also records
    ``(kernel, B, L, N, D, H)``; returns the counter it fills and the undo."""
    from rl4co_tpu_torch.ops import pointer_kernel

    inner, seen = pointer_kernel._launch, {}

    def launch(q, k, v, lk, neg_bias, w_out, num_heads):
        b, n, d = k.shape
        key = (("pointer_step_single", b, None, n, d, num_heads) if q.ndim == 2
               else ("pointer_step_grouped", b, q.shape[1], n, d, num_heads))
        seen[key] = seen.get(key, 0) + 1
        return inner(q, k, v, lk, neg_bias, w_out, num_heads)

    pointer_kernel._launch = launch

    def undo():
        pointer_kernel._launch = inner

    return seen, undo


def launches_by_width(seen):
    return [{"kernel": k[0], "B": k[1], "L": k[2], "N": k[3], "D": k[4], "H": k[5],
             "launches": c} for k, c in sorted(seen.items(), key=str)]


def hold_checksums(policy, gold, prefix="", gauge=ZOO_GRAD_GAUGE):
    """The policy's gradients against the JAX package's per-leaf checksums
    (sorted names; norm, sum and dot with `np.random.RandomState(0)`'s normal
    vectors, drawn in that order): each within what an elementwise error of
    ``gauge`` times the largest JAX gradient allows (sqrt(n), n and the
    vector's 1-norm times it). Returns the largest share of that bound used."""
    names = [str(n) for n in gold[prefix + "grad_names"]]
    got = {k: p.grad for k, p in policy.named_parameters()}
    assert sorted(got) == names, sorted(set(got) ^ set(names))
    eps = gauge * float(gold[prefix + "grad_max"])
    rs = np.random.RandomState(0)
    worst, worst_at = 0.0, None
    for i, name in enumerate(names):
        assert got[name] is not None, name
        g = got[name].detach().double().cpu().numpy()
        r = rs.standard_normal(g.shape)
        for value, ref, bound in (
                (np.linalg.norm(g), gold[prefix + "grad_norm"][i], eps * np.sqrt(g.size)),
                (g.sum(), gold[prefix + "grad_sum"][i], eps * g.size),
                ((g * r).sum(), gold[prefix + "grad_dot"][i], eps * np.abs(r).sum())):
            share = abs(value - ref) / bound
            assert share <= 1.0, (name, value, ref, bound)
            if share > worst:
                worst, worst_at = share, name
    return {"leaves": len(names), "grad_max": float(gold[prefix + "grad_max"]),
            "gauge": gauge, "worst_share_of_bound": worst, "worst_at": worst_at}


# MatNet's first layer starts from zero rows, whose attention depends on the
# costs alone: the rows come out nearly equal and the instance norm divides f32
# noise by their small spread. Either f32 encoder, JAX's or the port's, lies
# about 1e-3 from the f64 one (row embeddings), and the port's f32
# log-probabilities along JAX's tours lie up to 1.6e-3 nats from its f64 ones
# (8 golden instances x 50 starts, CPU; `PERF.md` §6). A tour that leaves
# JAX's where the two actions lie within this many nats left it at a tie of
# f32 rounding.
MATNET_TIE_ATOL = 4e-3
# The same floor in the gradients: the port's f32 gradients of the replayed
# POMO loss lie up to 7.2e-3 of the largest from its f64 ones (layer 0's row
# block and first norm; CPU, the golden file's 8 instances); the checksums are
# held at this gauge, and the share of it used is reported.
MATNET_GRAD_GAUGE = 1e-2


def multistart_departures(env, policy, inst, jax_actions, device):
    """The JAX package's multistart greedy tours ``[B, S, N]`` replayed
    through ``policy`` (one dispatch, every start a query of its instance):
    per row (repeat-major ``[S*B]``) the first step where the port's own
    greedy choice leaves JAX's tour (-1: never), the log-probability gap
    there, and the reward of JAX's tour (the port's env: ATSP's reward is
    JAX's to the bit, `tests/test_torch_scheduling_envs.py`)."""
    from rl4co_tpu_torch.decoding import DecodeSpec, process_logits_spec
    from rl4co_tpu_torch.utils.ops import batchify

    spec = DecodeSpec(kind="greedy", tanh_clipping=10.0)
    b, s, n = jax_actions.shape
    inst = {k: torch.as_tensor(v).to(device) for k, v in inst.items()}
    acts = torch.as_tensor(jax_actions.astype(np.int64)).to(device).transpose(0, 1)
    acts = acts.reshape(s * b, n)                                 # repeat-major rows
    with torch.no_grad():
        cache = policy.precompute(policy.encode(inst))
        state = env.reset(batchify(inst, s))
        first = torch.full((s * b,), -1, dtype=torch.long, device=device)
        gap = torch.zeros((s * b,), device=device)
        for t in range(n):
            mask = env.action_mask(state)
            if t > 0:    # the first action is the start, forced
                lp = process_logits_spec(policy.decode_step(cache, state, mask, s).float(),
                                         mask, spec)
                own = lp.argmax(dim=-1)
                leave = (own != acts[:, t]) & (first < 0) & ~state.done
                g = (lp.gather(1, own[:, None]) - lp.gather(1, acts[:, t:t + 1]))[:, 0]
                gap = torch.where(leave, g, gap)
                first = torch.where(leave, t, first)
            state = env.step(state, acts[:, t])
        jax_reward = env.reward(state, acts)
    return first.cpu().numpy(), gap.cpu().numpy(), jax_reward.cpu().numpy()


def hold_multistart(env, policy, inst, gold_cost, jax_actions, device, what):
    """Every (instance, start) tour of the port's multistart greedy against
    JAX's: a tour as JAX's has JAX's cost to the bit, a departure starts at a
    near-tie (gap at most MATNET_TIE_ATOL). Then the instances' best costs:
    those of the instances none of whose starts departed equal JAX's, their
    mean within ROUTING_MEAN_RTOL; the mean over all instances, which a tour
    that left JAX's at a tie moves, is reported beside it."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models import rollout

    s = jax_actions.shape[1]
    with torch.no_grad():
        out = rollout(policy, env, inst, DecodeSpec(kind="greedy", multistart=True,
                                                    num_starts=s, tanh_clipping=10.0),
                      device=device)
    cost = -out.reward.cpu().numpy()                               # [S*B]
    first, gap, jax_reward = multistart_departures(env, policy, inst, jax_actions, device)
    left = first >= 0
    assert (gap[left] <= MATNET_TIE_ATOL).all(), (
        f"{what}: left JAX's tour {int((gap[left] > MATNET_TIE_ATOL).sum())} times with "
        f"gaps up to {gap[left].max():.3e}")
    assert np.array_equal(cost[~left], -jax_reward[~left]), f"{what}: a tour as JAX's, another cost"
    best = cost.reshape(s, -1).min(0)
    assert np.array_equal(-jax_reward.reshape(s, -1).max(0), gold_cost), what
    rel = np.abs(best - gold_cost) / gold_cost
    kept = ~left.reshape(s, -1).any(0)            # no start of the instance departed
    assert kept.any(), f"{what}: every instance left JAX's tours somewhere"
    assert np.array_equal(best[kept], gold_cost[kept]), what
    mean_rel = float(abs(best[kept].mean() - gold_cost[kept].mean()) / gold_cost[kept].mean())
    assert mean_rel <= ROUTING_MEAN_RTOL, f"{what}: mean off by {mean_rel:.2e}"
    return {"instances": len(gold_cost), "starts": s, "mean_cost": float(best.mean()),
            "reference_mean_cost": float(gold_cost.mean()),
            "mean_rel_err_all": float(abs(best.mean() - gold_cost.mean()) / gold_cost.mean()),
            "instances_without_departure": int(kept.sum()), "mean_rel_err": mean_rel,
            "share_instances_within_1e-5": float((rel <= ROUTING_COST_RTOL).mean()),
            "max_rel_err": float(rel.max()), "tours": int(cost.size),
            "tours_departed_at_near_ties": int(left.sum()),
            "departure_gap_max": float(gap[left].max()) if left.any() else 0.0,
            "departure_gap_median": float(np.median(gap[left])) if left.any() else 0.0,
            "tie_atol": MATNET_TIE_ATOL}


def drive_matnet_atsp50(device, tmp, count=None, cli_batch=64, cli_steps=4):
    """MatNet at its published widths on ATSP-50: multistart greedy on the
    golden file's 256 JAX-generated instances (one dispatch, K1 at (256, 50,
    50, 256, 16)) held to the JAX CPU costs, departures proven near-ties; the
    POMO loss and every gradient on JAX's sampled actions for 8 instances
    (K1 under autograd); 4 train-CLI steps at 64 x 50."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.matnet import MatNet, MatNetPolicy
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import REINFORCE
    from rl4co_tpu_torch.tasks.eval import evaluate_policy
    from rl4co_tpu_torch.utils.ops import unbatchify

    gold = golden_npz("matnet_atsp50.npz")
    for k in ("cost_matrix", "cost", "actions"):   # ``count``: a rehearsal's slice
        gold[k] = gold[k][:count]
    env = get_env("atsp", num_loc=50)
    policy = zoo_policy("matnet", MatNetPolicy, device, **MATNET_FULL)
    inst = {"cost_matrix": gold["cost_matrix"]}
    n_inst = len(gold["cost"])
    widths, undo = record_launch_widths()
    try:
        reset_launches()
        res = evaluate_policy(env, policy, inst, "multistart_greedy", batch_size=n_inst,
                              device=device)
        eval_launches = dict(LAUNCHES)
        greedy = hold_multistart(env, policy, inst, gold["cost"], gold["actions"], device,
                                 "matnet_atsp50")
        eval_mean = float(-np.asarray(res["rewards"]).mean())
        assert abs(eval_mean - greedy["mean_cost"]) <= 1e-6 * eval_mean, (
            eval_mean, greedy["mean_cost"])   # the eval CLI's path gives the same tours
        greedy.update(seconds=res["inference_time"], launches=eval_launches)
        profiled = profile_dispatch(env, policy, inst, device, "multistart_greedy", n_inst)

        # the replayed POMO loss and its gradients
        n_rep = gold["replay_actions"].shape[0] // 50
        policy.train().requires_grad_(True)
        algo = MatNet(env, policy=policy, train_spec=DecodeSpec(kind="sampling",
                                                                tanh_clipping=10.0))
        reset_launches()
        calls, undo_bwd = count_backward_recomputes()
        try:
            loss, (metrics, out) = algo.loss({"cost_matrix": gold["cost_matrix"][:n_rep]},
                                             replay_actions=gold["replay_actions"])
            loss.backward()
        finally:
            undo_bwd()
        replay_launches = dict(LAUNCHES)
        r = unbatchify(out.reward, 50).detach().double()
        ll = unbatchify(out.log_likelihood, 50).detach().double()
        scale = float(((r - r.mean(-1, keepdim=True)) * ll).abs().mean())
        loss_err = abs(loss.item() - float(gold["loss"]))
        assert loss_err <= ZOO_LOSS_RTOL * scale, (loss.item(), float(gold["loss"]), scale)
        replay = {"instances": n_rep, "loss": loss.item(), "jax_loss": float(gold["loss"]),
                  "loss_err_over_terms_scale": loss_err / scale,
                  "gradients": hold_checksums(policy, gold, gauge=MATNET_GRAD_GAUGE),
                  "pointer_recomputes": len(calls), "launches": replay_launches}
        policy.zero_grad(set_to_none=True)
        policy.eval().requires_grad_(False)
        cli_calls, undo_bwd = count_backward_recomputes()
        try:
            report, cli_launches = train_cli(
                device, tmp, "matnet", "atsp", 50, [
                    "--batch-size", str(cli_batch), "--train-size", str(cli_batch * cli_steps),
                    "--val-size", str(cli_batch)], cli_steps, REINFORCE, profile_host=False)
        finally:
            undo_bwd()
        del report["algo"]
        # 49 recomputes per step (the first step's logits are not used), the
        # profiled step's among them
        assert len(cli_calls) == 49 * (cli_steps + 1), len(cli_calls)
        report["pointer_recomputes"] = len(cli_calls)
    finally:
        undo()
    # the warm-up dispatch and the timed one, 50 decode steps each; the replay
    # 50 steps under autograd and 49 recomputes in the backward (the first
    # step's logits are not used: its action is the start)
    assert eval_launches["pointer_step_grouped"] == 2 * 50, eval_launches
    assert replay_launches["pointer_step_grouped"] == 50 and len(calls) == 49, (
        replay_launches, len(calls))
    k1_full = [w for w in widths if w[0] == "pointer_step_grouped" and w[2:] == (50, 50, 256, 16)]
    assert k1_full, widths
    launches = {k: eval_launches[k] + replay_launches[k] + cli_launches[k] for k in LAUNCHES}
    return {"model": "MatNet 256/16 heads/5 layers/FFN 512 instance norm, ATSP-50, POMO "
                     "multistart over 50 starts, seeded weights",
            "greedy_multistart": greedy, "profiled_dispatch": profiled,
            "replayed_pomo_loss": replay, "cli": report,
            "launches_by_width": launches_by_width(widths),
            "tolerances": {"mean_rtol": ROUTING_MEAN_RTOL, "cost_rtol": ROUTING_COST_RTOL,
                           "tie_atol": MATNET_TIE_ATOL, "loss_rtol_of_terms": ZOO_LOSS_RTOL,
                           "grad_gauge": MATNET_GRAD_GAUGE},
            "launches": launches}, launches


def hold_paths(env, policy, inst, cost, gold_cost, gold_actions, device, what):
    """Every path's greedy costs ``[B, P]`` against JAX's, each path's
    departures proven near-ties; then the best path's mean."""
    reports = []
    for p in range(cost.shape[1]):
        first, gap = greedy_departures(env, policy.path(p), inst, gold_actions[p], device)
        reports.append(hold_costs_at_ties(cost[:, p], gold_cost[:, p], first, gap,
                                          f"{what} path {p}"))
    best, ref = cost.min(1), gold_cost.min(1)
    best_rel = float(abs(best.mean() - ref.mean()) / ref.mean())
    assert best_rel <= ROUTING_MEAN_RTOL, (what, best_rel)
    return {"paths": reports, "best_path_mean_cost": float(best.mean()),
            "jax_best_path_mean_cost": float(ref.mean()), "best_path_mean_rel_err": best_rel}


def drive_mdam_tsp50(device, tmp, count=None, cli_batch=512, cli_steps=4):
    """MDAM at its published widths (AM 128/8/3/512 batch norm, 5 paths) on
    the first 1 024 canonical TSP-50 instances: every path's greedy through
    K2 held to the JAX CPU costs; Embedding-Glimpse every 10 steps on 256 of
    them likewise; the loss with its KL on JAX's sampled actions for 8
    instances with every gradient; 4 train-CLI steps at batch 512."""
    from rl4co_tpu_torch.data.io import load_instances_npz
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.mdam import MDAM, MDAMPolicy
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    gold = golden_npz("mdam_tsp50.npz")
    env = get_env("tsp", num_loc=50)
    locs = load_instances_npz(os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz"))["locs"]
    for k in ("greedy_cost", "eg_cost"):   # ``count``: a rehearsal's slice
        gold[k] = gold[k][:count]
    for k in ("greedy_actions", "eg_actions"):
        gold[k] = gold[k][:, :count]
    inst = {"locs": locs[:gold["greedy_cost"].shape[0]]}
    policy = zoo_policy("mdam", MDAMPolicy, device)
    algo = MDAM(env, policy, train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    widths, undo = record_launch_widths()
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = -algo.path_rewards(inst).cpu().numpy()
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
        eval_launches = dict(LAUNCHES)
        greedy = hold_paths(env, policy, inst, cost, gold["greedy_cost"],
                            gold["greedy_actions"], device, "mdam_tsp50")
        greedy.update(seconds=greedy_s, launches=eval_launches)
        _, busy, n_launches, top = device_profile(lambda: algo.path_rewards(inst), host=False)
        greedy["profiled"] = {"device_busy_ms": busy, "device_launches": n_launches,
                              "device_busy_share": busy / (greedy_s * 1e3), "top_kernels": top}

        gap = int(gold["eg_gap"])
        eg_policy = zoo_policy("mdam", MDAMPolicy, device, eg_step_gap=gap)
        eg_algo = MDAM(env, eg_policy)
        n_eg = gold["eg_cost"].shape[0]
        reset_launches()
        eg_cost, eg_actions = eg_rollouts(eg_algo, {"locs": inst["locs"][:n_eg]}, device)
        eg_launches = dict(LAUNCHES)
        # EG changes the cache between segments: its tours are held by cost
        # against JAX's, a departure shown by the tour
        same_tour = np.array([[np.array_equal(a, b) for a, b in zip(
            p_actions, gold["eg_actions"][p])] for p, p_actions in enumerate(eg_actions)])
        eg_rel = np.abs(eg_cost - gold["eg_cost"]) / gold["eg_cost"]
        assert (eg_rel[same_tour.T] <= ROUTING_COST_RTOL).all()
        eg_mean_rel = float(abs(eg_cost.min(1).mean() - gold["eg_cost"].min(1).mean())
                            / gold["eg_cost"].min(1).mean())
        assert eg_mean_rel <= ROUTING_MEAN_RTOL, eg_mean_rel
        assert same_tour.mean() >= ROUTING_SAME_SHARE, same_tour.mean()
        eg = {"instances": n_eg, "gap": gap, "best_path_mean_cost": float(eg_cost.min(1).mean()),
              "jax_best_path_mean_cost": float(gold["eg_cost"].min(1).mean()),
              "best_path_mean_rel_err": eg_mean_rel, "share_tours_as_jax": float(same_tour.mean()),
              "launches": eg_launches}

        policy.train().requires_grad_(True)
        n_rep = gold["replay_actions"].shape[1]
        reset_launches()
        loss, (metrics, _) = algo.loss({"locs": inst["locs"][:n_rep]},
                                       replay_actions=gold["replay_actions"])
        loss.backward()
        replay_launches = dict(LAUNCHES)
        scale = float(gold["terms_scale"]) + algo.kl_coef * abs(float(gold["kl_divergence"]))
        loss_err = abs(loss.item() - float(gold["loss"]))
        assert loss_err <= ZOO_LOSS_RTOL * scale, (loss.item(), float(gold["loss"]), scale)
        kl_rel = abs(metrics["kl_divergence"].item() - float(gold["kl_divergence"])) / abs(
            float(gold["kl_divergence"]))
        assert kl_rel <= ZOO_LOSS_RTOL, kl_rel
        replay = {"instances": n_rep, "loss": loss.item(), "jax_loss": float(gold["loss"]),
                  "loss_err_over_terms_scale": loss_err / scale, "kl_rel_err": kl_rel,
                  "gradients": hold_checksums(policy, gold), "launches": replay_launches}
        policy.zero_grad(set_to_none=True)
        policy.eval().requires_grad_(False)
        report, cli_launches = train_cli(
            device, tmp, "mdam", "tsp", 50, [
                "--batch-size", str(cli_batch), "--train-size", str(cli_batch * cli_steps),
                "--val-size", str(cli_batch)], cli_steps, REINFORCE, profile_host=False)
        del report["algo"]
    finally:
        undo()
    # five paths of 50 steps each; the loss decodes each path's first step once more
    assert eval_launches["pointer_step_single"] == 5 * 50, eval_launches
    assert all(s["pointer_step_single"] == 5 * 51 for s in report["launches_per_step"]), report
    launches = {k: eval_launches[k] + eg_launches[k] + replay_launches[k] + cli_launches[k]
                for k in LAUNCHES}
    return {"model": "MDAM, 5 paths, AM 128/8/3/512 batch norm, TSP-50, seeded weights",
            "greedy": greedy, "embedding_glimpse": eg, "replayed_loss": replay, "cli": report,
            "launches_by_width": launches_by_width(widths),
            "launches": launches}, launches


def eg_rollouts(algo, inst, device):
    """Every path's Embedding-Glimpse greedy costs ``[B, P]`` and tours
    ``[P, B, N]`` (numpy)."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.policies.constructive import instances_to_device
    from rl4co_tpu_torch.models.zoo.mdam import rollout_eg

    inst = instances_to_device(inst, device)
    with torch.no_grad():
        emb, h_old = algo.policy.encode_with_hidden(inst)
        outs = [rollout_eg(algo.policy, algo.env, inst, algo.policy.precompute_path(emb, p),
                           h_old, DecodeSpec(kind="greedy"), p)
                for p in range(algo.policy.num_paths)]
    return (-torch.stack([o.reward for o in outs], 1).cpu().numpy(),
            [o.actions.cpu().numpy() for o in outs])


def drive_ham_pdp50(device, tmp, count=None, cli_batch=512, cli_steps=4):
    """HAM (AM 128/8/3/512 batch norm with the heterogeneous encoder) on
    PDP-50: greedy on the golden file's 1 024 JAX-generated instances in one
    dispatch through K2 (N 51), held to the JAX CPU costs with departures
    proven near-ties; 4 train-CLI steps at batch 512."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.ham import HAMPolicy
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import REINFORCE
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    gold = golden_npz("ham_pdp50.npz")
    env = get_env("pdp", num_loc=50)
    policy = zoo_policy("ham", HAMPolicy, device)
    for k in ("locs", "depot", "cost", "actions"):   # ``count``: a rehearsal's slice
        gold[k] = gold[k][:count]
    inst = {"locs": gold["locs"], "depot": gold["depot"]}
    count = len(gold["cost"])
    reset_launches()
    res = evaluate_policy(env, policy, inst, "greedy", batch_size=count, device=device)
    eval_launches = dict(LAUNCHES)
    first, gap = greedy_departures(env, policy, inst, gold["actions"], device)
    greedy = hold_costs_at_ties(-np.asarray(res["rewards"]), gold["cost"], first, gap,
                                "ham_pdp50")
    greedy.update(seconds=res["inference_time"], launches=eval_launches)
    profiled = profile_dispatch(env, policy, inst, device, "greedy", count)
    report, cli_launches = train_cli(
        device, tmp, "ham", "pdp", 50, [
            "--batch-size", str(cli_batch), "--train-size", str(cli_batch * cli_steps),
            "--val-size", str(cli_batch)], cli_steps, REINFORCE, profile_host=False)
    del report["algo"]
    assert eval_launches["pointer_step_single"] == 2 * env.max_steps, eval_launches  # + warm-up
    launches = {k: eval_launches[k] + cli_launches[k] for k in LAUNCHES}
    return {"model": "HAM 128/8/3/512 batch norm, PDP-50, seeded weights", "greedy": greedy,
            "profiled_dispatch": profiled, "cli": report, "launches": launches}, launches


def timed_no_grad(fn):
    """``fn()`` without a graph, synchronised: (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_matnet_ffsp20(device, count=None):
    """MatNet on the MatNet paper's FFSP20 (3 stages x 4 machines, 20 jobs,
    run times 2-9) at 256 wide, 16 heads, 3 layers, FFN 512: greedy on the
    golden file's 256 JAX-generated instances in one dispatch, makespans and
    schedules equal to the JAX package's. The pointer has an output bias:
    no kernel."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models import rollout
    from rl4co_tpu_torch.models.zoo.matnet_ffsp import MatNetFFSPPolicy
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    gold = golden_npz("matnet_ffsp20.npz")
    env = get_env("ffsp", **FFSP20)
    policy = zoo_policy("matnet_ffsp", MatNetFFSPPolicy, device, **FFSP_FULL)
    for k in ("run_time", "makespan", "actions"):   # ``count``: a rehearsal's slice
        gold[k] = gold[k][:count]
    inst = {"run_time": gold["run_time"].astype(np.int64)}

    def run():
        return rollout(policy, env, inst, DecodeSpec(kind="greedy"), device=device)

    reset_launches()
    run()   # warm-up
    out, seconds = timed_no_grad(run)
    launches = dict(LAUNCHES)
    makespan = -out.reward.cpu().numpy()
    assert np.array_equal(makespan, gold["makespan"]), np.abs(makespan - gold["makespan"]).max()
    assert np.array_equal(out.actions.cpu().numpy(), gold["actions"].astype(np.int64))
    _, busy, n_launches, top = device_profile(lambda: timed_no_grad(run), host=False)
    waits = float((gold["actions"] == FFSP20["num_job"]).mean())
    return {"model": "MatNet-FFSP 256/16 heads/3 layers/FFN 512, FFSP20 (3x4 machines, 20 "
                     "jobs, run times 2-9), seeded weights",
            "instances": len(makespan), "mean_makespan": float(makespan.mean()),
            "makespans_equal": True, "schedules_equal": True,
            "share_of_wait_actions": waits, "seconds": seconds,
            "profiled": {"device_busy_ms": busy, "device_launches": n_launches,
                         "device_busy_share": busy / (seconds * 1e3), "top_kernels": top},
            "launches": launches}, launches


def drive_l2d_fjsp_jssp(device, tmp, count=None, cli_batch=64, cli_steps=4):
    """L2DPolicy (JAX defaults) greedy on 256 FJSP 10x5 instances and
    L2DAttnPolicy 128/8/4 on 256 JSSP 10x10 instances, makespans and
    schedules equal to the JAX package's; one JAX StepwisePPO step replayed
    on 64 FJSP 10x5 instances (its draws): the transitions, the first
    minibatch's loss and gradients, the step's metrics; `--model l2d-ppo`
    through the train command line for 4 steps. No kernel."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo.l2d import (L2DAttnPolicy, L2DPolicy, l2d_attn_rollout,
                                                l2d_rollout)
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.stepwise_ppo import StepwisePPO

    gold = golden_npz("l2d_fjsp_jssp.npz")
    keys = ("proc_times", "pad_mask", "start_op_per_job", "end_op_per_job")
    reset_launches()
    greedy = {}
    for name, env_kw, tree, cls, fn, kw in (
            ("fjsp", dict(num_jobs=10, num_mas=5), "l2d", L2DPolicy, l2d_rollout, {}),
            ("jssp", dict(num_jobs=10, num_mas=10), "l2d_attn", L2DAttnPolicy,
             l2d_attn_rollout, L2D_ATTN_FULL)):
        env = get_env(name, **env_kw)
        policy = zoo_policy(tree, cls, device, **kw)
        inst = {k: torch.as_tensor(gold[f"{name}_{k}"][:count]).to(device) for k in keys}

        def run():
            return fn(policy, env, inst, DecodeSpec(kind="greedy"))

        run()
        out, seconds = timed_no_grad(run)
        makespan = -out.reward.cpu().numpy()
        assert np.array_equal(makespan, gold[f"{name}_makespan"][:count]), name
        assert np.array_equal(out.actions.cpu().numpy(), gold[f"{name}_actions"][:count]), name
        _, busy, n_launches, top = device_profile(lambda: timed_no_grad(run), host=False)
        greedy[name] = {"instances": len(makespan), "mean_makespan": float(makespan.mean()),
                        "makespans_equal": True, "schedules_equal": True, "seconds": seconds,
                        "device_busy_ms": busy, "device_launches": n_launches,
                        "device_busy_share": busy / (seconds * 1e3), "top_kernels": top}

    # one JAX StepwisePPO step replayed
    policy = zoo_policy("l2d", L2DPolicy, device, with_critic=True).train()
    mb = gold["ppo_minibatches"].shape[1]
    algo = StepwisePPO(get_env("fjsp", num_jobs=10, num_mas=5), policy, mini_batch_size=mb)
    inst = {k: gold[f"ppo_{k}"] for k in keys}
    collected = algo.collect({k: torch.as_tensor(v).to(device) for k, v in inst.items()},
                             torch.as_tensor(gold["ppo_actions"].astype(np.int64)).to(device))
    old_lp, rewards = collected[3].cpu().numpy(), collected[4].cpu().numpy()
    lp_err = float(np.abs(old_lp - gold["ppo_old_logp"]).max())
    rew_err = float(np.abs(rewards - gold["ppo_rewards"]).max())
    assert lp_err <= 1e-5 and rew_err <= 1e-5, (lp_err, rew_err)
    seen = {}

    def on_minibatch(i, loss, metrics):
        if i == 0:
            seen["loss"] = loss.item()
            seen["gradients"] = hold_checksums(policy, gold, prefix="ppo_")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = algo.update(inst, replay_actions=gold["ppo_actions"].astype(np.int64),
                          minibatches=gold["ppo_minibatches"], on_minibatch=on_minibatch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    first_rel = abs(seen["loss"] - float(gold["ppo_first_loss"])) / abs(
        float(gold["ppo_first_loss"]))
    assert first_rel <= ZOO_LOSS_RTOL, first_rel
    metric_rel = {k: abs(metrics[k].item() - float(gold[f"ppo_metric_{k}"]))
                  / abs(float(gold[f"ppo_metric_{k}"]))
                  for k in ("loss", "surrogate_loss", "value_loss", "entropy")}
    assert max(metric_rel.values()) <= PPO_METRIC_RTOL, metric_rel
    assert metrics["reward"].item() == float(gold["ppo_metric_reward"])
    replay = {"instances": len(gold["ppo_actions"]), "minibatches": len(gold["ppo_minibatches"]),
              "old_logp_max_abs_err": lp_err, "reward_max_abs_err": rew_err,
              "first_minibatch_loss_rel_err": first_rel, "first_minibatch": seen["gradients"],
              "metrics_rel_err": metric_rel, "step_seconds": step_s}
    report, cli_launches = train_cli(
        device, tmp, "l2d-ppo", "tsp", 20, [
            "--batch-size", str(cli_batch), "--train-size", str(cli_batch * cli_steps),
            "--val-size", str(cli_batch)], cli_steps, StepwisePPO, profile_host=False)
    del report["algo"]
    launches = dict(LAUNCHES)
    assert sum(launches.values()) == 0, launches   # no pointer kernel on these paths
    return {"models": {"fjsp": "L2DPolicy 64/2 layers/actor 64 instance norm, FJSP 10x5",
                       "jssp": "L2DAttnPolicy 128/8/4 batch norm, JSSP 10x10",
                       "ppo": "L2DPolicy with critic, StepwisePPO (2 epochs, minibatches of "
                              "128, clip 0.2), FJSP 10x5; the CLI on FJSP's defaults (5x3)"},
            "greedy": greedy, "stepwise_ppo_replay": replay, "cli": report,
            "tolerances": {"first_loss_rtol": ZOO_LOSS_RTOL, "grad_gauge": ZOO_GRAD_GAUGE,
                           "metrics_rtol": PPO_METRIC_RTOL},
            "launches": launches}, launches


# ------------------------------------------------- infrastructure: dp, Reptile, remat

DP_WORLD = 2
# The ranks replay the one-process run's tours (``kind="evaluate"``) and its
# random stream, so that the comparison holds the data-parallel arithmetic
# and not the sampler: each rank's batch norm sums its rows before the
# all-reduce, so the logits differ from the one-process run's in their last
# bits, and a near-uniform policy's draw at an edge of its CDF would send a
# tour elsewhere (a logit change of 1e-5 flips it), from where the runs part.
# With the tours replayed, every step's loss and mean reward lie within
# DP_SAME_RTOL of the one-process run's, and the parameters after every step
# have DP_CLOSE_SHARE of their elements within 1e-6 and all within
# DP_PARAM_ATOL (Adam turns the rounding noise of gradients that vanish,
# biases before a norm, into steps of +-lr; the JAX package's
# `tests/test_sharding.py` holds its dp parameters at 1e-3 for it).
DP_SAME_RTOL = 1e-5
DP_CLOSE_SHARE = 0.98
DP_PARAM_ATOL = 1e-3
REMAT_GRAD_GAUGE = 1e-6  # remat's gradients, of the largest
REPTILE_TASKS = ({"num_loc": 20}, {"num_loc": 50}, {"num_loc": 100})
# seed 0 draws 50 (the meta-weights' first policy), then 50, 20, 50, 100: the
# fourth epoch is the first at N 100
REPTILE_EPOCHS, REPTILE_STEPS, REPTILE_BATCH = 4, 3, 64
# Python run in each data-parallel rank before `dp_run` (a CPU rehearsal puts
# its stubs here)
DP_CHILD_PRELUDE = ""
# tensor parallelism: dp x model processes on the card replay the first
# TP_STEPS of `drive_dp_am_tsp50`'s one-process steps; expert parallelism:
# EP_MODEL processes replay `train_mvmoe`'s first EP_STEPS steps; both at the
# dp holds above
TP_DP, TP_MODEL, TP_STEPS = 2, 2, 2
EP_MODEL, EP_STEPS = 2, 2
# eval_oom_halving: the card's free memory left to the evaluation
OOM_KEEP_FREE = 2 << 30


def dp_argv(tmp, name, batch=512, steps=4, val=256):
    """AM at its published widths on TSP-50 through the train CLI, f32, one
    epoch of ``steps`` steps at the global ``batch``, with TensorBoard, MLflow
    and a profile of one step, into ``tmp/name``."""
    out = os.path.join(tmp, name)
    return ["--model", "am", "--env", "tsp", "--num-loc", "50", "--batch-size", str(batch),
            "--train-size", str(steps * batch), "--val-size", str(val), "--epochs", "1",
            "--precision", "f32", "--ckpt-dir", os.path.join(out, "ckpt"),
            "--log-file", os.path.join(out, "log.jsonl"),
            "--tensorboard", os.path.join(out, "tb"), "--mlflow", os.path.join(out, "mlruns"),
            "--profile-dir", os.path.join(out, "profile"), "--profile-steps", "1"]


def dp_run(argv, out_json, replay=None, model=1):
    """The train CLI in this process with every train step timed and its
    launches counted; writes the steps, the launches and their shapes, the
    whole parameters, the tours and the generator's state after each step,
    and the tours of every greedy rollout (``<out_json>.pt``). The
    one-process reference of `drive_dp_am_tsp50` (``replay`` None), or a
    rank of it that replays, from the reference's ``.pt`` file ``replay``,
    its rows of each step's tours and the reference's random stream after
    each step. With ``model > 1`` the CLI's processes form a ``(dp, model)``
    mesh and the policy is split over its model axis once the CLI has built
    it (`shard_params_model_axis` at its default ``min_dim``): the train
    CLI has no flag for the axis, as the JAX package's has none."""
    from rl4co_tpu_torch import train
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.parallel import mesh as mesh_mod
    from rl4co_tpu_torch.parallel.mesh import active_shard
    from rl4co_tpu_torch.rl import reinforce
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    reference = None if replay is None else torch.load(replay)
    done, undo = instrument_updates(REINFORCE)
    shapes, undo_shapes = record_launch_shapes()
    tours, snapshots, streams, greedy_tours, decisions = [], [], [], [], {}
    inner_rollout, inner_update = REINFORCE.train_rollout, REINFORCE.update
    inner_any_rollout = reinforce.rollout
    inner_init, inner_build = mesh_mod.init_distributed, train.build

    def train_rollout(self, *args, **kwargs):
        out = inner_rollout(self, *args, **kwargs)
        tours.append(out.actions.cpu())
        return out

    def any_rollout(policy, env, instances, spec, *args, **kwargs):
        out = inner_any_rollout(policy, env, instances, spec, *args, **kwargs)
        if spec.kind == "greedy":
            greedy_tours.append(out.actions.cpu())
        return out

    def update(self, instances):   # the replay and the records outside the timed step
        i, actions = len(snapshots), None
        if reference is not None:
            shard = active_shard()
            lo = shard.mesh.rank * shard.local_batch
            actions = reference["tours"][i][lo:lo + shard.local_batch].to(self.device)
        metrics = inner_update(self, instances, actions)
        if reference is not None:
            self.generator.set_state(reference["streams"][i])
        streams.append(self.generator.get_state())
        whole = mesh_mod.full_state_dict(self.policy)
        snapshots.append({k: whole[k].cpu().clone() for k, _ in self.policy.named_parameters()})
        return metrics

    def init_distributed(*args, **kwargs):
        _, dev = inner_init(*args, **kwargs)
        return mesh_mod.make_mesh(model=model), dev

    def build(spec, mesh=None, **kwargs):
        algo, trainer = inner_build(spec, mesh=mesh, **kwargs)
        decisions.update(mesh_mod.shard_params_model_axis(algo.policy, mesh))
        return algo, trainer

    REINFORCE.train_rollout, REINFORCE.update = train_rollout, update
    reinforce.rollout = any_rollout
    if model > 1:
        mesh_mod.init_distributed, train.build = init_distributed, build
    t0 = time.perf_counter()
    try:
        reset_launches()
        algo = train.main(argv)
        launches = dict(LAUNCHES)
    finally:
        REINFORCE.train_rollout, REINFORCE.update = inner_rollout, inner_update
        reinforce.rollout = inner_any_rollout
        mesh_mod.init_distributed, train.build = inner_init, inner_build
        undo()
        undo_shapes()
    torch.save({"params": snapshots, "tours": tours, "streams": streams,
                "greedy_tours": greedy_tours}, out_json + ".pt")
    with open(out_json, "w") as f:
        json.dump({"steps": [{k: s[k] for k in ("ms", "loss", "metrics", "launches")}
                             for s in done],
                   "launches": launches, "cli_seconds": time.perf_counter() - t0,
                   "launch_shapes": sorted({json.dumps(s) for s in shapes}),
                   "decisions": {k: sum(v == k for v in decisions.values())
                                 for k in ("row", "col", "expert", "replicated")},
                   "device": str(algo.device)}, f)


def start_ranks(code_for, world, timeout=600):
    """``world`` processes on this machine joined as ranks of one group
    (``RANK``, ``WORLD_SIZE``, ... for `init_distributed`), each running the
    Python of ``code_for(rank)`` after `DP_CHILD_PRELUDE`; waits for all,
    asserts that each exited with 0 and returns the seconds it took."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        code = "; ".join(filter(None, [
            f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke", DP_CHILD_PRELUDE,
            code_for(rank)]))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outputs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-4000:]
    return time.perf_counter() - t0


def param_deviation(got: dict, want: dict):
    """The largest absolute difference over every parameter, and the share
    of their elements within 1e-6."""
    dev = [(got[k] - want[k]).abs() for k in want]
    return (max(d.max().item() for d in dev),
            sum((d <= 1e-6).sum().item() for d in dev) / sum(d.numel() for d in dev))


def drive_dp_am_tsp50(device, tmp, batch=512, steps=4):
    """Data-parallel AM training through the train CLI: ``--distributed``
    ranks on the one card (gloo), each running its ``batch / 2`` rows of the
    global batch, against the one-process run of the same command, whose
    tours and random stream the ranks replay. Each step's global loss and
    mean reward, and the parameters after each step, against the one-process
    run; both ranks' parameters equal to the bit; K2 launched in every step
    of both ranks (the replayed rollout and the baseline's greedy one); the
    TensorBoard and MLflow files of rank 0 and the busy share of the
    profiled steps."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    one_argv = [*dp_argv(tmp, "one", batch, steps), "--dp", "1", "--device", str(device)]
    dp_run(one_argv, os.path.join(tmp, "one.json"))
    one = json.load(open(os.path.join(tmp, "one.json")))
    one_saved = torch.load(os.path.join(tmp, "one.json.pt"))

    flag = ["--device", "cpu" if device.type == "cpu" else "cuda"]
    argv = [*dp_argv(tmp, "dp", batch, steps), *flag]
    dp_seconds = start_ranks(lambda rank: (
        f"chip_smoke.dp_run({[*argv, '--distributed']!r}, "
        f"{os.path.join(tmp, f'rank{rank}.json')!r}, "
        f"{os.path.join(tmp, 'one.json.pt')!r})"), DP_WORLD)
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(DP_WORLD)]
    saved = [torch.load(os.path.join(tmp, f"rank{r}.json.pt")) for r in range(DP_WORLD)]
    params = [x["params"][-1] for x in saved]
    # the replay: each step's tours, the ranks' rows in rank order, are the one-process run's
    for i in range(steps):
        assert torch.equal(torch.cat([x["tours"][i] for x in saved]), one_saved["tours"][i]), i

    per_step = {"pointer_step_single": 100, "pointer_step_grouped": 0}
    for r in ranks + [one]:
        assert len(r["steps"]) == steps and all(s["launches"] == per_step for s in r["steps"]), (
            [s["launches"] for s in r["steps"]])
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(ranks[0]["steps"], one["steps"])]
    reward_rel = [abs(a["metrics"]["reward"] - b["metrics"]["reward"]) / abs(b["metrics"]["reward"])
                  for a, b in zip(ranks[0]["steps"], one["steps"])]
    for r in ranks[1:]:
        assert [s["loss"] for s in r["steps"]] == [s["loss"] for s in ranks[0]["steps"]]

    same = [param_deviation(saved[0]["params"][i], one_saved["params"][i]) for i in range(steps)]
    emit({"phase": "dp_am_tsp50_readings", "loss_rel_err": loss_rel,
          "reward_rel_err": reward_rel,
          "param_max_abs_dev_and_share_within_1e-6_per_step": same})
    for i in range(steps):
        assert loss_rel[i] <= DP_SAME_RTOL and reward_rel[i] <= DP_SAME_RTOL, (
            i, loss_rel, reward_rel)
        assert same[i][0] <= DP_PARAM_ATOL and same[i][1] >= DP_CLOSE_SHARE, (i, same)
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), f"ranks differ in {k}"

    def profiled(argv, run):
        """The trainer's profile record: device busy over the profiled wall,
        and per step over the median unprofiled step."""
        records = read_jsonl(argv[argv.index("--log-file") + 1])
        rec = [r for r in records if "profile/wall_ms" in r][0]
        median = statistics.median(s["ms"] for s in run["steps"])
        return {"steps": rec["profile/steps"], "wall_ms": rec["profile/wall_ms"],
                "device_busy_ms": rec["profile/device_busy_ms"],
                "busy_share_under_profiler": rec["profile/device_busy_ms"] / rec["profile/wall_ms"],
                "busy_share_of_median_step":
                    rec["profile/device_busy_ms"] / rec["profile/steps"] / median}

    logs = {}
    for name, a, run in (("dp", argv, ranks[0]), ("one", one_argv, one)):
        acc = EventAccumulator(a[a.index("--tensorboard") + 1])
        acc.Reload()
        loss_steps = [s.step for s in acc.Scalars("loss")]
        (mlflow_run,) = [d for d in os.scandir(os.path.join(a[a.index("--mlflow") + 1], "0"))
                         if d.is_dir()]
        with open(os.path.join(mlflow_run.path, "metrics", "loss")) as f:
            mlflow_steps = [int(line.split()[2]) for line in f]
        with open(os.path.join(mlflow_run.path, "meta.yaml")) as f:
            assert "status: 3" in f.read()
        assert loss_steps == mlflow_steps == [0], (loss_steps, mlflow_steps)
        assert "val/reward" in acc.Tags()["scalars"]
        assert os.path.getsize(os.path.join(a[a.index("--profile-dir") + 1],
                                            "trace_rank0.json" if name == "dp" else "trace.json"))
        logs[name] = {"tensorboard_loss_steps": loss_steps, "mlflow_loss_steps": mlflow_steps,
                      "profiled": profiled(a, run)}
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return {"model": "AM 128/8/3/512 batch norm, TSP-50, f32, rollout baseline behind its "
                     "warm-up, Adam 1e-4, global batch 512",
            "ranks": DP_WORLD, "backend": "gloo (two ranks on one card)",
            "devices": [r["device"] for r in ranks], "steps": steps,
            "replayed": "the one-process run's tours and random stream",
            "tolerances": {"same_run_rtol": DP_SAME_RTOL, "close_share": DP_CLOSE_SHARE,
                           "param_atol": DP_PARAM_ATOL},
            "param_max_abs_dev_and_share_within_1e-6_per_step": same,
            "loss_rel_err": loss_rel, "reward_rel_err": reward_rel,
            "losses": [s["loss"] for s in ranks[0]["steps"]],
            "one_process_losses": [s["loss"] for s in one["steps"]],
            "step_ms": {f"rank{r}": [s["ms"] for s in x["steps"]] for r, x in enumerate(ranks)},
            "one_process_step_ms": [s["ms"] for s in one["steps"]],
            "step_ms_median": {"dp_rank0": statistics.median(s["ms"] for s in ranks[0]["steps"]),
                               "one_process": statistics.median(s["ms"] for s in one["steps"])},
            "k2_launches_per_step": per_step["pointer_step_single"],
            "launches_by_rank": [r["launches"] for r in ranks],
            "one_process_launches": one["launches"],
            "logs": logs, "dp_seconds": dp_seconds,
            "one_process_cli_seconds": one["cli_seconds"]}, launches, one["launches"]


def drive_tp_am_tsp50(device, tmp, batch=512, steps=TP_STEPS):
    """Tensor parallelism: `drive_dp_am_tsp50`'s configuration on ``TP_DP x
    TP_MODEL`` processes on the one card (gloo), the policy split over the
    model axis at the default ``min_dim`` (every Megatron pair, the column
    rule and the gathered decoder at full width), each replaying its dp
    rank's rows of the one-process run's first ``steps`` steps (its tours
    and random stream, from ``tmp``, where `drive_dp_am_tsp50` left them).
    Each step's global loss and mean reward and the whole parameters after
    it against the one-process run at the dp holds; every process's whole
    parameters and the model ranks' greedy tours equal to the bit; K2's
    launches per rank per step (the replayed rollout and the baseline's
    greedy one) at B ``batch / TP_DP``, N 50; the checkpoint written under
    the mesh holds the whole last parameters; ms per step and the busy
    share of one profiled step."""
    one = json.load(open(os.path.join(tmp, "one.json")))
    one_saved = torch.load(os.path.join(tmp, "one.json.pt"))
    world = TP_DP * TP_MODEL
    flag = ["--device", "cpu" if device.type == "cpu" else "cuda"]
    argv = [*dp_argv(tmp, "tp", batch, steps), *flag, "--distributed"]
    seconds = start_ranks(lambda rank: (
        f"chip_smoke.dp_run({argv!r}, {os.path.join(tmp, f'tp{rank}.json')!r}, "
        f"{os.path.join(tmp, 'one.json.pt')!r}, model={TP_MODEL})"), world)
    ranks = [json.load(open(os.path.join(tmp, f"tp{r}.json"))) for r in range(world)]
    saved = [torch.load(os.path.join(tmp, f"tp{r}.json.pt")) for r in range(world)]

    for i in range(steps):   # the dp ranks' rows of the replayed tours, model rank 0's
        assert torch.equal(torch.cat([saved[d * TP_MODEL]["tours"][i] for d in range(TP_DP)]),
                           one_saved["tours"][i]), i
    for d in range(TP_DP):   # the model ranks' own greedy tours
        for j in range(1, TP_MODEL):
            a, b = saved[d * TP_MODEL]["greedy_tours"], saved[d * TP_MODEL + j]["greedy_tours"]
            assert len(a) == len(b) > steps and all(torch.equal(x, y) for x, y in zip(a, b)), d
    per_step = {"pointer_step_single": 100, "pointer_step_grouped": 0}
    for r in ranks:
        assert len(r["steps"]) == steps and all(s["launches"] == per_step for s in r["steps"]), (
            [s["launches"] for s in r["steps"]])
        shapes = {tuple(json.loads(s))[:4] for s in r["launch_shapes"]}   # steps, evaluations
        assert ("pointer_step_single", batch // TP_DP, None, 50) in shapes and all(
            s[0] == "pointer_step_single" and s[3] == 50 for s in shapes), shapes
        assert r["decisions"]["row"] and r["decisions"]["col"], r["decisions"]
    losses = [[s["loss"] for s in r["steps"]] for r in ranks]
    assert all(x == losses[0] for x in losses), losses
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(ranks[0]["steps"], one["steps"])]
    reward_rel = [abs(a["metrics"]["reward"] - b["metrics"]["reward"]) / abs(b["metrics"]["reward"])
                  for a, b in zip(ranks[0]["steps"], one["steps"])]
    same = [param_deviation(saved[0]["params"][i], one_saved["params"][i]) for i in range(steps)]
    emit({"phase": "tp_am_tsp50_readings", "loss_rel_err": loss_rel,
          "reward_rel_err": reward_rel,
          "param_max_abs_dev_and_share_within_1e-6_per_step": same})
    for i in range(steps):
        assert loss_rel[i] <= DP_SAME_RTOL and reward_rel[i] <= DP_SAME_RTOL, (
            i, loss_rel, reward_rel)
        assert same[i][0] <= DP_PARAM_ATOL and same[i][1] >= DP_CLOSE_SHARE, (i, same)
    last = saved[0]["params"][-1]
    for x in saved[1:]:
        for k in last:
            assert torch.equal(x["params"][-1][k], last[k]), f"processes differ in {k}"
    ckpt = torch.load(os.path.join(argv[argv.index("--ckpt-dir") + 1], "last.pt"),
                      map_location="cpu", weights_only=True)["state"]["policy"]
    for k in last:
        assert torch.equal(ckpt[k], last[k]), f"the checkpoint's {k} is not the whole parameter"

    records = read_jsonl(argv[argv.index("--log-file") + 1])
    rec = [r for r in records if "profile/wall_ms" in r][0]
    median = statistics.median(s["ms"] for s in ranks[0]["steps"])
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return {"model": "AM 128/8/3/512 batch norm, TSP-50, f32, rollout baseline behind its "
                     "warm-up, Adam 1e-4, global batch 512",
            "mesh": {"dp": TP_DP, "model": TP_MODEL}, "backend": "gloo (four ranks on one card)",
            "decisions": ranks[0]["decisions"], "devices": [r["device"] for r in ranks],
            "steps": steps, "replayed": "the one-process run's tours and random stream",
            "tolerances": {"same_run_rtol": DP_SAME_RTOL, "close_share": DP_CLOSE_SHARE,
                           "param_atol": DP_PARAM_ATOL},
            "param_max_abs_dev_and_share_within_1e-6_per_step": same,
            "loss_rel_err": loss_rel, "reward_rel_err": reward_rel, "losses": losses[0],
            "greedy_rollouts_equal_across_model_ranks": len(saved[0]["greedy_tours"]),
            "step_ms": {f"rank{r}": [s["ms"] for s in x["steps"]] for r, x in enumerate(ranks)},
            "step_ms_median_rank0": median,
            "profiled": {"steps": rec["profile/steps"], "wall_ms": rec["profile/wall_ms"],
                         "device_busy_ms": rec["profile/device_busy_ms"],
                         "busy_share_under_profiler":
                             rec["profile/device_busy_ms"] / rec["profile/wall_ms"],
                         "busy_share_of_median_step":
                             rec["profile/device_busy_ms"] / rec["profile/steps"] / median},
            "k2_launches_per_rank_per_step": per_step["pointer_step_single"],
            "launch_shapes": ranks[0]["launch_shapes"],
            "launches_by_rank": [r["launches"] for r in ranks], "seconds": seconds}, launches


def mvmoe_algorithm(env, device):
    """`train_mvmoe`'s MVMoE-POMO, weights from torch seed 1234."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.zoo.mvmoe import MVMoE_POMO

    torch.manual_seed(1234)
    return MVMoE_POMO(env, policy_kwargs=dict(device=device),
                      train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))


def record_updates(algo, count):
    """Record ``algo``'s first ``count`` updates: the tours of their rollouts,
    the generator's state, the metrics and the parameters after each;
    returns the dict it fills."""
    rec = {"tours": [], "streams": [], "params": [], "loss": [], "reward": []}
    inner_rollout, inner_update = algo.train_rollout, algo.update

    def train_rollout(*args, **kwargs):
        out = inner_rollout(*args, **kwargs)
        if len(rec["tours"]) < count:
            rec["tours"].append(out.actions.detach().clone())
        return out

    def update(*args, **kwargs):
        metrics = inner_update(*args, **kwargs)
        if len(rec["streams"]) < count:
            rec["streams"].append(algo.generator.get_state())
            rec["params"].append({k: p.detach().clone()
                                  for k, p in algo.policy.named_parameters()})
            rec["loss"].append(metrics["loss"].item())
            rec["reward"].append(metrics["reward"].item())
        return metrics

    algo.train_rollout, algo.update = train_rollout, update
    return rec


def ep_run(reference_path, out_json, steps, model, batch=64, device="cuda"):
    """A rank of the ``(dp 1, model)`` mesh of `drive_ep_mvmoe_cvrp50`:
    `mvmoe_algorithm` with its experts split over the model axis, replaying
    the one-process run's first ``steps`` updates (its tours, then its
    random stream after each); writes per step the metrics, ms, launches,
    the replayed rollout's log-likelihoods and the whole parameters."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.parallel import mesh as mesh_mod

    ref = torch.load(reference_path)
    _, device = mesh_mod.init_distributed(device)
    try:
        mesh = mesh_mod.make_mesh(dp=1, model=model)
        algo = mvmoe_algorithm(get_env("cvrp", num_loc=50), device)
        decisions = mesh_mod.shard_params_model_axis(algo.policy, mesh)
        algo.reseed(61)
        inner_rollout, inner_update = algo.train_rollout, algo.update
        out = {"steps": [], "params": [], "log_likelihood": []}

        def train_rollout(*args, **kwargs):
            o = inner_rollout(*args, **kwargs)
            out["log_likelihood"].append(o.log_likelihood.detach().cpu())
            return o

        algo.train_rollout = train_rollout
        for i in range(steps):
            algo.update = lambda instances, i=i: inner_update(instances, ref["tours"][i].to(device))
            sync(device)
            before, t0 = dict(LAUNCHES), time.perf_counter()
            metrics = algo.train_step(batch, mesh=mesh)
            sync(device)
            out["steps"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                 "loss": metrics["loss"].item(),
                                 "reward": metrics["reward"].item(),
                                 "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}})
            algo.generator.set_state(ref["streams"][i])
            whole = mesh_mod.full_state_dict(algo.policy)
            out["params"].append({k: whole[k].cpu() for k, _ in algo.policy.named_parameters()})
        out["decisions"] = {k: sum(v == k for v in decisions.values())
                            for k in ("row", "col", "expert", "replicated")}
        out["local_experts"] = algo.policy.pointer.project_out_moe.experts.Dense_0.kernel.shape[0]
        torch.save(out, out_json)
    finally:
        torch.distributed.destroy_process_group()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive_ep_mvmoe_cvrp50(device, tmp, reference, steps=EP_STEPS, batch=64):
    """Expert parallelism: `train_mvmoe`'s MVMoE-POMO (128/8/6/512, 4
    experts, top-2, CVRP-50, ``batch`` x 50 starts) on ``EP_MODEL`` processes on the
    card (gloo), two experts on each, replaying the one-process run's first
    ``steps`` steps (``reference``: `record_updates` of `train_mvmoe`). Each
    step's loss and mean reward and the whole parameters against that run at
    the dp holds; both processes' log-likelihoods and whole parameters equal
    to the bit; no pointer kernel (MVMoE's head is `pointer_logits` with an
    MoE projection)."""
    path = os.path.join(tmp, "mvmoe_reference.pt")
    torch.save({k: [t.cpu() if isinstance(t, torch.Tensor) else t for t in v]
                for k, v in reference.items() if k in ("tours", "streams")}, path)
    seconds = start_ranks(lambda rank: (
        f"chip_smoke.ep_run({path!r}, {os.path.join(tmp, f'ep{rank}.pt')!r}, {steps}, "
        f"{EP_MODEL}, {batch}, {'cpu' if device.type == 'cpu' else 'cuda'!r})"), EP_MODEL)
    ranks = [torch.load(os.path.join(tmp, f"ep{r}.pt")) for r in range(EP_MODEL)]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["log_likelihood"],
                                                      ranks[0]["log_likelihood"]))
        for k in ranks[0]["params"][-1]:
            assert torch.equal(r["params"][-1][k], ranks[0]["params"][-1][k]), k
        assert [s["loss"] for s in r["steps"]] == [s["loss"] for s in ranks[0]["steps"]]
    assert all(r["local_experts"] == 4 // EP_MODEL for r in ranks)
    assert ranks[0]["decisions"]["expert"] > 0, ranks[0]["decisions"]
    none = {"pointer_step_single": 0, "pointer_step_grouped": 0}
    assert all(s["launches"] == none for r in ranks for s in r["steps"])
    steps_0 = ranks[0]["steps"]
    loss_rel = [abs(s["loss"] - ref) / abs(ref) for s, ref in zip(steps_0, reference["loss"])]
    reward_rel = [abs(s["reward"] - ref) / abs(ref)
                  for s, ref in zip(steps_0, reference["reward"])]
    same = [param_deviation(ranks[0]["params"][i],
                            {k: v.cpu() for k, v in reference["params"][i].items()})
            for i in range(steps)]
    emit({"phase": "ep_mvmoe_cvrp50_readings", "loss_rel_err": loss_rel,
          "reward_rel_err": reward_rel,
          "param_max_abs_dev_and_share_within_1e-6_per_step": same})
    for i in range(steps):
        assert loss_rel[i] <= DP_SAME_RTOL and reward_rel[i] <= DP_SAME_RTOL, (
            i, loss_rel, reward_rel)
        assert same[i][0] <= DP_PARAM_ATOL and same[i][1] >= DP_CLOSE_SHARE, (i, same)
    return {"model": "MVMoE-POMO 128/8/6/512, 4 experts top-2, instance norm, CVRP-50, "
                     "64 x 50 starts, f32 (train_mvmoe's)",
            "mesh": {"dp": 1, "model": EP_MODEL}, "backend": "gloo (two ranks on one card)",
            "decisions": ranks[0]["decisions"], "experts_per_rank": ranks[0]["local_experts"],
            "steps": steps, "replayed": "train_mvmoe's tours and random stream",
            "tolerances": {"same_run_rtol": DP_SAME_RTOL, "close_share": DP_CLOSE_SHARE,
                           "param_atol": DP_PARAM_ATOL},
            "param_max_abs_dev_and_share_within_1e-6_per_step": same,
            "loss_rel_err": loss_rel, "reward_rel_err": reward_rel,
            "losses": [s["loss"] for s in steps_0], "one_process_losses": reference["loss"],
            "step_ms": {f"rank{r}": [s["ms"] for s in x["steps"]] for r, x in enumerate(ranks)},
            "seconds": seconds}, none


def drive_eval_oom_halving(device, count=8192, keep_free=OOM_KEEP_FREE):
    """`evaluate_policy` with ``batch_size=None`` (AM 128/8/3/512 batch norm,
    seed-0 weights, greedy on ``count`` TSP-100 instances: the JAX sizing
    picks 8192) while one tensor holds all but ``keep_free`` bytes of the
    card's free memory: at least one real CUDA out-of-memory error is caught
    and the dispatch halved; then, the memory released, a run at the size
    that ran gives the same rewards."""
    from rl4co_tpu_torch.data.io import load_instances_npz
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.tasks import eval as teval

    locs = load_instances_npz(os.path.join(ROOT, "data", "tsp", "test100_seed1234.npz"))["locs"]
    inst = {"locs": locs[:count]}
    env = get_env("tsp", num_loc=100)
    policy = make_policies(device)["kernel"]
    caught = []
    inner = teval._is_device_oom

    def is_oom(e):
        caught.append(f"{type(e).__name__}: {str(e)[:120]}")
        return inner(e)

    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        hog = torch.empty(max(free - keep_free, 0), dtype=torch.uint8, device=device)
        held = hog.numel()
    else:   # a CPU rehearsal: the first two dispatches' rollouts raise CUDA's text
        free = total = held = 0
        hog, inner_rollout = None, teval.rollout

        def rollout(*args, **kwargs):
            if len(caught) < 2:
                raise RuntimeError("CUDA error: out of memory")
            return inner_rollout(*args, **kwargs)

        teval.rollout = rollout
    teval._is_device_oom = is_oom
    reset_launches()
    t0 = time.perf_counter()
    try:
        got = teval.evaluate_policy(env, policy, inst, "greedy", device=device)
    finally:
        teval._is_device_oom = inner
        if hog is None:
            teval.rollout = inner_rollout
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    del hog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    assert got.get("oom_halvings", 0) >= 1 and len(caught) == got["oom_halvings"], (got, caught)
    assert launches["pointer_step_single"] > 0, launches
    want = teval.evaluate_policy(env, policy, inst, "greedy", batch_size=got["batch_size"],
                                 device=device)
    assert np.array_equal(got["rewards"], want["rewards"])
    assert np.isfinite(got["rewards"]).all() and got["rewards"].shape == (count,)
    return {"model": "AM 128/8/3/512 batch norm, seed-0 weights, TSP-100 greedy",
            "instances": count, "card_free_bytes": free, "card_total_bytes": total,
            "held_bytes": held,
            "sizing_batch_size": got["batch_size"] << got["oom_halvings"],
            "oom_halvings": got["oom_halvings"],
            "batch_size_that_ran": got["batch_size"], "errors_caught": caught,
            "mean_cost": -float(got["mean_reward"]), "seconds_with_retries": seconds,
            "rewards_equal_a_run_at_that_size": True, "launches": launches}, launches


def drive_reptile_pomo_tsp(device, epochs=REPTILE_EPOCHS, steps=REPTILE_STEPS,
                           batch=REPTILE_BATCH):
    """Reptile over TSP-20/50/100 with POMO at its published widths (128/8/6,
    instance norm, multistart sampling over N starts, f32): the tasks are
    ``random.Random(0)``'s draws, each task trains ``steps`` steps of
    ``batch`` x N from the meta-weights with fresh optimiser state (K1 at L =
    N = its size), and every outer update is held to θ_meta + β (θ_task −
    θ_meta) recomputed from the saved tensors."""
    import random

    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.meta import Reptile, ReptileConfig
    from rl4co_tpu_torch.models.zoo.pomo import POMO
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    tasks, updates = [], []

    def make_algo(task):
        tasks.append(task["num_loc"])
        from rl4co_tpu_torch.envs import get_env

        return POMO(get_env("tsp", **task), policy_kwargs=dict(device=device),
                    train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))

    class Recorded(Reptile):
        def outer_update(self, meta, task_params, beta):
            out = super().outer_update(meta, task_params, beta)
            updates.append({k: (meta[k].cpu(), task_params[k].cpu(), out[k].cpu())
                            for k in meta} | {"": beta})
            return out

    torch.manual_seed(0)
    done, undo = instrument_updates(REINFORCE)
    seen, undo_widths = record_launch_widths()
    logged = []
    t0 = time.perf_counter()
    try:
        reset_launches()
        meta = Recorded(make_algo, ReptileConfig(tasks=REPTILE_TASKS, seed=0)).run(
            epochs, steps, batch, logger=logged.append)
        launches = dict(LAUNCHES)
    finally:
        undo()
        undo_widths()
    seconds = time.perf_counter() - t0
    rng = random.Random(0)
    want = [rng.choice(list(REPTILE_TASKS))["num_loc"] for _ in range(epochs + 1)]
    assert tasks == want, (tasks, want)
    assert {20, 50, 100} <= set(tasks[1:]), tasks
    worst = 0.0
    for epoch, up in enumerate(updates):
        beta = up.pop("")
        assert beta == 1.0 - epoch / epochs
        for k, (m, t, out) in up.items():
            assert torch.equal(out, m + beta * (t - m)), k
            if epoch:
                assert torch.equal(m, updates[epoch - 1][k][2]), k
            worst = max(worst, (t - m).abs().max().item())
    assert worst > 0, "no task moved the weights"
    assert all(torch.equal(meta[k].cpu(), updates[-1][k][2]) for k in meta)
    by_n = {}
    for s, n in zip(done, [n for n in tasks[1:] for _ in range(steps)]):
        assert s["launches"] == {"pointer_step_single": 0, "pointer_step_grouped": n}, s
        assert np.isfinite(s["loss"])
        by_n.setdefault(n, []).append(s["ms"])
    return {"model": "POMO 128/8/6/512 instance norm, TSP-20/50/100, N starts, f32, "
                     "Adam 1e-4 per task",
            "epochs": epochs, "steps_per_task": steps, "batch": batch,
            "tasks": tasks[1:], "meta_init_task": tasks[0],
            "betas": [1.0 - e / epochs for e in range(epochs)],
            "losses": [r["loss"] for r in logged],
            "inner_step_ms_by_n": {str(n): v for n, v in by_n.items()},
            "inner_step_ms_median_by_n": {str(n): statistics.median(v) for n, v in by_n.items()},
            "k1_launches_by_n": {str(n): n * steps * tasks[1:].count(n) for n in sorted(by_n)},
            "largest_task_move": worst, "launches_by_shape": launches_by_width(seen),
            "seconds": seconds, "launches": launches}, launches


def drive_remat_fused_am_tsp50(device, count=512):
    """The AM checkpoint on the first ``count`` canonical TSP-50 instances:
    one REINFORCE loss and backward (mean baseline, sampling) with ``remat``
    off and on from the same generator state, the losses equal and the
    gradients within REMAT_GRAD_GAUGE of the largest, K2 launched 50 and then
    100 times (the recompute), the peak memory of each; then the fused
    rollout baseline: member 1 (the snapshot at temperature 1e-9) against
    the snapshot's greedy rollout, each departure proven a near-tie, and one
    fused train step."""
    from rl4co_tpu_torch.data.io import load_instances_npz
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models import rollout
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES
    from rl4co_tpu_torch.rl.baselines import get_reinforce_baseline
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    env = get_env("tsp", num_loc=50)
    locs = load_instances_npz(os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz"))["locs"]
    inst = {"locs": torch.as_tensor(locs[:count]).to(device)}
    runs = {}
    for remat in (False, True):
        policy = checkpoint_policy("am_tsp50", device).train().requires_grad_(True)
        algo = REINFORCE(env, policy, baseline="mean", train_spec=DecodeSpec(
            kind="sampling", tanh_clipping=10.0, remat=remat))
        algo.reseed(7, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, (_, out) = algo.loss(inst)
        forward = dict(LAUNCHES)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = {"loss": loss.item(), "actions": out.actions,
                       "grads": {k: p.grad.clone() for k, p in policy.named_parameters()},
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "ms": (time.perf_counter() - t0) * 1e3,
                       "launches_forward": forward, "launches": dict(LAUNCHES)}
    off, on = runs[False], runs[True]
    assert torch.equal(off["actions"], on["actions"])
    assert off["loss"] == on["loss"], (off["loss"], on["loss"])
    largest = max(g.abs().max().item() for g in off["grads"].values())
    grad_err = max((on["grads"][k] - g).abs().max().item() for k, g in off["grads"].items())
    assert grad_err <= REMAT_GRAD_GAUGE * largest, (grad_err, largest)
    assert off["launches"]["pointer_step_single"] == env.max_steps, off["launches"]
    assert on["launches_forward"]["pointer_step_single"] == env.max_steps
    assert on["launches"]["pointer_step_single"] == 2 * env.max_steps, on["launches"]
    remat_launches = {k: off["launches"][k] + on["launches"][k] for k in off["launches"]}

    # the fused rollout baseline: the snapshot is the checkpoint itself
    policy = checkpoint_policy("am_tsp50", device).train().requires_grad_(True)
    algo = REINFORCE(env, policy, baseline=get_reinforce_baseline("rollout", warmup=False),
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0),
                     fused_rollout_baseline=True)
    algo.reseed(7, 1)
    reset_launches()
    member1 = algo.baseline_rollout(inst)
    with torch.no_grad():
        greedy = rollout(algo.baseline_state.bl_policy, env, inst,
                         DecodeSpec(kind="greedy", tanh_clipping=10.0), device=device)
    first, gap = greedy_departures(env, algo.baseline_state.bl_policy, inst,
                                   member1.actions.cpu().numpy(), device)
    left = first >= 0
    assert (gap[left] <= ROUTING_TIE_ATOL).all(), gap[left]
    differs = (member1.actions != greedy.actions).any(dim=1).cpu().numpy()
    assert not (differs & ~left).any(), "member 1 left the greedy tour away from a tie"
    same = ~differs
    assert torch.equal(member1.reward[torch.as_tensor(same, device=device)],
                       greedy.reward[torch.as_tensor(same, device=device)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = algo.update(inst)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    fused_launches = dict(LAUNCHES)
    # greedy_departures' replay decodes through the plain `decode_step`: K2 too
    assert fused_launches["pointer_step_single"] == 5 * env.max_steps, fused_launches
    assert np.isfinite(metrics["loss"].item())
    return {"model": "AM checkpoint runs/ckpt_am_tsp50 (128/8/3/512 batch norm), "
                     f"{count} canonical TSP-50 instances",
            "remat": {"loss": off["loss"], "loss_with_remat": on["loss"],
                      "grad_max_abs_err": grad_err, "grad_largest": largest,
                      "grad_gauge": REMAT_GRAD_GAUGE,
                      "k2_launches": {"off": off["launches"]["pointer_step_single"],
                                      "on": on["launches"]["pointer_step_single"]},
                      "peak_memory_bytes": {"off": off["peak_memory_bytes"],
                                            "on": on["peak_memory_bytes"]},
                      "loss_and_backward_ms": {"off": off["ms"], "on": on["ms"]}},
            "fused_baseline": {"member1_rows_off_greedy": int(differs.sum()),
                               "near_tie_departures": int(left.sum()),
                               "near_tie_gaps": [float(x) for x in gap[left]],
                               "tie_atol": ROUTING_TIE_ATOL,
                               "member1_mean_cost": -member1.reward.mean().item(),
                               "greedy_mean_cost": -greedy.reward.mean().item(),
                               "fused_step_ms": step_ms, "fused_step_loss": metrics["loss"].item(),
                               "fused_step_bl_val": metrics["bl_val"].item()},
            "launches_remat": remat_launches, "launches_fused": fused_launches}, remat_launches, fused_launches


# the port's examples (`rl4co_tpu_torch/examples/`) and the pointer kernels
# each launches at its default sizes: greedy decoding and single sampling run
# K2; sampling with repeats (06's 16 samples), multistart, beam search and
# the EAS rollouts run K1; L2D's pointer (an unmasked glimpse) and the
# samplers reach none. A kernel not named must not launch.
EXAMPLES = {
    "01_quickstart": ("pointer_step_single",),
    "02_full_training": ("pointer_step_single",),
    "03_new_env_and_model": ("pointer_step_single",),
    "04_decoding_strategies": ("pointer_step_single", "pointer_step_grouped"),
    "05_transductive_search": ("pointer_step_single", "pointer_step_grouped"),
    "06_tsplib_cvrplib": ("pointer_step_grouped",),
    "07_local_search": ("pointer_step_single",),
    "08_mtvrp": ("pointer_step_single",),
    "09_scheduling": (),
    "10_generator_distributions": (),
    "11_meta_reptile": ("pointer_step_single",),
    "12_multichip_dp": ("pointer_step_single",),
    "13_canonical_datasets": ("pointer_step_single",),
}
EXAMPLES_DIR = os.path.join(ROOT, "rl4co_tpu_torch", "examples")


def load_example(name):
    """The example script ``name`` as a module, imported from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def numbers_in(tree):
    """Every number in a returned tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in numbers_in(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in numbers_in(v)]
    return [tree] if isinstance(tree, (int, float)) and not isinstance(tree, bool) else []


def drive_examples(device, sizes=None, names=tuple(EXAMPLES)):
    """Each example of ``names`` run by its ``main`` on ``device`` in this
    process, at its default sizes (``sizes``: ``{name: kwargs}`` to shrink
    some in a rehearsal): its wall seconds, the numbers it returns (those it
    prints, all finite), the last lines it printed and its launches of each
    pointer kernel, which must be those of `EXAMPLES`. Example 12's other
    rank runs in a process of its own; the launches are rank 0's. Returns
    the report and the launches by example."""
    import contextlib
    import io

    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    report, launches = {}, {}
    for name in names:
        kernels = EXAMPLES[name]
        module = load_example(name)
        printed = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            numbers = module.main(device=str(device), **(sizes or {}).get(name, {}))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = dict(LAUNCHES)
        for kernel, count in launches[name].items():
            assert (count > 0) == (kernel in kernels), (name, launches[name])
        values = numbers_in(numbers)
        assert values and all(np.isfinite(values)), (name, numbers)
        report[name] = {"seconds": seconds, "numbers": numbers,
                        "printed": printed.getvalue().splitlines()[-10:],
                        "launches": launches[name]}
    return report, launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # the port, before anything is printed: without it there is no result
    from rl4co_tpu_torch.data.io import load_instances_npz, load_reference_npz
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.ops import _build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    _build.load_library("pointer_kernel")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p, ROOT) for p in libs.values())})

    # 3. kernels against their plain versions, then their times
    stats = check_kernels(device)
    times = {t["name"]: t for t in time_kernels(device)}
    emit({"phase": "kernels", "card": smi, "rtol": RTOL, "atol": ATOL,
          "stats": stats, "times": times,
          "times_further_shapes": time_kernels(device, shapes=EXTRA_TIMES)})

    # 4. the main path
    locs = load_instances_npz(os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz"))["locs"]
    assert locs.shape == (10000, 50, 2) and locs.dtype == np.float32, (locs.shape, locs.dtype)
    env = get_env("tsp", num_loc=50)
    policies = make_policies(device)
    report, launches = drive_path(env, policies, locs, device)
    emit({"phase": "path", "card": smi, "model": "AM 128/8/3/512 batch norm, TSP-50",
          "methods": report, "launches": launches})

    report, tsp500_launches = drive_tsp500(device)
    emit({"phase": "path_tsp500", "card": smi, "model": "AM 128/8/3/512 batch norm, TSP-500",
          **report})

    profiles = [profile_dispatch(env, policies["kernel"], {"locs": locs}, device, m, c)
                for m, c in (("greedy", 1024), ("multistart_greedy", 256))]
    emit({"phase": "profile", "card": smi, "dispatches": profiles})

    # 5. golden
    emit({"phase": "golden", **check_golden(env, policies["kernel"], locs, device)})

    # 6. the committed checkpoints on the canonical test sets
    ckpt_launches, ckpt_reports = {}, {}
    for name in CHECKPOINTS:
        report, ckpt_launches[name] = drive_checkpoint(name, device)
        ckpt_reports[name] = report
        emit({"phase": f"ckpt_{name}", "card": smi, "methods": report,
              "tolerances": {k: CHECKPOINTS[name][k] for k in TOLERANCE_KEYS},
              "launches": ckpt_launches[name]})
    cvrp_env = get_env("cvrp", num_loc=50)
    cvrp = load_reference_npz(os.path.join(ROOT, "data", "cvrp", "test50_seed1234.npz"), "cvrp")
    pomo = checkpoint_policy("pomo_cvrp50", device)
    emit({"phase": "profile_pomo", "card": smi, "dispatches": [
        profile_dispatch(cvrp_env, pomo, cvrp, device, m, c)
        for m, c in (("multistart_greedy", 655), ("multistart_greedy_augment_dihedral_8", 81))]})
    tsp100 = load_instances_npz(os.path.join(ROOT, "data", "tsp", "test100_seed1234.npz"))
    emit({"phase": "profile_amxl", "card": smi, "dispatches": [
        profile_dispatch(get_env("tsp", num_loc=100), checkpoint_policy("amxl_tsp100", device),
                         tsp100, device, m, c)
        for m, c in (("greedy", 8192), ("augment_dihedral_8", 1024))]})
    report, beam_launches = drive_beam(device)
    emit({"phase": "beam_am_tsp50", "card": smi, **report})

    # 7. training: gradients through the kernels, then the trainer's paths
    emit({"phase": "train", "part": "a", "card": smi,
          "function_gradients": check_function_gradients(device),
          "reinforce_loss_and_gradients": check_training_gradients(env, device)})
    report, train_launches = train_full_width(env, locs, device)
    emit({"phase": "train", "part": "b", "card": smi, **report})
    report, grouped_launches = train_grouped(env, device)
    emit({"phase": "train", "part": "c", "card": smi, **report})
    emit({"phase": "train", "part": "d", "card": smi, **train_learns(device)})
    emit({"phase": "train", "part": "e", "card": smi, **train_resumes(device)})
    gradients = check_pomo_gradients(cvrp_env, device)
    report, pomo_launches = train_pomo(cvrp_env, cvrp, device)
    emit({"phase": "train_pomo", "card": smi, "replayed_loss_and_gradients": gradients,
          **report})

    # 8. the rest of the AM family
    report, bf16_launches = train_bf16(env, device)
    emit({"phase": "train_bf16", "card": smi, **report})
    report, symnco_launches = train_symnco(env, locs, device)
    emit({"phase": "train_symnco", "card": smi, **report})
    report, mvmoe_launches, mvmoe_record = train_mvmoe(cvrp_env, cvrp, device)
    emit({"phase": "train_mvmoe", "card": smi, **report})
    report, polynet_launches = train_polynet(env, locs, device)
    emit({"phase": "train_polynet", "card": smi, **report})

    # 9. the mixed OP + PCTSP configuration, PtrNet, and the command lines
    report, multienv_golden_launches = drive_golden_multienv(device)
    emit({"phase": "golden_multienv", "card": smi, **report})
    with tempfile.TemporaryDirectory() as tmp:
        report, multienv_launches = train_cli_multienv(device, tmp)
        emit({"phase": "cli_train_multienv", "card": smi, **report})
        report, ptrnet_launches = train_cli_ptrnet(device, tmp)
        emit({"phase": "cli_train_ptrnet", "card": smi, **report})
    ckpt_report, ckpt_cli_launches = eval_cli_checkpoint(
        device, ckpt_reports["am_tsp50"]["greedy"]["mean_cost"],
        CHECKPOINTS["am_tsp50"]["mean_rtol"])
    op_report, op_cli_launches = eval_cli_op_multistart(device)
    cli_eval_launches = {k: ckpt_cli_launches[k] + op_cli_launches[k] for k in launches}
    emit({"phase": "cli_eval", "card": smi, "am_tsp50_greedy": ckpt_report,
          "op20_multistart_greedy": op_report, "launches": cli_eval_launches})

    # 10. BASELINE.json's NAR configuration: DeepACO and GFACS on TSP-500, no
    # pointer kernel on their path
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    t_nar = time.perf_counter()
    report, deepaco_golden_launches = drive_golden_deepaco(device)
    emit({"phase": "golden_deepaco_tsp500", "card": smi, **report})
    reset_launches()
    gradients = check_deepaco_gradients(device)
    gradient_launches = dict(LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        report, deepaco_launches = train_cli_nar(device, tmp, "deepaco", steps=4)
        deepaco_launches = {k: deepaco_launches[k] + gradient_launches[k] for k in launches}
        emit({"phase": "train_deepaco_tsp500", "card": smi,
              "replayed_loss_and_gradients": gradients, **report,
              "launches": deepaco_launches})
        report, gfacs_launches = train_cli_nar(device, tmp, "gfacs", steps=2)
        assert all("logZ" in m for m in report["metrics_per_step"])
        emit({"phase": "cli_train_gfacs_tsp500", "card": smi, **report})
    nar_seconds = time.perf_counter() - t_nar

    # 11. the multi-task VRP family at N 50: AM on five routing envs and POMO
    # on MTVRP held to the JAX CPU costs; POMO's and AM-on-SDVRP's gradients
    # held to the JAX package's; MVMoE-POMO on MTVRP and AM on SDVRP trained
    # through the train command line
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    t_vrp = time.perf_counter()
    report, routing_launches = drive_golden_routing(device)
    sdvrp_env = get_env("sdvrp", num_loc=50)
    sdvrp = by_prefix(golden_npz("routing_envs_instances.npz"), "sdvrp")
    profiled = profile_dispatch(sdvrp_env, routing_policy(
        "sdvrp", device, int(golden_npz("routing_envs_costs.npz")["seed"])), sdvrp, device,
        "multistart_greedy", 256)
    emit({"phase": "golden_routing_envs", "card": smi,
          "model": "AM 128/8/3/512 batch norm, random weights, N 50",
          "xla_tanh_card_against_cpu": check_xla_tanh(device),
          "tolerances": {"mean_rtol": ROUTING_MEAN_RTOL, "cost_rtol": ROUTING_COST_RTOL,
                         "same_share": ROUTING_SAME_SHARE},
          "dispatches": report, "profiled_sdvrp_multistart_dispatch": profiled,
          "launches": routing_launches})
    report, pomo_mtvrp_launches = drive_golden_pomo_mtvrp(device)
    emit({"phase": "golden_pomo_mtvrp50", "card": smi, **report})
    with tempfile.TemporaryDirectory() as tmp:
        gradients = check_pomo_mtvrp_gradients(device)
        pomo_replay_launches = gradients["launches"]
        report, mvmoe_mtvrp_launches = train_cli(
            device, tmp, "mvmoe-pomo", "mtvrp", 50, ["--batch-size", "64", "--train-size",
                                                     "256", "--val-size", "64"], 4, REINFORCE)
        del report["algo"]
        # MVMoE's pointer head computes through `pointer_logits`: no kernel
        assert sum(mvmoe_mtvrp_launches.values()) == 0, mvmoe_mtvrp_launches
        emit({"phase": "train_pomo_mtvrp50", "card": smi,
              "replayed_loss_and_gradients": gradients,
              "model": "MVMoE-POMO 128/8/6/512, 4 experts top-2, instance norm, MTVRP-50 "
                       "preset all, 50 starts, bf16-mixed, Adam 1e-4",
              **report, "launches": {k: pomo_replay_launches[k] + mvmoe_mtvrp_launches[k]
                                     for k in launches}})
        gradients = check_am_sdvrp_gradients(device)
        sdvrp_replay_launches = gradients["launches"]
        report, am_sdvrp_launches = train_cli(
            device, tmp, "am", "sdvrp", 50, ["--batch-size", "512", "--train-size", "2048",
                                              "--val-size", "256"], 4, REINFORCE)
        del report["algo"]
        per_step = {"pointer_step_single": 2 * sdvrp_env.max_steps, "pointer_step_grouped": 0}
        assert all(s == per_step for s in report["launches_per_step"]), report
        emit({"phase": "train_am_sdvrp50", "card": smi,
              "replayed_loss_and_gradients": gradients,
              "model": "AM 128/8/3/512 batch norm + SDVRP's dynamic embedding, SDVRP-50, "
                       "rollout baseline behind its warm-up, bf16-mixed, Adam 1e-4",
              **report, "launches": {k: sdvrp_replay_launches[k] + am_sdvrp_launches[k]
                                     for k in launches}})
    vrp_seconds = time.perf_counter() - t_vrp

    # 12. the rest of the routing envs at N 50 (CVRPMVC, SVRP, mPDP, MDCPDP)
    # held to the JAX CPU costs, and GLOP on TSP-1000 with its reviser
    t_glop = time.perf_counter()
    report, rest_launches = drive_golden_routing(device, ROUTING_REST, ROUTING_REST_MULTISTART,
                                                 "routing_envs_rest")
    emit({"phase": "golden_routing_envs_rest", "card": smi,
          "model": "AM 128/8/3/512 batch norm, random weights, N 50; mPDP and MDCPDP 3 agents",
          "tolerances": {"mean_rtol": ROUTING_MEAN_RTOL, "cost_rtol": ROUTING_COST_RTOL,
                         "same_share": ROUTING_SAME_SHARE, "tie_atol": ROUTING_TIE_ATOL},
          "dispatches": report, "launches": rest_launches})
    report, glop_launches = drive_glop_tsp1000(device)
    emit({"phase": "glop_tsp1000", "card": smi,
          "model": "GLOP, TSP-1000, segments of 25, 24 rounds; reviser AM 128/8/3/512 batch "
                   "norm on SHPP-25, random weights",
          "tolerances": {"mean_rtol": GLOP_MEAN_RTOL, "cost_rtol": GLOP_COST_RTOL,
                         "same_share": GLOP_SAME_SHARE},
          **report, "launches": glop_launches})
    glop_seconds = time.perf_counter() - t_glop

    # 13. PPO and A2C with their critic on TSP-50 (the JAX package's step
    # replayed, then the train command line), and AM greedy on the envs it
    # drives outside routing (SMTWTP, DPP, MDPP, FLP, MCP) held to the JAX CPU
    # costs
    from rl4co_tpu_torch.rl.a2c import A2C
    from rl4co_tpu_torch.rl.ppo import PPO

    t_ppo = time.perf_counter()
    golden, ppo_golden_launches = check_ppo_golden(device)
    backward = check_function_gradients(device, shapes={
        "pointer_step_single_ppo_minibatch": (128, None, 50, 128, 8)})
    with tempfile.TemporaryDirectory() as tmp:
        report, ppo_cli_launches = train_cli_actor_critic(
            device, tmp, "ppo", PPO_CLI_STEPS, PPO, margin=PPO_LEARN_MARGIN, num_loc=PPO_CLI_LOC)
        emit({"phase": "train_ppo_tsp50", "card": smi, "golden_replay": golden,
              "pointer_backward_at_ppo_minibatch": backward, "cli": report,
              "launches": {k: ppo_golden_launches[k] + ppo_cli_launches[k] for k in launches}})
        golden, a2c_golden_launches = check_a2c_golden(device)
        report, a2c_cli_launches = train_cli_actor_critic(device, tmp, "a2c", A2C_CLI_STEPS, A2C)
        emit({"phase": "train_a2c_tsp50", "card": smi, "golden_replay": golden, "cli": report,
              "launches": {k: a2c_golden_launches[k] + a2c_cli_launches[k] for k in launches}})
    report, envs_10b_launches = drive_golden_routing(device, tuple(ENVS_10B), (), "envs_10b",
                                                     env_kwargs=ENVS_10B)
    emit({"phase": "golden_envs_10b", "card": smi,
          "model": "AM 128/8/3/512 batch norm, random weights; SMTWTP-50, DPP and MDPP 10x10 "
                   "with 20 decaps and 50 frequencies (synthetic PDN), FLP-100 choosing 10, "
                   "MCP 200 items x 100 sets choosing 10",
          "tolerances": {"mean_rtol": ROUTING_MEAN_RTOL, "cost_rtol": ROUTING_COST_RTOL,
                         "same_share": ROUTING_SAME_SHARE, "tie_atol": ROUTING_TIE_ATOL,
                         "noise_factor": NOISE_FACTOR},
          "dispatches": report, "launches": envs_10b_launches})
    ppo_seconds = time.perf_counter() - t_ppo

    # 14. the transductive search on the POMO CVRP-50 checkpoint (K1 and K2
    # under autograd), and the improvement trio with n-step PPO
    t_eas = time.perf_counter()
    golden, eas_golden_launches = check_eas_golden(device)
    function_gradients = check_function_gradients(device, shapes=EAS_GRAD_SHAPES)
    report, eas_launches = drive_eas_pomo_cvrp50(device)
    with tempfile.TemporaryDirectory() as tmp:
        cli, eas_cli_launches = search_cli_eas_lay(device, tmp)
    emit({"phase": "eas_pomo_cvrp50", "card": smi, "golden_replay": golden,
          "function_gradients_at_eas_shapes": function_gradients, "run": report, "cli": cli,
          "tolerances": {"loss_rtol": EAS_LOSS_RTOL, "grad_gauge": EAS_GRAD_GAUGE,
                         "active_search_grad_gauge": AS_GRAD_GAUGE,
                         "update_atol_in_lr": EAS_UPDATE_ATOL},
          "launches": {k: eas_golden_launches[k] + eas_launches[k] + eas_cli_launches[k]
                       for k in launches}})
    eas_seconds = time.perf_counter() - t_eas
    t_trio = time.perf_counter()
    reset_launches()
    golden = check_trio_golden(device)
    with tempfile.TemporaryDirectory() as tmp:
        cli = train_cli_trio(device, tmp)
    trio_launches = dict(LAUNCHES)
    assert sum(trio_launches.values()) == 0, trio_launches   # no pointer kernel on this path
    emit({"phase": "improvement_trio", "card": smi,
          "models": {"dact": "DACT 64/3 layers/4 heads, TSPkopt k_max 2",
                     "n2s": "N2S 128/3/4, PDPRuinRepair", "neuopt": "NeuOpt 128/3/4, TSPkopt "
                     "k_max 4", "replay": "N 50, batch 64", "cli": "N 20 (the CLI's defaults)"},
          "golden_replay": golden, "cli": cli,
          "tolerances": {"logp_atol": TRIO_LOGP_ATOL, "tie_rtol": TRIO_TIE_RTOL,
                         "cost_rtol": TRIO_COST_RTOL, "first_loss_rtol": TRIO_FIRST_LOSS_RTOL,
                         "later_loss_rtol": TRIO_LATER_LOSS_RTOL,
                         "grad_gauge": TRIO_GRAD_GAUGE,
                         "update_norm_rtol": TRIO_UPDATE_NORM_RTOL},
          "launches": trio_launches})
    trio_seconds = time.perf_counter() - t_trio

    # 15. the rest of the zoo: MatNet on ATSP-50 (K1 at D 256, 16 heads), MDAM
    # on TSP-50 and HAM on PDP-50 (K2), MatNet on FFSP20 and L2D on FJSP and
    # JSSP with stepwise PPO (no kernel), each held to the JAX CPU results of
    # the same weights and instances
    t_zoo = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report, matnet_launches = drive_matnet_atsp50(device, tmp)
        emit({"phase": "matnet_atsp50", "card": smi, **report})
        report, mdam_launches = drive_mdam_tsp50(device, tmp)
        emit({"phase": "mdam_tsp50", "card": smi, **report})
        report, ham_launches = drive_ham_pdp50(device, tmp)
        emit({"phase": "ham_pdp50", "card": smi, **report})
        report, ffsp_launches = drive_matnet_ffsp20(device)
        emit({"phase": "matnet_ffsp20", "card": smi, **report})
        report, l2d_launches = drive_l2d_fjsp_jssp(device, tmp)
        emit({"phase": "l2d_fjsp_jssp", "card": smi, **report})
    zoo_seconds = time.perf_counter() - t_zoo

    # 16. infrastructure: data-parallel AM training over two processes on the
    # card (the train CLI with --distributed, against its one-process run),
    # then tensor parallelism (four processes as dp 2 x model 2, replaying that
    # run), expert parallelism (MVMoE-POMO's experts over two processes,
    # replaying `train_mvmoe`) and the evaluation's dispatch sizing under a
    # real out-of-memory error; Reptile over POMO on TSP-20/50/100, remat and
    # the fused rollout baseline
    t_infra = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report, dp_launches, dp_one_launches = drive_dp_am_tsp50(device, tmp)
        emit({"phase": "dp_am_tsp50", "card": smi, **report})
        # tensor and expert parallelism over the model axis, and the
        # evaluation's dispatch sizing under a real out-of-memory error
        t_tp = time.perf_counter()
        report, tp_launches = drive_tp_am_tsp50(device, tmp)
        emit({"phase": "tp_am_tsp50", "card": smi, **report})
        report, ep_launches = drive_ep_mvmoe_cvrp50(device, tmp, mvmoe_record)
        emit({"phase": "ep_mvmoe_cvrp50", "card": smi, **report})
    del mvmoe_record
    report, oom_launches = drive_eval_oom_halving(device)
    emit({"phase": "eval_oom_halving", "card": smi, **report})
    tp_seconds = time.perf_counter() - t_tp
    report, reptile_launches = drive_reptile_pomo_tsp(device)
    emit({"phase": "reptile_pomo_tsp", "card": smi, **report})
    report, remat_launches, fused_launches = drive_remat_fused_am_tsp50(device)
    emit({"phase": "remat_fused_am_tsp50", "card": smi, **report})
    infra_seconds = time.perf_counter() - t_infra

    # 17. the port's 13 examples at their default sizes, each through the
    # pointer kernels its path reaches
    t_examples = time.perf_counter()
    report, example_launches = drive_examples(device)
    emit({"phase": "examples", "card": smi, "examples": report})
    examples_seconds = time.perf_counter() - t_examples

    by_path = {"evaluation": launches, "training": {
        name: train_launches[name] + grouped_launches[name] for name in launches}}

    kernels = []
    for name in MAIN_SHAPES:
        for path, counts in by_path.items():
            assert counts[name] > 0, f"{name} was never launched on the {path} path"
    for name, spec in CHECKPOINTS.items():
        assert ckpt_launches[name][spec["kernel"]] > 0, f"{name}: {spec['kernel']} never launched"
    assert pomo_launches["pointer_step_grouped"] > 0
    assert beam_launches["pointer_step_grouped"] > 0
    assert bf16_launches["pointer_step_single"] > 0
    assert symnco_launches["pointer_step_grouped"] > 0
    # MVMoE's and PolyNet's pointer heads compute through `pointer_logits`
    assert sum(mvmoe_launches.values()) == sum(polynet_launches.values()) == 0
    assert multienv_golden_launches["pointer_step_single"] > 0
    assert multienv_launches["pointer_step_single"] > 0
    assert sum(ptrnet_launches.values()) == 0  # PtrNet's pointer is additive, no kernel
    assert cli_eval_launches["pointer_step_single"] > 0
    assert cli_eval_launches["pointer_step_grouped"] > 0
    by_path["evaluation_tsp500"] = tsp500_launches
    by_path.update({f"evaluation_{name}": counts for name, counts in ckpt_launches.items()})
    by_path["evaluation_beam_am_tsp50"] = beam_launches
    by_path["training_pomo_cvrp50"] = pomo_launches
    by_path["training_bf16"] = bf16_launches
    by_path["training_symnco"] = symnco_launches
    by_path["training_mvmoe"] = mvmoe_launches
    by_path["training_polynet"] = polynet_launches
    by_path["evaluation_golden_multienv"] = multienv_golden_launches
    by_path["training_cli_multienv"] = multienv_launches
    by_path["training_cli_ptrnet"] = ptrnet_launches
    by_path["evaluation_cli"] = cli_eval_launches
    # DeepACO and GFACS run no pointer kernel: their heatmap decodes without one
    for path, counts in (("evaluation_golden_deepaco_tsp500", deepaco_golden_launches),
                         ("training_deepaco_tsp500", deepaco_launches),
                         ("training_cli_gfacs_tsp500", gfacs_launches)):
        assert sum(counts.values()) == 0, (path, counts)
        by_path[path] = counts
    # the multi-task VRP family: K2 on the greedy dispatches, SDVRP's tiled
    # multistart (fresh K/V per row and step), its replay under grad and its
    # train steps; K1 on CVRPTW's and POMO-on-MTVRP's multistart and POMO's
    # replay under grad; MVMoE's pointer reaches no kernel
    assert routing_launches["pointer_step_single"] > 0
    assert routing_launches["pointer_step_grouped"] > 0
    assert pomo_mtvrp_launches["pointer_step_grouped"] > 0
    assert pomo_replay_launches["pointer_step_grouped"] > 0
    assert sdvrp_replay_launches["pointer_step_single"] > 0
    assert am_sdvrp_launches["pointer_step_single"] > 0
    by_path["evaluation_golden_routing_envs"] = routing_launches
    by_path["evaluation_golden_pomo_mtvrp50"] = pomo_mtvrp_launches
    by_path["training_pomo_mtvrp50_replay"] = pomo_replay_launches
    by_path["training_cli_mvmoe_pomo_mtvrp50"] = mvmoe_mtvrp_launches
    by_path["training_am_sdvrp50_replay"] = sdvrp_replay_launches
    by_path["training_cli_am_sdvrp50"] = am_sdvrp_launches
    # the rest of the routing envs: K2 on their greedy dispatches, K1 on
    # CVRPMVC's multistart; GLOP: K2 in every decode step of its reviser
    assert rest_launches["pointer_step_single"] > 0
    assert rest_launches["pointer_step_grouped"] > 0
    assert glop_launches["pointer_step_single"] > 0
    by_path["evaluation_golden_routing_envs_rest"] = rest_launches
    by_path["evaluation_glop_tsp1000"] = glop_launches
    # PPO: K2 in the old rollout and under autograd in every minibatch; A2C:
    # K2 under autograd; the five envs: K2 on their greedy dispatches
    for path, counts in (("training_ppo_tsp50_replay", ppo_golden_launches),
                         ("training_cli_ppo_tsp20", ppo_cli_launches),
                         ("training_a2c_tsp50_replay", a2c_golden_launches),
                         ("training_cli_a2c_tsp50", a2c_cli_launches),
                         ("evaluation_golden_envs_10b", envs_10b_launches)):
        assert counts["pointer_step_single"] > 0, (path, counts)
        by_path[path] = counts
    # the transductive search: K1 in the multistart rollout and K2 in the
    # replay of the incumbents, both under autograd, in the golden replay, the
    # 20-iteration run and the command line's EAS-Lay
    for path, counts in (("search_eas_pomo_cvrp50", {
            k: eas_golden_launches[k] + eas_launches[k] for k in launches}),
            ("search_cli_eas_lay", eas_cli_launches)):
        assert counts["pointer_step_single"] > 0 and counts["pointer_step_grouped"] > 0, (
            path, counts)
        by_path[path] = counts
    by_path["training_improvement_trio"] = trio_launches
    # the rest of the zoo: K1 on MatNet's multistart (evaluation, the replay
    # under autograd, the train CLI); K2 on MDAM's five paths and HAM's
    # decoder; MatNet-FFSP's pointer (an output bias) and L2D reach no kernel
    assert matnet_launches["pointer_step_grouped"] > 0, matnet_launches
    assert mdam_launches["pointer_step_single"] > 0, mdam_launches
    assert ham_launches["pointer_step_single"] > 0, ham_launches
    assert sum(ffsp_launches.values()) == 0, ffsp_launches
    by_path["zoo_matnet_atsp50"] = matnet_launches
    by_path["zoo_mdam_tsp50"] = mdam_launches
    by_path["zoo_ham_pdp50"] = ham_launches
    by_path["zoo_matnet_ffsp20"] = ffsp_launches
    by_path["zoo_l2d_fjsp_jssp"] = l2d_launches
    # infrastructure: K2 in both data-parallel ranks (summed) and in their
    # one-process reference, under remat and in both members of the fused
    # baseline; K1 in Reptile's POMO tasks at N 20, 50 and 100
    for path, counts, name in (("training_dp_am_tsp50_two_ranks", dp_launches, "pointer_step_single"),
                               ("training_dp_am_tsp50_one_process", dp_one_launches,
                                "pointer_step_single"),
                               ("training_reptile_pomo_tsp", reptile_launches,
                                "pointer_step_grouped"),
                               ("training_remat_am_tsp50", remat_launches, "pointer_step_single"),
                               ("training_fused_baseline_am_tsp50", fused_launches,
                                "pointer_step_single"),
                               ("training_tp_am_tsp50_four_ranks", tp_launches,
                                "pointer_step_single"),
                               ("evaluation_oom_halving_am_tsp100", oom_launches,
                                "pointer_step_single")):
        assert counts[name] > 0, (path, counts)
        by_path[path] = counts
    # expert parallelism: MVMoE's pointer head reaches no kernel
    assert sum(ep_launches.values()) == 0, ep_launches
    by_path["training_ep_mvmoe_cvrp50_two_ranks"] = ep_launches
    # the examples: their kernels held in `drive_examples`
    by_path.update({f"examples_{name}": counts for name, counts in example_launches.items()})
    for name in MAIN_SHAPES:
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "replaces_body": REPLACES_BODY[name],
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": stats[name]["max_abs_err"], "cases": stats[name]["cases"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            **{key: t[key] for key in ("tc_bound_ms", "tc_bound_by") if key in t},
            "library_ms": None, "shape": t["shape"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "nar_phases_seconds": nar_seconds, "multi_task_vrp_phases_seconds": vrp_seconds,
          "routing_rest_and_glop_phases_seconds": glop_seconds,
          "ppo_a2c_and_envs_10b_phases_seconds": ppo_seconds,
          "eas_phase_seconds": eas_seconds, "improvement_trio_phase_seconds": trio_seconds,
          "zoo_phases_seconds": zoo_seconds, "infrastructure_phases_seconds": infra_seconds,
          "tp_ep_and_eval_sizing_phases_seconds": tp_seconds,
          "examples_phase_seconds": examples_seconds})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
