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
command line on the AM checkpoint and on OP-20 multistart. Every phase
prints one JSON line; any failure is a traceback and a non-zero exit. Without a card it exits non-zero and prints
no result. `check_kernels` and `time_kernels` also run alone, from a short
script, while a kernel is being worked on.

Weights are random, made from a seed, except the checkpoints' and the
multi-env golden file's; evaluation instances are the committed
`data/tsp/test50_seed1234.npz`, `data/tsp/test100_seed1234.npz` and
`data/cvrp/test50_seed1234.npz` and the golden OP/PCTSP instances; TSP-500
and OP instances and training batches are generated on the card.
Needs numpy, torch, nvcc and nvidia-smi; imports nothing of JAX.
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
    (512, 50, 51, 128, 8, "cvrp_like"),  # train_pomo's validation: 64 x 8 augments
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
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches():
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_case(rs, b, l, n, d, h, feasible, device):
    """Inputs of one kernel call from a frozen numpy stream."""
    from rl4co_tpu_torch.ops.pointer_kernel import mask_to_neg_bias

    def normal(*shape):
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
    (B, L, N, D, H))], by default the main path's), beside the bound."""
    from rl4co_tpu_torch.ops.pointer_kernel import (
        fused_pointer_logits,
        pointer_logits_plain,
    )

    rs = np.random.RandomState(seed)
    times = []
    for name, (b, l, n, d, h) in shapes or list(MAIN_SHAPES.items()):
        args = make_case(rs, b, l, n, d, h, 0.7, device)
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


def device_events(fn):
    """Run ``fn`` under `torch.profiler`; returns its result, the device's
    kernels as ``(name, start, duration)`` and the host's `record_function`
    ranges named ``part:...`` as ``{name: (start, end)}``, all in the
    profiler's microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    kernels, ranges = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # device-side kernels only: an annotated region's row on the device
            # (`Optimizer.step#...`, a `part:`) repeats its kernels' time
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("Optimizer.", "part:"))):
                kernels.append((e.name, e.time_range.start, e.time_range.end - e.time_range.start))
        elif e.name.startswith("part:"):
            ranges[e.name[len("part:"):]] = (e.time_range.start, e.time_range.end)
    return result, kernels, ranges


def top_kernels(kernels, n):
    """``(name, duration in us)`` pairs summed by name: the ``n`` largest."""
    by_name = {}
    for name, us in kernels:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:60], "ms": ms, "launches": c} for k, (ms, c) in top]


def device_profile(fn):
    """Run ``fn`` under `torch.profiler`; returns its result, the time the
    device was busy (sum over its kernels, ms; None if the profiler saw no
    device activity), the device launches and the kernels by device time."""
    result, kernels, _ = device_events(fn)
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


def check_function_gradients(device, seed=2, iters=20):
    """The `Function` at the training shapes. Its forward is the kernel and is
    held against the plain version's logits; its five gradients are held
    against plain autograd's, which checks the `Function`'s wiring (saved
    inputs, `needs_input_grad`, the order of the gradients) and not the
    kernel: both sides take them from the plain version's graph. Also the
    device time of its backward."""
    from rl4co_tpu_torch.ops.pointer_kernel import (
        fused_pointer_logits,
        pointer_logits_plain,
    )

    rs = np.random.RandomState(seed)
    report = {}
    for name, (b, l, n, d, h) in GRAD_SHAPES.items():
        q, k, v, lk, bias, w, _ = make_case(rs, b, l, n, d, h, 0.7, device)
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
    assert np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), (lk, lp)
    grads_p = {n: p.grad for n, p in live["plain"].named_parameters()}
    scale = max(g.abs().max().item() for g in grads_p.values())
    assert scale > 1e-3, f"gradients vanish (max {scale:.3e}): the check would be vacuous"
    worst_abs, worst_name = 0.0, None
    for name, p in live["kernel"].named_parameters():
        gk, gp = p.grad, grads_p[name]
        assert gk is not None and torch.isfinite(gk).all(), name
        err = (gk - gp).abs()
        over = (err - (GRAD_ATOL * scale + grad_rtol * gp.abs())).max().item()
        assert over <= 0, (f"gradient of {name} differs between kernel and plain path: "
                           f"max abs err {err.max().item():.3e} at scale {scale:.3e}")
        if err.max().item() > worst_abs:
            worst_abs, worst_name = err.max().item(), name
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel_err": abs(lk - lp) / abs(lp), "grad_scale": scale,
            "grad_max_abs_err": worst_abs, "grad_max_abs_err_at": worst_name,
            "grad_max_err_over_scale": worst_abs / scale,
            "parameters": len(grads_p), "loss_rtol": LOSS_RTOL,
            "grad_rtol": grad_rtol, "grad_atol_of_scale": GRAD_ATOL}


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
    an MoE projection: no kernel launches."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.zoo.mvmoe import MVMoE_POMO

    torch.manual_seed(1234)
    algo = MVMoE_POMO(env, policy_kwargs=dict(device=device),
                      train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    p = algo.policy
    assert (p.num_encoder_layers, p.num_experts, p.moe_topk) == (6, 4, 2)
    algo.reseed(61)
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
                     "50 starts", **report}, launches


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
    report, mvmoe_launches = train_mvmoe(cvrp_env, cvrp, device)
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
            "library_ms": None, "shape": t["shape"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
