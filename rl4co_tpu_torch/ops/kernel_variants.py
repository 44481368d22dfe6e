"""Variants of the pointer kernels, timed side by side on one GPU.

    python3 -m rl4co_tpu_torch.ops.kernel_variants [--baseline FILE ...] [VARIANT ...]
    (from the repository root)

Each variant is a patched copy of `rl4co_tpu_torch/csrc/pointer_kernel.cu`,
built with the same `nvcc` flags into `_build/variants/` (one `nvcc` per
variant, all started together), loaded with `ctypes` and swapped in for the
wrapper's library. Every variant that still computes the logits is held
against the plain version on its kernel's cases of `chip_smoke.CASES` (those
whose shared memory fits); then the kernels alone are timed in turns (the
list, then the list reversed) by `chip_smoke.time_ms` at the paths' shapes,
each beside `chip_smoke.bound_ms` and `chip_smoke.tc_bound_ms`. Each
`--baseline FILE` adds an unpatched source (another commit's
`pointer_kernel.cu`) as the variant `baseline`, `baseline2`, ..., checked
and timed at every shape of the run. Without variant names: DEFAULT_SINGLE
and DEFAULT_GROUPED. Prints one JSON line per result, `ptxas`' registers and
spills of every build first. Needs a card, `nvcc` and numpy; imports nothing
of JAX.

Single-query kernel (`pointer_step_single`, K2; names combine with `-`):
  g<G>t<T>n<N>  G groups of T threads per block, node tiles of N (the
                shipped kernel is g4t128n32);
  copyonly      the ring is filled and waited for, nothing is computed;
  computeonly   nothing is copied, the phases run on whatever is in the ring;
  bulkrow       the ring filled by 1-D bulk copies (`cp.async.bulk` with an
                mbarrier per slot), one per padded row, issued by warp 0;
  bulktile      the same, one bulk copy per tile into unpadded rows.

Grouped kernel (`pointer_step_grouped`, K1): `grouped` is the shipped
kernel, `grouped-<patch>[-<patch>...]` a patched copy. The patches act on
the tensor-core kernel (`pointer_step_grouped_mma_kernel`) unless they say
otherwise:
  copyonly      staging, fragment loads and the online softmax only: every
                product and every split cut to one add;
  computeonly   nothing staged (K, V, LK, W nor bias), the phases run on
                whatever is in shared memory, and the projection reads W's
                stand-in from shared memory;
  noproj        the projection is skipped (the logits use zeros);
  nohead        the (head, m-tile) pairs skipped: no scores, softmax or
                glimpse (the projection takes the queries);
  nologits      the logits' products skipped (nothing written);
  projunroll<U> the projection's k8 loop unrolled U times (2 shipped), so
                that more of W's loads are in flight;
  fastexp       the online softmax's exp by `__expf` (ex2.approx);
  tf32x1        one TF32 pass per product instead of the 3xTF32 split: the
                precision a plain TF32 kernel would have (fails the check);
  mt<M>         M m-tiles of 16 queries per block wherever shared memory
                allows (1, 2 or 4; the shipped kernel picks per launch);
  regs<R>       at most R registers per thread (kMmaMaxRegs; 80 lets three
                blocks of 256 threads share an SM);
  tileN<T>      node tiles of T (kGroupedTileN, a multiple of 8 up to 64),
                in both grouped kernels;
  cudacore      every shape on the CUDA-core kernel (the design before the
                tensor cores, which now serves head widths other than 8, 16
                and 32).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)  # the repository, for chip_smoke.py

SOURCE = os.path.join(PKG, "csrc", "pointer_kernel.cu")
OUT_DIR = os.path.join(PKG, "_build", "variants")
DEFAULT_SINGLE = ["g4t128n32", "g4t128n32-copyonly", "g4t128n32-computeonly",
                  "g4t128n32-bulkrow", "g4t128n32-bulktile", "g2t256n64", "g1t256n64"]
DEFAULT_GROUPED = ["grouped", "grouped-copyonly", "grouped-computeonly", "grouped-noproj",
                   "grouped-tf32x1", "grouped-mt1", "grouped-mt2", "grouped-mt4",
                   "grouped-regs80", "grouped-tileN32", "grouped-cudacore"]
BASE = {"g4t128n32", "grouped"}  # the shipped kernels: no patch
NO_LOGITS = ("copyonly", "computeonly", "noproj", "nohead", "nologits")  # break the result
# (B, L, N, D, H); L is None for the single kernel
SHAPES = {
    "single": [(1024, None, 50, 128, 8), (512, None, 50, 128, 8), (512, None, 20, 128, 8),
               (4096, None, 50, 128, 8), (64, None, 2048, 128, 8)],
    # the grouped shapes of chip_smoke.MAIN_SHAPES and EXTRA_TIMES: POMO on
    # CVRP-50 (multistart greedy, dihedral-8, a train step), AM's multistart
    # on TSP-50, TSP-500 multistart, beam search, SymNCO, OP-20, CVRPTW-50,
    # MTVRP-50, MatNet on ATSP-50 at D 256 (dispatch, train step), Reptile's
    # POMO on TSP-20/50/100
    "grouped": [(655, 50, 51, 128, 8), (648, 50, 51, 128, 8), (64, 50, 51, 128, 8),
                (256, 50, 50, 128, 8), (16, 500, 500, 128, 8), (163, 50, 50, 128, 8),
                (512, 50, 50, 128, 8), (409, 20, 21, 128, 8), (256, 50, 51, 128, 8),
                (512, 50, 51, 128, 8), (256, 50, 50, 256, 16), (64, 50, 50, 256, 16),
                (64, 20, 20, 128, 8), (64, 50, 50, 128, 8), (64, 100, 100, 128, 8)],
}


def sub(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"patch does not apply: {old[:70]!r}"
    return src.replace(old, new)


def kind(name: str) -> str:
    return "grouped" if name.startswith("grouped") else "single"


def patched(name: str) -> str:
    src = open(SOURCE).read()
    return patched_grouped(src, name) if kind(name) == "grouped" else patched_single(src, name)


def patched_single(src: str, name: str) -> str:
    g, t, n = map(int, re.match(r"g(\d+)t(\d+)n(\d+)", name).groups())
    src = re.sub(r"kSingleThreads = \d+;", f"kSingleThreads = {t};", src)
    src = re.sub(r"kSingleGroups = \d+;", f"kSingleGroups = {g};", src)
    src = re.sub(r"kSingleTileN = \d+;", f"kSingleTileN = {n};", src)
    wait = "    cp_async_wait_pending(stages - 1);  // this thread's copies of tile g have landed\n"
    if "copyonly" in name:
        src = sub(src, "    group_sync(bar);                    // ... and every thread's of the group\n",
                  "    group_sync(bar);                    // ... and every thread's of the group\n"
                  "    if (true) { group_sync(bar); continue; }\n")
    if "computeonly" in name:
        src = sub(src, "  auto issue = [&](int g) {\n    if (g >= total) return;",
                  "  auto issue = [&](int g) {\n    return;")
    if "bulk" in name:
        # an mbarrier per ring slot of every group, armed by warp 0's lane 0
        src = re.sub(r"kBarrierFloats = \d+;", "kBarrierFloats = 80;", src)
        src = sub(src, "    mbar_init(w_bar, 1);\n",
                  "    for (int i = 0; i < 1 + kSingleGroups * kMaxStages; ++i) mbar_init(w_bar + i, 1);\n")
        rows = ("    for (int c = tid; c < nt * ncol; c += kSingleThreads) {\n"
                "      const int r = c / ncol;\n"
                "      const int col = (c - r * ncol) * C;\n"
                "      cp_async<C>(slot + r * DP + col, src + (size_t)r * D + col);\n"
                "    }\n")
        copy = ("        if (lane == 0) bulk_copy(slot, src, (unsigned)(nt * D * 4), full);\n"
                if "bulktile" in name else
                "        for (int r = lane; r < nt; r += 32)\n"
                "          bulk_copy(slot + r * DP, src + (size_t)r * D, (unsigned)(D * 4), full);\n")
        # (16-byte rows only: the narrow path keeps its per-thread copies)
        src = sub(src, rows,
                  "    uint64_t* full = w_bar + 1 + grp * kMaxStages + g % stages;\n"
                  "    if (C == 4 && warp == 0) {\n"
                  "      if (lane == 0) mbar_expect_tx(full, (unsigned)((nt + (kind == 0 && t == 0)) * D * 4));\n"
                  "      __syncwarp();\n" + copy +
                  "      if (lane == 0 && kind == 0 && t == 0)\n"
                  "        bulk_copy(slot + TN * DP + TNP, q + b * D, (unsigned)(D * 4), full);\n"
                  "    }\n"
                  "    if (C != 4) {\n" + rows + "    }\n")
        src = sub(src, "      if (t == 0)\n        for (int c = tid * C; c < D; c += kSingleThreads * C)\n",
                  "      if (t == 0 && C != 4)\n        for (int c = tid * C; c < D; c += kSingleThreads * C)\n")
        src = sub(src, wait, wait + "    if (C == 4) mbar_wait(w_bar + 1 + grp * kMaxStages + g % stages, (g / stages) & 1);\n")
        if "bulktile" in name:  # rows D apart, as one copy lands them
            src = sub(src, "  const int DP = D + C;\n  const int TNP = padded_nodes(TN);\n"
                           "  const int slot_f = single_slot_floats(TN, D, C);\n  const int grp",
                      "  const int DP = D;\n  const int TNP = padded_nodes(TN);\n"
                      "  const int slot_f = single_slot_floats(TN, D, C);\n  const int grp")
    return src


# Pieces of the tensor-core grouped kernel that its patches replace
_MMA_3X = ("  mma_tf32(d, a_lo, b_hi);\n"
           "  mma_tf32(d, a_hi, b_lo);\n"
           "  mma_tf32(d, a_hi, b_hi);\n")
_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;\n")
_STAGE = ("  const int DP = D + 4;\n"
          "  for (int i = tid * 4; i < rows * D; i += NT * 4) {\n")
_BIAS_COPY = "      if (r < nl && c < nt)\n"
_W_STAGE = "  if (WS) {  // W, once, in flight while the first node tile is computed\n"
_W_LOAD = ("__ldg(w0 + (size_t)k0 * D + u * NS * 8),\n"
           "                  __ldg(w0 + (size_t)(k0 + 4) * D + u * NS * 8)")
_PROJ_LOOP = ("#pragma unroll 2\n"
              "    for (int k0 = 0; k0 < D; k0 += 8) {\n"
              "      uint32_t ah[4], al[4];\n")
_EXPS = ("alpha[i] = first ? 0.f : expf(", "s[j][e] = expf(")
_HEAD_LOOP = "    for (int item = warp; item < H * MT; item += NW) {\n"
_LOGIT_LOOP = "    for (int jt = pj; jt < (nt + 7) >> 3 && pm < mts; jt += NS) {\n"
_MT_CHOICE = "  int mt = N > kGroupedTileN ? 1 : L > 2 * kTileL ? 4 : L > kTileL ? 2 : 1;\n"
_ON_TC = "  return (hd == 8 || hd == 16 || hd == 32) && D <= kMmaMaxD;\n"


def patched_grouped(src: str, name: str) -> str:
    for part in name.split("-")[1:]:
        if m := re.fullmatch(r"mt([124])", part):
            # M where it fits, else the next smaller
            src = sub(src, _MT_CHOICE, f"  int mt = {m[1]};\n")
            src = sub(src, "    if (10 * blocks >= 9LL * dev.sms * per_sm) break;\n",
                      "    (void)blocks;\n    (void)per_sm;\n    break;\n")
        elif m := re.fullmatch(r"regs(\d+)", part):
            src = re.sub(r"kMmaMaxRegs = \d+;", f"kMmaMaxRegs = {m[1]};", src)
        elif m := re.fullmatch(r"tileN(\d+)", part):
            if int(m[1]) % 8 or not 8 <= int(m[1]) <= 64:
                raise ValueError(f"tileN takes a multiple of 8 up to 64, not {m[1]}")
            src = re.sub(r"kGroupedTileN = \d+;", f"kGroupedTileN = {m[1]};", src)
        elif part == "copyonly":
            src = sub(src, _MMA_3X,
                      "  d[0] += __uint_as_float(a_hi[0] ^ a_lo[0] ^ b_hi[0] ^ b_lo[0]);\n")
            src = sub(src, _SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;\n")
        elif part == "computeonly":
            src = sub(src, _STAGE, _STAGE.replace("  for", "  if (rows >= 0) return;\n  for", 1))
            src = sub(src, _BIAS_COPY, _BIAS_COPY.replace("if (", "if (false && "))
            src = sub(src, _W_STAGE, _W_STAGE.replace("if (WS)", "if (false && WS)"))
            # rows 0-31 of the two tile buffers stand in for W's rows
            src = sub(src, _W_LOAD, "kbuf[((k0 + t) & 31) * DP + (pj + u * NS) * 8 + g], "
                                    "kbuf[((k0 + t + 4) & 31) * DP + (pj + u * NS) * 8 + g]")
        elif part == "noproj":
            src = sub(src, _PROJ_LOOP, _PROJ_LOOP.replace("k0 < D", "k0 < 0"))
        elif part == "nohead":
            src = sub(src, _HEAD_LOOP, _HEAD_LOOP.replace("item < H * MT", "item < 0"))
        elif part == "nologits":
            src = sub(src, _LOGIT_LOOP, _LOGIT_LOOP.replace("jt < (nt + 7) >> 3", "jt < 0"))
        elif m := re.fullmatch(r"projunroll(\d+)", part):
            src = sub(src, _PROJ_LOOP, _PROJ_LOOP.replace("unroll 2", f"unroll {m[1]}"))
        elif part == "fastexp":
            for old in _EXPS:
                src = sub(src, old, old.replace("expf(", "__expf("))
        elif part == "tf32x1":
            src = sub(src, _MMA_3X, "  mma_tf32(d, a_hi, b_hi);\n")
        elif part == "cudacore":
            src = sub(src, _ON_TC, _ON_TC.replace("return (", "return false && ("))
        else:
            raise ValueError(f"unknown patch {part!r} in {name!r}")
    return src


def ptxas_lines(log: str, kinds) -> dict:
    """Registers, stack and spills of each entry point of the kernels named in
    ``kinds`` ("single", "grouped"), from `ptxas -v`."""
    out, entry = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"pointer_step_(single|grouped)(?:_mma)?_kernelI\w*?EE", line)
            entry = m[0] if m and m[1] in kinds else None
        elif entry and ("registers" in line or "spill" in line):
            out[entry] = (out.get(entry, "") + "; " + line.split(":", 1)[-1].strip()).lstrip("; ")
    return out


def build_all(sources: dict, kinds: dict):
    """{name: source text} -> {name: (library, ptxas lines of the kernels in
    kinds[name])}, one nvcc each,
    all started together. A variant that fails to build is reported, not
    loaded."""
    from rl4co_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib_path = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib_path, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib_path, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "build_failed": log[-3000:]}), flush=True)
            continue
        lib = ctypes.CDLL(lib_path)
        for fn, (restype, argtypes) in _build.SIGNATURES["pointer_kernel.cu"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        built[name] = (lib, ptxas_lines(log, kinds[name]))
    return built


def parse_args(argv):
    """[--baseline FILE ...] [VARIANT ...] -> ({baseline name: file}, variants)"""
    baselines, names = {}, []
    it = iter(argv)
    for arg in it:
        if arg == "--baseline":
            baselines["baseline" + (str(len(baselines) + 1) if baselines else "")] = next(it)
        else:
            names.append(arg)
    return baselines, names


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rl4co_tpu_torch.ops import _build
    from rl4co_tpu_torch.ops.pointer_kernel import fused_pointer_logits

    if not torch.cuda.is_available():
        print("kernel_variants needs an NVIDIA GPU", file=sys.stderr)
        return 1
    baselines, names = parse_args(argv)
    names = names or DEFAULT_SINGLE + DEFAULT_GROUPED
    kinds = sorted({kind(n) for n in names})
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sources = {name: patched(name) for name in names}
    variant_kinds = {name: [kind(name)] for name in names}
    for name, path in baselines.items():
        sources[name] = open(path).read()
        variant_kinds[name] = kinds
    built = build_all(sources, variant_kinds)
    for name, (_, regs) in built.items():
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    order = [n for n in list(baselines) + names if n in built]

    max_smem = built[order[0]][0].pointer_kernel_max_smem_bytes()
    for name in order:
        if any(p in name.split("-") for p in NO_LOGITS):
            continue
        lib = built[name][0]
        _build._LIBS["pointer_kernel"] = lib
        for kd in variant_kinds[name]:
            smem = getattr(lib, f"pointer_step_{kd}_smem_bytes")
            cases = [c for c in cs.CASES if (c[1] is None) == (kd == "single")
                     and smem(c[2], c[3], c[4]) <= max_smem]
            try:
                stats = cs.check_kernels(dev, cases=cases)[f"pointer_step_{kd}"]
                print(json.dumps({"variant": name, "kernel": kd, "check": stats}), flush=True)
            except AssertionError as e:
                print(json.dumps({"variant": name, "kernel": kd, "check_failed": str(e)}),
                      flush=True)

    rs = np.random.RandomState(1)
    cases, bounds = {}, {}
    for kd in kinds:
        for b, l, n, d, h in SHAPES[kd]:
            key = (f"B{b} N{n}" if l is None else f"B{b} L{l} N{n}") + f" D{d} H{h}"
            cases[key] = (kd, n, d, h, cs.make_case(rs, b, l, n, d, h, 0.7, dev))
            bounds[key] = {"bound_ms": cs.bound_ms(b, l, n, d)[0]}
            if l is not None:
                bounds[key]["tc_bound_ms"] = cs.tc_bound_ms(b, l, n, d)[0]
    print(json.dumps({"bounds": bounds}), flush=True)
    for name in order + order[::-1]:
        lib = built[name][0]
        _build._LIBS["pointer_kernel"] = lib
        ms = {}
        for key, (kd, n, d, h, args) in cases.items():
            if kd not in variant_kinds[name]:
                continue
            if getattr(lib, f"pointer_step_{kd}_smem_bytes")(n, d, h) > max_smem:
                ms[key] = None  # its shared memory does not fit
                continue
            ms[key] = cs.time_ms(lambda: fused_pointer_logits(*args))
        print(json.dumps({"variant": name, "card": smi, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
