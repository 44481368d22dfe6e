"""Variants of the pointer kernels, timed side by side on one GPU.

    python3 -m rl4co_tpu_torch.ops.kernel_variants [--baseline FILE] [VARIANT ...]
    (from the repository root)

Each variant is a patched copy of `rl4co_tpu_torch/csrc/pointer_kernel.cu`,
built with the same `nvcc` flags into `_build/variants/` (one `nvcc` per
variant, all started together), loaded with `ctypes` and swapped in for the
wrapper's library. Every variant that still computes the logits is held
against the plain version on its kernel's cases of `chip_smoke.CASES` (those
whose shared memory fits); then the kernels alone are timed in turns (the
list, then the list reversed) by `chip_smoke.time_ms` at the paths' shapes.
`--baseline FILE` adds the unpatched source FILE (another commit's
`pointer_kernel.cu`) as the variant `baseline`, timed at every shape of the
run. Without variant names: DEFAULT_SINGLE and DEFAULT_GROUPED. Prints one
JSON line per result, `ptxas`' registers and spills of every build first.
Needs a card, `nvcc` and numpy; imports nothing of JAX.

Single-query kernel (`pointer_step_single`, K2; names combine with `-`):
  g<G>t<T>n<N>  G groups of T threads per block, node tiles of N (the
                shipped kernel is g4t128n32);
  copyonly      the ring is filled and waited for, nothing is computed;
  computeonly   nothing is copied, the phases run on whatever is in the ring;
  bulkrow       the ring filled by 1-D bulk copies (`cp.async.bulk` with an
                mbarrier per slot), one per padded row, issued by warp 0;
  bulktile      the same, one bulk copy per tile into unpadded rows.

Grouped kernel (`pointer_step_grouped`, K1): `grouped` is the shipped
kernel, `grouped-<patch>[-<patch>...]` a patched copy:
  copyonly      K, V and LK staged, queries, bias and W read, the logits
                written; the arithmetic phases reduced to one read each;
  computeonly   nothing staged, the phases run on whatever is in shared
                memory, and the projection reads W from shared memory;
  noproj        the projection is skipped (the logits use the queries);
  tileL<T>      T queries per block (kTileL), one block per SM at least;
  subL<S>       S queries per thread in scores, glimpse and projection;
  minb<M>       `__launch_bounds__`' minimum of blocks per SM set to M;
  scoreN<R>     R nodes per thread in the scores phase (kScoreNodes);
  logitN<R>     R nodes per thread in the logits phase (kLogitNodes);
  groupL<G>     G queries per thread in the logits phase (kGroupL);
  fullsub       sub-tiles of kSubL queries wholly past the last query are
                computed as well (the kernel before it skipped them).
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
                   "grouped-tileL32", "grouped-tileL64", "grouped-subL4", "grouped-subL16",
                   "grouped-minb2", "grouped-fullsub", "grouped-scoreN1", "grouped-scoreN2",
                   "grouped-logitN1", "grouped-logitN4", "grouped-groupL8"]
BASE = {"g4t128n32", "grouped"}  # the shipped kernels: no patch
NO_LOGITS = ("copyonly", "computeonly", "noproj")  # patches that break the result
# (B, N) for the single kernel, (B, L, N) for the grouped one; D 128, H 8
SHAPES = {
    "single": [(1024, 50), (512, 50), (512, 20), (4096, 50), (64, 2048)],
    # POMO's multistart greedy and dihedral-8 dispatches and its train step on
    # CVRP-50, AM's multistart on TSP-50, multistart on TSP-500
    "grouped": [(655, 50, 51), (648, 50, 51), (64, 50, 51), (256, 50, 50), (16, 500, 500)],
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


# The grouped kernel's inner products, each cut to one read by `copyonly`
_SCORES_DOT = ("      for (int j = 0; j < hd; j += C) {\n"
               "        Chunk<C> kv[kScoreNodes];\n"
               "#pragma unroll\n"
               "        for (int r = 0; r < kScoreNodes; ++r) kv[r] = load_chunk<C>(kr[r] + j);\n"
               "#pragma unroll\n"
               "        for (int l = 0; l < kSubL; ++l) {\n"
               "          const Chunk<C> qv = load_chunk<C>(qr + l * D + j);\n"
               "#pragma unroll\n"
               "          for (int r = 0; r < kScoreNodes; ++r)\n"
               "#pragma unroll\n"
               "            for (int e = 0; e < C; ++e) acc[l][r] += qv.v[e] * kv[r].v[e];\n"
               "        }\n"
               "      }\n")
_GLIMPSE_DOT = ("      int n = 0;\n"
                "      for (; n + C <= nt; n += C) {\n"
                "        float vv[C];\n"
                "#pragma unroll\n"
                "        for (int e = 0; e < C; ++e) vv[e] = buf[(n + e) * DP + d];\n"
                "#pragma unroll\n"
                "        for (int l = 0; l < kSubL; ++l) {\n"
                "          const Chunk<C> pv = load_chunk<C>(wrow + l * H * TNP + n);\n"
                "#pragma unroll\n"
                "          for (int e = 0; e < C; ++e) acc[l] += pv.v[e] * vv[e];\n"
                "        }\n"
                "      }\n"
                "      for (; n < nt; ++n) {  // the nodes past the last whole chunk\n"
                "        const float vv = buf[n * DP + d];\n"
                "#pragma unroll\n"
                "        for (int l = 0; l < kSubL; ++l) acc[l] += wrow[l * H * TNP + n] * vv;\n"
                "      }\n")
_PROJ_DOT = ("#pragma unroll\n"
             "      for (int l = 0; l < kSubL; ++l) {\n"
             "        const Chunk<C> gv = load_chunk<C>(g_s + (lb + l) * D + d);\n"
             "#pragma unroll\n"
             "        for (int e = 0; e < C; ++e) acc[l] += gv.v[e] * wv[e];\n"
             "      }\n")
_LOGITS_DOT = ("      for (int d = 0; d < D; d += C) {\n"
               "        Chunk<C> lv[kLogitNodes];\n"
               "#pragma unroll\n"
               "        for (int r = 0; r < kLogitNodes; ++r) lv[r] = load_chunk<C>(lr[r] + d);\n"
               "#pragma unroll\n"
               "        for (int a = 0; a < kGroupL; ++a) {\n"
               "          const Chunk<C> pv = load_chunk<C>(prow + a * D + d);\n"
               "#pragma unroll\n"
               "          for (int r = 0; r < kLogitNodes; ++r)\n"
               "#pragma unroll\n"
               "            for (int e = 0; e < C; ++e) acc[a][r] += pv.v[e] * lv[r].v[e];\n"
               "        }\n"
               "      }\n")
_W_LOAD = "      for (int e = 0; e < C; ++e) wv[e] = w[(size_t)(d + e) * D + j];\n"
_LAUNCH_BOUNDS = "__launch_bounds__(kGroupedThreads, 3)"


def patched_grouped(src: str, name: str) -> str:
    parts = name.split("-")[1:]
    for part in parts:
        if m := re.fullmatch(r"tileL(\d+)", part):
            src = re.sub(r"kTileL = \d+;", f"kTileL = {m[1]};", src)
            if not any(p.startswith("minb") for p in parts):
                src = sub(src, _LAUNCH_BOUNDS, "__launch_bounds__(kGroupedThreads, 1)")
        elif m := re.fullmatch(r"subL(\d+)", part):
            src = re.sub(r"kSubL = \d+;", f"kSubL = {m[1]};", src)
        elif m := re.fullmatch(r"minb(\d+)", part):
            src = sub(src, _LAUNCH_BOUNDS, f"__launch_bounds__(kGroupedThreads, {m[1]})")
        elif m := re.fullmatch(r"(score|logit)N(\d+)", part):
            name_ = "kScoreNodes" if m[1] == "score" else "kLogitNodes"
            src = re.sub(name_ + r" = \d+;", f"{name_} = {m[2]};", src)
        elif m := re.fullmatch(r"groupL(\d+)", part):
            src = re.sub(r"kGroupL = \d+;", f"kGroupL = {m[1]};", src)
        elif part == "fullsub":
            src = sub(src, "  const int nsub = (nl + kSubL - 1) / kSubL;",
                      "  const int nsub = kTileL / kSubL;")
        elif part == "copyonly":
            src = sub(src, _SCORES_DOT, "      acc[0][0] = kr[0][0] + qr[0];\n")
            src = sub(src, "    for (int r = warp; r < nl * H; r += nwarps)\n",
                      "    for (int r = warp; r < 0; r += nwarps)\n")
            src = sub(src, _GLIMPSE_DOT, "      acc[0] += buf[d] + wrow[0];\n")
            src = sub(src, _PROJ_DOT, "#pragma unroll\n"
                      "      for (int e = 0; e < C; ++e) acc[0] += wv[e];\n")
            src = sub(src, _LOGITS_DOT, "      acc[0][0] = lr[0][0] + prow[0];\n")
        elif part == "computeonly":
            src = sub(src, "  for (int i = tid * C; i < rows * D; i += kGroupedThreads * C) {\n",
                      "  if (rows >= 0) return;\n"
                      "  for (int i = tid * C; i < rows * D; i += kGroupedThreads * C) {\n")
            # rows 0-31 of the staging buffer stand in for W's rows
            src = sub(src, _W_LOAD,
                      "      for (int e = 0; e < C; ++e) wv[e] = buf[((d + e) & 31) * DP + j];\n")
        elif part == "noproj":
            src = sub(src, "    const int j = t % D;\n",
                      "    const int j = t % D;\n    if (j >= 0) break;\n")
        else:
            raise ValueError(f"unknown patch {part!r} in {name!r}")
    return src


def ptxas_lines(log: str, kinds) -> dict:
    """Registers, stack and spills of each entry point of the kernels named in
    ``kinds`` ("single", "grouped"), from `ptxas -v`."""
    out, entry = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"pointer_step_(single|grouped)_kernelI\w*?EE", line)
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
        for fn, (restype, argtypes) in _build.SIGNATURES["pointer_kernel"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        built[name] = (lib, ptxas_lines(log, kinds[name]))
    return built


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rl4co_tpu_torch.ops import _build
    from rl4co_tpu_torch.ops.pointer_kernel import fused_pointer_logits

    if not torch.cuda.is_available():
        print("kernel_variants needs an NVIDIA GPU", file=sys.stderr)
        return 1
    baseline = None
    if argv[:1] == ["--baseline"]:
        baseline, argv = argv[1], argv[2:]
    names = argv or DEFAULT_SINGLE + DEFAULT_GROUPED
    kinds = sorted({kind(n) for n in names})
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sources = {name: patched(name) for name in names}
    variant_kinds = {name: [kind(name)] for name in names}
    if baseline:
        sources["baseline"] = open(baseline).read()
        variant_kinds["baseline"] = kinds
    built = build_all(sources, variant_kinds)
    for name, (_, regs) in built.items():
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    order = [n for n in (["baseline"] if baseline else []) + names if n in built]

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
        for shape in SHAPES[kd]:
            b, l, n = (shape[0], None, shape[1]) if kd == "single" else shape
            key = f"B{b} N{n}" if l is None else f"B{b} L{l} N{n}"
            cases[key] = (kd, n, cs.make_case(rs, b, l, n, 128, 8, 0.7, dev))
            bounds[key] = cs.bound_ms(b, l, n, 128)[0]
    print(json.dumps({"bound_ms": bounds}), flush=True)
    for name in order + order[::-1]:
        lib = built[name][0]
        _build._LIBS["pointer_kernel"] = lib
        ms = {}
        for key, (kd, n, args) in cases.items():
            if kd not in variant_kinds[name]:
                continue
            if getattr(lib, f"pointer_step_{kd}_smem_bytes")(n, 128, 8) > max_smem:
                ms[key] = None  # its shared memory does not fit
                continue
            ms[key] = cs.time_ms(lambda: fused_pointer_logits(*args))
        print(json.dumps({"variant": name, "card": smi, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
