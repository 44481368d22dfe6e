"""Variants of the single-query pointer kernel, timed side by side on one GPU.

    python3 -m rl4co_tpu_torch.ops.kernel_variants [VARIANT ...]   (from the repository root)

Each variant is a patched copy of `rl4co_tpu_torch/csrc/pointer_kernel.cu`,
built with the same `nvcc` flags into `_build/variants/`, loaded with
`ctypes` and swapped in for the wrapper's library; every variant that still
computes the logits is held against the plain version on the single-query
cases of `chip_smoke.CASES`; then the kernels alone are timed in turns (the
list, then the list reversed) by `chip_smoke.time_ms` at the main path's
shapes and three more. Without arguments: the variants in DEFAULT. Prints one JSON line per result. Needs a card, `nvcc` and numpy;
imports nothing of JAX.

Variants (names combine with `-`):
  g<G>t<T>n<N>  G groups of T threads per block, node tiles of N (the
                shipped kernel is g4t128n32);
  copyonly      the ring is filled and waited for, nothing is computed;
  computeonly   nothing is copied, the phases run on whatever is in the ring;
  bulkrow       the ring filled by 1-D bulk copies (`cp.async.bulk` with an
                mbarrier per slot), one per padded row, issued by warp 0;
  bulktile      the same, one bulk copy per tile into unpadded rows.
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
DEFAULT = ["g4t128n32", "g4t128n32-copyonly", "g4t128n32-computeonly",
           "g4t128n32-bulkrow", "g4t128n32-bulktile", "g2t256n64", "g1t256n64"]
SHAPES = [(1024, 50), (512, 50), (512, 20), (4096, 50), (64, 2048)]  # (B, N), D 128, H 8


def sub(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"patch does not apply: {old[:70]!r}"
    return src.replace(old, new)


def patched(name: str) -> str:
    src = open(SOURCE).read()
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


def build(name: str):
    from rl4co_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(patched(name))
    lib_path = os.path.join(OUT_DIR, f"lib{name}.so")
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                        lib_path, path], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = ctypes.CDLL(lib_path)
    for fn, (restype, argtypes) in _build.SIGNATURES["pointer_kernel"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    regs = [line.split(":")[-1].strip() for line in (r.stdout + r.stderr).splitlines()
            if "single_kernel" in line or ("Used" in line and "registers" in line)]
    return lib, regs


def main(names) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rl4co_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("kernel_variants needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    libs = {}
    for name in names:
        libs[name], regs = build(name)
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    single_cases = [c for c in cs.CASES if c[1] is None]
    for name in names:
        if "only" not in name:
            _build._LIBS["pointer_kernel"] = libs[name]
            stats = cs.check_kernels(dev, cases=single_cases)["pointer_step_single"]
            print(json.dumps({"variant": name, "check": stats}), flush=True)
    from rl4co_tpu_torch.ops.pointer_kernel import fused_pointer_logits

    rs = np.random.RandomState(1)
    cases = {f"B{b} N{n}": cs.make_case(rs, b, None, n, 128, 8, 0.7, dev) for b, n in SHAPES}
    bounds = {key: cs.bound_ms(b, None, n, 128)[0] for key, (b, n) in zip(cases, SHAPES)}
    print(json.dumps({"bound_ms": bounds}), flush=True)
    for name in names + names[::-1]:
        _build._LIBS["pointer_kernel"] = libs[name]
        ms = {key: cs.time_ms(lambda: fused_pointer_logits(*args)) for key, args in cases.items()}
        print(json.dumps({"variant": name, "card": smi, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULT))
