"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``, no PyTorch
headers) and becomes one shared library, compiled by ``nvcc`` for ``sm_90a``
into ``rl4co_tpu_torch/_build/`` (git-ignored) and loaded with `ctypes`.
The library's file name carries a hash of the source and the flags, so an
edit rebuilds. All sources are compiled in parallel, one ``nvcc`` each.
Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, lk, bias, w_out, out, B, L, N, D, H, stream
_STEP_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]

# C signatures per source: {source stem: {function: (restype, argtypes)}}
SIGNATURES = {
    "pointer_kernel": {
        "pointer_step_single": (_I, _STEP_ARGTYPES),
        "pointer_step_grouped": (_I, _STEP_ARGTYPES),
        "pointer_step_single_smem_bytes": (_I, [_I, _I, _I]),
        "pointer_step_grouped_smem_bytes": (_I, [_I, _I, _I]),
        "pointer_kernel_max_smem_bytes": (_I, []),
        "pointer_kernel_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together. Returns {name: library path}. A failed build
    raises with ``nvcc``'s output."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        # build under a temporary name, then rename: a reader never sees a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{n}_", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, str(CSRC_DIR / f"{n}.cu")]
        procs.append((n, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for n, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{out}")
            continue
        if verbose and out:
            print(out, flush=True)
        os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    `argtypes` set (a pointer passed without them is cut to 32 bits)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib
