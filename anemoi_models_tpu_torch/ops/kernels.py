"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, at first use, and loaded with ctypes. The
library lands in ``build/kernels/`` beside the package, under a name keyed by
the sources' content and the compiler flags, so a changed source rebuilds and
an unchanged one loads at once. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside it as ``.log``.

Nothing here runs at import time, and nothing falls back: a missing ``nvcc``
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "load_kernels", "build_log"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB: ctypes.CDLL | None = None
_LIB_PATH: str | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "kv_proj_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "kv_proj_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "edge_attn_csr_f32": [_P] * 9 + [_I] * 6 + [_P],
    "edge_attn_csr_bf16": [_P] * 9 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"anemoi_kernels_{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp-{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *cu],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    with open(so_path[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _LIB, _LIB_PATH
    if _LIB is None:
        so_path = _library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB, _LIB_PATH = lib, so_path
    return _LIB


def build_log() -> str:
    """The compiler's report for the loaded library ('' if it was not built
    by this checkout's build step)."""
    if _LIB_PATH is None:
        return ""
    log = _LIB_PATH[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()
