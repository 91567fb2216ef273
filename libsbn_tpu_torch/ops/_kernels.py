"""Builds and loads the package's CUDA kernels (csrc/*.cu).

Route: ``nvcc`` compiles each source into a shared library with a plain C
interface, which is loaded with ctypes; no PyTorch headers are compiled.
The library is built at first use into ``build/libsbn_tpu_torch_kernels/``
at the repository root (``build/`` is git-ignored), under a name carrying
the hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "pruning_jc.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(_PKG_DIR), "build", "libsbn_tpu_torch_kernels"
)
# sm_90a: Hopper. Never --use_fast_math (precision policy: full-precision
# exp/log/division, as the parity gates assume).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
# What the last build of this process did: library path, seconds spent in
# nvcc (0.0 when a built library was reused) and nvcc's ptxas report.
build_info = {"path": None, "seconds": 0.0, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _build() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"pruning_jc_{digest.hexdigest()[:16]}.so")
    build_info["path"] = path
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
        capture_output=True, text=True,
    )
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{build_info['log']}")
    os.replace(tmp, path)  # atomic: a concurrent reader never sees half a file
    return path


def load():
    """The kernel library (built first if needed), with its C signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lsbn_jc69_tile.restype = i32
    lib.lsbn_jc69_tile.argtypes = []
    lib.lsbn_jc69_max_k.restype = i32
    lib.lsbn_jc69_max_k.argtypes = []
    lib.lsbn_cuda_error_string.restype = ctypes.c_char_p
    lib.lsbn_cuda_error_string.argtypes = [i32]
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"lsbn_jc69_ll_{dt}")
        fn.restype = i32
        # pc, ea, props, tips, w, E, ES, ll_part; B, L, S, N1, K, P; stream
        fn.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        fn = getattr(lib, f"lsbn_jc69_ll_grad_{dt}")
        fn.restype = i32
        # pc, ea, rates, props, tips, w, E, ES, U, ll_part, grad_part;
        # B, L, S, N1, K, P; stream
        fn.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
        fn = getattr(lib, f"lsbn_jc69_dea_{dt}")
        fn.restype = i32
        # pc, ea, props, tips, w, E, ES, M, U, dprops_part, dea_part;
        # B, L, S, N1, K, P; stream
        fn.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
    _lib = lib
    return lib


def check(lib, rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.lsbn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
