"""Builds and loads the package's CUDA kernels (csrc/*.cu).

Route: ``nvcc`` compiles each source into its own shared library with a
plain C interface, which is loaded with ctypes; no PyTorch headers are
compiled. A library is built at first use into
``build/libsbn_tpu_torch_kernels/`` at the repository root (``build/`` is
git-ignored), under a name carrying the hash of its source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
``build()`` runs the nvcc of several sources in parallel. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(_PKG_DIR), "build", "libsbn_tpu_torch_kernels"
)
# sm_90a: Hopper. Never --use_fast_math (precision policy: full-precision
# exp/log/division, as the parity gates assume).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = {}
# Per source, what the last build of this process did: library path,
# seconds spent in nvcc (0.0 when a built library was reused) and nvcc's
# ptxas report.
build_info = {}

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


def _bind_jc(lib):
    lib.lsbn_jc69_tile.restype = _I32
    lib.lsbn_jc69_tile.argtypes = []
    lib.lsbn_jc69_max_k.restype = _I32
    lib.lsbn_jc69_max_k.argtypes = []
    for dt in ("f32", "f64"):
        # pc, em, props, tips, w, ll_part; B, L, S, N1, K, P, tile, shared
        # bytes; stream
        _sig(lib, f"lsbn_jc69_ll_{dt}", 6, 8)
        # pc, em, rates, props, tips, w, ll_part, grad_part;
        # B, L, S, N1, K, P, tile, shared bytes; stream
        _sig(lib, f"lsbn_jc69_ll_grad_{dt}", 8, 8)
        # pc, em, props, tips, w, dprops_part, dea_part;
        # B, L, S, N1, K, P, tile, shared bytes; stream
        _sig(lib, f"lsbn_jc69_dea_{dt}", 7, 8)
        # The slab routes: pc, em, props, tips, w, E, ES, ll_part;
        # B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_jc69_ll_slab_{dt}", 8, 6)
        # pc, em, rates, props, tips, w, E, ES, U, ll_part,
        # grad_part; B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_jc69_ll_grad_slab_{dt}", 11, 6)
        # pc, em, props, tips, w, E, ES, M, U, dprops_part, dea_part;
        # B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_jc69_dea_slab_{dt}", 11, 6)


def _bind_generic(lib):
    lib.lsbn_generic_tile.restype = _I32
    lib.lsbn_generic_tile.argtypes = []
    lib.lsbn_generic_max_k.restype = _I32
    lib.lsbn_generic_max_k.argtypes = []
    for dt in ("f32", "f64"):
        # pc, P, tips, freqs, props, w, ll_part; fs, ps, B, L, S, N1, K, P,
        # warps a block, shared bytes, tiles a warp walks; stream
        _sig(lib, f"lsbn_generic_ll_{dt}", 7, 11)
        # The slab route: pc, P, tips, freqs, props, w, E, ll_part; fs, ps,
        # B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_generic_ll_slab_{dt}", 8, 8)
        # pc, P, Q, tips, freqs, props, w, ll_part, grad_part; B, L, S, N1,
        # K, P, tile, shared bytes, tiles a block walks; stream
        _sig(lib, f"lsbn_generic_ll_grad_{dt}", 9, 9)
        # The slab route: pc, P, Q, tips, freqs, props, w, E, U, ll_part,
        # grad_part; B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_generic_ll_grad_slab_{dt}", 11, 6)
        # pc, P, tips, freqs, props, w, dp_part, root_part; fs, ps, B, L, S,
        # N1, K, P, tile, shared bytes, tiles a block walks; stream
        _sig(lib, f"lsbn_generic_dp_{dt}", 8, 11)
        # The slab route: pc, P, tips, freqs, props, w, E, M, U, dp_part,
        # root_part; fs, ps, B, L, S, N1, K, P; stream
        _sig(lib, f"lsbn_generic_dp_slab_{dt}", 11, 8)


def _bind_gp(lib):
    for dt in ("f32", "f64"):
        # rootward, leafward, roots, the streams' group and level offsets
        # (rootward, then leafward), q, P, tips, p, PH, rhat, RB, lsp, lsPH,
        # lsrhat, lsRB; n_rw, n_lw, n_roots, the offsets' group and level
        # counts, E, N, L, S, tile, shared bytes; stream
        _sig(lib, f"lsbn_gp_populate_{dt}", 18, 13)
        # The slab route: rootward, leafward, roots, q, P, tips, the 8
        # outputs; n_rw, n_lw, n_roots, E, N, L, S; stream
        _sig(lib, f"lsbn_gp_populate_slab_{dt}", 14, 7)
        # A, B, w, cur, out; E, S, shared bytes; stream
        _sig(lib, f"lsbn_gp_golden_sweep_{dt}", 5, 3)
        # The slab route: A, B, w, cur, out; E, S; stream
        _sig(lib, f"lsbn_gp_golden_sweep_slab_{dt}", 5, 2)


def _bind_heights(lib):
    for dt in ("f32", "f64"):
        # ratios, bounds, rates, parent, heights, operand, slab (null on
        # the shared route); a tree's bytes, B, L, N, sweeps; stream
        _sig(lib, f"lsbn_heights_forward_{dt}", 7, 5)
        # grad, heights, bounds, ratios, rates, post_children, parent,
        # dratios, clock, slab; a tree's bytes, grad's row stride, B, L, N,
        # sweeps, strict clock; stream
        _sig(lib, f"lsbn_heights_adjoint_{dt}", 10, 7)


# One library per source, csrc/<name>.cu, with its C signatures.
_BINDERS = {"pruning_jc": _bind_jc, "pruning_generic": _bind_generic,
            "gp_engine": _bind_gp, "heights": _bind_heights}
SOURCES = tuple(_BINDERS)


def _sig(lib, name, pointers, ints):
    fn = getattr(lib, name)
    fn.restype = _I32
    fn.argtypes = [_PTR] * pointers + [_I32] * ints + [_PTR]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _library_path(name: str):
    source = os.path.join(_CSRC, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return source, os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Build the named sources' libraries that are not built yet, one nvcc
    process per source, all started together. Raises if any nvcc fails."""
    started = []
    for name in names:
        source, path = _library_path(name)
        if os.path.exists(path):
            if build_info.get(name, {}).get("path") != path:
                build_info[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        build_info[name] = {"path": path, "seconds": 0.0, "log": ""}
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started.append((name, source, path, tmp, proc, time.perf_counter()))
    failed = []
    for name, source, path, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        build_info[name].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str):
    """The library of csrc/<name>.cu (built first if needed), with its C
    signatures."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(build_info[name]["path"])
    lib.lsbn_cuda_error_string.restype = ctypes.c_char_p
    lib.lsbn_cuda_error_string.argtypes = [_I32]
    _BINDERS[name](lib)
    _libs[name] = lib
    return lib


def check(lib, rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.lsbn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
