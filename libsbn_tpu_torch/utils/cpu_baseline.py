"""ctypes binding of the native CPU pruning + gradient baseline.

The counterpart of libsbn_tpu/utils/cpu_baseline.py, bound to the same
shared library: ``native/libsbn_cpu_baseline.so``, built from
``native/cpu_baseline.cpp`` with ``make -C native cpu_baseline`` when it is
missing (found as io/native.py finds the native core: the repo root's
``native/`` directory, or ``LIBSBN_TPU_NATIVE_DIR``). It is an -O3
-march=native, OpenMP-threaded host implementation of the headline workload
(JC69 + constant sites, log likelihood and the linear-time two-pass branch
gradient) and of a K-category LL from precomputed transition matrices: the
host denominator of a benchmark's ``vs_baseline``, the stand-in for the
reference's BEAGLE CPU backend (fat_beagle.cpp). It is not a device path:
it takes numpy arrays, or CPU tensors (converted with ``.numpy()``), and
returns numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from ..io.native import _NATIVE_DIR

_SO_PATH = os.path.join(_NATIVE_DIR, "libsbn_cpu_baseline.so")
_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR, "cpu_baseline"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(_SO_PATH)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.lsbn_cpu_baseline_eval.argtypes = [
        i32p, i32p, i32p, i32p, f64p, f64p, f64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f64p, f64p,
    ]
    lib.lsbn_cpu_baseline_eval.restype = None
    lib.lsbn_cpu_baseline_eval_pk.argtypes = [
        i32p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, f64p,
    ]
    lib.lsbn_cpu_baseline_eval_pk.restype = None
    _LIB = lib
    return lib


def _host(a, dtype):
    """``a`` (a numpy array or a CPU tensor) as a C-contiguous numpy array
    of ``dtype``; a tensor on another device raises."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(
                f"the CPU baseline takes host arrays, got a tensor on {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def eval_batch(post_children, up_node, up_parent, up_sibs, bl, tips,
               weights, leaf_count, threads=0, dtype_bits=64,
               ll_only=False):
    """LLs + branch gradients for a batch of trees on the host.

    post_children: (T, n_internal, 3); up_*: (T, n_up[, 2]); bl: (T, N+1)
    by node id (ones slot zero); tips: (L, 4, S); weights: (S,). threads:
    OpenMP threads (0: all cores); dtype_bits: 64 or 32, the arithmetic's
    width. Returns (lls (T,), grads (T, N)), float64; with ll_only=True
    the gradient pass is skipped and grads is None (the LL-only
    denominator)."""
    lib = _load()
    post_children, up_node, up_parent, up_sibs = (
        _host(a, np.int32) for a in (post_children, up_node, up_parent,
                                     up_sibs))
    bl, tips, weights = (_host(a, np.float64) for a in (bl, tips, weights))
    T, n_internal, _ = post_children.shape
    L = int(leaf_count)
    N = L + n_internal
    n_up = up_node.shape[1]
    S = weights.shape[0]
    if bl.shape != (T, N + 1) or tips.shape != (L, 4, S):
        raise ValueError(f"bl {bl.shape} must be ({T}, {N + 1}) and tips "
                         f"{tips.shape} ({L}, 4, {S})")
    if (up_node.shape != (T, n_up) or up_parent.shape != (T, n_up)
            or up_sibs.shape != (T, n_up, 2)):
        raise ValueError(f"up_node {up_node.shape}, up_parent "
                         f"{up_parent.shape}, up_sibs {up_sibs.shape} must be "
                         f"({T}, {n_up}), ({T}, {n_up}), ({T}, {n_up}, 2)")
    if int(dtype_bits) not in (32, 64):
        raise ValueError(f"dtype_bits must be 32 or 64, got {dtype_bits}")
    out_ll = np.empty(T, np.float64)
    out_grad = None if ll_only else np.empty((T, N), np.float64)
    i32, f64 = ctypes.c_int32, ctypes.c_double
    lib.lsbn_cpu_baseline_eval(
        _ptr(post_children, i32), _ptr(up_node, i32), _ptr(up_parent, i32),
        _ptr(up_sibs, i32), _ptr(bl, f64), _ptr(tips, f64),
        _ptr(weights, f64), T, L, N, n_up, S, int(threads), int(dtype_bits),
        _ptr(out_ll, f64),
        ctypes.cast(None, ctypes.POINTER(f64)) if ll_only
        else _ptr(out_grad, f64),
    )
    return out_ll, out_grad


def eval_batch_ll_pk(post_children, P, tips, weights, props, freqs,
                     leaf_count, threads=0):
    """K-category LL-only with precomputed per-node transition matrices:
    the native denominator for the batched GTR/Weibull likelihood.

    post_children: (T, n_internal, 3); P: (T, N+1, K, 4, 4); tips:
    (L, 4, S); props: (K,); freqs: (4,). Returns lls (T,), float64."""
    lib = _load()
    post_children = _host(post_children, np.int32)
    P, tips, weights, props, freqs = (
        _host(a, np.float64) for a in (P, tips, weights, props, freqs))
    T, n_internal, _ = post_children.shape
    L = int(leaf_count)
    N = L + n_internal
    K = P.shape[2]
    S = weights.shape[0]
    if P.shape != (T, N + 1, K, 4, 4) or tips.shape != (L, 4, S):
        raise ValueError(f"P {P.shape} must be ({T}, {N + 1}, K, 4, 4) and "
                         f"tips {tips.shape} ({L}, 4, {S})")
    if props.shape != (K,) or freqs.shape != (4,):
        raise ValueError(f"props {props.shape} must be ({K},) and freqs "
                         f"{freqs.shape} (4,)")
    out_ll = np.empty(T, np.float64)
    i32, f64 = ctypes.c_int32, ctypes.c_double
    lib.lsbn_cpu_baseline_eval_pk(
        _ptr(post_children, i32), _ptr(P, f64), _ptr(tips, f64),
        _ptr(weights, f64), _ptr(props, f64), _ptr(freqs, f64),
        T, L, N, K, S, int(threads), _ptr(out_ll, f64),
    )
    return out_ll
