"""The generic log likelihood with a custom backward that emits dP.

The counterpart of libsbn_tpu/ops/pruning_pallas_vjp.py. The forward (K5)
is the E-form recursion of ops/pruning_generic.py, LL only. The backward
(K6) recomputes the forward pass in M form (remat: the function saves only
its inputs), runs the upper pass, and contracts, per edge and category,
    dP[e, k] = (U' w / denom)_k M_k^T
over the patterns, with U' carrying the props folded in; it also emits
d ll / d freqs and d ll / d props per tree. The root and ones-slot rows of
dP are zero. Every model gradient (branch lengths, GTR in stick space,
Weibull shape) then chains through ordinary autograd of P = f(params).

K5 ``ll_generic_cuda`` replaces pruning_pallas_vjp.py::_fwd_kernel and K6
``ll_dp_generic_cuda`` replaces ::_bwd_kernel (csrc/pruning_generic.cu);
``ll_generic_plain`` and ``ll_dp_generic_plain`` are their twins. Both
kernels take freqs as (B, 4) and props as (B, K), one row per tree, or
shared as (4,) and (K,): the per-tree rows let the engine get every tree's
model gradient from one launch. tips and weights are data: they get no
gradient here.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pruning import per_tree, reduce_per_tree
from .pruning_generic import (
    TINY, _forward_plain, _ll_plain, _site, _upper_plain, check_inputs,
    load_checked,
)

# Launch counts of the CUDA kernels and call counts of their twins, so a run
# can show which one it took. reset_counters() sets them all to 0.
LAUNCHES = {"ll_generic": 0, "ll_dp_generic": 0}
TWIN_CALLS = {"ll_generic": 0, "ll_dp_generic": 0}


def reset_counters():
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


class _LogLikelihoodsGeneric(torch.autograd.Function):
    """(B,) LLs from P (B, N1, K, 4, 4), freqs and props: K5 forward, K6
    backward (their twins for CPU tensors). Like the JAX custom VJP
    ``log_likelihoods_pallas``, it saves only its inputs: the backward
    recomputes the forward pass."""

    @staticmethod
    def forward(ctx, P, freqs, props, post_children, tips, weights, root_id):
        ctx.save_for_backward(P, freqs, props, post_children, tips, weights)
        ctx.root_id = root_id
        fn = ll_generic_plain if tips.device.type == "cpu" else ll_generic_cuda
        return fn(post_children, P, tips, freqs, props, weights,
                  root_id=root_id)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        P, freqs, props, post_children, tips, weights = ctx.saved_tensors
        fn = (ll_dp_generic_plain if tips.device.type == "cpu"
              else ll_dp_generic_cuda)
        dP, dfreqs, dprops = fn(post_children, P, tips, freqs, props, weights,
                                root_id=ctx.root_id)
        g = g.to(P.dtype)
        return (dP * g[:, None, None, None, None],
                reduce_per_tree(dfreqs, g, freqs),
                reduce_per_tree(dprops, g, props),
                None, None, None, None)


def log_likelihoods_generic(post_children, P, tips, freqs, props, weights, *,
                            root_id):
    """(B,) log likelihoods (K5), differentiable in P, freqs and props
    through K6. post_children: (B, S, 3) int32; P: (B, N1, K, 4, 4);
    tips: (L, 4, P); freqs: (4,) or (B, 4); props: (K,) or (B, K);
    weights: (P,); one device, one working dtype."""
    return _LogLikelihoodsGeneric.apply(P, freqs, props, post_children, tips,
                                        weights, root_id)


# -- plain PyTorch twins ------------------------------------------------------


def ll_generic_plain(post_children, P, tips, freqs, props, weights, *,
                     root_id):
    """Plain PyTorch twin of K5. Returns ll (B,)."""
    TWIN_CALLS["ll_generic"] += 1
    B = post_children.shape[0]
    E, logscale, _ = _forward_plain(post_children, P, tips, root_id)
    return _ll_plain(E[:, root_id], per_tree(freqs, B), per_tree(props, B),
                     weights, logscale)


def ll_dp_generic_plain(post_children, P, tips, freqs, props, weights, *,
                        root_id):
    """Plain PyTorch twin of K6. Returns (dP (B, N1, K, 4, 4) = d ll / dP,
    dfreqs (B, 4), dprops (B, K)), per tree; the root and ones-slot rows of
    dP are zero."""
    TWIN_CALLS["ll_dp_generic"] += 1
    B = post_children.shape[0]
    N1 = root_id + 2
    K = P.shape[2]
    freqs_b, props_b = per_tree(freqs, B), per_tree(props, B)
    E, _, M = _forward_plain(post_children, P, tips, root_id, keep_m=True)
    # Root cotangents from the rescaled root partial; the scales cancel in
    # w / site.
    m_root = M[:, root_id]  # (B, K, 4, P)
    w_over_site = weights / _site(m_root, freqs_b, props_b)
    dfreqs = P.new_empty((B, 4))
    for i in range(4):
        row = torch.zeros_like(w_over_site)
        for k in range(K):
            row = row + props_b[:, k, None] * m_root[:, k, i]
        dfreqs[:, i] = torch.sum(row * w_over_site, dim=1)
    dprops = P.new_empty((B, K))
    for k in range(K):
        row = torch.zeros_like(w_over_site)
        for i in range(4):
            row = row + freqs_b[:, i, None] * m_root[:, k, i]
        dprops[:, k] = torch.sum(row * w_over_site, dim=1)

    rows = torch.arange(B, device=tips.device)
    dP = P.new_zeros((B, N1, K, 4, 4))

    def emit(kid, u, ek, denom):
        uw = u * (weights / torch.clamp_min(denom, TINY))[:, None, None, :]
        dP[rows, kid] = uw @ M[rows, kid].transpose(-1, -2)

    _upper_plain(post_children, P, freqs_b, props_b, E, root_id,
                 tips.shape[0], emit)
    dP[:, root_id] = 0.0
    dP[:, N1 - 1] = 0.0
    return dP, dfreqs, dprops


# -- CUDA kernels (csrc/pruning_generic.cu) ------------------------------------


def ll_generic_cuda(post_children, P, tips, freqs, props, weights, *, root_id):
    """K5 on the card: (B,) log likelihoods."""
    dims, (freqs, fs), (props, ps) = check_inputs(
        post_children, P, tips, weights, freqs, props, root_id)
    B, L, S, N1, K, n_pat = dims
    dt, dev = tips.dtype, tips.device
    lib = load_checked(K)
    tiles = -(-n_pat // lib.lsbn_generic_tile())
    E = torch.empty((B, N1, 4 * K, n_pat), dtype=dt, device=dev)
    ll_part = torch.empty((B, tiles), dtype=dt, device=dev)
    fn = lib.lsbn_generic_ll_f32 if dt == torch.float32 else lib.lsbn_generic_ll_f64
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), P.data_ptr(), tips.data_ptr(),
            freqs.data_ptr(), props.data_ptr(), weights.data_ptr(),
            E.data_ptr(), ll_part.data_ptr(), fs, ps, *dims,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "generic LL kernel")
    LAUNCHES["ll_generic"] += 1
    return ll_part.sum(dim=1)


def ll_dp_generic_cuda(post_children, P, tips, freqs, props, weights, *,
                       root_id):
    """K6 on the card: (dP (B, N1, K, 4, 4), dfreqs (B, 4), dprops (B, K))."""
    dims, (freqs, fs), (props, ps) = check_inputs(
        post_children, P, tips, weights, freqs, props, root_id)
    B, L, S, N1, K, n_pat = dims
    dt, dev = tips.dtype, tips.device
    lib = load_checked(K)
    tiles = -(-n_pat // lib.lsbn_generic_tile())
    E = torch.empty((B, N1, 4 * K, n_pat), dtype=dt, device=dev)
    U = torch.empty_like(E)
    M = torch.empty((B, S, 4 * K, n_pat), dtype=dt, device=dev)
    dp_part = torch.empty((B, tiles, N1 * K * 16), dtype=dt, device=dev)
    root_part = torch.empty((B, tiles, 4 + K), dtype=dt, device=dev)
    fn = lib.lsbn_generic_dp_f32 if dt == torch.float32 else lib.lsbn_generic_dp_f64
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), P.data_ptr(), tips.data_ptr(),
            freqs.data_ptr(), props.data_ptr(), weights.data_ptr(),
            E.data_ptr(), M.data_ptr(), U.data_ptr(), dp_part.data_ptr(),
            root_part.data_ptr(), fs, ps, *dims,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "generic dP kernel")
    LAUNCHES["ll_dp_generic"] += 1
    root = root_part.sum(dim=1)
    return (dp_part.sum(dim=1).reshape(B, N1, K, 4, 4), root[:, :4],
            root[:, 4:])
