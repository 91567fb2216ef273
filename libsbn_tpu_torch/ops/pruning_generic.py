"""Generic 4-state pruning: the fused LL + linear-time branch gradient (K4).

The counterpart of libsbn_tpu/ops/pruning_pallas.py. Any substitution model
enters through explicit per-(node, category) transition matrices P, the
stationary freqs, the category props and the rate-scaled rate matrices
Q_k = r_k Q (dP/db M = Q_k E), so GTR, and JC69 written out, take the same
route. The E form: the buffer holds evolved partials E[n] = P_n M_n, a
combine step multiplies three child slabs, divides by the per-pattern max
over all 4K rows and applies the node's matrices; the upper pass folds the
props into U[root] = props_k freqs_i and forms each child edge's gradient
row w (U . Q_k E) / (U . E).

K4 ``ll_grad_generic_cuda`` (csrc/pruning_generic.cu) replaces
pruning_pallas.py::_kernel; ``ll_grad_generic_plain`` is its plain PyTorch
twin, with the same layout, rescaling and order of operations. The twin
helpers here (``_forward_plain``, ``_upper_plain``) also serve the K5 and K6
twins in ops/pruning_vjp.py. A CPU tensor goes to the twin, a CUDA tensor
to the kernel, which raises on anything it cannot take; nothing falls back.
The kernel masks the ragged pattern tile, so patterns are not padded, and
assumes what ``pruning_jc.check_schedule`` checks on the host.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pruning import per_tree

# Launch counts of the CUDA kernel and call counts of its twin, so a run can
# show which one it took. reset_counters() sets them to 0.
LAUNCHES = {"ll_grad_generic": 0}
TWIN_CALLS = {"ll_grad_generic": 0}

TINY = 1e-30


def reset_counters():
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def log_likelihood_and_branch_gradient_generic(
    post_children, P, Q_scaled, tips, freqs, props, weights, *, root_id,
):
    """LLs and branch gradients from explicit transition matrices (K4).

    post_children: (B, S, 3) int32; P: (B, N1, K, 4, 4) with
    N1 = root_id + 2 (the root's and the ones slot's matrices are never
    consulted for the result); Q_scaled: (K, 4, 4) = r_k Q; tips: (L, 4, P);
    freqs: (4,); props: (K,); weights: (P,); all on one device in one
    working dtype. Returns (ll (B,), grad (B, root_id))."""
    fn = ll_grad_generic_plain if tips.device.type == "cpu" else ll_grad_generic_cuda
    ll, grad = fn(post_children, P, Q_scaled, tips, freqs, props, weights,
                  root_id=root_id)
    return ll, grad[:, :root_id]


# -- plain PyTorch twins ------------------------------------------------------
# E, U, M: (B, N1, K, 4, P), the kernels' (B, N1, 4K, P) layout.


def _apply(m, v):
    """m v per 4x4 block in the kernels' order,
    out_i = (m_i0 v_0 + m_i1 v_1) + (m_i2 v_2 + m_i3 v_3);
    m: (..., 4, 4), v: (..., 4, P) -> (..., 4, P)."""
    t = m[..., :, :, None] * v[..., None, :, :]  # (..., i, j, P)
    return (t[..., 0, :] + t[..., 1, :]) + (t[..., 2, :] + t[..., 3, :])


def _rowsum(x):
    """(B, K, 4, P) -> (B, P): the 4K rows summed left to right."""
    rows = x.reshape(x.shape[0], -1, x.shape[-1])
    acc = rows[:, 0]
    for r in range(1, rows.shape[1]):
        acc = acc + rows[:, r]
    return acc


def _rowmax(x):
    """(B, ..., K, 4, P) -> (B, ..., P): the per-pattern max over the 4K
    rows, 1 where it is not positive."""
    scale = torch.amax(x, dim=(-3, -2))
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _root_coeffs(freqs_b, props_b):
    """(B, K, 4): props_k freqs_i, the root's upper partial."""
    return props_b[:, :, None] * freqs_b[:, None, :]


def _site(X, freqs_b, props_b):
    """(B, P) scaled site likelihoods sum_k sum_i props_k freqs_i X_ki,
    summed in that order from 0 and clamped at 1e-30. X: (B, K, 4, P)."""
    c = _root_coeffs(freqs_b, props_b)
    site = torch.zeros_like(X[:, 0, 0])
    for k in range(X.shape[1]):
        for i in range(4):
            site = site + c[:, k, i, None] * X[:, k, i]
    return torch.clamp_min(site, TINY)


def _forward_plain(post_children, P, tips, root_id, keep_m=False):
    """The E-form forward pass: ones slot, leaves E[l] = P_l tip, then the
    combine steps with max rescaling before the apply. Returns (E, logscale
    (B, P), M): M holds the rescaled node partials (the tip partial for a
    leaf, ones for the ones slot) when keep_m, else None."""
    B, S, _ = post_children.shape
    L, _, n_pat = tips.shape
    K = P.shape[2]
    N1 = root_id + 2
    pc = post_children.long()
    rows = torch.arange(B, device=tips.device)
    E = P.new_empty((B, N1, K, 4, n_pat))
    E[:, N1 - 1] = 1.0
    E[:, :L] = _apply(P[:, :L], tips[None, :, None])
    M = None
    if keep_m:
        M = torch.empty_like(E)
        M[:, :L] = tips[None, :, None]
        M[:, N1 - 1] = 1.0
    logscale = P.new_zeros((B, n_pat))
    for s in range(S):
        c = pc[:, s]
        prod = (E[rows, c[:, 0]] * E[rows, c[:, 1]]) * E[rows, c[:, 2]]
        scale = _rowmax(prod)
        prod = prod / scale[:, None, None, :]
        node = L + s
        E[:, node] = _apply(P[:, node], prod)
        logscale = logscale + torch.log(scale)
        if keep_m:
            M[:, node] = prod
    return E, logscale, M


def _ll_plain(X_root, freqs_b, props_b, weights, logscale):
    """(B,) LL: sum_p w_p (log site_p + logscale_p)."""
    site = _site(X_root, freqs_b, props_b)
    return torch.sum(weights * (torch.log(site) + logscale), dim=1)


def _upper_plain(post_children, P, freqs_b, props_b, E, root_id, L, emit):
    """The upper pass shared by the K4 and K6 twins: U[root] = props_k
    freqs_i; from the root down, ev = P_node^T U[node], each child's upper
    partial u = (ev * a) * b from its siblings' E, and U[kid] = u over its
    own max. For every child edge it calls ``emit(kid, u, ek, denom)`` with
    kid (B,) child ids, u and ek (the child's E) (B, K, 4, P), and denom
    (B, P) = sum_r u_r ek_r."""
    B, S, _ = post_children.shape
    pc = post_children.long()
    rows = torch.arange(B, device=E.device)
    U = torch.empty_like(E)
    U[:, root_id] = _root_coeffs(freqs_b, props_b)[..., None]
    for t in range(S):
        node = root_id - t
        c = pc[:, node - L]
        ev = _apply(P[:, node].transpose(-1, -2), U[:, node])
        e0, e1, e2 = E[rows, c[:, 0]], E[rows, c[:, 1]], E[rows, c[:, 2]]
        for j, (a, b, ek) in enumerate(((e1, e2, e0), (e0, e2, e1),
                                        (e0, e1, e2))):
            u = (ev * a) * b
            emit(c[:, j], u, ek, _rowsum(u * ek))
            U[rows, c[:, j]] = u / _rowmax(u)[:, None, None, :]


def ll_grad_generic_plain(post_children, P, Q_scaled, tips, freqs, props,
                          weights, *, root_id):
    """Plain PyTorch twin of K4. Returns (ll (B,), grad (B, N1));
    grad[:, :root_id] are the edge derivatives, the root and ones-slot
    entries are zero."""
    TWIN_CALLS["ll_grad_generic"] += 1
    B = post_children.shape[0]
    N1 = root_id + 2
    freqs_b, props_b = per_tree(freqs, B), per_tree(props, B)
    E, logscale, _ = _forward_plain(post_children, P, tips, root_id)
    ll = _ll_plain(E[:, root_id], freqs_b, props_b, weights, logscale)
    rows = torch.arange(B, device=tips.device)
    Q = Q_scaled.expand((B,) + Q_scaled.shape)
    G = P.new_zeros((B, N1, weights.shape[0]))

    def emit(kid, u, ek, denom):
        num = _rowsum(u * _apply(Q, ek))
        G[rows, kid] = weights * num / torch.clamp_min(denom, TINY)

    _upper_plain(post_children, P, freqs_b, props_b, E, root_id,
                 tips.shape[0], emit)
    G[:, root_id] = 0.0
    G[:, N1 - 1] = 0.0
    return ll, G.sum(dim=2)


# -- CUDA kernel (csrc/pruning_generic.cu) -------------------------------------


def tree_rows(x, B, name):
    """A (n,) or (B, n) per-tree parameter as the kernels take it: a
    contiguous tensor and its tree stride (0 when shared)."""
    if x.dim() == 2 and x.shape[0] == B and x.stride(0) == 0:
        x = x[0]
    if x.dim() == 1:
        return x, 0
    if x.dim() != 2 or x.shape[0] != B:
        raise ValueError(f"{name} must be (n,) or ({B}, n), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x, x.shape[1]


def check_inputs(post_children, P, tips, weights, freqs, props, root_id,
                 Q=None):
    """Device, dtype, shape and contiguity checks shared by K4, K5 and K6.
    Returns ((B, L, S, N1, K, P), (freqs, fs), (props, ps)): freqs and props
    as ``tree_rows`` gives them."""
    dev = tips.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    dt = tips.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"working dtype must be float32 or float64, got {dt}")
    if post_children.dtype != torch.int32:
        raise TypeError("post_children must be int32")
    if post_children.dim() != 3 or post_children.shape[2] != 3:
        raise ValueError("post_children must be (B, S, 3)")
    B, S, _ = post_children.shape
    if tips.dim() != 3 or tips.shape[1] != 4:
        raise ValueError("tips must be (L, 4, P)")
    L, _, n_pat = tips.shape
    N1 = root_id + 2
    if root_id != L + S - 1:
        raise ValueError(f"root_id {root_id} != L + S - 1 = {L + S - 1}")
    if P.dim() != 5 or P.shape[:2] != (B, N1) or P.shape[3:] != (4, 4):
        raise ValueError(f"P must be ({B}, {N1}, K, 4, 4), got {tuple(P.shape)}")
    K = P.shape[2]
    freqs, fs = tree_rows(freqs, B, "freqs")
    props, ps = tree_rows(props, B, "props")
    tensors = [("post_children", post_children), ("P", P), ("tips", tips),
               ("weights", weights), ("freqs", freqs), ("props", props)]
    if Q is not None:
        tensors.append(("Q", Q))
        if Q.shape != (K, 4, 4):
            raise ValueError(f"Q must be ({K}, 4, 4), got {tuple(Q.shape)}")
    for name, x in tensors:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tips on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "post_children" and x.dtype != dt:
            raise TypeError(f"{name} is {x.dtype}, tips are {dt}")
    if weights.shape != (n_pat,):
        raise ValueError(f"weights must be ({n_pat},), got {tuple(weights.shape)}")
    if freqs.shape[-1] != 4 or props.shape[-1] != K:
        raise ValueError(f"freqs must end in 4 and props in K = {K}")
    if not 1 <= B <= 65535 or n_pat < 1:
        raise ValueError(f"need 1 <= B <= 65535 trees and P >= 1, got {B}, {n_pat}")
    return (B, L, S, N1, K, n_pat), (freqs, fs), (props, ps)


def load_checked(K):
    """The generic kernels' library, after checking K against its build."""
    lib = _kernels.load("pruning_generic")
    if K > lib.lsbn_generic_max_k():
        raise ValueError(
            f"K = {K} rate categories; the kernels are built for at most "
            f"{lib.lsbn_generic_max_k()}"
        )
    return lib


def ll_grad_generic_cuda(post_children, P, Q_scaled, tips, freqs, props,
                         weights, *, root_id):
    """K4 on the card: (ll (B,), grad (B, N1)). freqs (4,) and props (K,)
    are shared by all trees."""
    dims, (freqs, fs), (props, ps) = check_inputs(
        post_children, P, tips, weights, freqs, props, root_id, Q=Q_scaled)
    if fs or ps:
        raise ValueError("K4 takes freqs (4,) and props (K,) shared by all trees")
    B, L, S, N1, K, n_pat = dims
    dt, dev = tips.dtype, tips.device
    lib = load_checked(K)
    tiles = -(-n_pat // lib.lsbn_generic_tile())
    E = torch.empty((B, N1, 4 * K, n_pat), dtype=dt, device=dev)
    U = torch.empty_like(E)
    ll_part = torch.empty((B, tiles), dtype=dt, device=dev)
    grad_part = torch.empty((B, tiles, N1), dtype=dt, device=dev)
    fn = (lib.lsbn_generic_ll_grad_f32 if dt == torch.float32
          else lib.lsbn_generic_ll_grad_f64)
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), P.data_ptr(), Q_scaled.data_ptr(),
            tips.data_ptr(), freqs.data_ptr(), props.data_ptr(),
            weights.data_ptr(), E.data_ptr(), U.data_ptr(), ll_part.data_ptr(),
            grad_part.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "generic LL + gradient kernel")
    LAUNCHES["ll_grad_generic"] += 1
    return ll_part.sum(dim=1), grad_part.sum(dim=1)
