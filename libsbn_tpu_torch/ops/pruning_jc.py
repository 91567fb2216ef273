"""JC69 pruning: log likelihoods and the linear-time branch gradient.

The counterpart of libsbn_tpu/ops/pruning_pallas_jc.py. Under JC69 the
transition matrix has the closed form P(t) = e I + (1 - e)/4 J with
e = exp(-4t/3), so pruning needs no 4x4 matrices: P v = e v + (1 - e)/4
sum(v), P^T = P, column sums are conserved (the row sums S_E of the
evolved partials equal the pre-apply sums), and the edge derivative needs
only row sums and the u.E product:
    num_k = r_k [ (1/3) S_u,k S_E,k - (4/3) d_k ],  d_k = u_k . E_k.

Three kernels, each with a plain PyTorch twin of the same layout, rescaling
and order of operations:
  * K1 ``ll_grad_jc69_cuda`` / ``ll_grad_jc69_plain``: LL + branch gradient
    (replaces pruning_pallas_jc.py::_kernel);
  * K2 ``ll_jc69_cuda`` / ``ll_jc69_plain``: LL only (replaces
    pruning_pallas_jc.py::_fwd_ll_kernel);
  * K3 ``ll_dea_jc69_cuda`` / ``ll_dea_jc69_plain``: d ll / d e per (node,
    category) and d ll / d props (replaces
    pruning_pallas_jc.py::_bwd_dea_kernel). With P = eI + (1-e)/4 J,
        d ll / d e_{n,k} = sum_p [ (uw . M)_k - (1/4) rowsum4(uw)_k S_E,k ],
    uw = u w / denom, M the pre-apply partials at E's scale.
K2 and K3 are the two halves of one ``torch.autograd.Function``
(``log_likelihoods_jc69``), so branch-length, rate and Weibull-shape
gradients chain through ``exp_factors`` by autograd, as the JAX package's
custom VJP ``_ll_jc`` does.
The public functions take branch lengths, build the exp factors in f64
(``exp_factors``), and route by device: a CPU tensor goes to the twin, a
CUDA tensor to the kernel (csrc/pruning_jc.cu), which raises on anything it
cannot take. Nothing falls back.

The CUDA kernels mask the ragged pattern edge themselves, so patterns are
not padded (the TPU kernels' pad_patterns is a lane rule of that chip).
Preconditions the kernels do not check on the device (``check_schedule``
checks them on the host): internal node ids are postorder-linear (step s
writes node L + s) and every child id lies in [0, N1).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

# Launch counts of the CUDA kernels and call counts of their twins, so a run
# can show which one it took. reset_counters() sets them all to 0.
LAUNCHES = {"ll_grad_jc69": 0, "ll_jc69": 0, "ll_dea_jc69": 0}
TWIN_CALLS = {"ll_grad_jc69": 0, "ll_jc69": 0, "ll_dea_jc69": 0}


def reset_counters():
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def check_schedule(post_node, post_children, leaf_count, root_id):
    """Check on the host what the kernels assume of a (B, S) schedule and
    do not check on the device: step s combines into node leaf_count + s,
    and every child id is a node or the ones slot. Raises ValueError."""
    post_node = np.asarray(post_node)
    pc = np.asarray(post_children)
    if not np.array_equal(
        post_node,
        np.broadcast_to(np.arange(leaf_count, root_id + 1), post_node.shape),
    ):
        raise ValueError("internal node ids must be postorder-linear")
    if pc.min() < 0 or pc.max() > root_id + 1:
        raise ValueError("child ids out of range of the schedule")


def exp_factors(bl_padded, rates, dtype):
    """e = exp(-4 b r / 3) per (tree, node, category), the exp in f64 (the
    BASELINE.md precision policy), then cast to ``dtype``; differentiable.
    bl_padded: (B, N1); rates: (K,), or (B, K) per tree. Returns
    (B, N1, K)."""
    r = rates.to(torch.float64)
    if r.dim() == 2:
        r = r[:, None, :]
    t = bl_padded.to(torch.float64)[:, :, None] * r
    return torch.exp(-4.0 / 3.0 * t).to(dtype)


def _default_rates_props(rates, props, like):
    if rates is None:
        rates = torch.ones((1,), dtype=like.dtype, device=like.device)
    if props is None:
        K = rates.shape[-1]
        props = torch.full((K,), 1.0 / K, dtype=like.dtype, device=like.device)
    return rates.to(like.dtype), props.to(like.dtype)


def log_likelihood_and_branch_gradient_jc69(
    post_children, bl_padded, tips, weights, *, root_id, rates=None,
    props=None,
):
    """JC69 LLs and branch gradients from branch lengths (K1).

    post_children: (B, S, 3) int32; bl_padded: (B, N + 1) with the ones-slot
    zero appended (root slot 0 for unrooted trees); tips: (L, 4, P);
    weights: (P,); rates/props: (K,) category rates and proportions
    (default: one category). All on one device, in the working dtype of
    ``tips``. Returns (ll (B,), grad (B, root_id))."""
    rates, props = _default_rates_props(rates, props, tips)
    ea = exp_factors(bl_padded, rates, tips.dtype)
    if tips.device.type == "cpu":
        fn = ll_grad_jc69_plain
    else:
        fn = ll_grad_jc69_cuda
    ll, grad = fn(post_children, ea, rates, props, tips, weights,
                  root_id=root_id)
    return ll, grad[:, :root_id]


class _LogLikelihoodsJC69(torch.autograd.Function):
    """(B,) LLs from the exp factors ea (B, N1, K) and props (K,): K2
    forward, K3 backward (their twins for CPU tensors). Like the JAX custom
    VJP ``_ll_jc``, it saves only its inputs, never E or M: the backward
    recomputes the forward pass."""

    @staticmethod
    def forward(ctx, ea, props, post_children, tips, weights, root_id):
        ctx.save_for_backward(ea, props, post_children, tips, weights)
        ctx.root_id = root_id
        fn = ll_jc69_plain if tips.device.type == "cpu" else ll_jc69_cuda
        return fn(post_children, ea, props, tips, weights, root_id=root_id)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ea, props, post_children, tips, weights = ctx.saved_tensors
        fn = ll_dea_jc69_plain if tips.device.type == "cpu" else ll_dea_jc69_cuda
        dea, dprops = fn(post_children, ea, props, tips, weights,
                         root_id=ctx.root_id)
        return (dea * g[:, None, None], (dprops * g[:, None]).sum(dim=0),
                None, None, None, None)


def log_likelihoods_jc69(
    post_children, bl_padded, tips, weights, *, root_id, rates=None,
    props=None,
):
    """(B,) JC69 log likelihoods from branch lengths (K2), differentiable in
    bl_padded, rates and props by autograd through ``exp_factors`` and the
    K3 backward. Arguments as in log_likelihood_and_branch_gradient_jc69,
    except that rates may also be (B, K), one row per tree."""
    rates, props = _default_rates_props(rates, props, tips)
    ea = exp_factors(bl_padded, rates, tips.dtype)
    return _LogLikelihoodsJC69.apply(ea, props, post_children, tips, weights,
                                     root_id)


# -- plain PyTorch twins ------------------------------------------------------
# E: (B, N1, K, 4, P), the kernel's (B, N1, 4K, P) layout; ES: (B, N1, K, P).


def _apply(e, slab, rsums):
    """P_node(slab) per category: e (B, K), slab (B, K, 4, P), rsums
    (B, K, P) -> e slab + ((1 - e)/4) rowsum."""
    c = (1.0 - e) * 0.25
    return e[:, :, None, None] * slab + c[:, :, None, None] * rsums[:, :, None, :]


def _forward_plain(post_children, ea, tips, root_id, keep_m=False):
    """Forward pass: ones slot, leaves, then the combine steps with
    row-sum rescaling on odd steps and the last one. Returns (E, ES,
    logscale (B, P), M): M (B, N1, K, 4, P) holds the pre-apply partials at
    E's scale when keep_m (the tip partial for a leaf, ones for the ones
    slot), else None."""
    B, S, _ = post_children.shape
    L, _, P = tips.shape
    K = ea.shape[2]
    N1 = root_id + 2
    dt, dev = tips.dtype, tips.device
    pc = post_children.long()
    rows = torch.arange(B, device=dev)
    E = torch.empty((B, N1, K, 4, P), dtype=dt, device=dev)
    ES = torch.empty((B, N1, K, P), dtype=dt, device=dev)
    M = torch.empty_like(E) if keep_m else None
    E[:, N1 - 1] = 1.0
    ES[:, N1 - 1] = 4.0
    rt = ((tips[:, 0] + tips[:, 1]) + tips[:, 2]) + tips[:, 3]  # (L, P)
    for leaf in range(L):
        slab = tips[leaf].expand(B, K, 4, P)
        rs = rt[leaf].expand(B, K, P)
        E[:, leaf] = _apply(ea[:, leaf], slab, rs)
        ES[:, leaf] = rs
    if keep_m:
        M[:, :L] = tips[None, :, None]
        M[:, N1 - 1] = 1.0
    logscale = torch.zeros((B, P), dtype=dt, device=dev)
    for s in range(S):
        node = L + s
        c = pc[:, s]
        prod = (E[rows, c[:, 0]] * E[rows, c[:, 1]]) * E[rows, c[:, 2]]
        rs = ((prod[:, :, 0] + prod[:, :, 1]) + prod[:, :, 2]) + prod[:, :, 3]
        out = _apply(ea[:, node], prod, rs)
        if s % 2 == 1 or s == S - 1:
            scale = rs[:, 0]
            for k in range(1, K):
                scale = scale + rs[:, k]
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            inv = 1.0 / scale
            out = out * inv[:, None, None, :]
            if keep_m:
                prod = prod * inv[:, None, None, :]
            rs = rs * inv[:, None, :]
            logscale = logscale + torch.log(scale)
        E[:, node] = out
        ES[:, node] = rs
        if keep_m:
            M[:, node] = prod
    return E, ES, logscale, M


def _root_site_plain(ES, props, root_id):
    """(B, P) scaled site likelihoods (1/4) sum_k props_k S_E,k[root],
    clamped at 1e-30."""
    es_root = ES[:, root_id]  # (B, K, P)
    site = (props[0] * 0.25) * es_root[:, 0]
    for k in range(1, props.shape[0]):
        site = site + (props[k] * 0.25) * es_root[:, k]
    return torch.clamp_min(site, 1e-30)


def _ll_plain(ES, props, weights, logscale, root_id):
    """(B,) LL: sum_p w_p (log((1/4) sum_k props_k S_E,k[root]) + logscale)."""
    site = _root_site_plain(ES, props, root_id)
    return torch.sum(weights * (torch.log(site) + logscale), dim=1)


def _rowsum4(x):
    """(B, K, 4, P) -> (B, K, P), summed left to right."""
    return ((x[:, :, 0] + x[:, :, 1]) + x[:, :, 2]) + x[:, :, 3]


def _upper_plain(post_children, ea, props, E, weights, root_id, L, emit):
    """The upper pass shared by the K1 and K3 twins: U[root] = props / 4,
    then, from the root down, U[node] evolved up through its edge, each
    child's upper partial u from it and the siblings' E, and U[kid] = u
    over its own row sum. For every child edge it calls
    ``emit(kid, u, d, winv)`` with kid (B,) child ids, u (B, K, 4, P), d
    (B, K, P) the per-category denominators and winv (B, P) = w / denom."""
    B, S, _ = post_children.shape
    K = ea.shape[2]
    dev = E.device
    pc = post_children.long()
    rows = torch.arange(B, device=dev)
    U = torch.empty_like(E)
    U[:, root_id] = (props * 0.25)[None, :, None, None]
    for t in range(S):
        node = root_id - t
        c = pc[:, node - L]
        un = U[:, node]  # (B, K, 4, P)
        e = ea[:, node]
        if K == 1:
            # U rows sum to exactly 1 here: the row-sum operand is 1.
            ev = e[:, :, None, None] * un + ((1.0 - e) * 0.25)[:, :, None, None]
        else:
            ev = _apply(e, un, _rowsum4(un))
        e0, e1, e2 = E[rows, c[:, 0]], E[rows, c[:, 1]], E[rows, c[:, 2]]
        m01, m02, m12 = e0 * e1, e0 * e2, e1 * e2
        d = _rowsum4(ev * (m01 * e2))  # (B, K, P)
        denom = d[:, 0]
        for k in range(1, K):
            denom = denom + d[:, k]
        winv = weights / torch.clamp_min(denom, 1e-30)
        for j, mab in ((0, m12), (1, m02), (2, m01)):
            kid = c[:, j]
            u = ev * mab
            emit(kid, u, d, winv)
            su_k = _rowsum4(u)
            su = su_k[:, 0]
            for k in range(1, K):
                su = su + su_k[:, k]
            sc = torch.where(su > 0, su, torch.ones_like(su))
            U[rows, kid] = u / sc[:, None, None, :]


def ll_jc69_plain(post_children, ea, props, tips, weights, *, root_id):
    """Plain PyTorch twin of K2. ea: (B, N1, K). Returns ll (B,)."""
    TWIN_CALLS["ll_jc69"] += 1
    _, ES, logscale, _ = _forward_plain(post_children, ea, tips, root_id)
    return _ll_plain(ES, props, weights, logscale, root_id)


def ll_grad_jc69_plain(post_children, ea, rates, props, tips, weights, *,
                       root_id):
    """Plain PyTorch twin of K1. ea: (B, N1, K). Returns (ll (B,),
    grad (B, N1)); grad[:, :root_id] are the edge derivatives, the root and
    ones-slot entries are zero."""
    TWIN_CALLS["ll_grad_jc69"] += 1
    E, ES, logscale, _ = _forward_plain(post_children, ea, tips, root_id)
    ll = _ll_plain(ES, props, weights, logscale, root_id)
    B = post_children.shape[0]
    K = rates.shape[0]
    N1 = root_id + 2
    rows = torch.arange(B, device=tips.device)
    third = 1.0 / 3.0
    four_thirds = 4.0 / 3.0
    G = torch.zeros((B, N1, weights.shape[0]), dtype=tips.dtype,
                    device=tips.device)

    def emit(kid, u, d, winv):
        su_k = _rowsum4(u)
        se = ES[rows, kid]
        num = rates[0] * (third * (su_k[:, 0] * se[:, 0]) - four_thirds * d[:, 0])
        for k in range(1, K):
            num = num + rates[k] * (
                third * (su_k[:, k] * se[:, k]) - four_thirds * d[:, k]
            )
        G[rows, kid] = winv * num

    _upper_plain(post_children, ea, props, E, weights, root_id, tips.shape[0],
                 emit)
    G[:, N1 - 1] = 0.0
    return ll, G.sum(dim=2)


def ll_dea_jc69_plain(post_children, ea, props, tips, weights, *, root_id):
    """Plain PyTorch twin of K3. ea: (B, N1, K). Returns (dea (B, N1, K)
    = d ll / d ea, dprops (B, K) = d ll / d props), per tree; the root and
    ones-slot rows of dea are zero."""
    TWIN_CALLS["ll_dea_jc69"] += 1
    E, ES, _, M = _forward_plain(post_children, ea, tips, root_id, keep_m=True)
    B, N1, K = ea.shape
    rows = torch.arange(B, device=tips.device)
    # dprops_k = sum_p (w / site) (1/4) S_E,k[root].
    w_over_site = weights / _root_site_plain(ES, props, root_id)
    dprops = torch.sum((0.25 * ES[:, root_id]) * w_over_site[:, None, :], dim=2)
    dea = torch.zeros((B, N1, K), dtype=tips.dtype, device=tips.device)

    def emit(kid, u, d, winv):
        uw = u * winv[:, None, None, :]
        val = _rowsum4(uw * M[rows, kid]) - 0.25 * (_rowsum4(uw) * ES[rows, kid])
        dea[rows, kid] = val.sum(dim=2)

    _upper_plain(post_children, ea, props, E, weights, root_id, tips.shape[0],
                 emit)
    dea[:, root_id] = 0.0
    dea[:, N1 - 1] = 0.0
    return dea, dprops


# -- CUDA kernels (csrc/pruning_jc.cu) -----------------------------------------


def _check_inputs(post_children, ea, tips, weights, cats, root_id):
    """Device, dtype, shape and contiguity checks shared by K1, K2 and K3.
    Returns (B, L, S, N1, K, P)."""
    dev = tips.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    dt = tips.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"working dtype must be float32 or float64, got {dt}")
    if post_children.dtype != torch.int32:
        raise TypeError("post_children must be int32")
    for name, x in [("post_children", post_children), ("ea", ea),
                    ("tips", tips), ("weights", weights)] + cats:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tips on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "post_children" and x.dtype != dt:
            raise TypeError(f"{name} is {x.dtype}, tips are {dt}")
    if post_children.dim() != 3 or post_children.shape[2] != 3:
        raise ValueError("post_children must be (B, S, 3)")
    B, S, _ = post_children.shape
    if tips.dim() != 3 or tips.shape[1] != 4:
        raise ValueError("tips must be (L, 4, P)")
    L, _, P = tips.shape
    N1 = root_id + 2
    if root_id != L + S - 1:
        raise ValueError(f"root_id {root_id} != L + S - 1 = {L + S - 1}")
    K = cats[0][1].shape[0]
    if ea.shape != (B, N1, K):
        raise ValueError(f"ea must be {(B, N1, K)}, got {tuple(ea.shape)}")
    if weights.shape != (P,):
        raise ValueError(f"weights must be ({P},), got {tuple(weights.shape)}")
    for name, x in cats:
        if x.shape != (K,):
            raise ValueError(f"{name} must be ({K},), got {tuple(x.shape)}")
    if not 1 <= B <= 65535 or P < 1:
        raise ValueError(f"need 1 <= B <= 65535 trees and P >= 1, got {B}, {P}")
    return B, L, S, N1, K, P


def _check_k(lib, K):
    if K > lib.lsbn_jc69_max_k():
        raise ValueError(
            f"K = {K} rate categories; the kernels are built for at most "
            f"{lib.lsbn_jc69_max_k()}"
        )


def ll_jc69_cuda(post_children, ea, props, tips, weights, *, root_id):
    """K2 on the card: (B,) log likelihoods. ea: (B, N1, K)."""
    dims = _check_inputs(post_children, ea, tips, weights, [("props", props)],
                         root_id)
    B, L, S, N1, K, P = dims
    dt, dev = tips.dtype, tips.device
    lib = _kernels.load("pruning_jc")
    _check_k(lib, K)
    tiles = -(-P // lib.lsbn_jc69_tile())
    E = torch.empty((B, N1, 4 * K, P), dtype=dt, device=dev)
    ES = torch.empty((B, N1, K, P), dtype=dt, device=dev)
    ll_part = torch.empty((B, tiles), dtype=dt, device=dev)
    fn = lib.lsbn_jc69_ll_f32 if dt == torch.float32 else lib.lsbn_jc69_ll_f64
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), ea.data_ptr(), props.data_ptr(),
            tips.data_ptr(), weights.data_ptr(), E.data_ptr(), ES.data_ptr(),
            ll_part.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "jc69 LL kernel")
    LAUNCHES["ll_jc69"] += 1
    return ll_part.sum(dim=1)


def ll_grad_jc69_cuda(post_children, ea, rates, props, tips, weights, *,
                      root_id):
    """K1 on the card: (ll (B,), grad (B, N1)). ea: (B, N1, K)."""
    dims = _check_inputs(post_children, ea, tips, weights,
                         [("rates", rates), ("props", props)], root_id)
    B, L, S, N1, K, P = dims
    dt, dev = tips.dtype, tips.device
    lib = _kernels.load("pruning_jc")
    _check_k(lib, K)
    tiles = -(-P // lib.lsbn_jc69_tile())
    E = torch.empty((B, N1, 4 * K, P), dtype=dt, device=dev)
    ES = torch.empty((B, N1, K, P), dtype=dt, device=dev)
    U = torch.empty_like(E)
    ll_part = torch.empty((B, tiles), dtype=dt, device=dev)
    grad_part = torch.empty((B, tiles, N1), dtype=dt, device=dev)
    fn = (lib.lsbn_jc69_ll_grad_f32 if dt == torch.float32
          else lib.lsbn_jc69_ll_grad_f64)
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), ea.data_ptr(), rates.data_ptr(),
            props.data_ptr(), tips.data_ptr(), weights.data_ptr(),
            E.data_ptr(), ES.data_ptr(), U.data_ptr(), ll_part.data_ptr(),
            grad_part.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "jc69 LL + gradient kernel")
    LAUNCHES["ll_grad_jc69"] += 1
    return ll_part.sum(dim=1), grad_part.sum(dim=1)


def ll_dea_jc69_cuda(post_children, ea, props, tips, weights, *, root_id):
    """K3 on the card: (dea (B, N1, K), dprops (B, K)). ea: (B, N1, K)."""
    dims = _check_inputs(post_children, ea, tips, weights, [("props", props)],
                         root_id)
    B, L, S, N1, K, P = dims
    dt, dev = tips.dtype, tips.device
    lib = _kernels.load("pruning_jc")
    _check_k(lib, K)
    tiles = -(-P // lib.lsbn_jc69_tile())
    E = torch.empty((B, N1, 4 * K, P), dtype=dt, device=dev)
    ES = torch.empty((B, N1, K, P), dtype=dt, device=dev)
    M = torch.empty((B, S, 4 * K, P), dtype=dt, device=dev)
    U = torch.empty_like(E)
    dprops_part = torch.empty((B, tiles, K), dtype=dt, device=dev)
    dea_part = torch.empty((B, tiles, N1 * K), dtype=dt, device=dev)
    fn = lib.lsbn_jc69_dea_f32 if dt == torch.float32 else lib.lsbn_jc69_dea_f64
    with torch.cuda.device(dev):
        rc = fn(
            post_children.data_ptr(), ea.data_ptr(), props.data_ptr(),
            tips.data_ptr(), weights.data_ptr(), E.data_ptr(), ES.data_ptr(),
            M.data_ptr(), U.data_ptr(), dprops_part.data_ptr(),
            dea_part.data_ptr(), *dims, torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "jc69 d ll / d ea kernel")
    LAUNCHES["ll_dea_jc69"] += 1
    return dea_part.sum(dim=1).reshape(B, N1, K), dprops_part.sum(dim=1)
