"""Felsenstein pruning over dense schedules: the portable scan engine.

The counterpart of libsbn_tpu/ops/pruning.py, batched over a leading tree
axis B (where the JAX package vmaps over trees) and written as plain torch
ops, so it runs on any device:

  * the postorder pass walks the schedule's combine steps, keeping node
    partials M (B, N1, K, 4, P) and, afterwards, the evolved partials
    E = P M;
  * the preorder pass computes upper partials U one internal node at a
    time, emitting all three children of a node per step;
  * the log likelihood is a ``torch.autograd.Function`` whose backward is
    the JAX package's custom VJP ``_ll_bwd`` (the linear-time scheme), so
    gradients in P, tips, freqs, props and weights are exact;
  * ``log_likelihood_and_branch_gradient`` fuses the branch gradient with
    dP/db M = (r_k Q) E.

Rescaling (optional): after each combine the partial is divided by its
per-pattern max over categories and states and the log accumulates; the
backward quantities are ratios in which the scales cancel. This engine is
what ``rescale=False`` runs, and the port's f64 oracle for the kernels.

Shapes: B trees, S combine steps, N1 = node count + 1 buffer slots (the
ones slot last), K rate categories, P site patterns. freqs may be (4,) or
(B, 4), props (K,) or (B, K), Q_scaled (K, 4, 4) or (B, K, 4, 4).
"""

from __future__ import annotations

import torch

# Calls of the two entry points, so a run can show that it took this engine
# (the kernel modules count their launches the same way).
CALLS = {"ll": 0, "ll_grad": 0}


def reset_counters():
    for name in CALLS:
        CALLS[name] = 0


def node_transition_matrices(evec, ivec, evals, branch_lengths, rates):
    """P = V exp(Λ b r) V^-1 for every node slot and rate category.

    branch_lengths: (..., N1) with 0 at the root and the ones slot; rates:
    (K,) or (..., K). Returns (..., N1, K, 4, 4) in the promoted dtype of
    evec and branch_lengths. The scalar exponential runs in f64 whatever the
    working dtype (BASELINE.md precision policy)."""
    dt = torch.promote_types(evec.dtype, branch_lengths.dtype)
    r = rates.to(torch.float64)
    if r.dim() > 1:
        r = r[..., None, :]
    t = branch_lengths.to(torch.float64)[..., :, None] * r  # (..., N1, K)
    expo = torch.exp(t[..., None] * evals.to(torch.float64)).to(dt)
    return torch.einsum("ij,...nkj,jl->...nkil", evec.to(dt), expo, ivec.to(dt))


def per_tree(x, B):
    """(n,) or (B, n) -> (B, n) (a view)."""
    return x.expand(B, x.shape[-1])


def reduce_per_tree(x_b, g, like):
    """Per-tree cotangent rows (B, n) times g (B,), summed over the trees
    when the input ``like`` was shared (n,)."""
    out = x_b * g[:, None]
    return (torch.sum(out, dim=0) if like.dim() == 1 else out).to(like.dtype)


def _postorder_m(post_children, P, tips, rescale: bool):
    """Node partials M (B, N1, K, 4, P) and logscale (B, P). Step s writes
    node L + s (internal ids are postorder-linear, ops/schedule.py)."""
    B, N1, K = P.shape[:3]
    L, _, n_pat = tips.shape
    pc = post_children.long()
    rows = torch.arange(B, device=P.device)[:, None]
    M = P.new_ones((B, N1, K, 4, n_pat))
    M[:, :L] = tips.to(P.dtype)[None, :, None]
    logscale = P.new_zeros((B, n_pat))
    for s in range(pc.shape[1]):
        children = pc[:, s]  # (B, 3)
        ev = P[rows, children] @ M[rows, children]  # (B, 3, K, 4, P)
        prod = ev[:, 0] * ev[:, 1] * ev[:, 2]
        if rescale:
            scale = torch.amax(prod, dim=(1, 2))  # (B, P)
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            prod = prod / scale[:, None, None, :]
            logscale = logscale + torch.log(scale)
        M[:, L + s] = prod
    return M, logscale


def _evolved_of(P, M):
    """E[n] = P_n M_n for every slot, one batched product."""
    return P @ M


def _preorder_pernode(post_children, P, E, freqs, root_id, rescale: bool):
    """Upper partials U (B, N1, K, 4, P): U[root] = freqs; one step per
    internal node in reverse postorder, each child's U = (P_node^T U[node])
    times its two siblings' E. The ones slot receives rows never read."""
    B = E.shape[0]
    pc = post_children.long()
    S = pc.shape[1]
    L = root_id + 1 - S
    rows = torch.arange(B, device=E.device)[:, None]
    U = torch.zeros_like(E)
    U[:, root_id] = per_tree(freqs, B).to(E.dtype)[:, None, :, None]
    for i in range(S):
        node = root_id - i
        kids = pc[:, node - L]  # (B, 3)
        evolved_up = P[:, node].transpose(-1, -2) @ U[:, node]  # (B, K, 4, P)
        se = E[rows, kids]  # (B, 3, K, 4, P)
        u = torch.stack([
            evolved_up * se[:, 1] * se[:, 2],
            evolved_up * se[:, 0] * se[:, 2],
            evolved_up * se[:, 0] * se[:, 1],
        ], dim=1)
        if rescale:
            scale = torch.amax(u, dim=(2, 3))  # (B, 3, P)
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            u = u / scale[:, :, None, None, :]
        U[rows, kids] = u
    return U


def _root_site_likelihoods(M, root_id, freqs, props):
    """Scaled per-pattern site likelihoods at the root: (B, P)."""
    B = M.shape[0]
    return torch.einsum("bk,bi,bkip->bp", per_tree(props, B),
                        per_tree(freqs, B), M[:, root_id])


def _edge_denominators(props_b, Ue, Ee):
    """Per-edge scaled site likelihoods sum_k props_k U_k . E_k: (B, Ne, P)."""
    return torch.einsum("bk,bekp->bep", props_b, torch.sum(Ue * Ee, dim=3))


class _LogLikelihood(torch.autograd.Function):
    """(B,) LLs from P (B, N1, K, 4, 4); backward: libsbn_tpu/ops/
    pruning.py:212-250 ``_ll_bwd``, batched."""

    @staticmethod
    def forward(ctx, P, tips, freqs, props, weights, post_children, root_id,
                rescale):
        M, logscale = _postorder_m(post_children, P, tips, rescale)
        site = _root_site_likelihoods(M, root_id, freqs, props)
        ctx.save_for_backward(P, tips, freqs, props, weights, post_children,
                              M, logscale, site)
        ctx.root_id, ctx.rescale = root_id, rescale
        return torch.sum(weights * (torch.log(site) + logscale), dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        P, tips, freqs, props, weights, post_children, M, logscale, site = (
            ctx.saved_tensors
        )
        root_id = ctx.root_id
        B = P.shape[0]
        L = tips.shape[0]
        g = g.to(P.dtype)
        E = _evolved_of(P, M)
        U = _preorder_pernode(post_children, P, E, freqs, root_id, ctx.rescale)
        props_b = per_tree(props, B).to(P.dtype)
        freqs_b = per_tree(freqs, B).to(P.dtype)
        Ue, Ee, Me = U[:, :root_id], E[:, :root_id], M[:, :root_id]
        wden = weights / _edge_denominators(props_b, Ue, Ee)  # (B, Ne, P)
        # d ll / dP[e,k,i,j] = sum_p w_p props_k U[e,k,i,p] M[e,k,j,p] / denom
        uw = Ue * props_b[:, None, :, None, None] * wden[:, :, None, None, :]
        dP = torch.zeros_like(P)
        dP[:, :root_id] = (uw @ Me.transpose(-1, -2)) * g[:, None, None, None, None]
        # d ll / d tips[l,i,p] = w_p / denom[l,p] sum_k props_k (P_l^T U_l)
        PtU = P[:, :L].transpose(-1, -2) @ U[:, :L]  # (B, L, K, 4, P)
        dtips = torch.einsum("b,bk,blkjp,blp->ljp", g, props_b, PtU, wden[:, :L])
        w_over_site = weights / site  # (B, P)
        root_M = M[:, root_id]  # (B, K, 4, P)
        dfreqs = torch.einsum("bk,bkip,bp->bi", props_b, root_M, w_over_site)
        dprops = torch.einsum("bi,bkip,bp->bk", freqs_b, root_M, w_over_site)
        dweights = g @ (torch.log(site) + logscale)
        return (dP, dtips.to(tips.dtype), reduce_per_tree(dfreqs, g, freqs),
                reduce_per_tree(dprops, g, props), dweights.to(weights.dtype),
                None, None, None)


def log_likelihoods(post_children, P, tips, freqs, props, weights, *,
                    root_id, rescale: bool = True):
    """(B,) log likelihoods, differentiable in P, tips, freqs, props and
    weights. post_children: (B, S, 3); P: (B, N1, K, 4, 4) with
    N1 = root_id + 2; tips: (L, 4, P); weights: (P,)."""
    if P.shape[1] != root_id + 2:
        raise ValueError(
            f"P must cover N1 = root_id + 2 = {root_id + 2} slots (root + "
            f"ones slot); got {P.shape[1]}"
        )
    CALLS["ll"] += 1
    return _LogLikelihood.apply(P, tips, freqs, props, weights, post_children,
                                root_id, rescale)


def log_likelihood(sched, P, tips, freqs, props, weights, rescale: bool = True):
    """Log likelihood (a 0-dim tensor) of one tree, differentiable as
    log_likelihoods is. sched: the tree's ops/schedule.py PruningSchedule;
    P: (N+1, K, 4, 4) node transition matrices with N = root_id + 1; tips:
    (L, 4, P); freqs: (4,); props: (K,); weights: (P,)."""
    pc = torch.as_tensor(sched.post_children, device=P.device).long()
    return log_likelihoods(pc[None], P[None], tips, freqs, props, weights,
                           root_id=sched.root_id, rescale=rescale)[0]


def log_likelihood_and_branch_gradient(
    post_children, P, Q_scaled, tips, freqs, props, weights, *, root_id,
    rescale: bool = True,
):
    """Linear-time (ll (B,), branch gradient (B, root_id)) in one pass.
    Q_scaled: the rate matrix scaled by each category rate (K, 4, 4), or
    per tree (B, K, 4, 4). The gradient covers node ids 0..root_id-1."""
    if P.shape[1] != root_id + 2:
        raise ValueError(f"P must cover N1 = root_id + 2 = {root_id + 2} slots")
    CALLS["ll_grad"] += 1
    B = P.shape[0]
    M, logscale = _postorder_m(post_children, P, tips, rescale)
    E = _evolved_of(P, M)
    site = _root_site_likelihoods(M, root_id, freqs, props)
    ll = torch.sum(weights * (torch.log(site) + logscale), dim=1)
    U = _preorder_pernode(post_children, P, E, freqs, root_id, rescale)
    props_b = per_tree(props, B).to(P.dtype)
    Ue, Ee = U[:, :root_id], E[:, :root_id]
    denom = _edge_denominators(props_b, Ue, Ee)
    Q = Q_scaled.to(P.dtype)
    QE = (Q[:, None] if Q.dim() == 4 else Q) @ Ee  # dP/db M = (r_k Q) P M
    num = _edge_denominators(props_b, Ue, QE)
    return ll, torch.sum(weights * num / denom, dim=-1)
