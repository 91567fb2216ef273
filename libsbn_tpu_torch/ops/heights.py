"""The height-ratio transform of rooted time trees, batched over trees.

The counterpart of libsbn_tpu/ops/heights.py (the reference's
rooted_tree.cpp InitializeTimeTreeUsingHeightRatios, fat_beagle.cpp
LogDeterminantJacobian and the BEAST-derived recursions of
rooted_gradient_transforms.cpp). Plain PyTorch on (B, N) tensors: row b is
tree b, where the JAX package vmaps a per-tree function.

A tree has N nodes: leaves 0..L-1, internal nodes L..N-2, the root N-1.
``ratios`` (B, L-1) holds the internal non-root nodes' height ratios,
ratio_v = (h_v - b_v) / (h_parent - b_v), then the root height last;
``node_bounds`` (B, N) holds each node's largest tip date below it (a
leaf's own date). The heights follow from the fixed point
h_v = b_v + r_v (h[parent_v] - b_v), reached after as many sweeps as the
deepest internal node's depth; each sweep is a gather on the parent index.
``method="squaring"`` instead composes the affine sweep with itself by
matrix squarings of (B, N, N) one-hot matrices (the JAX function's second
lowering; exact for any count of sweeps at least the depth).

The hand adjoint sums onto each parent over its children in a fixed order:
gathers over the children table (the schedule's ``post_children``, row s
holding internal node leaf_count + s's children, padded with the ones slot
N), never scatter-adds, whose float atomics on a card add in no fixed
order. So two runs on a card agree bit for bit.

``SWEEPS`` counts the fixed point's steps as they are built: "forward"
(``node_heights_from_ratios``) and "adjoint" (the hand adjoint of
``ratio_and_rate_gradients_from_branch_gradient``), one a sweep, or one a
squaring under ``method="squaring"``. Counted in Python, so a captured
graph's replay adds its capture's counts (models/rooted_graph.py), as the
kernels' launch counters do.
"""

from __future__ import annotations

import math

import torch

# The heights fixed point's steps built, by direction; reset_counters()
# sets them to 0.
SWEEPS = {"forward": 0, "adjoint": 0}


def reset_counters():
    for name in SWEEPS:
        SWEEPS[name] = 0


def _sweep_operands(ratios, node_bounds, leaf_count, pre_internal_node,
                    pre_internal_parent):
    """(b, r_full, parent_full): the bounds in the ratios' dtype, the
    per-node ratio (0 at leaves, 1 at the root, which is its own parent)
    and the per-node parent index (a leaf is its own parent), all (B, N)."""
    B, n = node_bounds.shape
    n_internal = n - leaf_count - 1
    b = node_bounds.to(ratios.dtype)
    r_full = torch.cat([
        ratios.new_zeros((B, leaf_count)), ratios[:, :n_internal],
        ratios.new_ones((B, 1)),
    ], dim=1)
    parent_full = torch.arange(n, device=node_bounds.device).repeat(B, 1)
    parent_full.scatter_(1, pre_internal_node.long(),
                         pre_internal_parent.long())
    return b, r_full, parent_full


def _squarings(n_iters):
    return max(1, math.ceil(math.log2(max(n_iters, 2))))


def _one_hot(parent_full, n, dtype):
    return (parent_full[..., None]
            == torch.arange(n, device=parent_full.device)).to(dtype)


def children_table(parent, leaf_count):
    """(B, N - L, 3) int64 children of each internal node (row s: node
    leaf_count + s) padded with the ones slot N, from the parent index
    parent (B, N-1) of binary trees, as a schedule's post_children lays
    them out. A stable sort of the parent index: every internal node is
    the parent of exactly two nodes, so sorted positions 2s and 2s + 1
    hold node leaf_count + s's children."""
    parent = parent.long()
    B, n1 = parent.shape
    kids = torch.argsort(parent, dim=1, stable=True).view(B, -1, 2)
    return torch.nn.functional.pad(kids, (0, 1), value=n1 + 1)


def _children_index(post_children, leaf_count, root_self=False):
    """(B, 3 (N + 1)) int64 gather index over per-node values padded with a
    zero at the ones slot N: row v holds node v's children (the slot where
    it has none: the leaves, and the slot's own row). With root_self the
    binary root's third column, the slot, becomes the root itself."""
    pc = post_children.long()
    B, n_internal, _ = pc.shape
    n = n_internal + leaf_count
    if root_self:
        root = torch.nn.functional.pad(pc[:, -1:, :2], (0, 1), value=n - 1)
        pc = torch.cat([pc[:, :-1], root], dim=1)
    return torch.nn.functional.pad(pc, (0, 0, leaf_count, 1),
                                   value=n).reshape(B, -1)


def _sum_over_children(x, index):
    """(B, N + 1): for each node the sum of x (B, N + 1, zero at the ones
    slot) over the row of ``index`` (_children_index), one reduction in a
    fixed order."""
    return torch.gather(x, 1, index).view(x.shape[0], -1, 3).sum(-1)


def node_heights_from_ratios(ratios, node_bounds, leaf_count,
                             pre_internal_node, pre_internal_parent,
                             n_iters=None, method="sweeps"):
    """Heights (B, N) from ratios (B, L-1) and node_bounds (B, N), in the
    ratios' dtype, differentiable in the ratios. pre_internal_node /
    pre_internal_parent: (B, I) internal non-root nodes in preorder and
    their parents. n_iters: at least the deepest internal node's depth
    (default I, always enough)."""
    n = node_bounds.shape[1]
    if n_iters is None:
        n_iters = max(1, n - leaf_count - 1)
    b, r_full, parent_full = _sweep_operands(
        ratios, node_bounds, leaf_count, pre_internal_node,
        pre_internal_parent)
    h = torch.cat([b[:, :n - 1], ratios[:, -1:]], dim=1)
    if method == "squaring":
        # h' = A h + c with A = diag(r) P, c = (1 - r) b; (A, c) ->
        # (A^2, A c + c) doubles the sweeps each time.
        A = r_full[:, :, None] * _one_hot(parent_full, n, ratios.dtype)
        c = b - r_full * b
        SWEEPS["forward"] += _squarings(n_iters)
        for _ in range(_squarings(n_iters)):
            c = torch.matmul(A, c[:, :, None])[:, :, 0] + c
            A = torch.matmul(A, A)
        return torch.matmul(A, h[:, :, None])[:, :, 0] + c
    if method != "sweeps":
        raise ValueError(f"unknown method {method!r}")
    # The sweeps run over N + 1 slots: slot N holds the root height (bound
    # 0, ratio 1, its own parent, so it keeps its value) and is the root's
    # parent. No slot is then the parent of more than two, and the gather's
    # backward, which adds onto parents with float atomics on a card, has
    # one value: the autograd route repeats bit for bit. The root's height
    # is b + (h - b) each sweep, as with the root its own parent.
    B = ratios.shape[0]
    b1 = torch.nn.functional.pad(b, (0, 1))
    r1 = torch.nn.functional.pad(r_full, (0, 1), value=1.0)
    p1 = torch.cat([parent_full[:, :n - 1], parent_full.new_full((B, 2), n)],
                   dim=1)
    h = torch.cat([h, ratios[:, -1:]], dim=1)
    SWEEPS["forward"] += n_iters
    for _ in range(n_iters):
        h = b1 + r1 * (torch.gather(h, 1, p1) - b1)
    return h[:, :n]


def branch_lengths_from_heights(heights, parent):
    """bl[:, i] = heights[:, parent[:, i]] - heights[:, i] over the N-1
    non-root nodes; parent: (B, N-1)."""
    return torch.gather(heights, 1, parent.long()) - heights[:, :-1]


def ratio_and_rate_gradients_from_branch_gradient(
    g_bl_scaled, ratios, node_bounds, rates, leaf_count, pre_internal_node,
    pre_internal_parent, parent, n_iters, include_jacobian=True,
    heights=None, method="sweeps", post_children=None,
):
    """The hand chain rule from a gradient with respect to the rate-scaled
    branch lengths bl * rates, g_bl_scaled (B, N-1), to (d obj / d ratios
    (B, L-1), d obj / d rates (B, N-1), heights (B, N)), obj = LL plus, with
    include_jacobian, the log-det-Jacobian of the transform.

    The adjoint of the fixed point is taken at the converged heights: with
    A = diag(r) P, W = sum_j (A^T)^j g_h over n_iters terms and the ratios'
    gradient is W (h[parent] - b) at internal non-root nodes; the root
    height's is the last term (A^T)^n_iters g_h at the root.

    post_children: the schedule's (B, N - L, 3) children table; without it
    the table comes from ``parent`` (children_table). Every sum onto a
    parent is a gather over it, in a fixed order."""
    B, n = node_bounds.shape
    dtype = g_bl_scaled.dtype
    h = heights
    if h is None:
        h = node_heights_from_ratios(
            ratios, node_bounds, leaf_count, pre_internal_node,
            pre_internal_parent, n_iters=n_iters, method=method)
    parent = parent.long()
    if post_children is None:
        post_children = children_table(parent, leaf_count)
    kids = _children_index(post_children, leaf_count)
    bl = branch_lengths_from_heights(h, parent)
    g_rates = g_bl_scaled * bl
    g_bl = torch.nn.functional.pad(g_bl_scaled * rates, (0, 2))

    # bl_i = h[parent_i] - h_i: +g at the parent, -g at the node. Per-node
    # values carry the ones slot's zero last, (B, N + 1).
    g_h = _sum_over_children(g_bl, kids) - g_bl
    b, r_full, parent_full = _sweep_operands(
        ratios.to(dtype), node_bounds, leaf_count, pre_internal_node,
        pre_internal_parent)
    if include_jacobian:
        # d/dh of sum over internal non-root i of log(h[parent_i] - b_i):
        # 1 / (h[parent_i] - b_i) at the parent. The division is guarded on
        # the masked leaf rows: a leaf whose height equals its parent's
        # would give 0 * inf = NaN there.
        diff = torch.gather(h, 1, parent) - b[:, :-1]
        mask = (torch.arange(n - 1, device=h.device) >= leaf_count).to(dtype)
        inv = mask / torch.where(mask > 0, diff, torch.ones_like(diff))
        g_h = g_h + _sum_over_children(
            torch.nn.functional.pad(inv, (0, 2)), kids)

    if method == "squaring":
        At = (r_full[:, :, None]
              * _one_hot(parent_full, n, dtype)).transpose(1, 2)
        S = torch.eye(n, dtype=dtype, device=h.device).expand(B, n, n)
        M = At
        SWEEPS["adjoint"] += _squarings(n_iters)
        for _ in range(_squarings(n_iters)):
            S = S + torch.matmul(M, S)
            M = torch.matmul(M, M)
        W = torch.matmul(S, g_h[:, :n, None])[:, :, 0]
        w_final = torch.matmul(M, g_h[:, :n, None])[:, :, 0]
    elif method == "sweeps":
        # w <- P^T (r w): each node passes r_v w_v to its parent; the root
        # (r = 1, its own parent) keeps its own w besides. Four kernels a
        # sweep.
        up = _children_index(post_children, leaf_count, root_self=True)
        r_pad = torch.nn.functional.pad(r_full, (0, 1))
        w, W = g_h, g_h
        SWEEPS["adjoint"] += n_iters
        for _ in range(n_iters):
            w = _sum_over_children(r_pad * w, up)
            W = W + w
        W, w_final = W[:, :n], w[:, :n]
    else:
        raise ValueError(f"unknown method {method!r}")

    # d sweep / d r_v = h[parent_v] - b_v at internal non-root v; the root
    # height is the initial condition of the root's slot.
    hp_minus_b = torch.gather(h, 1, parent_full) - b
    dratios = torch.cat([(W * hp_minus_b)[:, leaf_count:n - 1],
                         w_final[:, n - 1:]], dim=1)
    return dratios, g_rates, h


def log_det_jacobian(heights, node_bounds, parent, leaf_count):
    """(B,) log |det d heights / d ratios| = sum over internal non-root
    nodes of log(h_parent - bound_node)."""
    n = heights.shape[1]
    par = parent[:, leaf_count:n - 1].long()
    return torch.sum(torch.log(
        torch.gather(heights, 1, par)
        - node_bounds[:, leaf_count:n - 1].to(heights.dtype)), dim=1)
