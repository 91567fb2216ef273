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

Which path runs where. The engine's rooted hand route (models/engine.py
``_rooted_hand``, JC69 with rescaling) with ``heights_method="sweeps"``
runs the sweeps and their adjoint through ``forward`` and ``adjoint``: on
a card two hand-written kernels (csrc/heights.cu), one block a tree,
``forward_cuda`` (the heights and K1's operand, the rate-scaled branch
lengths in the working dtype) before K1 and ``adjoint_cuda`` (the ratio
and clock gradients in the working dtype) after it; on the CPU their
twins ``forward_plain`` and ``adjoint_plain``, in the kernels' order of
operations. A tree's per-node values sit in the block's shared memory,
or, past ``SHARED_LIMIT`` (``tree_bytes``), in a slab of device memory
per tree: the slab route, the same kernels' code and bits. Every other
caller runs the plain PyTorch functions above them, which share no code
with the kernels: ``method="squaring"``, the autograd route (which
differentiates through ``node_heights_from_ratios``) and
``rooted_log_likelihoods``.

``SWEEPS`` counts the fixed point's steps as they are built: "forward"
(``node_heights_from_ratios``, the forward kernel) and "adjoint" (the hand
adjoint of ``ratio_and_rate_gradients_from_branch_gradient``, the adjoint
kernel), one a sweep, or one a squaring under ``method="squaring"``;
``LAUNCHES`` the kernels enqueued ("forward", "adjoint", and
"forward_slab", "adjoint_slab" on the slab route) and ``TWIN_CALLS`` the
twins' calls.
Counted in Python, so a captured graph's replay adds its capture's counts
(models/rooted_graph.py), as the pruning kernels' launch counters do.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .pruning_jc import SHARED_LIMIT

# The heights fixed point's steps built, the kernels launched and their
# twins' calls, by direction; reset_counters() sets them to 0.
SWEEPS = {"forward": 0, "adjoint": 0}
LAUNCHES = {"forward": 0, "adjoint": 0, "forward_slab": 0, "adjoint_slab": 0}
TWIN_CALLS = {"forward": 0, "adjoint": 0}


def reset_counters():
    for counts in (SWEEPS, LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


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


# -- the kernels (csrc/heights.cu) and their twins ------------------------

def tree_bytes(kernel, node_count):
    """Bytes of a tree's per-node values in csrc/heights.cu's ``kernel``
    ("forward" or "adjoint"), rounded up to 16: N + 1 slots of four
    float64 (two height buffers, bounds, ratios) and one int32 (the
    parent) in the forward kernel; nine float64 (heights, bounds, ratios,
    the clock terms, g_bl, the Jacobian's terms, two w buffers, W) and
    four int32 (the parent, three children) in the adjoint. A block's
    shared memory up to SHARED_LIMIT, else the slab route's stride."""
    f64s, i32s = (4, 1) if kernel == "forward" else (9, 4)
    return -(-(node_count + 1) * (8 * f64s + 4 * i32s) // 16) * 16


def forward(ratios, node_bounds, rates, parent, leaf_count, n_iters, dtype):
    """The heights (B, N) float64 and K1's operand (B, N + 1) in dtype by
    the sweeps: forward_cuda on a card, its twin forward_plain on the
    CPU."""
    fn = forward_plain if node_bounds.device.type == "cpu" else forward_cuda
    return fn(ratios, node_bounds, rates, parent, leaf_count, n_iters, dtype)


def adjoint(grad, heights, ratios, node_bounds, rates, post_children, parent,
            leaf_count, n_iters, strict_clock):
    """The ratio and clock gradients in grad's dtype from K1's branch
    gradient grad: adjoint_cuda on a card, its twin adjoint_plain on the
    CPU."""
    fn = adjoint_plain if node_bounds.device.type == "cpu" else adjoint_cuda
    return fn(grad, heights, ratios, node_bounds, rates, post_children, parent,
              leaf_count, n_iters, strict_clock)


def forward_plain(ratios, node_bounds, rates, parent, leaf_count, n_iters,
                  dtype):
    """The forward kernel's twin, in its order of operations: (heights
    (B, N) float64, K1's operand (B, N + 1) in ``dtype``: the rate-scaled
    branch lengths (h[parent] - h) rates rounded to dtype, then the root's
    and the ones slot's zeros). ratios (B, N - L), node_bounds (B, N) and
    rates (B, N - 1) float64; parent (B, N - 1). The sweeps update the
    internal nodes and the root over N + 1 slots; the leaves keep their
    bounds, and the ones slot, the root's parent, the root height."""
    TWIN_CALLS["forward"] += 1
    SWEEPS["forward"] += n_iters
    B, n = node_bounds.shape
    L = leaf_count
    b = node_bounds[:, L:]
    r = torch.cat([ratios[:, :-1], ratios.new_ones((B, 1))], dim=1)
    p = torch.nn.functional.pad(parent.long(), (0, 2), value=n)
    h = torch.cat([node_bounds[:, :n - 1], ratios[:, -1:], ratios[:, -1:]],
                  dim=1)
    for _ in range(n_iters):
        inner = b + r * (torch.gather(h, 1, p[:, L:n]) - b)
        h = torch.cat([h[:, :L], inner, h[:, n:]], dim=1)
    bl = (torch.gather(h, 1, p[:, :n - 1]) - h[:, :n - 1]) * rates
    return h[:, :n], torch.nn.functional.pad(bl.to(dtype), (0, 2))


def adjoint_plain(grad, heights, ratios, node_bounds, rates, post_children,
                  parent, leaf_count, n_iters, strict_clock):
    """The adjoint kernel's twin, in its order of operations: (d (LL +
    log-det-Jacobian) / d ratios (B, N - L), d LL / d rates: (B, 1) summed
    under a strict clock, else (B, N - 1)), both in grad's dtype, from
    K1's branch gradient grad (B, N - 1) and the forward's heights.
    Everything between is float64: ratio_and_rate_gradients_from_branch_
    gradient's sweeps with the Jacobian, each node's three children summed
    left to right, and the strict clock's sum as the kernel's warp takes
    it (lane l adds branches l, l + 32, ... in order; the lanes then fold
    by halves)."""
    TWIN_CALLS["adjoint"] += 1
    SWEEPS["adjoint"] += n_iters
    B, n = node_bounds.shape
    L = leaf_count
    g = grad.to(torch.float64)
    pad = torch.nn.functional.pad
    hp = torch.gather(heights, 1, parent.long())
    c = g * (hp - heights[:, :n - 1])
    x = pad(g * rates, (0, 2))
    y = pad(1.0 / (hp[:, L:] - node_bounds[:, L:n - 1]), (L, 2))
    r = torch.cat([ratios.new_zeros((B, L)), ratios[:, :-1],
                   ratios.new_ones((B, 1)), ratios.new_zeros((B, 1))], dim=1)
    slot = post_children.new_full((B, 1, 3), n).long()
    kids = torch.cat([slot.expand(B, L, 3), post_children.long(), slot],
                     dim=1)
    up = kids.clone()
    up[:, n - 1, 2] = n - 1  # the root passes its own w to itself

    def over_kids(z, k):
        t = torch.gather(z, 1, k.reshape(B, -1)).view(B, -1, 3)
        return t[..., 0] + t[..., 1] + t[..., 2]

    w = (over_kids(x, kids) - x) + over_kids(y, kids)
    W = w
    for _ in range(n_iters):
        w = over_kids(r * w, up)
        W = W + w
    d = W[:, L:n - 1] * (hp[:, L:] - node_bounds[:, L:n - 1])
    dratios = torch.cat([d, w[:, n - 1:n]], dim=1).to(grad.dtype)
    if not strict_clock:
        return dratios, c.to(grad.dtype)
    chunks = -(-(n - 1) // 32)
    lanes = pad(c, (0, 32 * chunks - (n - 1))).view(B, chunks, 32)
    s = torch.zeros((B, 32), dtype=torch.float64, device=c.device)
    for j in range(chunks):
        s = s + lanes[:, j]
    for off in (16, 8, 4, 2, 1):
        s = s[:, :off] + s[:, off:2 * off]
    return dratios, s.to(grad.dtype)


def _check_kernel_inputs(dev, arrays):
    """Raise unless each (name, tensor, dtype, shape) lies on the card dev
    with that dtype and shape, contiguous."""
    if dev.type != "cuda":
        raise ValueError(f"the heights kernels take CUDA tensors, got {dev}")
    for name, x, dtype, shape in arrays:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tree_dims(node_bounds, leaf_count, n_iters):
    B, n = node_bounds.shape
    if (not 1 <= B <= 2**31 - 1 or tree_bytes("adjoint", n) > 2**31 - 1
            or n_iters < 0):
        raise ValueError(f"the heights kernels take 1 <= B < 2**31 trees of "
                         f"fewer than 2**31 bytes each and n_iters >= 0, got "
                         f"{B}, {n} nodes, {n_iters}")
    if not 0 < leaf_count < n:
        raise ValueError(f"leaf_count {leaf_count} out of range for {n} "
                         f"nodes")
    return B, n, n - leaf_count


def _scratch(kernel, B, n, dev):
    """(route key, slab, a tree's bytes): the shared route (slab None)
    when a tree's values fit a block's shared memory, else a uint8 slab of
    B trees' values in device memory (the "_slab" route key)."""
    nbytes = tree_bytes(kernel, n)
    if nbytes <= SHARED_LIMIT:
        return kernel, None, nbytes
    slab = torch.empty(B * nbytes, dtype=torch.uint8, device=dev)
    return kernel + "_slab", slab, nbytes


def forward_cuda(ratios, node_bounds, rates, parent, leaf_count, n_iters,
                 dtype):
    """The forward kernel (csrc/heights.cu heights_forward_kernel), one
    block a tree, on the shared or the slab route (_scratch): as
    forward_plain, bit for bit. parent: int32."""
    B, n, R = _tree_dims(node_bounds, leaf_count, n_iters)
    f64, dev = torch.float64, node_bounds.device
    _check_kernel_inputs(dev, [
        ("ratios", ratios, f64, (B, R)), ("node_bounds", node_bounds, f64,
                                          (B, n)),
        ("rates", rates, f64, (B, n - 1)), ("parent", parent, torch.int32,
                                            (B, n - 1))])
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"working dtype must be float32 or float64, got "
                        f"{dtype}")
    lib = _kernels.load("heights")
    heights = torch.empty((B, n), dtype=f64, device=dev)
    operand = torch.empty((B, n + 1), dtype=dtype, device=dev)
    route, slab, nbytes = _scratch("forward", B, n, dev)
    fn = (lib.lsbn_heights_forward_f32 if dtype == torch.float32
          else lib.lsbn_heights_forward_f64)
    with torch.cuda.device(dev):
        rc = fn(ratios.data_ptr(), node_bounds.data_ptr(), rates.data_ptr(),
                parent.data_ptr(), heights.data_ptr(), operand.data_ptr(),
                None if slab is None else slab.data_ptr(), nbytes, B,
                leaf_count, n, n_iters,
                torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, rc, "heights forward kernel")
    LAUNCHES[route] += 1
    SWEEPS["forward"] += n_iters
    return heights, operand


def adjoint_cuda(grad, heights, ratios, node_bounds, rates, post_children,
                 parent, leaf_count, n_iters, strict_clock):
    """The adjoint kernel (csrc/heights.cu heights_adjoint_kernel), one
    block a tree, on the shared or the slab route (_scratch): as
    adjoint_plain, bit for bit. grad: K1's gradient, rows
    of unit stride (a slice of K1's output); post_children and parent:
    int32."""
    B, n, R = _tree_dims(node_bounds, leaf_count, n_iters)
    f64, i32, dev = torch.float64, torch.int32, node_bounds.device
    dtype = grad.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"grad must be float32 or float64, got {dtype}")
    if (grad.device != dev or tuple(grad.shape) != (B, n - 1)
            or grad.stride(1) != 1):
        raise ValueError(f"grad must be ({B}, {n - 1}) on {dev} with rows "
                         f"of unit stride")
    _check_kernel_inputs(dev, [
        ("heights", heights, f64, (B, n)), ("ratios", ratios, f64, (B, R)),
        ("node_bounds", node_bounds, f64, (B, n)),
        ("rates", rates, f64, (B, n - 1)),
        ("post_children", post_children, i32, (B, R, 3)),
        ("parent", parent, i32, (B, n - 1))])
    lib = _kernels.load("heights")
    dratios = torch.empty((B, R), dtype=dtype, device=dev)
    clock = torch.empty((B, 1 if strict_clock else n - 1), dtype=dtype,
                        device=dev)
    route, slab, nbytes = _scratch("adjoint", B, n, dev)
    fn = (lib.lsbn_heights_adjoint_f32 if dtype == torch.float32
          else lib.lsbn_heights_adjoint_f64)
    with torch.cuda.device(dev):
        rc = fn(grad.data_ptr(), heights.data_ptr(), node_bounds.data_ptr(),
                ratios.data_ptr(), rates.data_ptr(), post_children.data_ptr(),
                parent.data_ptr(), dratios.data_ptr(), clock.data_ptr(),
                None if slab is None else slab.data_ptr(), nbytes,
                grad.stride(0), B, leaf_count, n, n_iters, int(strict_clock),
                torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, rc, "heights adjoint kernel")
    LAUNCHES[route] += 1
    SWEEPS["adjoint"] += n_iters
    return dratios, clock
