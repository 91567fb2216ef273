"""Forest evaluation: cross-tree subtree sharing for tree collections.

The counterpart of libsbn_tpu/ops/forest.py, with the same public names.
When branch lengths are keyed by *split* (the clade below an edge) -- the
regime of GP hot starts (gp_engine.cpp:363-394), split-based VBPI branch
models and any fixed-support analysis -- trees in a collection share
identical subtree partials, and the whole collection collapses to a DAG of
unique structures:

  * a unique *down node* per distinct subtree;
  * a unique *up node* per distinct rootward context;
  * a unique *edge* per distinct (up, down) pair. The per-edge gradient
    num/denom ratio cancels all rescale factors, so a tree edge's branch
    gradient IS its unique edge's value: per-tree outputs are gathers.

``build_forest`` is host code (a copy of the JAX package's hash-consing,
over this package's Topology): it compiles a collection to level-sorted
numpy index arrays once. The evaluation runs one chain of about 2 x depth
wide *levels*, each a few batched gathers and elementwise torch ops; the
index arrays go to a device once per (forest, device) and stay cached on
the schedule (``_device_schedule``).

Batching: every evaluation takes split-keyed branch lengths ``bl_splits``
as (n_splits,) or (R, n_splits) -- R length sets over one forest, where the
JAX package vmaps -- and returns per-tree outputs (T,) / (T, N-1) or
(R, T) / (R, T, N-1) to match.

Device: tensor inputs compute where they lie; numpy inputs go to
``device`` (utils/device.py ``compute_device``: the card unless
``device="cpu"``, raising without one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.topology import Topology
from ..utils.device import DEFAULT_DEVICE, compute_device
from . import pruning


@dataclass(frozen=True)
class ForestSchedule:
    """Dense schedules for a deduplicated tree collection.

    Down nodes: ids 0..L-1 are the leaves; internals L..n_down-1 are sorted
    by level (leaves = level 0) so every level is a contiguous id range;
    id n_down is the all-ones padding slot. Up nodes: id 0 is the shared
    root context (U = freqs), the rest sorted by level. Edges are unique
    (up, down) pairs. Branch lengths are indexed by split id; split id
    n_splits is the zero-length slot (root / padding edges)."""

    leaf_count: int
    tree_count: int
    node_count: int  # per-tree node count (for output shapes)
    n_down: int
    n_up: int
    n_edges: int
    n_splits: int
    # Per internal down node (ids L..n_down-1, level-sorted):
    down_kids: np.ndarray  # (n_down - L, 3) child down ids, ones-padded
    down_bl: np.ndarray  # (n_down,) split id of the edge above each down node
    # Contiguous (start, mid, end) per level: [start, mid) are binary nodes,
    # [mid, end) trifurcating (tree roots) -- the JC69 path skips the
    # ones-slot multiply for the binary majority.
    down_levels: Tuple[Tuple[int, int, int], ...]
    # Per up node (id 0 = root context, level-sorted):
    up_parent: np.ndarray  # (n_up,) parent up id
    up_pbl: np.ndarray  # (n_up,) split id of the edge above the parent
    up_sibs: np.ndarray  # (n_up, 2) sibling down ids, ones-padded
    # (start, mid, end) per level: [start, mid) have one sibling,
    # [mid, end) two (children of trifurcating roots).
    up_levels: Tuple[Tuple[int, int, int], ...]
    # Unique edges:
    edge_up: np.ndarray  # (n_edges,)
    edge_down: np.ndarray  # (n_edges,)
    edge_bl: np.ndarray  # (n_edges,) split id of the edge itself
    # Per-tree output maps:
    tree_root: np.ndarray  # (T,) down id of each tree's root
    tree_edge: np.ndarray  # (T, node_count - 1) edge id per non-root node
    # Split table (clade bitmask -> id), for building bl vectors. Masks are
    # Python ints: a clade of 64 or more taxa overflows any fixed width.
    split_of_clade: Dict[int, int]

    @property
    def ones_slot(self) -> int:
        return self.n_down

    def split_count_with_zero(self) -> int:
        return self.n_splits + 1

    def branch_lengths_from_tree(self, top: Topology, bl) -> np.ndarray:
        """Split-keyed bl vector taking each split's length from `bl`
        (node-id indexed) wherever `top` contains that split; unseen splits
        keep 0.1. Handy for tests and hot starts."""
        out = np.full((self.n_splits,), 0.1)
        bl = np.asarray(bl)
        for node in top.postorder():
            if node.id == top.id:
                continue
            idx = self.split_of_clade.get(_clade_mask(node))
            if idx is not None:
                out[idx] = bl[node.id]
        return out

    def tree_branch_lengths(self, top: Topology, bl_splits) -> np.ndarray:
        """Node-id-indexed branch lengths of `top` gathered from a
        split-keyed vector (root slot 0)."""
        bl_splits = np.asarray(bl_splits)
        out = np.zeros((top.id + 1,))
        for node in top.postorder():
            if node.id == top.id:
                continue
            out[node.id] = bl_splits[self.split_of_clade[_clade_mask(node)]]
        return out


def _clade_mask(node: Topology) -> int:
    mask = 0
    for n in node.postorder():
        if n.is_leaf():
            mask |= 1 << n.leaf_id
    return mask


def build_forest(tops: Sequence[Topology]) -> ForestSchedule:
    """Host compiler: hash-cons subtrees, rootward contexts, and edges of a
    polished topology collection into level-sorted dense schedules."""
    tops = list(tops)
    if not tops:
        raise ValueError("empty collection")
    for t in tops:
        if t.id < 0:
            t.polish()
    leaf_count = tops[0].leaf_count
    node_count = tops[0].id + 1
    for t in tops:
        if t.leaf_count != leaf_count or t.id + 1 != node_count:
            raise ValueError(
                "all trees in a forest must share a taxon set and rootedness")

    splits: Dict[int, int] = {}
    full_mask = (1 << leaf_count) - 1
    # Unrooted collections (trifurcating roots) key splits by the canonical
    # UNORDERED bipartition min(mask, ~mask): the same branch in
    # inconsistently-rooted samples has complementary clade-below masks
    # depending on orientation, and the reference's split semantics
    # (SplitModel branch lengths, HotStartBranchLengths) treat those as ONE
    # optimization variable. Rooted (binary-root) collections keep the raw
    # clade mask: rooted splits ARE clades there.
    unrooted = len(tops[0].children) == 3

    def canon(mask: int) -> int:
        if not unrooted or mask == full_mask:
            return mask
        comp = full_mask ^ mask
        return mask if mask <= comp else comp

    def split_id(mask: int) -> int:
        mask = canon(mask)
        if mask not in splits:
            splits[mask] = len(splits)
        return splits[mask]

    # --- down pass: unique subtrees ---------------------------------------
    down_ids: Dict[tuple, int] = {}
    down_kids: List[Tuple[int, ...]] = []
    down_level: List[int] = []
    down_clade: List[int] = []
    for i in range(leaf_count):
        down_ids[("L", i)] = i
        down_kids.append(())
        down_level.append(0)
        down_clade.append(1 << i)

    def down(node: Topology) -> int:
        if node.is_leaf():
            return node.leaf_id
        kids = tuple(sorted(down(c) for c in node.children))
        key = ("I",) + kids
        uid = down_ids.get(key)
        if uid is None:
            uid = len(down_kids)
            down_ids[key] = uid
            down_kids.append(kids)
            down_level.append(1 + max(down_level[k] for k in kids))
            mask = 0
            for k in kids:
                mask |= down_clade[k]
            down_clade.append(mask)
        return uid

    tree_root = np.array([down(t) for t in tops], dtype=np.int32)

    # Level-sort internals (binary before trifurcating within a level):
    # old uid -> new id (leaves keep 0..L-1).
    internal = sorted(range(leaf_count, len(down_kids)),
                      key=lambda u: (down_level[u], len(down_kids[u]) > 2))
    remap = np.empty((len(down_kids),), dtype=np.int32)
    remap[:leaf_count] = np.arange(leaf_count)
    for new, old in enumerate(internal):
        remap[old] = leaf_count + new
    n_down = len(down_kids)
    ones = n_down

    kids_arr = np.full((n_down - leaf_count, 3), ones, dtype=np.int32)
    levels_of = np.zeros((n_down,), dtype=np.int32)
    clade_of = np.zeros((n_down,), dtype=object)  # Python ints
    for old in range(n_down):
        new = remap[old]
        levels_of[new] = down_level[old]
        clade_of[new] = down_clade[old]
        if old >= leaf_count:
            ks = [remap[k] for k in down_kids[old]]
            kids_arr[new - leaf_count, : len(ks)] = ks
    tree_root = remap[tree_root]

    down_levels: List[Tuple[int, int, int]] = []
    start = leaf_count
    for lvl in range(1, int(levels_of.max()) + 1):
        end = start + int(np.sum(levels_of[leaf_count:] == lvl))
        n_tri = int(np.sum(
            kids_arr[start - leaf_count:end - leaf_count, 2] != ones
        ))
        down_levels.append((start, end - n_tri, end))
        assert np.all(levels_of[start:end] == lvl), "ids must be level-sorted"
        assert np.all(
            kids_arr[start - leaf_count:end - n_tri - leaf_count, 2] == ones
        )
        start = end
    assert start == n_down

    # Split ids (edge above each down node). A tree root's row evolves
    # through its own clade's split, unused unless that subtree is also an
    # inner node of another tree, where the split-keyed length is right.
    down_bl = np.empty((n_down,), dtype=np.int32)
    for uid in range(n_down):
        down_bl[uid] = split_id(int(clade_of[uid]))
    n_splits = len(splits)
    zero_slot = n_splits

    # --- up pass: unique rootward contexts --------------------------------
    up_ids: Dict[tuple, int] = {("R",): 0}
    up_parent: List[int] = [0]
    up_pbl: List[int] = [zero_slot]
    up_sibs: List[Tuple[int, int]] = [(ones, ones)]
    up_level: List[int] = [0]
    edge_ids: Dict[Tuple[int, int], int] = {}
    edge_up: List[int] = []
    edge_down: List[int] = []
    edge_bl: List[int] = []
    tree_edge = np.full((len(tops), node_count - 1), -1, dtype=np.int32)

    def up_of(parent_up: int, parent_pbl: int, sibs: Tuple[int, ...]) -> int:
        sibs = tuple(sorted(sibs))
        key = ("U", parent_up, parent_pbl, sibs)
        uid = up_ids.get(key)
        if uid is None:
            uid = len(up_parent)
            up_ids[key] = uid
            up_parent.append(parent_up)
            up_pbl.append(parent_pbl)
            padded = sibs + (ones,) * (2 - len(sibs))
            up_sibs.append(padded[:2])
            up_level.append(1 + up_level[parent_up])
        return uid

    def edge_of(u: int, d: int) -> int:
        key = (u, d)
        eid = edge_ids.get(key)
        if eid is None:
            eid = len(edge_up)
            edge_ids[key] = eid
            edge_up.append(u)
            edge_down.append(d)
            edge_bl.append(int(down_bl[d]))
        return eid

    def walk(ti: int, node: Topology, my_up: int, my_pbl: int) -> None:
        if node.is_leaf():
            return
        kid_down = [int(remap[down(c)]) for c in node.children]
        for i, c in enumerate(node.children):
            sibs = tuple(kid_down[j] for j in range(len(kid_down)) if j != i)
            u = up_of(my_up, my_pbl, sibs)
            tree_edge[ti, c.id] = edge_of(u, kid_down[i])
            walk(ti, c, u, int(down_bl[kid_down[i]]))

    for ti, t in enumerate(tops):
        walk(ti, t, 0, zero_slot)
    assert np.all(tree_edge >= 0)

    # Level-sort up nodes, one-sibling before two within a level (id 0
    # stays put: it is the unique level-0 node).
    order = sorted(range(len(up_parent)),
                   key=lambda u: (up_level[u], up_sibs[u][1] != ones))
    assert order[0] == 0
    up_remap = np.empty((len(up_parent),), dtype=np.int32)
    for new, old in enumerate(order):
        up_remap[old] = new
    n_up = len(up_parent)
    up_parent_arr = np.empty((n_up,), dtype=np.int32)
    up_pbl_arr = np.empty((n_up,), dtype=np.int32)
    up_sibs_arr = np.empty((n_up, 2), dtype=np.int32)
    up_lvl_arr = np.empty((n_up,), dtype=np.int32)
    for old in range(n_up):
        new = up_remap[old]
        up_parent_arr[new] = up_remap[up_parent[old]]
        up_pbl_arr[new] = up_pbl[old]
        up_sibs_arr[new] = up_sibs[old]
        up_lvl_arr[new] = up_level[old]
    up_levels: List[Tuple[int, int, int]] = []
    start = 1
    for lvl in range(1, int(up_lvl_arr.max()) + 1):
        end = start + int(np.sum(up_lvl_arr == lvl))
        n_two = int(np.sum(up_sibs_arr[start:end, 1] != ones))
        up_levels.append((start, end - n_two, end))
        assert np.all(up_lvl_arr[start:end] == lvl)
        assert np.all(up_sibs_arr[start:end - n_two, 1] == ones)
        start = end
    assert start == n_up
    edge_up_arr = up_remap[np.asarray(edge_up, dtype=np.int32)]

    # Export BOTH orientations of each canonical split so consumers can keep
    # looking up by raw clade-below mask (tree_branch_lengths).
    split_table = dict(splits)
    if unrooted:
        for mask, idx in list(splits.items()):
            if mask != full_mask:
                split_table.setdefault(full_mask ^ mask, idx)

    return ForestSchedule(
        leaf_count=leaf_count,
        tree_count=len(tops),
        node_count=node_count,
        n_down=n_down,
        n_up=n_up,
        n_edges=len(edge_up),
        n_splits=n_splits,
        down_kids=kids_arr,
        down_bl=down_bl,
        down_levels=tuple(down_levels),
        up_parent=up_parent_arr,
        up_pbl=up_pbl_arr,
        up_sibs=up_sibs_arr,
        up_levels=tuple(up_levels),
        edge_up=edge_up_arr,
        edge_down=np.asarray(edge_down, dtype=np.int32),
        edge_bl=np.asarray(edge_bl, dtype=np.int32),
        tree_root=tree_root,
        tree_edge=tree_edge,
        split_of_clade=split_table,
    )


# -- device placement ----------------------------------------------------------


def _target_device(device, *xs) -> torch.device:
    """Where a call computes: ``device`` if given; else where its tensor
    inputs lie; else the default (the card)."""
    if device is not None:
        return compute_device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return compute_device(DEFAULT_DEVICE)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _as(x, dtype, device) -> torch.Tensor:
    return _tensor(x).to(device=device, dtype=dtype)


def _lead(bl) -> Tuple[torch.Tensor, bool]:
    """(bl as (R, n), whether the caller passed one set (n,))."""
    return (bl[None], True) if bl.dim() == 1 else (bl, False)


def _fused_up_plan(fs: ForestSchedule):
    """Host-side plan for the fused rolling-block up pass (cached on fs).

    Exploits two schedule invariants: (a) an up node's parent context is
    always in the PREVIOUS level (up_level[u] == 1 + up_level[parent], by
    construction in build_forest), so the up pass only ever reads the
    level just produced -- the full (n_up, 4, S) buffer and the final
    (E, 4, S) Ue re-gather disappear; (b) no edge's up node is the root
    context, so every edge gradient can be emitted at the level where its
    up row is materialized. Edges are re-sorted by up level on host so the
    per-level outputs concatenate without scatters; tree_edge is
    pre-permuted to match."""
    cached = getattr(fs, "_fused_plan_cache", None)
    if cached is not None:
        return cached
    lvl = np.zeros(fs.n_up, np.int32)
    for li, (a, _, b) in enumerate(fs.up_levels):
        lvl[a:b] = li + 1
    elvl = lvl[fs.edge_up]
    assert np.all(elvl > 0), "edges never hang off the root context"
    perm = np.argsort(elvl, kind="stable")
    pos = np.empty((fs.n_edges,), np.int64)
    pos[perm] = np.arange(fs.n_edges)
    tree_edge_pos = pos[fs.tree_edge]
    plan = []
    prev_start = 0  # the level-0 block is the single root-context row
    ei = 0
    for li, (a, m, b) in enumerate(fs.up_levels):
        n_e = int(np.sum(elvl == li + 1))
        sel = perm[ei:ei + n_e]
        plan.append((
            a, m, b,
            (fs.up_parent[a:b] - prev_start).astype(np.int32),
            fs.edge_down[sel].astype(np.int32),
            (fs.edge_up[sel] - a).astype(np.int32),
        ))
        prev_start = a
        ei += n_e
    assert ei == fs.n_edges
    cached = (tuple(plan), tree_edge_pos)
    object.__setattr__(fs, "_fused_plan_cache", cached)
    return cached


class _DeviceSchedule:
    """A forest's index arrays as torch.long tensors on one device, uploaded
    once: gathering a device tensor with a numpy index would copy the index
    to the device on every gather. Per-level index blocks are views of the
    uploaded arrays."""

    def __init__(self, fs: ForestSchedule, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        L = fs.leaf_count
        self.down_bl = t(fs.down_bl)
        kids = t(fs.down_kids)
        self.down_levels = [
            (a, mid, b, self.down_bl[a:b], kids[a - L:b - L],
             kids[a - L:mid - L], kids[mid - L:b - L])
            for (a, mid, b) in fs.down_levels]
        up_parent, up_pbl, up_sibs = t(fs.up_parent), t(fs.up_pbl), t(fs.up_sibs)
        self.up_levels = [
            (a, mid, b, up_parent[a:b], up_pbl[a:b], up_sibs[a:b],
             up_sibs[a:mid, 0], up_sibs[mid:b])
            for (a, mid, b) in fs.up_levels]
        self.edge_up, self.edge_down = t(fs.edge_up), t(fs.edge_down)
        self.tree_root, self.tree_edge = t(fs.tree_root), t(fs.tree_edge)
        plan, tree_edge_pos = _fused_up_plan(fs)
        self.fused = [
            (a, mid, b, up_pbl[a:b], t(par_local), up_sibs[a:mid, 0],
             up_sibs[mid:b], t(e_down), t(e_up_local), len(e_down))
            for (a, mid, b, par_local, e_down, e_up_local) in plan]
        self.tree_edge_pos = t(tree_edge_pos)


def _device_schedule(fs: ForestSchedule, device) -> _DeviceSchedule:
    """fs's _DeviceSchedule on ``device``, built at first use and cached on
    fs (the frozen dataclass keeps it as an attribute, not a field)."""
    cache = getattr(fs, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(fs, "_device_cache", cache)
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = _DeviceSchedule(fs, device)
    return cache[key]


def _rescaled(x, ls, dims):
    """(x / its max over ``dims`` per pattern, ls + log of that max), a max
    of 0 taken as 1."""
    scale = torch.amax(x, dim=dims)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    x = x / scale.reshape(scale.shape[:2] + (1,) * len(dims) + scale.shape[2:])
    return x, (None if ls is None else ls + torch.log(scale))


# -- the generic forest ---------------------------------------------------------


def forest_log_likelihoods_and_gradients(
    fs: ForestSchedule,
    bl_splits,
    evec, ivec, evals,
    Q_scaled,
    tips,
    freqs,
    rates,
    props,
    weights,
    rescale: bool = True,
    device=None,
):
    """(ll (T,), grad (T, node_count-1)) for every tree in the forest under
    split-keyed branch lengths bl_splits (n_splits,); (R, T) and
    (R, T, node_count-1) for bl_splits (R, n_splits).

    Same math as pruning.log_likelihood_and_branch_gradient per tree -- the
    difference is purely the shared-evaluation order. Computes in the
    promoted dtype of tips and bl_splits."""
    dev = _target_device(device, bl_splits, tips, weights)
    tips, bl_splits = _tensor(tips), _tensor(bl_splits)
    dtype = torch.promote_types(tips.dtype, bl_splits.dtype)
    bl, single = _lead(_as(bl_splits, dtype, dev))
    tips = _as(tips, dtype, dev)
    evec, ivec, evals, Q_scaled, freqs, rates, props, w = (
        _as(x, dtype, dev) for x in (evec, ivec, evals, Q_scaled, freqs,
                                     rates, props, weights))
    ds = _device_schedule(fs, dev)
    R = bl.shape[0]
    K = props.shape[0]
    S = tips.shape[-1]
    L = fs.leaf_count

    bl = torch.cat([bl, torch.zeros((R, 1), dtype=dtype, device=dev)], dim=1)
    Pmat = pruning.node_transition_matrices(evec, ivec, evals, bl, rates)
    # (R, n_splits+1, K, 4, 4)

    # Down pass.
    shape = (R, fs.n_down + 1, K, 4, S)
    Md = torch.ones(shape, dtype=dtype, device=dev)
    Md[:, :L] = tips[:, None]
    Ed = torch.ones(shape, dtype=dtype, device=dev)
    Ed[:, :L] = Pmat[:, ds.down_bl[:L]] @ Md[:, :L]
    ls_d = torch.zeros((R, fs.n_down + 1, S), dtype=dtype, device=dev)
    for (a, _, b, pbl, kids, _, _) in ds.down_levels:
        ke = Ed[:, kids]  # (R, n, 3, K, 4, S)
        prod = ke[:, :, 0] * ke[:, :, 1] * ke[:, :, 2]
        ls = ls_d[:, kids].sum(dim=2)
        if rescale:
            prod, ls = _rescaled(prod, ls, (2, 3))
        Md[:, a:b] = prod
        Ed[:, a:b] = Pmat[:, pbl] @ prod
        ls_d[:, a:b] = ls

    # Up pass.
    U = torch.zeros((R, fs.n_up, K, 4, S), dtype=dtype, device=dev)
    U[:, 0] = freqs[None, :, None]
    for (a, _, b, par, pbl, sibs, _, _) in ds.up_levels:
        evolved = Pmat[:, pbl].transpose(-1, -2) @ U[:, par]
        se = Ed[:, sibs]  # (R, n, 2, K, 4, S)
        u = evolved * se[:, :, 0] * se[:, :, 1]
        if rescale:
            u, _ = _rescaled(u, None, (2, 3))
        U[:, a:b] = u

    # Per-tree log likelihoods.
    site = torch.einsum("k,i,rtkip->rtp", props, freqs, Md[:, ds.tree_root])
    ll = torch.sum(w * (torch.log(site) + ls_d[:, ds.tree_root]), dim=-1)

    # Unique-edge gradients; scale factors cancel in num/denom.
    Ue = U[:, ds.edge_up]  # (R, E, K, 4, S)
    Ee = Ed[:, ds.edge_down]
    denom = torch.einsum("k,rekip,rekip->rep", props, Ue, Ee)
    num = torch.einsum("k,rekip,rekip->rep", props, Ue, Q_scaled @ Ee)
    edge_grad = torch.sum(w * num / denom, dim=-1)
    grad = edge_grad[:, ds.tree_edge]  # (R, T, node_count - 1)
    return (ll[0], grad[0]) if single else (ll, grad)


# -- the JC69 forest ------------------------------------------------------------


def _jc_coeffs(bl):
    """JC69 closed form P(t) = b I + a J/4 with b = exp(-4t/3), a = 1 - b,
    so evolve(v) = b v + (a/4) sum_states v: matrix-free. The exponential
    runs in f64 (BASELINE.md precision policy) and is symmetric, so the up
    pass reuses it un-transposed."""
    b = torch.exp(-4.0 * bl.to(torch.float64) / 3.0)
    return 1.0 - b, b


def forest_jc_log_likelihoods_and_gradients(
    fs: ForestSchedule,
    bl_splits,
    tips,
    weights,
    rescale: bool = True,
    ll_only: bool = False,
    dtype=torch.float32,
    fused: bool = True,
    gather_dtype=None,
    device=None,
):
    """Matrix-free JC69 forest evaluation.

    Identical results to forest_log_likelihoods_and_gradients with the
    JC69 eigensystem (tested): every 4x4 contraction collapses to a
    broadcast multiply-add, and the gradient numerator needs only state
    sums: the normalized JC69 rate matrix is Q = (4/3)(J/4 - I), so
        num = sum_x U_x (QE)_x = (4/3)((sum E)(sum U)/4 - sum_x U_x E_x),
    and grad_e = (4/3) sum_s w_s ((See Sue)/(4 denom) - 1).
    Returns (ll, grad) -- grad is None if ll_only -- shaped (T,) and
    (T, node_count-1) for bl_splits (n_splits,), with a leading R for
    (R, n_splits). Differentiable in bl_splits (autograd).

    ``gather_dtype`` (default: ``dtype``) stores the Ed buffer and the
    rolling up block of the fused gradient phase; arithmetic upcasts to
    ``dtype`` and the LL (from the down pass) is untouched."""
    dev = _target_device(device, bl_splits, tips, weights)
    bl, single = _lead(_tensor(bl_splits).to(dev))
    ds = _device_schedule(fs, dev)
    R = bl.shape[0]
    L = fs.leaf_count
    a_all, b_all = _jc_coeffs(torch.cat(
        [bl, torch.zeros((R, 1), dtype=bl.dtype, device=dev)], dim=1))
    a_all = a_all.to(dtype)
    b_all = b_all.to(dtype)

    def evolve(idx, V):
        a = a_all[:, idx][..., None, None]
        b = b_all[:, idx][..., None, None]
        return b * V + (a * 0.25) * torch.sum(V, dim=2, keepdim=True)

    tips = _as(tips, dtype, dev)
    S = tips.shape[-1]
    w = _as(weights, dtype, dev)
    shape = (R, fs.n_down + 1, 4, S)
    Md = torch.ones(shape, dtype=dtype, device=dev)
    Md[:, :L] = tips
    Ed = torch.ones(shape, dtype=dtype, device=dev)
    Ed[:, :L] = evolve(ds.down_bl[:L], tips.expand(R, -1, -1, -1))
    ls_d = torch.zeros((R, fs.n_down + 1, S), dtype=dtype, device=dev)

    for (a0, mid, b0, pbl, _, k2, k3) in ds.down_levels:
        parts, lss = [], []
        if mid > a0:  # binary nodes: skip the ones-slot multiply
            parts.append(Ed[:, k2[:, 0]] * Ed[:, k2[:, 1]])
            lss.append(ls_d[:, k2[:, 0]] + ls_d[:, k2[:, 1]])
        if b0 > mid:  # trifurcating tree roots
            parts.append(Ed[:, k3[:, 0]] * Ed[:, k3[:, 1]] * Ed[:, k3[:, 2]])
            lss.append(ls_d[:, k3[:, 0]] + ls_d[:, k3[:, 1]]
                       + ls_d[:, k3[:, 2]])
        prod = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        ls = lss[0] if len(lss) == 1 else torch.cat(lss, dim=1)
        if rescale:
            prod, ls = _rescaled(prod, ls, (2,))
        Md[:, a0:b0] = prod
        Ed[:, a0:b0] = evolve(pbl, prod)
        ls_d[:, a0:b0] = ls

    site = 0.25 * torch.sum(Md[:, ds.tree_root], dim=2)  # (R, T, S)
    ll = torch.sum(w * (torch.log(site) + ls_d[:, ds.tree_root]), dim=-1)
    if ll_only:
        return (ll[0] if single else ll), None

    if fused:
        # Rolling-block up pass with the edge gradients fused in (see
        # _fused_up_plan). Per-row rescaling of u cancels in each edge's
        # num/denom ratio, exactly as in the buffered form.
        gdt = dtype if gather_dtype is None else gather_dtype
        Edg = Ed if gdt == dtype else Ed.to(gdt)
        prev = torch.full((R, 1, 4, S), 0.25, dtype=dtype, device=dev)
        grad_parts = []
        for (a0, mid, b0, pbl, par_local, sib1, sib2, e_down, e_up_local,
             n_e) in ds.fused:
            evolved = evolve(pbl, prev[:, par_local].to(dtype))
            parts = []
            if mid > a0:  # one sibling
                parts.append(evolved[:, :mid - a0] * Edg[:, sib1].to(dtype))
            if b0 > mid:  # two siblings (children of trifurcating roots)
                parts.append(evolved[:, mid - a0:]
                             * (Edg[:, sib2[:, 0]].to(dtype)
                                * Edg[:, sib2[:, 1]].to(dtype)))
            u = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            if rescale:
                u, _ = _rescaled(u, None, (2,))
            if n_e:
                Ue = u[:, e_up_local]
                Ee = Edg[:, e_down].to(dtype)
                denom = torch.sum(Ue * Ee, dim=2)  # (R, e, S)
                Sue = torch.sum(Ue, dim=2)
                See = torch.sum(Ee, dim=2)
                grad_parts.append((4.0 / 3.0) * torch.sum(
                    w * (0.25 * See * Sue / denom - 1.0), dim=-1))
            prev = u if gdt == dtype else u.to(gdt)
        edge_grad = torch.cat(grad_parts, dim=1)
        grad = edge_grad[:, ds.tree_edge_pos]
        return (ll[0], grad[0]) if single else (ll, grad)

    U = torch.zeros((R, fs.n_up, 4, S), dtype=dtype, device=dev)
    U[:, 0] = 0.25
    for (a0, mid, b0, par, pbl, _, sib1, sib2) in ds.up_levels:
        evolved = evolve(pbl, U[:, par])
        parts = []
        if mid > a0:  # one sibling
            parts.append(evolved[:, :mid - a0] * Ed[:, sib1])
        if b0 > mid:  # two siblings (children of trifurcating roots)
            parts.append(evolved[:, mid - a0:] * Ed[:, sib2[:, 0]]
                         * Ed[:, sib2[:, 1]])
        u = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if rescale:
            u, _ = _rescaled(u, None, (2,))
        U[:, a0:b0] = u

    Ue = U[:, ds.edge_up]
    Ee = Ed[:, ds.edge_down]
    denom = torch.sum(Ue * Ee, dim=2)  # (R, E, S)
    Sue = torch.sum(Ue, dim=2)
    See = torch.sum(Ee, dim=2)
    edge_grad = (4.0 / 3.0) * torch.sum(
        w * (0.25 * See * Sue / denom - 1.0), dim=-1)
    grad = edge_grad[:, ds.tree_edge]
    return (ll[0], grad[0]) if single else (ll, grad)


def forest_jc_weighted_ll_and_split_gradient(
    fs: ForestSchedule, bl_splits, tips, weights, lam=None,
    dtype=torch.float32, device=None,
):
    """(per-tree lls (T,), d(sum_t lam_t ll_t)/d bl_splits (n_splits,)) in
    ONE forward and ONE reverse pass through the shared down DAG (autograd
    through the LL-only forest; the JAX package's jax.value_and_grad). With
    bl_splits (R, n_splits): (R, T) and (R, n_splits), each row its own
    objective.

    This is the split-keyed *optimization* surface (GP-style branch-length
    ascent over a fixed support, MAP fitting): when only the aggregated
    gradient is needed, the reverse pass through the LL-only forest skips
    the per-tree up/edge machinery entirely. Equal to aggregating the
    per-tree edge gradients onto splits (tests/test_torch_forest.py). The
    gradient has bl_splits' dtype."""
    dev = _target_device(device, bl_splits, tips, weights)
    b = _tensor(bl_splits).to(dev).detach().clone().requires_grad_(True)
    lam_v = (torch.ones((fs.tree_count,), dtype=dtype, device=dev)
             if lam is None else _as(lam, dtype, dev))
    with torch.enable_grad():
        ll, _ = forest_jc_log_likelihoods_and_gradients(
            fs, b, tips, weights, ll_only=True, dtype=dtype, device=dev)
        (g,) = torch.autograd.grad(torch.sum(lam_v * ll), b)
    return ll.detach(), g


def forest_branch_ascent(
    fs: ForestSchedule, bl0, tips, weights, lam=None, steps: int = 200,
    lr: float = 0.05, dtype=torch.float32, device=None,
):
    """Maximize sum_t lam_t LL_t over split-keyed branch lengths -- the
    collection analog of GPInstance.EstimateBranchLengths
    (gp_instance.cpp:129-175), driven by the one-reverse-pass aggregated
    gradient. Adam in log-branch-length space (positivity for free; the
    reference optimizes log-space too, gp_engine.cpp:326-345), written out
    as the JAX package writes it (b1, b2, eps, bias correction in the
    working dtype), for a fixed number of steps.

    Returns (bl (n_splits,), per-tree lls at the optimum (T,), objective
    trace (steps,)); with bl0 (R, n_splits): (R, n_splits), (R, T) and
    (R, steps), each row its own ascent."""
    dev = _target_device(device, bl0, tips, weights)
    lam_v = (torch.ones((fs.tree_count,), dtype=dtype, device=dev)
             if lam is None else _as(lam, dtype, dev))
    tips, weights = _as(tips, dtype, dev), _as(weights, dtype, dev)

    def objective(log_bl):
        ll, _ = forest_jc_log_likelihoods_and_gradients(
            fs, torch.exp(log_bl), tips, weights, ll_only=True, dtype=dtype,
            device=dev)
        return torch.sum(lam_v * ll, dim=-1), ll

    b1, b2, eps = 0.9, 0.999, 1e-8
    log_bl = torch.log(torch.clamp(_as(bl0, dtype, dev), min=1e-6))
    m = torch.zeros_like(log_bl)
    v = torch.zeros_like(log_bl)
    trace = []
    for i in range(steps):
        x = log_bl.detach().requires_grad_(True)
        with torch.enable_grad():
            obj, _ = objective(x)
            (g,) = torch.autograd.grad(torch.sum(obj), x)
        t = torch.tensor(i + 1.0, dtype=dtype, device=dev)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        log_bl = log_bl + lr * mhat / (torch.sqrt(vhat) + eps)
        trace.append(obj.detach())
    _, ll = objective(log_bl)
    trace = (torch.stack(trace, dim=-1) if trace
             else torch.zeros(log_bl.shape[:-1] + (0,), dtype=dtype, device=dev))
    return torch.exp(log_bl), ll, trace


def forest_stats(fs: ForestSchedule) -> Dict[str, float]:
    """Sharing diagnostics (for logs and the bench's honest accounting)."""
    per_tree_internal = fs.node_count - fs.leaf_count
    per_tree_edges = fs.node_count - 1
    T = fs.tree_count
    return {
        "trees": T,
        "down_internal_unique": fs.n_down - fs.leaf_count,
        "down_internal_total": per_tree_internal * T,
        "up_unique": fs.n_up - 1,
        "up_total": per_tree_edges * T,
        "edges_unique": fs.n_edges,
        "edges_total": per_tree_edges * T,
        "down_levels": len(fs.down_levels),
        "up_levels": len(fs.up_levels),
        "op_sharing": (per_tree_internal + 2 * per_tree_edges) * T / max(
            1, (fs.n_down - fs.leaf_count) + (fs.n_up - 1) + fs.n_edges
        ),
    }
