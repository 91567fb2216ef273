"""The GP engine's two kernels: K7 (PLV population) and K8 (the
golden-section branch sweep). The counterpart of
libsbn_tpu/gp/engine_pallas.py.

K7 ``populate_plvs`` runs the whole population pass, the reference's
``GPDAG::PopulatePLVs`` program (gp_dag.cpp:218-263), as one kernel over two
host-built edge streams (``build_edge_streams``):

  * rootward: ``PH[dest] += q_g P_g p[src]`` with max-aligned log-scale
    accumulation; on a node's last in-edge ``p = phat * phattilde``,
    divided by its max over the 4 states per pattern;
  * root seeds: ``rhat = q_g / 4``, then ``r = rhat * phattilde`` and
    ``rtilde = rhat * phat``;
  * leafward: ``rhat[dest] += q_g P_g RB[src]``, finishing r and rtilde on
    a node's last in-edge.

Paired PLVs are packed as 2N-row slabs, PH = [phat; phattilde] and
RB = [r; rtilde], so the side and rotation choices are row arithmetic in
the streams. Log-scales are per (node, pattern), not the level route's one
scalar per node (gp/engine.py), so the two routes agree on scale-invariant
quantities (likelihood rows, marginals, swept branch lengths), not on the
PLV arrays themselves. P (E, 4, 4) comes from outside (engine.py
``_jc69_transition``, exp in f64).

K8 ``golden_sweep`` runs a fixed ``GOLDEN_ITERS``-iteration golden-section
search of each edge's log branch length on [MIN_LOG_BL, MAX_LOG_BL] against
the JC69 objective f(lb) = -sum_s w log(A + exp(-4/3 e^lb) B), where
A = (sum r)(sum p)/4 and B = sum r p - A per edge and pattern are built
outside the kernel (``sweep_stats``), then rejects a step that makes f
worse. It is the kernel route's sweep; the level route's sweep is the
safeguarded Newton-bisection of engine.py (``GPEngine._newton_sweep``).
The two are different searches and land on the same optimum to within
their tolerances, not bit for bit.

Each kernel has a plain PyTorch twin with the same layout and order of
operations (``populate_plvs_twin``, ``golden_sweep_twin``). The public
functions route by device: a CPU tensor goes to the twin, a CUDA tensor to
the kernel (csrc/gp_engine.cu), which raises on anything it cannot take.
Nothing falls back.

K7 on the card keeps a tile of up to 8 patterns' PLVs in shared memory, a
lane per (pattern, state), and its warps share each level's destination
groups (``stream_groups``); ``populate_onchip_plan`` chooses the tile from
the dtype and the DAG's sizes. A DAG where not even one pattern fits takes
the slab route, K7's first design over device-memory PLVs (a thread per
pattern), counted as ``populate_plvs_slab``. The route follows from the
shapes alone.

K8 on the card runs a block of SWEEP_WARPS warps per edge over the edge's
A and B rows and w staged once in shared memory, evaluating f at c and d
together and summing the warps' partials in a fixed order;
``golden_sweep_plan`` checks that the rows fit. Longer rows take the slab
route, K8's first design (a warp per edge over device-memory rows), counted
as ``golden_sweep_slab``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _kernels
from ..ops.pruning_jc import SHARED_LIMIT

NEG = -1e30  # log-scale "empty" sentinel: exp(NEG - m) underflows to 0
MIN_LOG_BL = -13.9
MAX_LOG_BL = 1.1
GOLDEN_ITERS = 70  # K8's fixed number of golden-section iterations
INVPHI = (math.sqrt(5.0) - 1.0) / 2.0

# Launch counts of the CUDA kernels and call counts of their twins, so a run
# can show which one it took. reset_counters() sets them all to 0.
LAUNCHES = {"populate_plvs": 0, "populate_plvs_slab": 0, "golden_sweep": 0,
            "golden_sweep_slab": 0}
TWIN_CALLS = {"populate_plvs": 0, "golden_sweep": 0}

# Patterns a tile of the on-chip K7 holds at most: a lane per (pattern,
# state), one warp.
POPULATE_TILE = 8
# Warps a block of the main K8, which sweeps one edge (csrc/gp_engine.cu
# kSweepWarps).
SWEEP_WARPS = 8

PLV_KEYS = ("p", "phat", "phattilde", "rhat", "r", "rtilde", "ls_p", "ls_phat",
            "ls_phattilde", "ls_rhat", "ls_r", "ls_rtilde")


def reset_counters():
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


class EdgeStreams(NamedTuple):
    """K7's instruction streams on one device (see build_edge_streams), and
    the offsets the on-chip K7 shares a level's rows out by
    (``stream_groups``)."""

    rootward: torch.Tensor  # (T_rw, 5) int32
    leafward: torch.Tensor  # (T_lw, 5) int32
    roots: torch.Tensor  # (R, 2) int32: (root node, root gpcsp)
    node_count: int
    rootward_groups: torch.Tensor  # (G_rw + 1,) int32 row offsets
    rootward_levels: torch.Tensor  # (V_rw + 1,) int32 group offsets
    leafward_groups: torch.Tensor  # (G_lw + 1,) int32
    leafward_levels: torch.Tensor  # (V_lw + 1,) int32


def build_edge_streams(engine):
    """Flatten the level schedules into two (T, 5) int32 streams.

    Rootward rows: (dest_row in PH, src node, gpcsp, finish_flag, node).
      dest_row = parent + rotated·N (phat vs phattilde half of PH).
    Leafward rows: (dest node in rhat, src_row in RB, gpcsp, finish_flag,
      node). src_row = parent + rotated·N (r vs rtilde half of RB).
    finish_flag marks the LAST in-edge of each node at its level (all of a
    node's in-edges live in one level; see subsplit_dag.level_schedules).
    Returns (rootward, leafward, roots) as numpy arrays."""
    N = engine.dag.node_count()

    def stream(levels, rootward):
        rows = []
        for level in levels:
            order = np.lexsort(
                (level["gpcsp"], level["parent" if rootward else "child"])
            )
            pa = level["parent"][order]
            ch = level["child"][order]
            rot = level["rotated"][order]
            g = level["gpcsp"][order]
            key = pa if rootward else ch
            last = np.r_[key[1:] != key[:-1], True]
            for i in range(len(order)):
                if rootward:
                    rows.append(
                        (pa[i] + (N if rot[i] else 0), ch[i], g[i],
                         int(last[i]), pa[i])
                    )
                else:
                    rows.append(
                        (ch[i], pa[i] + (N if rot[i] else 0), g[i],
                         int(last[i]), ch[i])
                    )
        return np.asarray(rows, dtype=np.int32).reshape(-1, 5)

    roots = np.stack(
        [engine.root_ids.astype(np.int32),
         engine.root_gpcsps.astype(np.int32)], axis=1
    )
    return (
        stream(engine.rootward_levels, True),
        stream(engine.leafward_levels, False),
        roots,
    )


def stream_groups(rows, level_sizes):
    """(groups, levels) of one stream: the row offsets of its destination
    groups (a group is the rows into one destination in one level, and
    ends at its finish flag) and, per level, the offsets of its groups.
    Every level ends a group, so the on-chip K7's warps can share a
    level's groups out and sync between levels."""
    ends = np.flatnonzero(rows[:, 3]) + 1
    level_ends = np.cumsum(np.asarray(level_sizes, dtype=np.int64))
    if len(rows) and not np.isin(level_ends, np.r_[0, ends]).all():
        raise ValueError("a stream level does not end at a finish flag")
    levels = np.searchsorted(ends, level_ends, side="right")
    return np.r_[0, ends], np.r_[0, levels]


def edge_streams(engine, device) -> EdgeStreams:
    """build_edge_streams as int32 tensors on ``device``, with the node
    count and the streams' group and level offsets; the host checks every
    index once here, so the kernel does not."""
    rw, lw, roots = build_edge_streams(engine)
    N = engine.dag.node_count()
    E = engine.dag.gpcsp_count_with_fake()
    # Exclusive upper bounds of the columns (dest, src, gpcsp, flag, node):
    # PH and RB rows run to 2N, node rows to N.
    for name, s, limits in (("rootward", rw, (2 * N, N, E, 2, N)),
                            ("leafward", lw, (N, 2 * N, E, 2, N)),
                            ("roots", roots, (N, E))):
        if len(s) and not ((s >= 0).all() and (s < np.array(limits)).all()):
            raise ValueError(f"{name} stream indices out of range")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    rw_groups = stream_groups(rw, [len(lv["parent"]) for lv in engine.rootward_levels])
    lw_groups = stream_groups(lw, [len(lv["parent"]) for lv in engine.leafward_levels])
    return EdgeStreams(t(rw), t(lw), t(roots), N, *map(t, rw_groups + lw_groups))


def _plv_dict(N, p, PH, rhat, RB, lsp, lsPH, lsrhat, lsRB):
    return {
        "p": p, "phat": PH[:N], "phattilde": PH[N:], "rhat": rhat,
        "r": RB[:N], "rtilde": RB[N:], "ls_p": lsp, "ls_phat": lsPH[:N],
        "ls_phattilde": lsPH[N:], "ls_rhat": lsrhat, "ls_r": lsRB[:N],
        "ls_rtilde": lsRB[N:],
    }


def plvs_from_numpy(plvs, device, dtype):
    """The JAX package's PLV dict (12 arrays, as numpy) as this package's
    tensors on ``device`` in ``dtype``: the state a sweep starts from."""
    return {k: torch.as_tensor(np.array(plvs[k])).to(device=device,
                                                       dtype=dtype)
            for k in PLV_KEYS}


def sweep_stats(plvs, e_parent, e_child, e_rot):
    """Per-edge JC69 likelihood decomposition rows (A, B), each (E, S):
    r P(b) p = A + e^{-4b/3} B with A = (sum r)(sum p)/4, B = sum r p - A,
    r the parent's r (or rtilde on a rotated edge) and p the child's p."""
    r_plv = torch.where(e_rot[:, None, None], plvs["rtilde"][e_parent],
                        plvs["r"][e_parent])
    p_plv = plvs["p"][e_child]
    D = torch.einsum("eis,eis->es", r_plv, p_plv)
    A = 0.25 * torch.sum(r_plv, dim=1) * torch.sum(p_plv, dim=1)
    return A, D - A


def populate_plvs(streams: EdgeStreams, q, P, tips):
    """The 12-entry PLV dict (N-row PLVs (N, 4, S), per-(node, pattern)
    log-scales (N, S)) from q (E,), P (E, 4, 4) and tips (L, 4, S): K7 for
    CUDA tensors, its twin for CPU tensors."""
    if tips.device.type == "cpu":
        return populate_plvs_twin(streams, q, P, tips)
    return populate_plvs_cuda(streams, q, P, tips)


def golden_sweep(A, B, w, cur_log_bl):
    """(E,) new log branch lengths from the rows A, B (E, S), weights w (S,)
    and the current log branch lengths (E,): K8 for CUDA tensors, its twin
    for CPU tensors."""
    if A.device.type == "cpu":
        return golden_sweep_twin(A, B, w, cur_log_bl)
    return golden_sweep_cuda(A, B, w, cur_log_bl)


# -- plain PyTorch twins ------------------------------------------------------


def populate_plvs_twin(streams: EdgeStreams, q, P, tips):
    """Plain PyTorch twin of K7: walks the streams one row at a time, every
    step vectorised over the patterns, in the kernel's order of operations."""
    TWIN_CALLS["populate_plvs"] += 1
    N = streams.node_count
    L, _, S = tips.shape
    dt, dev = tips.dtype, tips.device
    p = torch.zeros((N, 4, S), dtype=dt, device=dev)
    p[:L] = tips
    PH = torch.zeros((2 * N, 4, S), dtype=dt, device=dev)
    rhat = torch.zeros((N, 4, S), dtype=dt, device=dev)
    RB = torch.zeros((2 * N, 4, S), dtype=dt, device=dev)
    lsp = torch.zeros((N, S), dtype=dt, device=dev)
    lsPH = torch.full((2 * N, S), NEG, dtype=dt, device=dev)
    lsrhat = torch.full((N, S), NEG, dtype=dt, device=dev)
    lsRB = torch.zeros((2 * N, S), dtype=dt, device=dev)

    def accumulate(buf, ls, row, g, src, ls_c):
        """buf[row] += q_g P_g src at scale ls_c, max-aligned."""
        contrib = q[g] * (P[g] @ src)
        ls_cur = ls[row]
        m = torch.maximum(ls_cur, ls_c)
        buf[row] = buf[row] * torch.exp(ls_cur - m) + contrib * torch.exp(ls_c - m)
        ls[row] = m

    def finish(dst, lsdst, row, prod, ls_sum):
        """dst[row] = prod / max over states; the log-scale absorbs it."""
        scale = torch.amax(prod, dim=0)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        dst[row] = prod / scale
        lsdst[row] = ls_sum + torch.log(scale)

    def finish_r(node):
        rh, ls_rh = rhat[node], lsrhat[node]
        finish(RB, lsRB, node, rh * PH[node + N], ls_rh + lsPH[node + N])
        finish(RB, lsRB, node + N, rh * PH[node], ls_rh + lsPH[node])

    for dest, src, g, fin, node in streams.rootward.tolist():
        accumulate(PH, lsPH, dest, g, p[src], lsp[src])
        if fin:
            finish(p, lsp, node, PH[node] * PH[node + N],
                   lsPH[node] + lsPH[node + N])
    for node, g in streams.roots.tolist():
        rhat[node] = 0.25 * q[g]
        lsrhat[node] = 0.0
        finish_r(node)
    for dest, src, g, fin, _ in streams.leafward.tolist():
        accumulate(rhat, lsrhat, dest, g, RB[src], lsRB[src])
        if fin:
            finish_r(dest)
    return _plv_dict(N, p, PH, rhat, RB, lsp, lsPH, lsrhat, lsRB)


def objective(A, B, w, lb):
    """(E,) f(lb) = -sum_s w log(A + exp(-4/3 e^lb) B), the negative log
    likelihood of each edge at log branch lengths lb (E,)."""
    e = torch.exp((-4.0 / 3.0) * torch.exp(lb))
    return -torch.sum(torch.log(A + e[:, None] * B) * w, dim=1)


def sweep_disagreement(A, B, w, got, want, step=1e-3, flat=1e-9):
    """How far two sweeps' log branch lengths (E,) got and want are apart,
    for the rows A, B and weights w, all evaluated in f64:
    (the largest |f(got) - f(want)| / (|f(want)| + sum(w)), the largest
    |got - want| over the edges whose objective is not flat, the largest
    |f(got) - f(want)|).

    An edge is flat where the objective's second difference at ``step``
    around ``want`` is at most ``flat`` (|f| + sum(w)). A golden section
    resolves the minimiser only to about sqrt(eps): near it f(c) - f(d)
    falls below the rounding of f, so two summation orders may take
    different brackets and end apart by that much, and by anything at all
    on a flat edge; the objective's value is what they must agree on. The
    scale |f| + sum(w) bounds the rounding of f, which is relative per
    pattern (an edge whose rows are all near 1 has f near 0)."""
    A, B, w = A.double(), B.double(), w.double()
    got, want = got.double(), want.double()
    fg, fw = objective(A, B, w, got), objective(A, B, w, want)
    scale = fw.abs() + w.sum()
    gap = (fg - fw).abs()
    curv = (objective(A, B, w, want + step) + objective(A, B, w, want - step)
            - 2 * fw) / scale
    sharp = curv.abs() > flat
    lb_gap = (got - want).abs()[sharp].max() if bool(sharp.any()) else 0.0
    return float((gap / scale).max()), float(lb_gap), float(gap.max())


def golden_sweep_twin(A, B, w, cur_log_bl):
    """Plain PyTorch twin of K8, vectorised over the edges."""
    TWIN_CALLS["golden_sweep"] += 1
    cur = cur_log_bl
    fcur = objective(A, B, w, cur)
    a = torch.full_like(cur, MIN_LOG_BL)
    b = torch.full_like(cur, MAX_LOG_BL)
    c = b - INVPHI * (b - a)
    d = a + INVPHI * (b - a)
    fc, fd = objective(A, B, w, c), objective(A, B, w, d)
    for _ in range(GOLDEN_ITERS):
        left = fc < fd
        b, a = torch.where(left, d, b), torch.where(left, a, c)
        c = b - INVPHI * (b - a)
        d = a + INVPHI * (b - a)
        fc, fd = objective(A, B, w, c), objective(A, B, w, d)
    best = torch.where(fc < fd, c, d)
    fbest = torch.minimum(fc, fd)
    return torch.where(fbest < fcur, best, cur)


# -- CUDA kernels (csrc/gp_engine.cu) -----------------------------------------


def _check(tensors, dt, dev):
    for name, x, want in tensors:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype != (want or dt):
            raise TypeError(f"{name} is {x.dtype}, expected {want or dt}")


def _working(x):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"working dtype must be float32 or float64, got {x.dtype}")
    return x.dtype, x.device


def populate_onchip_bytes(itemsize, N, E, T_rw, T_lw, R, TP):
    """Shared-memory bytes of the on-chip K7 for a tile of TP patterns, as
    csrc/gp_engine.cu populate_onchip_bytes carves them: P and q (17 E
    values), the tile's PLVs p, PH, rhat and RB (24 N values a pattern) and
    their log-scales (6 N a pattern), and in int32 the three streams and,
    reserved at their most, each stream's group and level offsets
    (2 (T + 1) each)."""
    ints = 7 * T_rw + 7 * T_lw + 2 * R + 4
    return itemsize * (30 * N * TP + 17 * E) + 4 * ints


def populate_onchip_plan(dtype, N, E, T_rw, T_lw, R):
    """(TP, shared bytes) of the on-chip K7 for a DAG of N nodes, E GPCSPs,
    T_rw rootward and T_lw leafward stream rows and R rootsplits: the largest
    tile TP <= POPULATE_TILE whose state fits in SHARED_LIMIT, or None when
    not even one pattern fits (the slab route)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for TP in range(POPULATE_TILE, 0, -1):
        need = populate_onchip_bytes(itemsize, N, E, T_rw, T_lw, R, TP)
        if need <= SHARED_LIMIT:
            return TP, need
    return None


def populate_plvs_cuda(streams: EdgeStreams, q, P, tips):
    """K7 on the card: the 12-entry PLV dict (see populate_plvs). On chip
    when populate_onchip_plan fits, else the slab route."""
    dt, dev = _working(tips)
    i32 = torch.int32
    _check([("rootward", streams.rootward, i32),
            ("leafward", streams.leafward, i32), ("roots", streams.roots, i32),
            ("rootward_groups", streams.rootward_groups, i32),
            ("rootward_levels", streams.rootward_levels, i32),
            ("leafward_groups", streams.leafward_groups, i32),
            ("leafward_levels", streams.leafward_levels, i32),
            ("q", q, None), ("P", P, None), ("tips", tips, None)], dt, dev)
    E = q.shape[0]
    L, four, S = tips.shape
    N = streams.node_count
    if q.dim() != 1 or P.shape != (E, 4, 4) or four != 4:
        raise ValueError(f"need q (E,), P (E, 4, 4), tips (L, 4, S); got "
                         f"{tuple(q.shape)}, {tuple(P.shape)}, {tuple(tips.shape)}")
    if S < 1 or L > N:
        raise ValueError(f"{S} patterns, {L} tips for {N} nodes")
    plan = populate_onchip_plan(dt, N, E, streams.rootward.shape[0],
                                streams.leafward.shape[0], streams.roots.shape[0])
    return _populate_plvs_launch(streams, q, P, tips, plan)


def _populate_plvs_launch(streams: EdgeStreams, q, P, tips, plan):
    """K7 on chip with ``plan`` (TP, shared bytes), or its slab route when
    plan is None; inputs checked by the caller."""
    dt, dev = tips.dtype, tips.device
    E = q.shape[0]
    L, _, S = tips.shape
    N = streams.node_count
    lib = _kernels.load("gp_engine")
    p = torch.empty((N, 4, S), dtype=dt, device=dev)
    PH = torch.empty((2 * N, 4, S), dtype=dt, device=dev)
    rhat = torch.empty_like(p)
    RB = torch.empty_like(PH)
    lsp = torch.empty((N, S), dtype=dt, device=dev)
    lsPH = torch.empty((2 * N, S), dtype=dt, device=dev)
    lsrhat = torch.empty_like(lsp)
    lsRB = torch.empty_like(lsPH)
    rows = (streams.rootward, streams.leafward, streams.roots)
    if plan is None:
        key, name, offsets = "populate_plvs_slab", "lsbn_gp_populate_slab", ()
    else:
        key, name = "populate_plvs", "lsbn_gp_populate"
        offsets = (streams.rootward_groups, streams.rootward_levels,
                   streams.leafward_groups, streams.leafward_levels)
    fn = getattr(lib, f"{name}_{'f32' if dt == torch.float32 else 'f64'}")
    outs = (p, PH, rhat, RB, lsp, lsPH, lsrhat, lsRB)
    with torch.cuda.device(dev):
        rc = fn(
            *(x.data_ptr() for x in rows + offsets + (q, P, tips) + outs),
            *(x.shape[0] for x in rows), *(x.shape[0] - 1 for x in offsets),
            E, N, L, S, *(plan or ()), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(lib, rc, "GP populate kernel"
                   + (" (slab route)" if plan is None else ""))
    LAUNCHES[key] += 1
    return _plv_dict(N, p, PH, rhat, RB, lsp, lsPH, lsrhat, lsRB)


def golden_sweep_bytes(itemsize, S):
    """Shared-memory bytes of the main K8 for rows of S patterns, as
    csrc/gp_engine.cu golden_sweep_bytes carves them: the edge's A and B
    rows and w (3 S values), then two buffers of SWEEP_WARPS pairs of warp
    sums."""
    return itemsize * (3 * S + 2 * 2 * SWEEP_WARPS)


def golden_sweep_plan(dtype, S):
    """Shared-memory bytes of the main K8 (a block per edge, its rows staged
    in shared memory) for rows of S patterns, or None when they do not fit
    in SHARED_LIMIT (float32: beyond 19,360 patterns, float64: 9,674), and
    the rows take the slab route."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = golden_sweep_bytes(itemsize, S)
    return need if need <= SHARED_LIMIT else None


def golden_sweep_cuda(A, B, w, cur_log_bl):
    """K8 on the card: (E,) new log branch lengths (see golden_sweep). A
    block per edge over rows staged in shared memory when golden_sweep_plan
    fits, else the slab route."""
    dt, dev = _working(A)
    _check([("A", A, None), ("B", B, None), ("w", w, None),
            ("cur_log_bl", cur_log_bl, None)], dt, dev)
    E, S = A.shape
    if B.shape != (E, S) or w.shape != (S,) or cur_log_bl.shape != (E,):
        raise ValueError(f"need A, B (E, S), w (S,), cur (E,); got "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(w.shape)}, "
                         f"{tuple(cur_log_bl.shape)}")
    if E < 1 or S < 1:
        raise ValueError(f"need E >= 1 edges and S >= 1 patterns, got {E}, {S}")
    return _golden_sweep_launch(A, B, w, cur_log_bl, golden_sweep_plan(dt, S))


def _golden_sweep_launch(A, B, w, cur_log_bl, plan):
    """K8 with ``plan`` (shared bytes), or its slab route when plan is
    None; inputs checked by the caller."""
    dt, dev = A.dtype, A.device
    E, S = A.shape
    lib = _kernels.load("gp_engine")
    out = torch.empty((E,), dtype=dt, device=dev)
    if plan is None:
        key, name, extra = "golden_sweep_slab", "lsbn_gp_golden_sweep_slab", ()
    else:
        key, name, extra = "golden_sweep", "lsbn_gp_golden_sweep", (plan,)
    fn = getattr(lib, f"{name}_{'f32' if dt == torch.float32 else 'f64'}")
    with torch.cuda.device(dev):
        rc = fn(A.data_ptr(), B.data_ptr(), w.data_ptr(), cur_log_bl.data_ptr(),
                out.data_ptr(), E, S, *extra,
                torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, rc, "GP golden-section sweep kernel"
                   + (" (slab route)" if plan is None else ""))
    LAUNCHES[key] += 1
    return out
