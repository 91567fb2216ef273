"""The generalized-pruning engine: batched passes over the subsplit DAG.

The counterpart of libsbn_tpu/gp/engine.py. The reference interprets a
10-op ISA one op at a time (gp_engine.cpp ProcessOperations); here each GP
computation is a handful of batched tensor passes over device-resident PLV
tensors (N, 4, patterns). Two routes populate the PLVs and sweep the
branch lengths, chosen by ``use_kernels``:

  * the kernel route (``use_kernels=True``, the default on a CUDA device):
    K7 populates every PLV in one launch and K8 sweeps every edge with a
    fixed golden-section search (gp/engine_kernels.py, csrc/gp_engine.cu;
    their plain PyTorch twins on the CPU). Log-scales are per (node,
    pattern), shape (N, S);
  * the level route (``use_kernels=False``, the default on the CPU; on the
    card an explicit choice and the f64 oracle): the DAG's level schedules
    (subsplit_dag.level_schedules) drive per-level gathers, ``index_add_``
    and ``scatter_reduce`` in torch ops, with one log-scale per (kind,
    node), shape (N,) -- the continuous analog of the reference's integer
    rescaling counts (gp_engine.cpp:288-324); the sweep is a vectorised
    safeguarded Newton-bisection on the analytic derivative
    (``_newton_sweep``).

Everything downstream of the PLVs (likelihood rows, marginals, the
coordinate ascent, SBN estimation, hybrid marginals) is shared and
broadcasts either log-scale form. State follows the JAX package:
``branch_lengths`` and ``q`` are numpy attributes that callers may assign;
the PLVs stay tensors on the engine's device.

A mesh with an "sp" axis (``mesh=``, parallel/sharding.py) splits the
pattern axis over its sp devices: each shard is an engine over its own
patterns, resident on its device, padded to equal widths with copies of
the last pattern at weight 0 (as the streamed ascent pads). Population is
independent per pattern, so each shard populates on its own (K7 a shard
on the kernel route); the marginal is the sum of the shards' marginals,
and a sweep gathers the shards' per-edge rows A and B (E x S, far smaller
than the PLVs) onto the first device and sweeps there once (K8 on the
kernel route). ``run_branch_ascent`` and ``populate_plvs`` run on the
shards; the PLVs they leave in ``plvs`` are the shards' gathered onto the
first device with per-(node, pattern) log-scales, for the calls that read
them (likelihood rows, hybrid marginals, single-edge derivatives), and the
streamed ascent runs on the first device.

On a card with a single shard (``cuda_graphs=True``, the default),
``run_branch_ascent`` replays captured CUDA graphs of its phases
(gp/ascent_graph.py), the counterpart of the JAX package's one-program
ascent; ``cuda_graphs=False`` runs the eager host loop.

Substitution model: JC69, matching gp_engine.hpp:144-155.
"""

from __future__ import annotations

import copy
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..ops import substitution
from ..parallel.sharding import check_mesh, pad_to_multiple, pattern_sharding
from ..utils.device import DEFAULT_DEVICE, compute_device
from . import ascent_graph, engine_kernels, hybrid_graph, streamed_graph
from .engine_kernels import MAX_LOG_BL, MIN_LOG_BL

DEFAULT_BRANCH_LENGTH = 0.1
NEWTON_ITERS = 64  # cap on the Newton-bisection iterations of one sweep


def _jc69_evolve(bl, v):
    """Matrix-free JC69 transition apply: P(bl) v = e v + (1-e)/4 sum_i v_i
    per edge, with e = exp(-4 bl / 3) in f64 (BASELINE.md precision
    policy), then cast. bl: (E,); v: (E, 4, S)."""
    e = torch.exp((-4.0 / 3.0) * bl.to(torch.float64)).to(v.dtype)
    return (e[:, None, None] * v
            + (0.25 * (1.0 - e))[:, None, None] * v.sum(dim=1, keepdim=True))


def _jc69_transition(bl, eigen=None):
    """(E,) branch lengths -> (E, 4, 4) JC69 transition matrices, the
    exponential in f64 and cast back (BASELINE.md precision policy). eigen:
    substitution.jc69_eigen in bl's dtype and device, made ahead (a CUDA
    graph cannot copy its constants from the host)."""
    if eigen is None:
        eigen = substitution.jc69_eigen(dtype=bl.dtype, device=bl.device)
    _, evec, ivec, evals = eigen
    expo = torch.exp(
        bl.to(torch.float64)[..., None] * evals.to(torch.float64)
    ).to(bl.dtype)
    return torch.einsum("ij,...j,jk->...ik", evec, expo, ivec)


def _b(x):
    """Per-node log-scales (N,) of the level route broadcast like K7's
    per-(node, pattern) rows (N, S)."""
    return x[:, None] if x.dim() == 1 else x


class GPEngine:
    def __init__(
        self,
        site_pattern: SitePattern,
        dag,
        sbn_prior: np.ndarray,
        unconditional_node_probabilities: np.ndarray,
        inverted_sbn_prior: np.ndarray,
        rescaling_threshold: float = 1e-40,  # kept for API parity; unused
        dtype=torch.float64,
        device=DEFAULT_DEVICE,
        use_kernels="auto",
        mesh=None,
        cuda_graphs=True,
    ):
        """mesh: a parallel.sharding.Mesh whose devices take the place of
        ``device``; its sp axis splits the patterns (module docstring).
        cuda_graphs: on a CUDA device with one shard, run_branch_ascent
        replays captured graphs of its phases; False runs it eagerly."""
        if mesh is not None:
            device = check_mesh(mesh).first_device
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        device = compute_device(device)
        if use_kernels == "auto":
            use_kernels = device.type == "cuda"
        self.use_kernels = bool(use_kernels)
        self.dag = dag
        self.dtype = dtype
        self.device = device
        self.site_pattern = site_pattern
        self.weights = np.asarray(site_pattern.weights)
        self.tips = np.asarray(site_pattern.tip_partials())  # (L, 4, S)
        self.patterns = self.tips.shape[-1]
        self.q = np.asarray(sbn_prior, dtype=np.float64).copy()
        self.unconditional_node_probabilities = np.asarray(
            unconditional_node_probabilities
        )
        self.inverted_sbn_prior = np.asarray(inverted_sbn_prior)
        E = dag.gpcsp_count_with_fake()
        self.branch_lengths = np.full(E, DEFAULT_BRANCH_LENGTH)
        self.log_likelihood_rows = torch.full(
            (E, self.patterns), -np.inf, dtype=dtype, device=device)
        self.log_marginal_per_site = np.full(self.patterns, -np.inf)
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)
        self.last_ascent_converged = None
        self.cuda_graphs = cuda_graphs
        # The ascent's phase graphs (gp/ascent_graph.py), made at the first
        # graphed ascent; the hybrid marginals' programs
        # (gp/hybrid_graph.py), made at the first graphed call; the MB the
        # last graphed streamed ascent's graphs held (gp/streamed_graph.py).
        self.graphs = None
        self.hybrid_graphs = None
        self.last_streamed_graphs = None

        self.rootward_levels, self.leafward_levels = dag.level_schedules()
        self.root_ids = np.asarray(dag.rootsplit_node_ids(), dtype=np.int32)
        self.root_gpcsps = np.asarray(
            [dag.rootsplit_index_of_id(int(r)) for r in self.root_ids],
            dtype=np.int32,
        )
        # All non-self-loop edges in one flat listing.
        edges = dag.edge_list()
        self.e_parent = np.asarray([e[0] for e in edges], dtype=np.int32)
        self.e_child = np.asarray([e[1] for e in edges], dtype=np.int32)
        self.e_rot = np.asarray([e[2] for e in edges], dtype=bool)
        self.e_gpcsp = np.asarray([e[3] for e in edges], dtype=np.int32)
        self.plvs: Dict[str, torch.Tensor] = {}
        self._upload(device, self.tips, self.weights)
        self._shards = [self]
        sp = 1 if mesh is None else mesh.shape["sp"]
        if sp > 1:
            tips, _ = pad_to_multiple(self.tips, sp, axis=-1)
            w = np.concatenate([self.weights,
                                np.zeros(tips.shape[-1] - self.patterns)])
            sharding = pattern_sharding(mesh)
            self._shards = [
                self._shard(d, t, x) for d, t, x in zip(
                    sharding.devices, sharding.split(tips),
                    sharding.split(w))]

    def _upload(self, device, tips, weights):
        """The engine's tensors on ``device``: tips (L, 4, S) and weights
        (S,) in the working dtype, and the DAG's index tensors."""

        def t(a, dt=torch.long):
            return torch.as_tensor(a, device=device).to(dt)

        self.device = device
        self._tips = t(tips, self.dtype)
        self._w = t(weights, self.dtype)
        self._pa, self._ch = t(self.e_parent), t(self.e_child)
        self._rot, self._g = t(self.e_rot, torch.bool), t(self.e_gpcsp)
        self._ri, self._rg = t(self.root_ids), t(self.root_gpcsps)
        self._jc69 = substitution.jc69_eigen(dtype=self.dtype, device=device)
        self._build_level_tensors()
        self._streams = None  # K7's edge streams, built at first use

    def _shard(self, device, tips, weights):
        """A shallow copy of this engine over one pattern shard, its
        tensors on ``device``."""
        shard = copy.copy(self)
        shard.patterns = tips.shape[-1]
        shard._upload(device, tips, weights)
        shard._shards = [shard]
        return shard

    # -- PLV population ------------------------------------------------------
    def _build_level_tensors(self):
        """Per-level index tensors on the device. Rootward level: (dest row
        of PH = parent + rotated N, child, gpcsp, the level's parents).
        Leafward level: (child, source row of RB = parent + rotated N,
        gpcsp, the level's children). Every node's in-edges lie in one
        level (its own), so each level finishes its nodes."""
        N = self.dag.node_count()

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self._rw_levels = [
            (t(lv["parent"] + N * lv["rotated"]), t(lv["child"]),
             t(lv["gpcsp"]), t(np.unique(lv["parent"])))
            for lv in self.rootward_levels
        ]
        self._lw_levels = [
            (t(lv["child"]), t(lv["parent"] + N * lv["rotated"]),
             t(lv["gpcsp"]), t(np.unique(lv["child"])))
            for lv in self.leafward_levels
        ]

    def _populate_levels(self, bl, q, tips=None):
        """The level route: the 12-entry PLV dict with per-node scalar
        log-scales. Within a level, the edges into one PLV row align their
        scales to the smallest child scale (scatter_reduce amin) and
        accumulate with index_add_; the finished node's PLV is divided by
        its max over states and patterns. ``tips`` (L, 4, S) defaults to
        the engine's, all patterns."""
        N = self.dag.node_count()
        L = self.dag.taxon_count
        tips = self._tips if tips is None else tips
        S = tips.shape[-1]
        dt, dev = bl.dtype, bl.device
        inf = float("inf")

        p = torch.zeros((N, 4, S), dtype=dt, device=dev)
        p[:L] = tips
        ls_p = torch.zeros(N, dtype=dt, device=dev)
        PH = torch.zeros((2 * N, 4, S), dtype=dt, device=dev)
        ls_PH = torch.zeros(2 * N, dtype=dt, device=dev)

        def normalized(x):
            """(x / its max over states and patterns, that max), max 0 -> 1."""
            mx = torch.amax(x, dim=(1, 2))
            mx = torch.where(mx > 0, mx, torch.ones_like(mx))
            return x / mx[:, None, None], mx

        def accumulate(buf, ls_buf, dest, g, src, ls_src):
            contrib = q[g][:, None, None] * _jc69_evolve(bl[g], src)
            m = torch.full((buf.shape[0],), inf, dtype=dt, device=dev)
            m = m.scatter_reduce(0, dest, ls_src, "amin")[dest]
            factor = torch.exp(ls_src - m)
            buf.index_add_(0, dest, contrib * factor[:, None, None])
            ls_buf[dest] = m

        for dest, ch, g, nodes in self._rw_levels:
            accumulate(PH, ls_PH, dest, g, p[ch], ls_p[ch])
            p[nodes], mx = normalized(PH[nodes] * PH[nodes + N])
            ls_p[nodes] = ls_PH[nodes] + ls_PH[nodes + N] + torch.log(mx)

        # Leafward: rhat at rootsplits = q * stationary; descend by level.
        rhat = torch.zeros((N, 4, S), dtype=dt, device=dev)
        ls_rhat = torch.zeros(N, dtype=dt, device=dev)
        rhat[self._ri] = (0.25 * q[self._rg])[:, None, None].expand(-1, 4, S)
        RB = torch.zeros((2 * N, 4, S), dtype=dt, device=dev)
        ls_RB = torch.zeros(2 * N, dtype=dt, device=dev)

        def finish_r(nodes):
            RB[nodes], mx_r = normalized(rhat[nodes] * PH[nodes + N])
            RB[nodes + N], mx_rt = normalized(rhat[nodes] * PH[nodes])
            ls_RB[nodes] = ls_rhat[nodes] + ls_PH[nodes + N] + torch.log(mx_r)
            ls_RB[nodes + N] = ls_rhat[nodes] + ls_PH[nodes] + torch.log(mx_rt)

        finish_r(self._ri)
        for ch, src, g, nodes in self._lw_levels:
            accumulate(rhat, ls_rhat, ch, g, RB[src], ls_RB[src])
            finish_r(nodes)
        return {
            "p": p, "phat": PH[:N], "phattilde": PH[N:], "rhat": rhat,
            "r": RB[:N], "rtilde": RB[N:], "ls_p": ls_p, "ls_phat": ls_PH[:N],
            "ls_phattilde": ls_PH[N:], "ls_rhat": ls_rhat, "ls_r": ls_RB[:N],
            "ls_rtilde": ls_RB[N:],
        }

    def _edge_streams(self):
        if self._streams is None:
            self._streams = engine_kernels.edge_streams(self, self.device)
        return self._streams

    def _populate(self, bl, q, tips=None):
        """The PLV dict for branch lengths bl (E,) and SBN parameters q (E,),
        tensors on the device in the working dtype, by the engine's route,
        over ``tips`` (L, 4, S; default: the engine's, all patterns)."""
        tips = self._tips if tips is None else tips
        if self.use_kernels:
            return engine_kernels.populate_plvs(
                self._edge_streams(), q,
                _jc69_transition(bl, self._jc69).contiguous(), tips)
        return self._populate_levels(bl, q, tips)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    # -- pattern shards (a mesh's sp axis; one shard, the engine, otherwise) --
    def _populate_shards(self, bl, q):
        """Each shard's PLV dict at bl and q (tensors on the first device),
        populated on the shard's device."""
        return [s._populate(bl.to(s.device), q.to(s.device))
                for s in self._shards]

    def _marginal_of_shards(self, plvs, q):
        """The marginal (a 0-dim tensor on the first device) of the shards'
        PLVs: their marginals added in shard order."""
        total = None
        for s, p in zip(self._shards, plvs):
            m = s._marginal_of_plvs(p, q.to(s.device)).to(self.device)
            total = m if total is None else total + m
        return total

    def _sweep_shards(self, plvs, bl):
        """New branch lengths from one sweep against the shards' frozen
        PLVs: their rows A and B gathered onto the first device without the
        padding (weight 0, so it adds nothing to a sweep's sums, and the
        sweep then sums the unsharded sweep's terms in its order), one
        sweep there."""
        rows = [engine_kernels.sweep_stats(p, s._pa, s._ch, s._rot)
                for s, p in zip(self._shards, plvs)]
        if len(rows) == 1:
            A, B = rows[0]
        else:
            A, B = (torch.cat([r[i].to(self.device) for r in rows],
                              dim=-1)[:, :self.patterns] for i in (0, 1))
        return self._sweep_rows(A, B, self._w, bl)

    def _gathered(self, plvs):
        """The shards' PLV dicts as one on the first device, without the
        padding: log-scales per (node, pattern), the level route's per-node
        ones broadcast over their shard's patterns."""
        if len(plvs) == 1:
            return plvs[0]
        out = {}
        for key in plvs[0]:
            parts = []
            for s, p in zip(self._shards, plvs):
                x = p[key]
                if x.dim() == 1:
                    x = x[:, None].expand(-1, s.patterns)
                parts.append(x.to(self.device))
            out[key] = torch.cat(parts, dim=-1)[..., :self.patterns]
        return out

    def populate_plvs(self):
        plvs = self._gathered(self._populate_shards(
            self._tensor(self.branch_lengths), self._tensor(self.q)))
        self.plvs = plvs
        # PLV sanitization (the reference asserts finiteness per op,
        # gp_engine.cpp:298-300): one device-side check, one scalar read.
        finite = bool(
            torch.isfinite(plvs["p"]).all()
            & torch.isfinite(plvs["r"]).all()
            & torch.isfinite(plvs["rtilde"]).all()
        )
        if not finite:
            raise FloatingPointError(
                "Non-finite values in GP PLVs; check branch lengths and "
                "SBN parameters."
            )

    # -- likelihoods ---------------------------------------------------------
    def _root_rows(self, plvs, q):
        """(R, S) log(q_root / 4 sum_i p_i) + log-scale of p, per rootsplit."""
        rp = plvs["p"][self._ri]
        return (torch.log(0.25 * q[self._rg][:, None] * torch.sum(rp, dim=1))
                + _b(plvs["ls_p"][self._ri]))

    def _likelihood_rows(self, plvs, bl, q):
        """(E_total, S) log-likelihood rows + per-site log marginal; the
        log-scales broadcast from either form, (N,) or (N, S)."""
        pa, ch, g = self._pa, self._ch, self._g
        rot = self._rot
        rot_s = rot if plvs["ls_r"].dim() == 1 else rot[:, None]
        r_plv = torch.where(rot[:, None, None], plvs["rtilde"][pa],
                            plvs["r"][pa])
        ls_rsrc = torch.where(rot_s, plvs["ls_rtilde"][pa], plvs["ls_r"][pa])
        lik = torch.sum(r_plv * _jc69_evolve(bl[g], plvs["p"][ch]), dim=1)
        rows_edges = torch.log(lik) + _b(ls_rsrc) + _b(plvs["ls_p"][ch])
        root_rows = self._root_rows(plvs, q)
        log_marginal = torch.logsumexp(root_rows, dim=0)
        # Conditional per-rootsplit rows (log-divide by rootsplit prob).
        root_rows = root_rows - torch.log(q[self._rg])[:, None]
        E = self.dag.gpcsp_count_with_fake()
        rows = torch.full((E, self.patterns), -np.inf, dtype=bl.dtype,
                          device=bl.device)
        rows[g] = rows_edges
        rows[self._rg] = root_rows
        return rows, log_marginal

    def compute_likelihoods(self):
        rows, log_marginal = self._likelihood_rows(
            {k: v.to(self.dtype) for k, v in self.plvs.items()},
            self._tensor(self.branch_lengths), self._tensor(self.q),
        )
        # Rows stay on the device ((E, patterns) -- large); the per-site
        # marginal is small and is what the convergence loop polls.
        self.log_likelihood_rows = rows
        self.log_marginal_per_site = log_marginal.cpu().numpy()

    def get_log_marginal_likelihood(self) -> float:
        return float(np.sum(self.log_marginal_per_site * self.weights))

    def get_per_gpcsp_log_likelihoods(self) -> np.ndarray:
        rows = self.log_likelihood_rows
        return (rows.to(torch.float64)
                @ torch.as_tensor(self.weights, device=rows.device)).cpu().numpy()

    def get_per_gpcsp_components_of_full_log_marginal(self) -> np.ndarray:
        return (
            self.get_per_gpcsp_log_likelihoods()
            + self.site_pattern.site_count() * np.log(self.q)
        )

    # -- coordinate ascent ----------------------------------------------------
    def _marginal_of_plvs(self, plvs, q, w=None):
        """Marginal log likelihood (a 0-dim tensor) from populated PLVs
        (root rows only -- skips the full (E, S) likelihood rows), under
        pattern weights ``w`` (default: the engine's)."""
        per_site = torch.logsumexp(self._root_rows(plvs, q), dim=0)
        return torch.sum(per_site * (self._w if w is None else w))

    def run_branch_ascent_streamed(
        self, tol: float, max_iter: int, pattern_chunk: int,
        memmap_dir: str | None = None, finalize: bool = True,
        rtol: float = 0.0,
    ):
        """EstimateBranchLengths with PLVs that never fully materialize on
        the device: the pattern axis streams through in chunks of
        ``pattern_chunk``, so device memory is O(nodes x chunk) instead of
        O(nodes x patterns). This is the capacity role of the reference's
        disk-mmapped PLV arena (mmapped_plv.hpp:19-47, gp_instance.cpp:32):
        the device holds one chunk's PLVs, populated by the engine's route
        (K7 on the kernel route), and the per-edge Newton statistics (A, B)
        live in host RAM, or in a disk-backed np.memmap under
        ``memmap_dir``, removed at the end.

        The sweep is the JAX package's: a safeguarded Newton-bisection per
        edge on the host over chunk-accumulated derivatives, reject-if-worse
        against chunk-accumulated objectives, and the step damped by halves
        down to 1/64 until the marginal does not fall; whatever the route,
        never K8's golden section. Exactness: populate is independent per
        pattern, the Newton derivative phi = sum_s w B/(A+uB) is
        scale-invariant per pattern, and the per-chunk scale constants
        cancel in reject-if-worse, so a streamed fit matches the in-memory
        Newton ascent (the level route) to float tolerance. The last chunk
        is padded with copies of the last pattern at zero weight. ``finalize``
        repopulates at full width and computes the likelihood rows.
        Returns (marginal, sweeps).

        On a CUDA device with cuda_graphs, each chunk call replays a
        captured graph of its program (gp/streamed_graph.py), made for the
        call and dropped at its end (``last_streamed_graphs`` then holds
        their pool's and buffers' MB); cuda_graphs=False runs them
        eagerly."""
        return self._run_streamed(
            tol, max_iter, pattern_chunk, memmap_dir, finalize, rtol,
            graphed=self.cuda_graphs and self.device.type == "cuda")

    def _run_streamed(self, tol, max_iter, pattern_chunk, memmap_dir,
                      finalize, rtol, graphed):
        """run_branch_ascent_streamed with its chunk programs eager or, with
        ``graphed``, over static buffers as graphs (on the CPU: the same
        functions over the same buffers, called as they are)."""
        if pattern_chunk < 1:
            raise ValueError(f"pattern_chunk must be >= 1, got {pattern_chunk}")
        dt = np.float64 if self.dtype == torch.float64 else np.float32
        S = self.patterns
        C = -(-S // pattern_chunk)
        Sp = C * pattern_chunk
        tips = np.asarray(self.tips, dt)
        w = np.asarray(self.weights, dt)
        if Sp != S:
            # Pad with copies of the last pattern at weight 0: all-ones tips
            # (the JAX package's padding) dwarf the real patterns' partials,
            # and the level route's one log-scale per node then underflows
            # them (a 600-taxon tree: a marginal of -inf).
            tips = np.pad(tips, ((0, 0), (0, 0), (0, Sp - S)), mode="edge")
            w = np.concatenate([w, np.zeros(Sp - S, dt)])
        tips_c = np.ascontiguousarray(np.moveaxis(
            tips.reshape(*tips.shape[:-1], C, pattern_chunk), -2, 0))
        w_c = w.reshape(C, pattern_chunk)  # (C, L, 4, chunk), (C, chunk)
        E = len(self.e_gpcsp)
        tmp = None
        if memmap_dir is not None:
            tmp = tempfile.NamedTemporaryFile(
                dir=memmap_dir, suffix=".gp_ab", delete=False)
            tmp.close()
            AB = np.memmap(tmp.name, dtype=dt, mode="w+", shape=(2, E, Sp))
        else:
            AB = np.empty((2, E, Sp), dt)
        try:
            cur, sweeps, self.branch_lengths = self._streamed_ascent(
                AB, tips_c, w_c, tol, max_iter, rtol, graphed)
        finally:
            if tmp is not None:
                del AB
                os.unlink(tmp.name)
        if finalize:
            # Materialize full-width PLVs and rows for downstream consumers;
            # skip (finalize=False) when they would not fit on the device.
            self.populate_plvs()
            self.compute_likelihoods()
        return cur, sweeps

    def _streamed_ascent(self, AB, tips_c, w_c, tol, max_iter, rtol,
                         graphed):
        """The chunked ascent of run_branch_ascent_streamed over the (2, E,
        C chunk) statistics array AB, its chunk programs eager or, with
        ``graphed``, replays of their graphs (gp/streamed_graph.py); returns
        (marginal, sweeps, branch lengths)."""
        programs = (streamed_graph.StreamedGraphs if graphed
                    else streamed_graph.StreamedEager)(self, AB, tips_c, w_c)
        try:
            return self._streamed_loop(programs, tol, max_iter, rtol)
        finally:
            programs.close()
            if graphed:
                self.last_streamed_graphs = {
                    "pool_mb": programs.pool_mb,
                    "buffers_mb": programs.buffers_mb}

    def _streamed_loop(self, programs, tol, max_iter, rtol):
        """The JAX package's host loop of the streamed ascent over the chunk
        programs' refresh (A and B, the marginal), phi and obj."""
        dt = programs.np_dtype
        E = programs.E
        refresh_ab, acc_phi, acc_obj = (programs.refresh, programs.phi,
                                        programs.obj)

        c_jc = 4.0 / 3.0

        def u_of(log_bl):
            return np.exp(-c_jc * np.exp(log_bl))

        ulo = u_of(MAX_LOG_BL)
        uhi = u_of(MIN_LOG_BL)
        tol_u = 1e-12 if dt == np.float64 else 1e-7
        g = np.asarray(self.e_gpcsp)

        def newton_sweep(bl_np):
            phi_lo, _ = acc_phi(np.full(E, ulo))
            phi_hi, _ = acc_phi(np.full(E, uhi))
            at_max = phi_lo <= 0  # f decreasing everywhere: b at MAX_LOG_BL
            at_min = phi_hi >= 0  # f increasing everywhere: b at MIN_LOG_BL
            u = np.clip(u_of(np.log(bl_np[g])), ulo, uhi)
            lo = np.full(E, ulo)
            hi = np.full(E, uhi)
            active = ~(at_max | at_min)
            for _ in range(NEWTON_ITERS):
                if not active.any():
                    break
                phi, dphi = acc_phi(u)
                lo = np.where(phi > 0, u, lo)
                hi = np.where(phi < 0, u, hi)
                step = np.where(dphi < 0, phi / np.where(dphi < 0, dphi, 1), 0)
                u_newton = u - step
                inside = (u_newton > lo) & (u_newton < hi)
                u_next = np.where(inside, u_newton, 0.5 * (lo + hi))
                moved = np.abs(u_next - u)
                u = np.where(active, u_next, u)
                active = active & (moved > tol_u * np.maximum(u, tol_u))
            u_best = np.where(at_max, ulo, np.where(at_min, uhi, u))
            best_log = np.clip(
                np.log(-np.log(u_best) / c_jc), MIN_LOG_BL, MAX_LOG_BL)
            current_log = np.log(bl_np[g])
            keep = acc_obj(u_of(best_log)) < acc_obj(u_of(current_log))
            out = bl_np.copy()
            out[g] = np.exp(np.where(keep, best_log, current_log))
            return out

        bl = np.asarray(self.branch_lengths, np.float64)
        cur = refresh_ab(bl)
        sweeps = 0
        for _ in range(max_iter):
            proposed = newton_sweep(bl)
            sweeps += 1
            m = refresh_ab(proposed)
            alpha, trial = 1.0, proposed
            while m < cur and alpha > 1.0 / 64:
                alpha /= 2.0
                trial = np.exp(
                    (1 - alpha) * np.log(np.maximum(bl, 1e-300))
                    + alpha * np.log(np.maximum(proposed, 1e-300)))
                m = refresh_ab(trial)
            if m < cur:
                refresh_ab(bl)  # restore A and B for the current lengths
                break
            improved_enough = abs(m - cur) >= tol + rtol * abs(cur)
            bl, cur = trial, m
            if not improved_enough:
                break
        return float(cur), sweeps, bl

    def run_branch_ascent(self, tol: float, max_iter: int, rtol: float = 0.0):
        """EstimateBranchLengths on the device; returns (marginal, sweeps).

        A host loop over device tensors with the semantics of the JAX
        package's fused ascent (libsbn_tpu/gp/engine.py ``_ascent_impl``):
        sweep all edges against frozen PLVs, repopulate, and damp the step
        in log-branch-length space by halves down to 1/64 until the
        marginal does not fall; stop when no damping helps or the gain is
        below ``tol + rtol*|marginal|`` (the reference's rule,
        gp_instance.cpp:129-175, is ``tol`` alone; ``rtol`` is for near-flat
        surfaces). The host reads only the scalar comparisons.

        On a CUDA device with one shard and cuda_graphs, the same loop
        replays captured graphs of its phases (gp/ascent_graph.py): about
        one replay and one read of a flag buffer per populate."""
        if (self.cuda_graphs and self.device.type == "cuda"
                and len(self._shards) == 1):
            return self._run_branch_ascent_graphed(tol, max_iter, rtol)
        dt = self.dtype
        q = self._tensor(self.q)
        floor = 1e-300 if dt == torch.float64 else 1e-30
        bl = self._tensor(self.branch_lengths)
        plvs = self._populate_shards(bl, q)
        cur = self._marginal_of_shards(plvs, q)
        sweeps, done = 0, False
        while sweeps < max_iter and not done:
            proposed = self._sweep_shards(plvs, bl)
            log_prev = torch.log(torch.clamp_min(bl, floor))
            log_prop = torch.log(torch.clamp_min(proposed, floor))
            alpha, trial = 1.0, proposed
            plvs_t = self._populate_shards(trial, q)
            m = self._marginal_of_shards(plvs_t, q)
            while bool(m < cur) and alpha > 1.0 / 64:
                alpha /= 2
                trial = torch.exp((1 - alpha) * log_prev + alpha * log_prop)
                plvs_t = self._populate_shards(trial, q)
                m = self._marginal_of_shards(plvs_t, q)
            improved = bool(m >= cur)
            done = (not improved) or bool(
                torch.abs(m - cur) < tol + rtol * torch.abs(cur))
            if improved:
                bl, plvs, cur = trial, plvs_t, m
            sweeps += 1
        self.branch_lengths = bl.cpu().numpy()
        self.plvs = self._gathered(plvs)
        # `done` tells tolerance-met from cap-hit: sweeps == max_iter alone
        # cannot (a fit can converge on exactly the last sweep).
        self.last_ascent_converged = done or sweeps < max_iter
        self.compute_likelihoods()
        return float(cur), sweeps

    def _run_branch_ascent_graphed(self, tol, max_iter, rtol):
        """run_branch_ascent by replays of the phase graphs."""
        if self.graphs is None or self.graphs.use_kernels != self.use_kernels:
            self.graphs = ascent_graph.AscentGraphs(self)
        g = self.graphs
        cur, sweeps, done = g.run(self.branch_lengths, self.q, tol, max_iter,
                                  rtol)
        self.branch_lengths = g.bl.cpu().numpy()
        self.plvs = {k: v.clone() for k, v in g.plvs.items()}
        self.last_ascent_converged = done or sweeps < max_iter
        self.compute_likelihoods()
        return cur, sweeps

    # -- branch optimization -------------------------------------------------
    def _sweep(self, plvs, bl, early_exit=True):
        """New branch lengths (E_total,) from one sweep over all edges
        against frozen PLVs, by the engine's route (early_exit: see
        _newton_sweep)."""
        A, B = engine_kernels.sweep_stats(plvs, self._pa, self._ch, self._rot)
        return self._sweep_rows(A, B, self._w, bl, early_exit)

    def _sweep_rows(self, A, B, w, bl, early_exit=True):
        """One sweep by the engine's route from the per-edge rows A and B
        (E, S) under pattern weights w (S,)."""
        if self.use_kernels:
            return self._golden_sweep(A, B, w, bl)
        return self._newton_sweep(A, B, w, bl, early_exit)

    def _golden_sweep(self, A, B, w, bl):
        """The kernel route's sweep: K8's golden-section search per edge."""
        new_log = engine_kernels.golden_sweep(
            A.contiguous(), B.contiguous(), w,
            torch.log(bl[self._g]).contiguous())
        out = bl.clone()
        out[self._g] = torch.exp(new_log)
        return out

    def _newton_sweep(self, A, Bc, w, bl, early_exit=True):
        """The level route's sweep: one vectorized derivative-driven sweep
        over all edges.

        For JC69, r·P(b)·p collapses to A + u·B with u = e^(-4b/3), so the
        per-edge objective f(u) = Σₛ wₛ log(Aₛ + u·Bₛ) is CONCAVE in u and
        its derivative φ(u) = Σ w·B/(A+uB) decreases: the maximizer is a
        boundary or the unique root of φ. The sweep solves φ = 0 with a
        safeguarded Newton–bisection (bracket kept by the sign of φ; a
        Newton step outside it bisects), each edge stopping once its step
        falls below tolerance -- the analog of the reference's Brent
        (gp_engine.cpp:244-266, 326-361; optimization.hpp:10-115).
        Reject-if-worse per edge, as in BrentOptimization. Edges that have
        stopped do not move, so ending the loop when none is active gives
        the same u as running all NEWTON_ITERS iterations; early_exit=False
        runs them all and reads nothing on the host, as a CUDA graph
        must."""
        g = self._g
        dt = bl.dtype
        c_jc = 4.0 / 3.0

        def obj(u):  # (E,) -> (E,) negative log likelihood
            return -torch.sum(torch.log(A + u[:, None] * Bc) * w, dim=-1)

        def phi_and_dphi(u):  # df/du and d²f/du² per edge
            denom = A + u[:, None] * Bc
            ratio = torch.where(denom > 0, Bc / denom, torch.zeros_like(denom))
            return (torch.sum(w * ratio, dim=-1),
                    -torch.sum(w * ratio * ratio, dim=-1))

        def u_of(log_bl):
            return torch.exp(-c_jc * torch.exp(log_bl))

        ulo = u_of(torch.full((), MAX_LOG_BL, dtype=dt, device=bl.device))
        uhi = u_of(torch.full((), MIN_LOG_BL, dtype=dt, device=bl.device))
        E = g.shape[0]
        phi_lo, _ = phi_and_dphi(ulo.expand(E))
        phi_hi, _ = phi_and_dphi(uhi.expand(E))
        at_max = phi_lo <= 0  # f decreasing everywhere: b at MAX_LOG_BL
        at_min = phi_hi >= 0  # f increasing everywhere: b at MIN_LOG_BL
        active = ~(at_max | at_min)
        tol_u = 1e-12 if dt == torch.float64 else 1e-7
        u = torch.clamp(u_of(torch.log(bl[g])), ulo, uhi)
        lo, hi = ulo.expand(E).clone(), uhi.expand(E).clone()
        for _ in range(NEWTON_ITERS):
            if early_exit and not bool(active.any()):
                break
            phi, dphi = phi_and_dphi(u)
            lo = torch.where(phi > 0, u, lo)  # the root is above u where φ>0
            hi = torch.where(phi < 0, u, hi)
            step = torch.where(dphi < 0, phi / dphi, torch.zeros_like(phi))
            u_newton = u - step
            inside = (u_newton > lo) & (u_newton < hi)
            u_next = torch.where(inside, u_newton, 0.5 * (lo + hi))
            moved = torch.abs(u_next - u)
            still = active & (moved > tol_u * torch.clamp_min(u, tol_u))
            u = torch.where(active, u_next, u)
            active = still
        u_best = torch.where(at_max, ulo, torch.where(at_min, uhi, u))
        best_log = torch.clamp(torch.log(-torch.log(u_best) / c_jc),
                               MIN_LOG_BL, MAX_LOG_BL)
        current_log = torch.log(bl[g])
        keep = obj(u_of(best_log)) < obj(u_of(current_log))
        out = bl.clone()
        out[g] = torch.exp(torch.where(keep, best_log, current_log))
        return out

    def optimize_branch_lengths_sweep(self):
        self.branch_lengths = self._sweep(
            self.plvs, self._tensor(self.branch_lengths)).cpu().numpy()

    def _plvs_numpy(self):
        return {k: v.detach().cpu().numpy() for k, v in self.plvs.items()}

    def log_likelihood_and_derivative(self, parent_id, child_id):
        """Analytic (LL, dLL/db) for one edge (LogLikelihoodAndDerivative)."""
        rot = None
        for (p_, c_, rot_, g_) in self.dag.edge_list():
            if p_ == parent_id and c_ == child_id:
                rot = rot_
                gpcsp = g_
                break
        assert rot is not None
        plvs = self._plvs_numpy()
        bl = self.branch_lengths[gpcsp]
        r_plv = (plvs["rtilde"] if rot else plvs["r"])[parent_id]
        ls_r = (plvs["ls_rtilde"] if rot else plvs["ls_r"])[parent_id]
        p_plv = plvs["p"][child_id]
        ls_p = plvs["ls_p"][child_id]
        P = _jc69_transition(torch.as_tensor(np.asarray([bl])))[0].numpy()
        Q = substitution.jc69_q().numpy()
        dP = Q @ P
        lik = np.einsum("is,ij,js->s", r_plv, P, p_plv)
        dlik = np.einsum("is,ij,js->s", r_plv, dP, p_plv)
        ll = float(np.sum((np.log(lik) + ls_r + ls_p) * self.weights))
        dll = float(np.sum(dlik / lik * self.weights))
        return ll, dll

    # -- SBN parameter estimation --------------------------------------------
    def update_sbn_probabilities(self):
        """q over each sibling range = softmax(per-gpcsp LL + log prior),
        using hybrid marginals when available (UpdateSBNProbabilities)."""
        per_gpcsp = self.get_per_gpcsp_log_likelihoods()
        ranges = []
        seen = set()
        for node_id in self.dag.leafward_pass_traversal():
            node = self.dag.nodes[node_id]
            for subsplit in (node.subsplit, node.subsplit.rotate_subsplit()):
                rng = self.dag.parent_to_range.get(subsplit)
                if rng and rng not in seen:
                    seen.add(rng)
                    ranges.append(rng)
        ranges.append((0, self.dag.rootsplit_count()))
        for start, stop in ranges:
            if stop - start == 1:
                self.q[start] = 1.0
                continue
            hybrid = self.hybrid_marginal_log_likelihoods[start:stop]
            lls = hybrid if np.min(hybrid) > -np.inf else per_gpcsp[start:stop]
            log_post = lls + np.log(self.q[start:stop])
            log_post -= np.max(log_post)
            post = np.exp(log_post)
            self.q[start:stop] = post / post.sum()

    # -- quartet hybrid marginals --------------------------------------------
    def process_quartet_hybrid_request(self, request):
        """Port of CalculateQuartetHybridLikelihoods (gp_engine.cpp:396-460),
        on the host."""
        if not request.is_fully_formed():
            return
        plvs = self._plvs_numpy()
        results = []
        bl = self.branch_lengths

        def P_of(gpcsp):
            return _jc69_transition(
                torch.as_tensor(np.asarray([bl[gpcsp]])))[0].numpy()

        for rootward in request.rootward_tips:
            r_plv = (
                plvs["rtilde"] if rootward.rotated else plvs["r"]
            )[rootward.node_id]
            ls_root = (
                plvs["ls_rtilde"] if rootward.rotated else plvs["ls_r"]
            )[rootward.node_id]
            log_prior = np.log(
                self.unconditional_node_probabilities[rootward.node_id]
            )
            quartet_root = P_of(rootward.gpcsp_idx) @ r_plv
            for sister in request.sister_tips:
                r_s = quartet_root * (
                    P_of(sister.gpcsp_idx) @ plvs["p"][sister.node_id])
                q_s = P_of(request.central_gpcsp_idx) @ r_s
                for rotated_tip in request.rotated_tips:
                    r_sorted = q_s * (P_of(rotated_tip.gpcsp_idx)
                                      @ plvs["p"][rotated_tip.node_id])
                    for sorted_tip in request.sorted_tips:
                        non_seq = np.log(
                            self.inverted_sbn_prior[rootward.gpcsp_idx]
                            * self.q[sister.gpcsp_idx]
                            * self.q[rotated_tip.gpcsp_idx]
                            * self.q[sorted_tip.gpcsp_idx]
                        )
                        per_pattern = np.log(
                            np.einsum(
                                "is,ij,js->s", r_sorted,
                                P_of(sorted_tip.gpcsp_idx),
                                plvs["p"][sorted_tip.node_id],
                            )
                        )
                        # Add back the PLV log-scales dropped by
                        # renormalization (the reference asserts zero
                        # rescaling here instead, gp_engine.cpp:398-400).
                        per_pattern += (
                            ls_root
                            + plvs["ls_p"][sister.node_id]
                            + plvs["ls_p"][rotated_tip.node_id]
                            + plvs["ls_p"][sorted_tip.node_id]
                        )
                        per_pattern -= log_prior
                        results.append(
                            non_seq + float(np.dot(per_pattern, self.weights))
                        )
        from scipy.special import logsumexp

        self.hybrid_marginal_log_likelihoods[request.central_gpcsp_idx] = (
            logsumexp(results))

    def process_quartet_hybrid_requests(self, requests, chunk: int = 4096):
        """Batched form of process_quartet_hybrid_request: flattens every
        quartet combination (rootward x sister x rotated x sorted) across
        ALL requests into index rows and evaluates them on the device,
        ``chunk`` rows a program call (gp/hybrid_graph.py ``hybrid_chunk``:
        (rows, 4, S) JC69 applies), then a per-central-edge logsumexp on the
        host. As in the JAX package, when the rows outnumber ``chunk`` the
        last chunk is padded with rows of zeros, whose values are dropped.

        On a CUDA device with cuda_graphs the program is a captured graph
        kept on the engine (``hybrid_graphs``, under utils/graphs.py's
        capture policy), as the JAX engine keeps its jit, replayed over
        copies of the PLVs made once a call; cuda_graphs=False runs it
        eagerly."""
        self._process_hybrid(
            requests, chunk,
            graphed=self.cuda_graphs and self.device.type == "cuda")

    def _process_hybrid(self, requests, chunk, graphed):
        """process_quartet_hybrid_requests with its program eager or, with
        ``graphed``, by hybrid_graph's HybridGraphs (on the CPU: the same
        function over the same buffers, called as it is)."""
        from scipy.special import logsumexp

        reqs = [r for r in requests if r.is_fully_formed()]
        if not reqs:
            return
        rows = []
        segs = []
        centrals = []
        for seg, req in enumerate(reqs):
            centrals.append(req.central_gpcsp_idx)
            for rw in req.rootward_tips:
                for si in req.sister_tips:
                    for rt in req.rotated_tips:
                        for so in req.sorted_tips:
                            rows.append(
                                (
                                    rw.node_id, int(rw.rotated), rw.gpcsp_idx,
                                    si.node_id, si.gpcsp_idx,
                                    req.central_gpcsp_idx,
                                    rt.node_id, rt.gpcsp_idx,
                                    so.node_id, so.gpcsp_idx,
                                )
                            )
                            segs.append(seg)
        idx = np.asarray(rows, np.int64)
        segs = np.asarray(segs, np.int64)
        if not graphed:
            vals = hybrid_graph.HybridEager(self)(idx, chunk)
        else:
            if self.hybrid_graphs is None:
                self.hybrid_graphs = hybrid_graph.HybridGraphs(self)
            vals = self.hybrid_graphs.run(idx, chunk)
        for seg, central in enumerate(centrals):
            self.hybrid_marginal_log_likelihoods[central] = logsumexp(
                vals[segs == seg]
            )

    # -- hot start ------------------------------------------------------------
    def hot_start_branch_lengths(self, tree_collection, indexer):
        """Mean observed branch length per PCSP (HotStartBranchLengths)."""
        from ..sbn import maps as sbn_maps

        default_index = self.branch_lengths.size
        totals = np.zeros(self.branch_lengths.size)
        counts = np.zeros(self.branch_lengths.size, dtype=np.int64)
        for tree in tree_collection.trees:
            leaf_count = tree.leaf_count()

            def visit(sister, focal, child0, child1):
                gpcsp_bitset = sbn_maps.pcsp_bitset_of(
                    leaf_count, sister, False, focal, False,
                    child0, False, child1, False,
                )
                idx = indexer.get(gpcsp_bitset, default_index)
                if idx != default_index:
                    totals[idx] += tree.branch_lengths[focal.id]
                    counts[idx] += 1

            sbn_maps.rooted_pcsp_preorder(tree.topology, visit)
        self.branch_lengths = np.where(
            counts == 0, DEFAULT_BRANCH_LENGTH, totals / np.maximum(counts, 1)
        )
