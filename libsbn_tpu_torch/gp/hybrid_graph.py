"""The quartet hybrid marginals' chunk program, eagerly and as a captured
CUDA graph.

The JAX engine jits ``_chunk`` once per engine (libsbn_tpu/gp/engine.py
``process_quartet_hybrid_requests``): for a chunk of quartet index rows
(rootward node, its rotation and GPCSP, sister, central, rotated and
sorted tips, each a node and a GPCSP) it evolves the PLVs along the five
edges with JC69 and sums each row's per-pattern log likelihood under the
pattern weights (``hybrid_chunk`` here). The host pads the last chunk with
rows of zeros when the rows outnumber the chunk, drops their values, and
takes a logsumexp per central edge.

``HybridEager`` runs the program as torch ops over the engine's PLVs
(``GPEngine(cuda_graphs=False)``, and the route the graphs are held to).
``HybridGraphs`` keeps the engine's programs by shape, as the JAX engine
keeps its jit, under utils/graphs.py's capture policy (``KeyedPrograms``),
with HybridEager as a shape's eager call and a ``HybridProgram`` as its
program. A HybridProgram's static buffers hold copies of the six PLVs the
program reads (``populate_plvs`` replaces the engine's PLV tensors, so a
graph cannot read them where it found them), the branch lengths, SBN
parameters, inverted prior and node probabilities (float64, one
host-to-device copy a call) and the pattern weights, and it captures the
program at its first chunk; a call copies the PLVs on the device once,
then replays once a chunk after one copy of the chunk's index rows, and
reads the chunk's values back, as JAX's ``np.asarray`` does. The graph
and its buffers stay with the engine (``held_mb``).

The program has the same operands, shapes and order on both routes, so the
graph equals the eager route bit for bit. On the CPU a Graph calls its
function as is, so the CPU tests run the same function over the same
buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.graphs import Graph, KeyedPrograms, pool_mb

# Captures, replays and eager calls of the hybrid programs;
# reset_counters() sets them to 0.
COUNTS = {"captures": 0, "replays": 0, "eager": 0}
# The PLVs the program reads.
PLV_KEYS = ("r", "rtilde", "p", "ls_r", "ls_rtilde", "ls_p")


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def hybrid_chunk(plvs, bl, qv, log_inv_prior, log_node_prob, w, ix):
    """(rows,) hybrid log likelihoods of the quartet index rows ix (rows,
    10): the JAX engine's ``_chunk``. Log-scales are per node (N,) on the
    level route or per (node, pattern) (N, S) on the kernel route."""
    from .engine import _b, _jc69_evolve

    (rn, rrot, rg, sn, sg, cg, tn, tg, un, ug) = ix.T
    rrot = rrot.bool()
    per_node = plvs["ls_r"].dim() == 1
    r_plv = torch.where(rrot[:, None, None], plvs["rtilde"][rn],
                        plvs["r"][rn])
    ls_root = torch.where(rrot if per_node else rrot[:, None],
                          plvs["ls_rtilde"][rn], plvs["ls_r"][rn])
    quartet_root = _jc69_evolve(bl[rg], r_plv)
    r_s = quartet_root * _jc69_evolve(bl[sg], plvs["p"][sn])
    q_s = _jc69_evolve(bl[cg], r_s)
    r_sorted = q_s * _jc69_evolve(bl[tg], plvs["p"][tn])
    lik = torch.sum(r_sorted * _jc69_evolve(bl[ug], plvs["p"][un]), dim=1)
    # ls_* are per-PLV log-scales; the reference instead asserts zero
    # rescaling here (gp_engine.cpp:398-400).
    lnp = log_node_prob[rn]
    ls = ls_root + plvs["ls_p"][sn] + plvs["ls_p"][tn] + plvs["ls_p"][un]
    per_pattern = torch.log(lik) + _b(ls - (lnp if per_node else lnp[:, None]))
    non_seq = (log_inv_prior[rg] + torch.log(qv[sg]) + torch.log(qv[tg])
               + torch.log(qv[ug]))
    return non_seq + per_pattern @ w


def _host_params(engine):
    """The branch lengths, SBN parameters, inverted SBN prior and
    unconditional node probabilities, as the host holds them."""
    return (engine.branch_lengths, engine.q, engine.inverted_sbn_prior,
            engine.unconditional_node_probabilities)


def chunk_values(run, idx, chunk):
    """(C,) values of the quartet index rows idx (C, 10), ``chunk`` rows a
    call of ``run`` (a chunk's rows to their values); when the rows
    outnumber ``chunk`` the last chunk is padded with rows of zeros, whose
    values are dropped."""
    C = idx.shape[0]
    width = min(chunk, C)
    vals = np.empty(C)
    for start in range(0, C, chunk):
        ix = idx[start:start + chunk]
        pad = width - ix.shape[0]
        if pad:
            ix = np.pad(ix, ((0, pad), (0, 0)))
        vals[start:start + chunk] = run(ix)[:width - pad]
    return vals


class HybridEager:
    """The program as torch ops over the engine's PLVs, for one call: a
    callable from the index rows (numpy) and the chunk to their values."""

    def __init__(self, engine):
        self.plvs = engine.plvs
        dt = self.plvs["p"].dtype
        bl, q, inv, node = (engine._tensor(x).to(dt)
                            for x in _host_params(engine))
        self.inputs = (bl, q, torch.log(inv), torch.log(node),
                       engine._w.to(dt))
        self.device = engine.device

    def __call__(self, idx, chunk):
        return chunk_values(self._chunk, idx, chunk)

    def _chunk(self, ix):
        return hybrid_chunk(self.plvs, *self.inputs,
                            torch.as_tensor(ix, device=self.device)
                            ).cpu().numpy()


class HybridProgram:
    """The program of one chunk width over static buffers, a Graph: a call
    copies its inputs in, then each chunk copies its index rows, replays
    and reads the values back."""

    def __init__(self, engine, width, pool=None):
        self.engine = e = engine
        dev = e.device
        cuda = dev.type == "cuda"
        self.plvs = {k: torch.empty_like(e.plvs[k],
                                         memory_format=torch.contiguous_format)
                     for k in PLV_KEYS}
        self.dtype = dt = self.plvs["p"].dtype
        self.sizes = [np.size(x) for x in _host_params(e)]
        self.params = torch.zeros(sum(self.sizes), dtype=torch.float64,
                                  device=dev)
        self.w = torch.empty_like(e._w)
        self.ix = torch.zeros((width, 10), dtype=torch.int64, device=dev)
        self.out = torch.zeros(width, dtype=dt, device=dev)
        self.out_host = torch.zeros(width, dtype=dt, pin_memory=cuda)
        self.graph = Graph(lambda: self.out.copy_(self._compute()), dev, (),
                           COUNTS, warmup=self._compute, pool=pool)

    def buffers_mb(self):
        return sum(x.numel() * x.element_size() for x in
                   [*self.plvs.values(), self.params, self.w, self.ix,
                    self.out]) / 2**20

    def _compute(self):
        e, dt = self.engine, self.dtype
        bl, q, inv, node = (x.to(e.dtype).to(dt) for x in
                            torch.split(self.params, self.sizes))
        return hybrid_chunk(self.plvs, bl, q, torch.log(inv), torch.log(node),
                            self.w.to(dt), self.ix)

    def load(self):
        """This call's inputs into the buffers: the engine's PLVs and
        weights (copies on the device), the host's parameters (one
        host-to-device copy)."""
        e = self.engine
        for k, v in self.plvs.items():
            v.copy_(e.plvs[k])
        self.w.copy_(e._w)
        self.params.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(x, np.float64).ravel() for x in _host_params(e)])))

    def __call__(self, idx, chunk):
        self.load()
        return chunk_values(self._chunk, idx, chunk)

    def _chunk(self, ix):
        self.ix.copy_(torch.from_numpy(np.ascontiguousarray(ix)))
        self.graph()
        self.out_host.copy_(self.out)
        return self.out_host.numpy()


class HybridGraphs:
    """One engine's hybrid programs by key (the chunk's rows, the PLVs'
    shapes and dtype), sharing one memory pool."""

    def __init__(self, engine):
        self.engine = engine
        self.programs = KeyedPrograms(
            engine.device, (), COUNTS,
            torch.cuda.graph_pool_handle()
            if engine.device.type == "cuda" else None)

    def _key(self, width):
        plvs = self.engine.plvs
        return (width,) + tuple((tuple(plvs[k].shape), plvs[k].dtype)
                                for k in PLV_KEYS)

    def run(self, idx, chunk):
        """(C,) values of the index rows idx (C, 10), ``chunk`` rows a
        program call."""
        width = min(chunk, idx.shape[0])
        return self.programs.call(
            self._key(width), lambda *a: HybridEager(self.engine)(*a),
            lambda: HybridProgram(self.engine, width, self.programs.pool),
            idx, chunk)

    def held_mb(self):
        """MB of device memory the engine's hybrid programs hold: their
        static buffers and their pool."""
        return (sum(p.buffers_mb() for p in self.programs.programs.values())
                + pool_mb(self.programs.pool))
