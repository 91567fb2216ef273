"""The streamed GP ascent's chunk programs, eagerly and as replays of
captured CUDA graphs.

The JAX package's streamed ascent (libsbn_tpu/gp/engine.py
``run_branch_ascent_streamed``) jits three programs a call and runs them
chunk by chunk between the host's Newton steps (its fourth,
``chunk_marginal``, is called by nothing):

* ``chunk_stats``: populate one chunk's PLVs (K7 on the kernel route),
  then the per-edge rows A and B (``engine_kernels.sweep_stats``) and the
  chunk's marginal; the host stores A and B in the (2, E, patterns) array
  AB, in host RAM or an np.memmap, and adds the marginals;
* ``chunk_phi``: the Newton derivative phi = sum_s w B / (A + u B) and its
  derivative per edge, from one chunk of AB;
* ``chunk_obj``: the per-edge negative log likelihood at u, likewise.

``StreamedEager`` runs them as torch ops (``GPEngine(cuda_graphs=False)``,
and the route the graphs are held to). ``StreamedGraphs`` runs the same
functions over static buffers on the engine's device, each a key of one
``utils/graphs.py KeyedPrograms`` under its capture policy (a first
populate that ran K7's slab route keeps the statistics program eager); a
program captures ``commit(compute())`` with ``compute`` alone as the
warm-up, so the warm-up writes no buffer. A chunk call copies the chunk's
inputs into the program's buffers by one host-to-device copy, as JAX's
``jnp.asarray`` uploads them at every call: the branch lengths and SBN
parameters once a statistics refresh, then the chunk's tips and weights; or
u (with the accumulators' zeros) once a derivative or objective pass, then
the chunk's A, B and weights, gathered from AB through a pinned staging
buffer (AB[k, :, chunk] is a strided view). The derivative and objective
programs add into device accumulators in chunk order, as the eager route
does, and the host reads them once a pass; the statistics program writes A,
B and the marginal into one buffer that the host reads once a chunk. A and
B never move to the device beyond one chunk: that is the path's capacity
contract. The graphs and their shared memory pool, O(DAG nodes x chunk), go
at the end of the call, as JAX's per-call jits do.

Every sum has the same operands, shapes and order on both routes, so on
the kernel route the graphs equal the eager route bit for bit. On the CPU
a Graph calls its function as is, so the CPU tests run the same functions
over the same buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.graphs import KeyedPrograms, pool_mb
from . import engine_kernels

# Captures, replays and eager calls of the chunk programs; reset_counters()
# sets them to 0.
COUNTS = {"captures": 0, "replays": 0, "eager": 0}


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def chunk_stats(engine, bl, q, tips, w):
    """(A, B, marginal) of one chunk: its PLVs at bl and q over ``tips``
    (L, 4, chunk) by the engine's route, the per-edge rows A and B (E,
    chunk), and the chunk's marginal under weights w (chunk,)."""
    plvs = engine._populate(bl, q, tips)
    A, B = engine_kernels.sweep_stats(plvs, engine._pa, engine._ch,
                                      engine._rot)
    return A, B, engine._marginal_of_plvs(plvs, q, w)


def chunk_phi(u, A, B, w):
    """One chunk's (phi, dphi) per edge at u (E,), from A and B (E, chunk)
    and w (1, chunk)."""
    denom = A + u[:, None] * B
    ratio = torch.where(denom > 0, B / denom, torch.zeros_like(denom))
    return (torch.sum(w * ratio, dim=-1),
            -torch.sum(w * ratio * ratio, dim=-1))


def chunk_obj(u, A, B, w):
    """One chunk's per-edge negative log likelihood at u (E,); patterns of
    weight 0 (the padding) add nothing."""
    lik = A + u[:, None] * B
    return -torch.sum(
        torch.where(w > 0, torch.log(lik), torch.zeros_like(lik)) * w, dim=-1)


class _Chunks:
    """What both routes share: the engine, AB (2, E, C chunk), the chunked
    tips (C, L, 4, chunk) and weights (C, chunk), in the working dtype."""

    def __init__(self, engine, AB, tips_c, w_c):
        self.engine = engine
        self.AB, self.tips_c, self.w_c = AB, tips_c, w_c
        self.np_dtype = AB.dtype
        self.C, self.chunk = w_c.shape
        self.E = AB.shape[1]

    def slice(self, c):
        return slice(c * self.chunk, (c + 1) * self.chunk)

    def close(self):
        pass


class StreamedEager(_Chunks):
    """The chunk programs as eager torch ops."""

    def __init__(self, engine, AB, tips_c, w_c):
        super().__init__(engine, AB, tips_c, w_c)
        self.q = engine._tensor(engine.q)

    def _chunk_of(self, array, c):
        return torch.as_tensor(array[c], device=self.engine.device)

    def refresh(self, bl_np):
        """A and B of every chunk into AB at branch lengths bl_np; the
        marginal, summed over the chunks."""
        e = self.engine
        blt = e._tensor(bl_np)
        total = 0.0
        for c in range(self.C):
            A, B, m = chunk_stats(e, blt, self.q, self._chunk_of(self.tips_c, c),
                                  self._chunk_of(self.w_c, c))
            sl = self.slice(c)
            self.AB[0, :, sl] = A.cpu().numpy()
            self.AB[1, :, sl] = B.cpu().numpy()
            total += float(m)
        return total

    def _chunk_ab(self, c):
        dev, sl = self.engine.device, self.slice(c)
        return (torch.as_tensor(self.AB[0, :, sl], device=dev),
                torch.as_tensor(self.AB[1, :, sl], device=dev),
                self._chunk_of(self.w_c, c)[None, :])

    def _u(self, u):
        return torch.as_tensor(np.asarray(u, self.np_dtype),
                               device=self.engine.device)

    def phi(self, u):
        """(phi, dphi) per edge at u (E,), summed over the chunks on the
        device in chunk order."""
        ut = self._u(u)
        phi = torch.zeros(self.E, dtype=ut.dtype, device=ut.device)
        dphi = torch.zeros_like(phi)
        for c in range(self.C):
            p, d = chunk_phi(ut, *self._chunk_ab(c))
            phi += p
            dphi += d
        return phi.cpu().numpy(), dphi.cpu().numpy()

    def obj(self, u):
        """Per-edge negative log likelihood at u (E,), summed over the
        chunks."""
        ut = self._u(u)
        obj = torch.zeros(self.E, dtype=ut.dtype, device=ut.device)
        for c in range(self.C):
            obj += chunk_obj(ut, *self._chunk_ab(c))
        return obj.cpu().numpy()


class StreamedGraphs(_Chunks):
    """The chunk programs over static buffers, each a key of one
    KeyedPrograms, for one call of the streamed ascent; ``close()`` drops
    them and records ``pool_mb`` (their shared pool's MB at the end of the
    call) and ``buffers_mb`` (the static buffers' and staging buffers' MB
    on the device)."""

    def __init__(self, engine, AB, tips_c, w_c):
        super().__init__(engine, AB, tips_c, w_c)
        e = engine
        dev, dt = e.device, e.dtype
        cuda = dev.type == "cuda"
        C, chunk, E = self.C, self.chunk, self.E
        L = tips_c.shape[1]
        self.tips_shape = (L, 4, chunk)
        self.n_tips = L * 4 * chunk
        self.pool = torch.cuda.graph_pool_handle() if cuda else None

        def buf(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def host(*shape):
            return torch.zeros(shape, dtype=dt, pin_memory=cuda)

        # chunk_stats: bl and q (float64, once a refresh), the chunk's tips
        # and weights (once a chunk; their host rows made once a call);
        # out: A, B and the marginal, read back once a chunk.
        self.q_host = np.asarray(e.q, np.float64)
        self.blq = buf(2, e.branch_lengths.size, dtype=torch.float64)
        self.tw_c = np.concatenate([tips_c.reshape(C, -1), w_c], axis=1)
        self.tw = buf(self.n_tips + chunk)
        self.stats_out = buf(2 * E * chunk + 1)
        self.stats_host = host(2 * E * chunk + 1)
        # chunk_phi and chunk_obj: the chunk's A, B and weights, staged
        # through pinned memory; u with the accumulators, zeroed by the same
        # copy that brings u.
        self.ab = buf(2 * E + 1, chunk)
        self.ab_host = host(2 * E + 1, chunk)
        self.u_phi = buf(3, E)
        self.u_obj = buf(2, E)
        self.buffers_mb = sum(
            x.numel() * x.element_size() for x in
            (self.blq, self.tw, self.stats_out, self.ab, self.u_phi,
             self.u_obj)) / 2**20
        self.programs = KeyedPrograms(dev, (engine_kernels.LAUNCHES,), COUNTS,
                                      self.pool)

        def program(key, compute, commit):
            def run():
                commit(compute())

            return lambda: self.programs.call(
                key, run, lambda: self.programs.graph(run, warmup=compute))

        self.stats = program("stats", self._stats, self._commit_stats)
        self.phi_program = program("phi", self._phi, self._commit_phi)
        self.obj_program = program("obj", self._obj, self._commit_obj)
        self.pool_mb = 0.0

    # -- the programs: compute reads the buffers, commit writes them ------
    def _stats(self):
        dt = self.engine.dtype
        tips = self.tw[:self.n_tips].view(self.tips_shape)
        return chunk_stats(self.engine, self.blq[0].to(dt),
                           self.blq[1].to(dt), tips, self.tw[self.n_tips:])

    def _commit_stats(self, out):
        A, B, m = out
        n = A.numel()
        self.stats_out[:n].copy_(A.reshape(-1))
        self.stats_out[n:2 * n].copy_(B.reshape(-1))
        self.stats_out[2 * n].copy_(m)

    def _rows(self):
        E = self.E
        return self.ab[:E], self.ab[E:2 * E], self.ab[2 * E:]

    def _phi(self):
        return chunk_phi(self.u_phi[0], *self._rows())

    def _commit_phi(self, out):
        self.u_phi[1] += out[0]
        self.u_phi[2] += out[1]

    def _obj(self):
        return chunk_obj(self.u_obj[0], *self._rows())

    def _commit_obj(self, out):
        self.u_obj[1] += out

    # -- the host's calls ----------------------------------------------------
    def refresh(self, bl_np):
        """A and B of every chunk into AB at branch lengths bl_np; the
        marginal, summed over the chunks."""
        self.blq.copy_(torch.from_numpy(
            np.stack([np.asarray(bl_np, np.float64), self.q_host])))
        n = self.E * self.chunk
        out = self.stats_host.numpy()
        total = 0.0
        for c in range(self.C):
            self.tw.copy_(torch.from_numpy(self.tw_c[c]))
            self.stats()
            self.stats_host.copy_(self.stats_out)
            self.AB[:, :, self.slice(c)] = out[:2 * n].reshape(2, self.E,
                                                               self.chunk)
            total += float(out[2 * n])
        return total

    def _load_ab(self, c):
        """The chunk's A, B and weights into the device buffer ``ab``: a
        gather from AB on the host into pinned memory, then one copy."""
        E, sl = self.E, self.slice(c)
        stage = self.ab_host.numpy()
        stage[:E] = self.AB[0, :, sl]
        stage[E:2 * E] = self.AB[1, :, sl]
        stage[2 * E] = self.w_c[c]
        self.ab.copy_(self.ab_host)

    def _pass(self, state, program, u):
        """One pass over the chunks at u: u and zeros into ``state``, the
        program once a chunk, the accumulators read back."""
        init = np.zeros(state.shape, self.np_dtype)
        init[0] = u
        state.copy_(torch.from_numpy(init))
        for c in range(self.C):
            self._load_ab(c)
            program()
        return state[1:].to("cpu", copy=True).numpy()

    def phi(self, u):
        """(phi, dphi) per edge at u (E,), summed over the chunks on the
        device in chunk order."""
        phi, dphi = self._pass(self.u_phi, self.phi_program, u)
        return phi, dphi

    def obj(self, u):
        """Per-edge negative log likelihood at u (E,), summed over the
        chunks."""
        return self._pass(self.u_obj, self.obj_program, u)[0]

    def close(self):
        """Record the pool's MB, then drop the graphs (their pool goes back
        to the caching allocator)."""
        if self.pool is not None:
            torch.cuda.synchronize(self.engine.device)
            self.pool_mb = pool_mb(self.pool)
        # The graphs' captures refer back to this object.
        self.programs = self.stats = self.phi_program = self.obj_program = None
