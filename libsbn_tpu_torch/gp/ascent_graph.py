"""The GP coordinate ascent as replays of captured CUDA graphs.

The JAX package runs the whole ascent as one XLA program
(libsbn_tpu/gp/engine.py ``_ascent_impl``: populate, sweep, damped line
search and the convergence check under ``lax.while_loop``). Eagerly, the
port's host loop issues hundreds of small launches an ascent and reads the
marginal back after every populate. ``AscentGraphs`` captures the loop's
phases once per engine, each a function of static buffers (the state: bl,
the PLVs, cur; the trial: its lengths, PLVs and marginal; alpha, tol and
rtol as device scalars), and the host replays them:

* ``start``: the inputs (bl0, q, tol, rtol; one host-to-device copy)
  into the state, populate at bl0 and take the marginal;
* ``propose``: sweep against the state's PLVs (K8, or the Newton sweep on
  the level route, run for all NEWTON_ITERS: a graph has no early exit,
  and frozen lanes keep their value, so the result is the same), populate
  the proposal (K7 or the level route) and compare its marginal with cur;
* ``damp``: halve alpha, populate the trial between bl and the proposal in
  log space, and compare;
* ``accept``: the trial becomes the state where the device flag says it
  improved (torch.where).

After each propose and damp the host reads one small flag buffer (m < cur,
m >= cur, |m - cur| < tol + rtol |cur|): that read takes the place of
``lax.while_loop``'s conditions, and the host keeps ``_ascent_impl``'s
rules (damping by halves down to 1/64, reject-if-worse, the tolerance,
``done`` against the cap) exactly as GPEngine's eager loop does. On the
kernel route K7, K8 and every other sum have a fixed order, so the graphs
equal the eager loop bit for bit; the level route's ``index_add_`` adds
with float atomics on a card, so there they agree to rounding.

utils/graphs.py's ``Graph`` does the capture (warm-up, pool, launch
counts); on the CPU it calls each phase as is, which the CPU tests run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.graphs import Graph
from . import engine_kernels

# Captures and replays of the ascent's phases; reset_counters() sets them
# to 0.
COUNTS = {"captures": 0, "replays": 0}


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


class AscentGraphs:
    """The ascent's phase graphs and their static buffers, for one GPEngine
    with a single pattern shard."""

    def __init__(self, engine):
        self.engine = e = engine
        self.use_kernels = e.use_kernels  # the route the phases capture
        dev, dt = e.device, e.dtype
        E = e.branch_lengths.size
        N, S = e.dag.node_count(), e.patterns
        self.floor = 1e-300 if dt == torch.float64 else 1e-30

        def buf(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # bl0, q, tol, rtol as the host gives them, in float64.
        self.inputs = buf(2 * E + 2, dtype=torch.float64)
        self.bl, self.q, self.trial, self.log_prev, self.log_prop = (
            buf(E) for _ in range(5))
        self.cur, self.m, self.alpha, self.tol, self.rtol = (
            buf() for _ in range(5))
        # m < cur, m >= cur, |m - cur| < tol + rtol |cur|: the host's read.
        self.flags = buf(3, dtype=torch.bool)
        ls = (N, S) if e.use_kernels else (N,)

        def plvs():
            return {k: buf(*(ls if k.startswith("ls_") else (N, 4, S)))
                    for k in engine_kernels.PLV_KEYS}

        self.plvs, self.plvs_t = plvs(), plvs()

        def phase(compute, commit):
            return Graph(lambda: commit(compute()), dev,
                         (engine_kernels.LAUNCHES,), COUNTS, warmup=compute)

        self.start = phase(self._start, self._commit_start)
        self.propose = phase(self._propose, self._commit_propose)
        self.damp = phase(self._damp, self._commit_damp)
        self.accept = phase(self._accept, self._commit_accept)

    # -- the phases: compute reads the buffers, commit writes them ----------
    def _start(self):
        e, E = self.engine, self.bl.shape[0]
        dt = e.dtype
        bl, q = self.inputs[:E].to(dt), self.inputs[E:2 * E].to(dt)
        plvs = e._populate(bl, q)
        return bl, q, plvs, e._marginal_of_plvs(plvs, q), self.inputs[2 * E:]

    def _commit_start(self, out):
        bl, q, plvs, cur, tols = out
        self.bl.copy_(bl)
        self.q.copy_(q)
        self._copy_plvs(self.plvs, plvs)
        self.cur.copy_(cur)
        self.tol.copy_(tols[0])
        self.rtol.copy_(tols[1])

    def _trial(self, trial):
        """(trial, its PLVs, its marginal m, the flags against cur)."""
        e = self.engine
        plvs = e._populate(trial, self.q)
        m = e._marginal_of_plvs(plvs, self.q)
        flags = torch.stack([
            m < self.cur, m >= self.cur,
            torch.abs(m - self.cur) < self.tol + self.rtol * torch.abs(self.cur)])
        return trial, plvs, m, flags

    def _commit_trial(self, trial, plvs, m, flags):
        self.trial.copy_(trial)
        self._copy_plvs(self.plvs_t, plvs)
        self.m.copy_(m)
        self.flags.copy_(flags)

    def _propose(self):
        proposed = self.engine._sweep(self.plvs, self.bl, early_exit=False)
        log_prev = torch.log(torch.clamp_min(self.bl, self.floor))
        log_prop = torch.log(torch.clamp_min(proposed, self.floor))
        return (log_prev, log_prop) + self._trial(proposed)

    def _commit_propose(self, out):
        self.log_prev.copy_(out[0])
        self.log_prop.copy_(out[1])
        self.alpha.fill_(1.0)
        self._commit_trial(*out[2:])

    def _damp(self):
        alpha = self.alpha * 0.5
        trial = torch.exp((1 - alpha) * self.log_prev + alpha * self.log_prop)
        return (alpha,) + self._trial(trial)

    def _commit_damp(self, out):
        self.alpha.copy_(out[0])
        self._commit_trial(*out[1:])

    def _accept(self):
        improved = self.flags[1]
        return (torch.where(improved, self.trial, self.bl),
                {k: torch.where(improved, self.plvs_t[k], v)
                 for k, v in self.plvs.items()},
                torch.where(improved, self.m, self.cur))

    def _commit_accept(self, out):
        self.bl.copy_(out[0])
        self._copy_plvs(self.plvs, out[1])
        self.cur.copy_(out[2])

    @staticmethod
    def _copy_plvs(dst, src):
        for k, v in dst.items():
            v.copy_(src[k])

    # -- the host loop ---------------------------------------------------
    def run(self, bl0, q, tol, max_iter, rtol):
        """The ascent from branch lengths bl0 and SBN parameters q (numpy);
        returns (marginal, sweeps, done) and leaves the fit in ``bl``,
        ``plvs`` and ``cur``."""
        self.inputs.copy_(torch.from_numpy(np.concatenate([
            np.asarray(bl0, np.float64), np.asarray(q, np.float64),
            [tol, rtol]])))
        self.start()
        sweeps, done = 0, False
        while sweeps < max_iter and not done:
            self.propose()
            need_damp, improved, small = self.flags.tolist()
            alpha = 1.0
            while need_damp and alpha > 1.0 / 64:
                alpha /= 2
                self.damp()
                need_damp, improved, small = self.flags.tolist()
            done = not improved or small
            if improved:
                self.accept()
            sweeps += 1
        return float(self.cur), sweeps, done
