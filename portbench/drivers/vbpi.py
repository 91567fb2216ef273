"""The VBPI training cell: ``JitVBPI.step_many`` windows on one trainer.

Traffic parameters (``traffic/<name>.json``): ``particles`` (P a step),
``window_steps`` (K steps a ``step_many`` call, one CUDA-graph replay),
``beta``, ``use_vimco``, ``scalar_lr`` and ``sbn_lr``, ``q_start`` (the
split-lognormal start (mu, sigma), as the program's trainer states it) and
``trace_calls`` (calls in the traced sub-window). The trainer's seed is
``--seed``: it draws the topologies and normals.

Set-up builds one trainer, drives it through its first two windows (the
window's own call, K steps each) while recording what each step drew,
and hands the same trainer to the measured window. The first call
captures the window's graph; the second takes the path of every timed
call (the draws copied into the graph's buffers, the state carried over
from the last replay). The reference follows both windows from its own
start (reference/vbpi.py) over the same draws; the program's state
before the first and after the second is what is judged.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import layout, work
from portbench.harness import path
from portbench.reference import alignment, sbn, trees as ref_trees
from portbench.reference import vbpi as ref_vbpi
from portbench.trace import CALL_SPAN, SPAN_PREFIX

# Windows that set-up drives and the reference follows: the first
# captures the window's graph, the second replays it as the timed calls do.
CHECKED_WINDOWS = 2


def _host(x):
    return np.asarray(x.detach().to("cpu", torch.float64))


def _state(jv):
    s = jv.state
    return {"q": _host(s.q_params), "phi": _host(s.sbn_params),
            "mu_q": _host(s.opt_state[0].mu),
            "mu_phi": _host(s.opt_state[1].mu)}


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, device, fault=None):
        import libsbn_tpu_torch as lt

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fault = fault
        m = cfg["model"]
        if (m["substitution"], m["site"]) != ("JC69", "constant"):
            raise ValueError("the VBPI step is JC69 with constant rates")
        inst = lt.UnrootedInstance("portbench")
        if cfg["trees_format"] == "nexus":
            inst.read_nexus_file(path(cfg["trees"]))
        else:
            inst.read_newick_file(path(cfg["trees"]))
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.read_fasta_file(path(cfg["alignment"]))
        dtype = {"float32": torch.float32, "float64": torch.float64}[
            cfg["dtype"]]
        inst.prepare_for_phylo_likelihood(lt.PhyloModelSpec(), device=device,
                                          dtype=dtype)
        self.inst, self.dtype = inst, dtype
        self.names = inst.taxon_names()
        self.ref_trees = ref_trees.read_trees(path(cfg["trees"]),
                                              cfg["trees_format"])
        self.support = sbn.Support(self.ref_trees)
        # The program's parameters in the reference's order: program index
        # i is reference index order[i] (KeyError: another support).
        keys = layout.sbn_keys(inst.sbn_support, layout.taxon_map(
            self.names, self.ref_trees[0].taxa))
        self.order = np.array([self.support.index[k] for k in keys])
        if len(self.order) != len(self.support.keys):
            raise RuntimeError("the program's network has another support")
        self.pats = alignment.patterns(path(cfg["alignment"]),
                                       self.ref_trees[0].taxa)
        self.K, self.P = int(traffic["window_steps"]), int(traffic["particles"])
        self.beta = float(traffic["beta"])
        self.shape = work.Shape("JC69", self.P, len(self.names), 1,
                                len(self.pats.weights), cfg["dtype"])
        self._restore = None

    def _plant(self):
        """The faults the harness's tests plant under the timed path: in
        the likelihood kernel's wrapper the step calls, or in the state."""
        from libsbn_tpu_torch.ops import pruning_jc

        if (self.fault not in ("half_batch", "altered_answer")
                or self._restore is not None):
            return
        orig = pruning_jc.log_likelihood_and_branch_gradient_jc69
        fault = self.fault

        def broken(*args, **kwargs):
            lls, grads = orig(*args, **kwargs)
            if fault == "altered_answer":
                return torch.cat([lls[:1], lls[1:2] * 1.001, lls[2:]]), grads
            half = lls.shape[0] // 2
            rest = lls.shape[0] - half
            return (torch.cat([lls[:half], lls[:half].mean().expand(rest)]),
                    torch.cat([grads[:half],
                               grads[:half].mean(0).expand(rest, -1)]))

        pruning_jc.log_likelihood_and_branch_gradient_jc69 = broken
        self._restore = (pruning_jc, orig)

    def prepare(self, seed: int):
        """One trainer from the seed, driven through its first two
        windows with each step's draws recorded."""
        from libsbn_tpu_torch.vi import JitVBPI

        tr = self.traffic
        self._plant()
        # A trainer writes its network's parameters back into the instance,
        # where the next trainer starts: each starts from the estimate.
        self.inst.train_simple_average()
        self.jv = JitVBPI(self.inst, particle_count=self.P, seed=seed,
                          dtype=self.dtype,
                          use_vimco=bool(tr["use_vimco"]),
                          scalar_lr=float(tr["scalar_lr"]),
                          sbn_lr=float(tr["sbn_lr"]))
        self.before = _state(self.jv)
        self.drawn = []
        window = self.jv._window

        def record(ints_k, eps_k, betas):
            self.drawn.append((np.array(ints_k[0]), np.array(eps_k),
                               np.array(betas, np.float64)))
            return window(ints_k, eps_k, betas)

        self.jv._window = record
        metrics = []
        for _ in range(CHECKED_WINDOWS):
            metrics.append(self.jv.step_many(self.K, self.beta))
            if self.fault == "unchanged_state":
                self._put_params(self.before)
        del self.jv._window
        self.metrics = {k: np.concatenate([_host(m[k]) for m in metrics])
                        for k in metrics[0]}
        self.after = _state(self.jv)
        self._sync()

    def _put_params(self, state):
        """The fault of a step that returns its state unchanged: the
        parameters put back as they were at the start."""
        from libsbn_tpu_torch.vi.jit_step import VBPIState

        st = self.jv.state
        self.jv.state = VBPIState(
            torch.as_tensor(state["q"]).to(st.q_params),
            torch.as_tensor(state["phi"]).to(st.sbn_params), st.opt_state)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict:
        calls = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            self.jv.step_many(self.K, self.beta)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        steps = calls * self.K
        self.stats = {"attempted": steps, "window_s": window_s,
                      "vbpi_step_ms": 1e3 * window_s / steps}
        return self.stats

    def traced(self, n: int):
        rf = torch.profiler.record_function
        self._sync()
        for _ in range(n):
            with rf(CALL_SPAN):
                with rf(SPAN_PREFIX + "JitVBPI.step_many"):
                    self.jv.step_many(self.K, self.beta)
                with rf(SPAN_PREFIX + "wait"):
                    self._sync()

    def work(self) -> Dict:
        return {"shape": self.shape, "call_job": "ll_bgrad",
                "steps_per_call": self.K}

    def collect(self):
        pass

    def release(self):
        self.jv = None
        self.inst.engine = None
        if self._restore is not None:
            module, orig = self._restore
            module.log_likelihood_and_branch_gradient_jc69 = orig
            self._restore = None

    # -- correctness ----------------------------------------------------------
    def _follow(self, control: bool):
        """The reference over the recorded windows: per-step metrics and
        the trainer after them."""
        dev = "cuda" if self.device.type == "cuda" else "cpu"
        L = len(self.names)
        trainer = ref_vbpi.Trainer(
            self.support, self.pats, self.traffic["q_start"],
            float(self.traffic["scalar_lr"]), float(self.traffic["sbn_lr"]),
            device=dev, control=control)
        self.ref_start = {"q": _host(trainer.q), "phi": _host(trainer.phi)}
        steps = []
        for pc, eps, betas in self.drawn:
            for k in range(pc.shape[0]):
                trees, eps_ref = [], np.zeros(eps.shape[1:])
                for p in range(pc.shape[1]):
                    tree, edges = layout.tree_of_schedule(pc[k, p], L,
                                                          self.names)
                    trees.append(tree)
                    eps_ref[p, edges] = eps[k, p]
                steps.append(trainer.step(trees, eps_ref, float(betas[k])))
        return steps, trainer

    def _numbers(self, steps, trainer) -> Dict[str, float]:
        """loss_rel: each step's ELBO term and mean log-likelihood against
        the reference's, the worst step. moment_rel: Adam's first moment
        after the windows (the gradients as the optimizer holds them), each
        leaf's norm against the reference's, the worst leaf. change_rel and
        change_rel_sbn: the parameters' change over the windows, the branch
        model's and the network's, each norm against the reference's. A
        leaf's gap of norms is taken over the larger of its reference norm
        and the median leaf's. Entries whose reference gradient stayed
        under a thousandth of the leaf's median (a network parameter alone
        in its parent's block has none: its probability is 1) move by
        round-off alone and are left out. The network's change swings
        more from seed to seed than the branch model's in sound runs
        (Adam's normalised step turns float32 round-off in its nearly
        cancelled entries into whole steps), so it has a limit of its own."""
        loss = 0.0
        self.per_step = []
        for k, ref in enumerate(steps):
            gap = max(abs(self.metrics[n][k] - ref[n]) / abs(ref[n])
                      for n in ("elbo_like", "mean_ll"))
            self.per_step.append(gap)
            loss = max(loss, gap)
        V = len(self.support.splits)

        def ref_order(a, leaf):
            out = np.empty_like(a)
            out[self.order[:V] if leaf == "q" else self.order] = a
            return out

        gmax = {"q": _host(trainer.gmax_q), "phi": _host(trainer.gmax_phi)}
        keep = {k: g >= 1e-3 * np.median(g[g > 0]) for k, g in gmax.items()}
        ref_mu = {"q": _host(trainer.adam_q.mu),
                  "phi": _host(trainer.adam_phi.mu)}
        moment = {k: (np.linalg.norm(ref_order(self.after["mu_" + k], k)[
            keep[k]]), np.linalg.norm(ref_mu[k][keep[k]])) for k in keep}
        start = self.ref_start
        ref_now = {"q": _host(trainer.q), "phi": _host(trainer.phi)}
        change = {k: (
            np.linalg.norm(ref_order(self.after[k] - self.before[k], k)[
                keep[k]]),
            np.linalg.norm((ref_now[k] - start[k])[keep[k]])) for k in keep}
        gaps = _leaf_gaps(change)
        return {"loss_rel": _nan_inf(loss),
                "moment_rel": max(_leaf_gaps(moment).values()),
                "change_rel": gaps["q"], "change_rel_sbn": gaps["phi"]}

    def check(self) -> Dict[str, float]:
        return self._numbers(*self._follow(control=False))

    def control(self) -> Dict[str, float]:
        return self._numbers(*self._follow(control=True))

    def failed_calls(self, limits) -> int:
        return sum(1 for g in self.per_step if not g <= limits["loss_rel"])


def _nan_inf(x: float) -> float:
    return float("inf") if x != x else float(x)


def _leaf_gaps(norms: Dict[str, tuple]) -> Dict[str, float]:
    """Each leaf's gap of norms (program, reference) over the larger of its
    reference norm and the median leaf's."""
    median = float(np.median([r for _, r in norms.values()]))
    return {k: _nan_inf(abs(p - r) / max(r, median))
            for k, (p, r) in norms.items()}
