"""The engine cells: one caller in a closed loop over one
``LikelihoodEngine`` entry, each call made from host arrays and waited for.

Traffic parameters (``traffic/<name>.json``): ``entry`` (the engine method:
``branch_gradients`` or ``phylo_gradients``), ``batch`` (trees a call: the
configuration's topologies tiled to it, in an order the seed shuffles),
``length_sets`` and ``length_scale`` (that many sets of branch lengths made
from the seed in set-up, each the file's lengths times U(lo, hi) edge by
edge; call i takes set i mod length_sets), ``check_calls`` (how many of the
window's calls, drawn from the seed, the reference checks) and
``trace_calls`` (the traced sub-window's length).

A call's latency is read from CUDA events recorded before the call's host
work starts and after its outputs, on the card's clock: the card is idle
at the first (the loop waits for every call), so the interval holds the
host's packing and dispatch and the device's work.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import layout, work
from portbench.harness import p95, path
from portbench.reference import alignment, likelihood, trees as ref_trees
from portbench.trace import CALL_SPAN, SPAN_PREFIX


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, device, fault=None):
        from libsbn_tpu_torch.core.site_pattern import SitePattern
        from libsbn_tpu_torch.io import newick
        from libsbn_tpu_torch.io.fasta import Alignment
        from libsbn_tpu_torch.models.engine import LikelihoodEngine
        from libsbn_tpu_torch.models.phylo_model import PhyloModelSpec

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fault = fault
        m = cfg["model"]
        parse = (newick.parse_nexus_file if cfg["trees_format"] == "nexus"
                 else newick.parse_newick_file)
        self.tops, _, ttm = parse(path(cfg["trees"]))
        self.ref_trees = ref_trees.read_trees(path(cfg["trees"]),
                                              cfg["trees_format"])
        if len(self.ref_trees) != len(self.tops):
            raise RuntimeError("the program read another number of trees")
        taxa = self.ref_trees[0].taxa
        self.taxon_of_leaf = layout.taxon_map(
            [ttm[(i, 1)] for i in range(len(ttm))], taxa)
        self.pats = alignment.patterns(path(cfg["alignment"]), taxa)
        self.model = likelihood.Model.of_config(cfg)
        site = (f"weibull+{m['categories']}" if m["site"] == "weibull"
                else "constant")
        self.spec = PhyloModelSpec(m["substitution"], site, "strict")
        sp = SitePattern(Alignment.read_fasta(path(cfg["alignment"])), ttm)
        dtype = {"float32": torch.float32, "float64": torch.float64}[
            cfg["dtype"]]
        self.engine = LikelihoodEngine(sp, self.spec, dtype=dtype,
                                       device=device)
        f64 = torch.float64
        self.params = {"clock": {"rate": torch.tensor(1.0, dtype=f64)}}
        if m["substitution"] == "GTR":
            self.params["substitution"] = {
                "rates": torch.tensor(m["gtr_rates"], dtype=f64),
                "frequencies": torch.tensor(m["frequencies"], dtype=f64)}
        if m["site"] == "weibull":
            self.params["site"] = {
                "shape": torch.tensor(m["weibull_shape"], dtype=f64)}
        self.entry = traffic["entry"]
        if self.entry not in ("branch_gradients", "phylo_gradients"):
            raise ValueError(f"entry {self.entry!r} is not an engine call")
        self.shape = work.Shape(m["substitution"], int(traffic["batch"]),
                                len(taxa), int(m["categories"]),
                                len(self.pats.weights), cfg["dtype"])

    # -- traffic ------------------------------------------------------------
    def prepare(self, seed: int):
        """The seed's traffic: the batch's order, the length sets, the
        program's schedule of the batch; then each shape warmed up (a
        key's first call runs eagerly, its second captures, its third
        replays)."""
        from libsbn_tpu_torch.ops import schedule

        tr = self.traffic
        rng = np.random.default_rng(seed)
        B, n_sets = int(tr["batch"]), int(tr["length_sets"])
        lo, hi = tr["length_scale"]
        self.tree_index = rng.permutation(np.resize(np.arange(len(self.tops)),
                                                    B))
        batch = [self.ref_trees[i] for i in self.tree_index]
        E = len(batch[0].splits)
        base = np.array([t.lengths for t in batch])
        self.ref_sets = base[None] * rng.uniform(lo, hi, size=(n_sets, B, E))
        self.check_rng = np.random.default_rng([seed, 1])
        self.sched = schedule.schedules_of_topologies(
            [self.tops[i] for i in self.tree_index])
        self.edge_of = layout.split_edges(
            self.sched.post_children, self.sched.leaf_count,
            self.taxon_of_leaf, batch)
        N = self.sched.node_count
        self.sets = np.zeros((n_sets, B, N))
        self.sets[:, :, :N - 1] = np.take_along_axis(
            self.ref_sets, np.broadcast_to(self.edge_of, (n_sets,) +
                                           self.edge_of.shape), axis=2)
        for j in range(3):
            self._call(self.sets[j % n_sets])
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, bl):
        fn = getattr(self.engine, self.entry)
        out = fn(self.sched, bl, self.params)
        if self.entry == "branch_gradients":
            out = {"log_likelihood": out[0], "branch_lengths": out[1]}
        return self._break(out)

    def _break(self, out):
        """The faults the harness's tests plant under the timed path."""
        if self.fault is None:
            return out
        out = {k: v.clone() for k, v in out.items()}
        g = out["branch_lengths"]
        if self.fault == "altered_answer":
            row = g.shape[0] // 3
            g[row, g.shape[1] // 2] += 0.5 * g[row].abs().max()
        elif self.fault == "half_batch":
            half = g.shape[0] // 2
            for v in out.values():
                v[half:] = v[:half].mean(0)
        else:
            raise ValueError(f"no fault {self.fault!r}")
        return out

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Calls in a closed loop until ``seconds`` have passed; keeps the
        outputs of ``check_calls`` calls drawn from the seed (reservoir
        sampling)."""
        n_sets, R = len(self.sets), int(self.traffic["check_calls"])
        cuda = self.device.type == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        lat: List[float] = []
        self.kept = []
        calls = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            j = calls % n_sets
            if cuda:
                ev0.record()
                out = self._call(self.sets[j])
                ev1.record()
                ev1.synchronize()
                lat.append(ev0.elapsed_time(ev1))
            else:
                c0 = time.perf_counter()
                out = self._call(self.sets[j])
                lat.append((time.perf_counter() - c0) * 1e3)
            if calls < R:
                self.kept.append((j, out))
            else:
                r = int(self.check_rng.integers(calls + 1))
                if r < R:
                    self.kept[r] = (j, out)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        B = self.shape.B
        self.stats = {"attempted": calls, "window_s": window_s,
                      "tree_evals_per_s": B * calls / window_s,
                      "call_p95_ms": p95(lat)}
        return self.stats

    def traced(self, n: int):
        """n calls with the harness's spans around each part, for the
        profiler."""
        rf = torch.profiler.record_function
        n_sets = len(self.sets)
        self._sync()
        for i in range(n):
            with rf(CALL_SPAN):
                with rf(SPAN_PREFIX + "pick_lengths"):
                    bl = self.sets[i % n_sets]
                with rf(SPAN_PREFIX + "engine." + self.entry):
                    self._call(bl)
                with rf(SPAN_PREFIX + "wait"):
                    self._sync()

    def work(self) -> Dict:
        job = "ll_bgrad" if self.entry == "branch_gradients" else "phylo"
        return {"shape": self.shape, "call_job": job}

    def collect(self):
        """Moves the kept outputs to the host."""
        self.kept = [(j, {k: np.asarray(torch.as_tensor(v).detach().to(
            "cpu", torch.float64)) for k, v in out.items()})
            for j, out in self.kept]

    def release(self):
        """Moves the kept outputs to the host and frees the program's
        state."""
        self.collect()
        self.engine = self.sched = None

    # -- correctness ----------------------------------------------------------
    def reference(self, j: int, control: bool = False):
        dev = "cuda" if self.device.type == "cuda" else "cpu"
        return likelihood.evaluate(
            self.ref_trees, self.tree_index, self.ref_sets[j], self.pats,
            self.model, want_model=self.entry == "phylo_gradients",
            device=dev, control=control)

    def _program(self, out):
        """The program's outputs in the reference's layout."""
        g = np.zeros_like(out["branch_lengths"])
        np.put_along_axis(g, self.edge_of, out["branch_lengths"], axis=1)
        got = {"ll": out["log_likelihood"], "bgrad": g}
        if "substitution_model" in out:
            got["subst"] = out["substitution_model"]
        if "site_model" in out:
            got["shape"] = out["site_model"]
        return got

    def check(self) -> Dict[str, float]:
        """The worst of each number over the kept calls, program against
        reference."""
        refs = {}
        self.per_call = []
        for j, out in self.kept:
            if j not in refs:
                refs[j] = self.reference(j)
            self.per_call.append(errors(self._program(out), refs[j]))
        self._refs = refs
        return worst(self.per_call)

    def control(self) -> Dict[str, float]:
        """The same numbers with the control (the reference in TF32) in the
        program's place, on the kept calls' length sets."""
        return worst([errors(self.reference(j, control=True), ref)
                      for j, ref in self._refs.items()])

    def failed_calls(self, limits) -> int:
        return sum(1 for e in self.per_call
                   if not all(v <= limits[k] for k, v in e.items()))


def _rel_rows(got, ref):
    """Per row: the largest gap over the row's largest reference value."""
    gap = np.abs(got - ref).reshape(len(ref), -1).max(1)
    scale = np.abs(ref).reshape(len(ref), -1).max(1)
    return gap / scale


def errors(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: ll_rel, each tree's log-likelihood gap over
    its magnitude; bgrad_rel and subst_rel, each tree's largest gradient
    gap over its largest reference entry; shape_rel, each tree's gap over
    the larger of its own and the batch's median magnitude. The worst tree
    of each; NaN reads as infinity."""
    out = {"ll_rel": _rel_rows(got["ll"], ref["ll"]),
           "bgrad_rel": _rel_rows(got["bgrad"], ref["bgrad"])}
    if "subst" in ref:
        out["subst_rel"] = _rel_rows(got["subst"], ref["subst"])
    if "shape" in ref:
        scale = np.maximum(np.abs(ref["shape"]),
                           np.median(np.abs(ref["shape"])))
        out["shape_rel"] = np.abs(got["shape"] - ref["shape"]) / scale
    return {k: (float(np.nan_to_num(v, nan=np.inf).max())) for k, v in
            out.items()}


def worst(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(e[k] for e in per_call) for k in per_call[0]}

