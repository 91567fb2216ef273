"""The rooted cells: one caller in a closed loop over
``LikelihoodEngine.rooted_phylo_gradients`` on dated rooted trees under a
strict clock, each call made from host arrays and waited for.

The closed loop, its latency (two CUDA events a call), the traced calls and
the keeping of the checked calls are the engine cells' (drivers/engine.py,
whose Driver this one extends): a call there is ``_call`` of one set of
the traffic, here a set of height ratios.

The configuration's tree is read by the program (``RootedTreeCollection``,
its dates from the taxon names and its height ratios) and by the reference
(reference/rooted.py), each for itself; a ratio set is the same numbers in
each one's node order, matched by each internal node's leaf set
(layout.node_masks).

Traffic parameters (``traffic/<name>.json``): ``batch`` (trees a call:
copies of the configuration's tree, one a chain), ``ratio_sets`` (that many
sets made from the seed in set-up, each the tree's non-root ratios times
U(0.95, 1.05), clipped to [1e-4, 1 - 1e-4], and its root height times
U(1.00, 1.05), so that it never falls below its bound; call i takes set i
mod ratio_sets), ``clock_rate`` (the strict clock's rate), ``check_calls``
and ``trace_calls`` (as the engine cells').
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import layout
from portbench.drivers import engine
from portbench.harness import path
from portbench.reference import alignment, rooted
from portbench.work_rooted import RootedShape

# The outputs the cell checks, as the program names them.
OUTPUTS = ("log_likelihood", "ratios_root_height", "clock_model")


class Driver(engine.Driver):
    def __init__(self, cfg: Dict, traffic: Dict, device, fault=None):
        from libsbn_tpu_torch.core.site_pattern import SitePattern
        from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection
        from libsbn_tpu_torch.io import newick
        from libsbn_tpu_torch.io.fasta import Alignment
        from libsbn_tpu_torch.models.engine import LikelihoodEngine
        from libsbn_tpu_torch.models.phylo_model import PhyloModelSpec

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fault = fault
        m = cfg["model"]
        if (m["substitution"], m["site"], m["clock"]) != ("JC69", "constant",
                                                           "strict"):
            raise ValueError("the rooted cells run JC69, one category, a "
                             "strict clock")
        tops, bls, ttm = newick.parse_newick_file(path(cfg["trees"]))
        coll = RootedTreeCollection(
            [RootedTree(t, b) for t, b in zip(tops, bls)], ttm)
        coll.parse_dates_from_taxon_names(True)
        self.tree = coll.trees[0]
        self.ref_tree = rooted.read_time_tree(path(cfg["trees"]))
        self.pats = alignment.patterns(path(cfg["alignment"]),
                                       self.ref_tree.taxa)
        self.taxon_of_leaf = layout.taxon_map(
            [ttm[(i, 1)] for i in range(len(ttm))], self.ref_tree.taxa)
        sp = SitePattern(Alignment.read_fasta(path(cfg["alignment"])), ttm)
        dtype = {"float32": torch.float32, "float64": torch.float64}[
            cfg["dtype"]]
        self.engine = LikelihoodEngine(
            sp, PhyloModelSpec("JC69", "constant", "strict"), dtype=dtype,
            device=device)
        self.params = {"clock": {"rate": torch.tensor(1.0,
                                                      dtype=torch.float64)}}
        # The traced calls' span: portbench.engine.rooted_phylo_gradients.
        self.entry = "rooted_phylo_gradients"
        self.shape = RootedShape("JC69", int(traffic["batch"]),
                                 self.ref_tree.leaf_count, 1,
                                 len(self.pats.weights), cfg["dtype"])
        self.sweeps = None

    # -- traffic ------------------------------------------------------------
    def prepare(self, seed: int):
        """The seed's traffic: the ratio sets in the reference's order and
        the program's, the program's schedule of the batch; then the shape
        warmed up (a key's first call runs eagerly, its second captures,
        its third replays)."""
        from libsbn_tpu_torch.ops import schedule

        tr = self.traffic
        rng = np.random.default_rng(seed)
        B, n_sets = int(tr["batch"]), int(tr["ratio_sets"])
        base = self.ref_tree.ratios
        scale = np.concatenate([
            rng.uniform(0.95, 1.05, size=(n_sets, B, len(base) - 1)),
            rng.uniform(1.00, 1.05, size=(n_sets, B, 1))], axis=2)
        self.ref_sets = base * scale
        self.ref_sets[..., :-1] = np.clip(self.ref_sets[..., :-1], 1e-4,
                                          1 - 1e-4)
        self.check_rng = np.random.default_rng([seed, 1])
        self.sched = schedule.schedules_of_topologies([self.tree.topology] * B)
        L = self.sched.leaf_count
        # The program's ratio j (node L + j, the root last) is the
        # reference's ratio of the node with the same leaf set.
        mask = layout.node_masks(self.sched.post_children[0], L,
                                 self.taxon_of_leaf)
        ref_index = {m: j for j, m in enumerate(self.ref_tree.masks)}
        self.order = np.array([ref_index[mask[L + j]] for j in range(L - 1)])
        self.sets = self.ref_sets[..., self.order]
        # The program's bounds come from its own dates; its ratios of the
        # file's tree are the sets' base.
        if not np.allclose(self.tree.height_ratios, base[self.order],
                           rtol=1e-9, atol=0):
            raise RuntimeError("the program's height ratios of the file's "
                               "tree are not the reference's")
        self.bounds = np.tile(self.tree.node_bounds, (B, 1))
        self.rates = np.full((B, self.sched.node_count - 1),
                             float(tr["clock_rate"]))
        for j in range(3):
            self._call(self.sets[j % n_sets])
        self._sync()

    def _call(self, ratios):
        out = self.engine.rooted_phylo_gradients(
            self.sched, self.bounds, ratios, self.rates, self.params,
            strict_clock=True)
        return self._break(ratios, {k: out[k] for k in OUTPUTS})

    def _break(self, ratios, out):
        """The faults the harness's tests plant under the timed path: the
        engine cells' two on the ratio gradient, and that gradient without
        the log-det-Jacobian's term (the program's own adjoint of the
        Jacobian alone, in float64, taken off)."""
        if self.fault is None:
            return out
        out = {k: v.clone() for k, v in out.items()}
        g = out["ratios_root_height"]
        if self.fault == "altered_answer":
            row = g.shape[0] // 3
            g[row, g.shape[1] // 2] += 0.5 * g[row].abs().max()
        elif self.fault == "half_batch":
            half = g.shape[0] // 2
            for v in out.values():
                v[half:] = v[:half].mean(0)
        elif self.fault == "no_jacobian":
            from libsbn_tpu_torch.ops import heights

            s, t = self.sched, torch.as_tensor
            jac, _, _ = heights.ratio_and_rate_gradients_from_branch_gradient(
                torch.zeros(self.rates.shape, dtype=torch.float64),
                t(ratios), t(self.bounds), t(self.rates), s.leaf_count,
                *(t(np.asarray(x)).long() for x in (
                    s.pre_internal_node, s.pre_internal_parent, s.parent)),
                self.engine._height_iters(s))
            g -= jac.to(g.device, g.dtype)
        else:
            raise ValueError(f"no fault {self.fault!r}")
        return out

    def traced(self, n: int):
        """The engine cells' traced calls; counts the heights sweeps they
        run where the program counts them (``ops/heights.py SWEEPS``)."""
        from libsbn_tpu_torch.ops import heights

        counter = getattr(heights, "SWEEPS", None)
        before = sum(counter.values()) if counter is not None else None
        super().traced(n)
        if counter is not None:
            self.sweeps = sum(counter.values()) - before

    def work(self) -> Dict:
        return {"shape": self.shape, "call_job": "ll_bgrad",
                "height_sweeps": self.sweeps}

    # -- correctness ----------------------------------------------------------
    def reference(self, j: int, control: bool = False):
        dev = "cuda" if self.device.type == "cuda" else "cpu"
        return rooted.evaluate(self.ref_tree, self.pats, self.ref_sets[j],
                               float(self.traffic["clock_rate"]), device=dev,
                               control=control)

    def _program(self, out):
        """The program's outputs in the reference's layout."""
        g = np.zeros_like(out["ratios_root_height"])
        g[:, self.order] = out["ratios_root_height"]
        return {"ll": out["log_likelihood"], "ratio": g,
                "clock": out["clock_model"].reshape(-1)}

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
        return engine.worst(self.per_call)

    def control(self) -> Dict[str, float]:
        """The same numbers with the control (the reference in TF32) in the
        program's place, on the kept calls' ratio sets."""
        return engine.worst([errors(self.reference(j, control=True), ref)
                             for j, ref in self._refs.items()])


def errors(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: ll_rel, each tree's log-likelihood gap over
    its magnitude; ratio_rel, each tree's largest ratio or root-height
    gradient gap over its largest reference entry; clock_rel, each tree's
    clock-rate gradient gap over its magnitude. The worst tree of each;
    NaN reads as infinity."""
    gap = np.abs(got["ratio"] - ref["ratio"]).max(1)
    out = {"ll_rel": np.abs(got["ll"] - ref["ll"]) / np.abs(ref["ll"]),
           "ratio_rel": gap / np.abs(ref["ratio"]).max(1),
           "clock_rel": np.abs(got["clock"] - ref["clock"])
           / np.abs(ref["clock"])}
    return {k: float(np.nan_to_num(v, nan=np.inf).max())
            for k, v in out.items()}
