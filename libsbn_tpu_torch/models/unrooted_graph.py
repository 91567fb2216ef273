"""The unrooted engine's calls as captured CUDA graphs: one replay a call.

The JAX engine jits every unrooted call (libsbn_tpu/models/engine.py
``_cached``: ("ll_pallas", root_id), ("bgrad_pallas", root_id) and the
model-parameter gradients), so a call is one dispatch. Eagerly, the port's
calls are tens of small launches around their kernels (the padding and
casts of the branch lengths, the model's tensors, GTR's transition
matrices, the model gradients' autograd), whose enqueue takes the host
longer than the card takes to run them. ``UnrootedGraphs`` keeps each
route by key, under utils/graphs.py's capture policy, and replays it:

* routes: "ll" (``log_likelihoods``: K2, or K5 for GTR), "bgrad"
  (``branch_gradients``: K1, or K4 for GTR) and "phylo"
  (``phylo_gradients``: K1 or K4, then the model-parameter gradients, K2 +
  K3 for JC69 + Weibull, K5 + K6 for GTR, all in one graph);
* the key holds the shapes and statics: (route, B, S, N, leaf_count,
  root_id, K, dtype, spec, use_tip_states and the parameters' names, the
  packed arrays' shapes added by utils/graphs.py); never the schedule
  object, which the instances rebuild on every call, so a new schedule of
  the same shapes replays the same graph;
* the inputs are two static buffers, each filled by one host-to-device
  copy a call: the schedule's child table as int32 (not copied again while
  the schedule object repeats), and float64 values
  (the branch lengths, the model's parameters, and GTR's eigensystem of
  its shared Q, which the host solves ahead in one NumPy pass as the eager
  call does, ``engine._shared_eigen``);
* the captured function unpacks them, casting to the working dtype as the
  eager call's uploads do, and runs the engine's own code (``_lls``,
  ``_branch_gradients``, ``_phylo_gradients``), so a replay equals the
  eager call bit for bit (the sums of K1-K6 have a fixed order); the
  model gradients run their backward (K3, K6 and expm_transition's)
  inside the capture;
* outputs are cloned out of the graph's pool as soon as the replay is
  enqueued, before any other replay: the engine's unrooted and rooted
  graphs share one pool.

A call's spans (utils/profiling.py ``annotate``, recorded only under
torch.profiler; none inside the captured function): ``libsbn.engine.call``
around the whole call (its time outside the others is the host's own
dispatch), and inside it, in order, ``libsbn.engine.model_inputs`` (the
parameters to the host, GTR's NumPy eigen solve), utils/graphs.py's
``libsbn.graphs.pack``, ``upload_ints`` (when the schedule object differs
from the key's last call's), ``upload_floats`` and ``replay`` (``eager``
or ``capture`` on a key's first calls), then ``libsbn.engine.clone``.

The schedule is checked once per schedule object before the replay
(``engine._sched_cache``). On the CPU a Graph calls its function as is:
the CPU tests run the packed path against the eager one.
"""

from __future__ import annotations

import numpy as np

from ..ops import pruning_generic, pruning_jc, pruning_vjp
from ..utils.graphs import PackedPrograms, host_f64
from ..utils.profiling import annotate
from .rooted_graph import model_inputs, unpack_model

# Captures, replays and eager calls of the unrooted programs;
# reset_counters() sets them to 0.
COUNTS = {"captures": 0, "replays": 0, "eager": 0}
# What an unrooted program launches: K1-K3, K4, K5 + K6.
_COUNTERS = (pruning_jc.LAUNCHES, pruning_generic.LAUNCHES,
             pruning_vjp.LAUNCHES)
ROUTES = ("ll", "bgrad", "phylo")


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


class UnrootedGraphs:
    """The captured unrooted programs of one LikelihoodEngine, by key."""

    def __init__(self, engine):
        self.engine = engine
        # The engine's graphs, rooted and unrooted, share its memory pool.
        self.programs = PackedPrograms(engine.device, _COUNTERS, COUNTS,
                                       engine.graph_pool)

    def log_likelihoods(self, sched, branch_lengths, params):
        """(B,) LLs as log_likelihoods computes them, by one replay."""
        with annotate("libsbn.engine.call"):
            lls = self.run("ll", sched, branch_lengths, params)
            with annotate("libsbn.engine.clone"):
                return lls.clone()

    def branch_gradients(self, sched, branch_lengths, params):
        """(LLs (B,), branch gradients (B, N-1)), by one replay."""
        with annotate("libsbn.engine.call"):
            lls, grads = self.run("bgrad", sched, branch_lengths, params)
            with annotate("libsbn.engine.clone"):
                return lls.clone(), grads.clone()

    def phylo_gradients(self, sched, branch_lengths, params):
        """phylo_gradients' dict, by one replay."""
        with annotate("libsbn.engine.call"):
            out = self.run("phylo", sched, branch_lengths, params)
            with annotate("libsbn.engine.clone"):
                return {k: v.clone() for k, v in out.items()}

    def run(self, route, sched, branch_lengths, params):
        """Fill the route's buffers (capturing it first if its key is new)
        and replay it once; returns its outputs, in its pool."""
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        eng = self.engine
        eng._sched_cache(sched)  # checks the schedule once per object
        leaves, eigen = model_inputs(eng, params)
        names = [n for n, _ in leaves]
        B, S, _ = np.shape(sched.post_children)
        root_id = sched.root_id
        key = (route, B, S, sched.node_count, sched.leaf_count, root_id,
               eng.spec.site_category_count(), eng.dtype, eng.spec,
               eng.use_tip_states, tuple(names))

        def make(ints, floats):
            (pc,) = ints
            params, eigen_v = unpack_model(names, floats[1:])
            bl_host = floats[0]

            def program():
                bl = eng._bl_padded(bl_host)
                if route == "ll":
                    return eng._lls(pc, bl, eng._model(params), root_id,
                                    eigen_v)
                if route == "bgrad":
                    return eng._branch_gradients(pc, bl, params, root_id,
                                                 eigen_v)
                return eng._phylo_gradients(pc, bl, params, root_id, eigen_v)

            return program

        return self.programs.run(
            key, [sched.post_children],
            [host_f64(branch_lengths)] + [x for _, x in leaves] + list(eigen),
            make, sched)
