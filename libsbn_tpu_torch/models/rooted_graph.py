"""The rooted engine's calls as captured CUDA graphs: one replay a call.

The JAX engine jits its rooted hand route (libsbn_tpu/models/engine.py
``_rooted_phylo_gradients_hand``, cached by ("rooted_grad_hand", root_id,
n_height_iters, heights_method)), its autograd route (("rooted_grad_pallas",
...)) and its rooted LLs (``_rooted_core``), so a call is one dispatch.
Eagerly, the port's autograd route and rooted LLs are a few hundred small
launches (the heights sweeps of ops/heights.py, 32 for fluA, and for the
autograd route their backward), whose enqueue takes the host longer than
the card takes to run them; the hand route is two heights kernels (the
sweeps and their adjoint, csrc/heights.cu) around one K1 launch and a few
small ops, or, with ``heights_method="squaring"``, as many launches as the
others.
``RootedGraphs`` keeps each of the three programs by key, under
utils/graphs.py's capture policy, and replays it:

* the key holds what the JAX cache keys hold, the shapes and the model's
  layout: (route, B, S, N, leaf_count, root_id, n_height_iters,
  heights_method, K, dtype, and the model parameters' shapes); never the
  schedule object, which RootedInstance rebuilds on every call;
* the inputs are two static buffers, filled by one host-to-device copy
  each: the schedule's index arrays packed as int32 (post_children,
  pre_internal_node, pre_internal_parent, parent; not copied again while
  the schedule object repeats), and float64 values (bounds, ratios, clock
  rates, then the model's parameters: the Weibull shape, GTR's rates and
  frequencies and the eigensystem of its Q, which the host solves ahead
  in one NumPy pass (``engine._shared_eigen``, as the eager calls do),
  since a graph cannot read the device from the host);
* the captured function unpacks them, as the eager call's uploads make
  them (the time-tree arrays stay float64: the engine's time-tree
  arithmetic is float64 whatever the working dtype), and runs the engine's
  own code
  (``_rooted_hand``, ``_rooted_autograd``, ``_rooted_lls``), so a replay
  equals the eager call bit for bit where its sums have a fixed order (K1,
  K2, K3, K5, K6, the heights kernels and the heights' gathers do); the
  autograd route runs its backward (the custom Functions of K2/K3, K5/K6
  and expm_transition) inside the capture;
* outputs are cloned out of the graph's pool as soon as the replay is
  enqueued, before any other replay: the engine's rooted and unrooted
  graphs share one pool.

A call opens the spans of an unrooted call (models/unrooted_graph.py), in
the same order, and before ``libsbn.engine.model_inputs`` its own:
``libsbn.rooted.arrays``, the time-tree arrays' host copies and the sweep
count (``engine._height_iters``, cached on the schedule). A replay adds
its capture's heights sweeps and heights kernels to ``ops/heights.py
SWEEPS`` and ``LAUNCHES``, as it adds its pruning kernels' launches.

utils/graphs.py's ``PackedPrograms`` does the packing and keeps the
programs, and ``Graph`` the capture (warm-up, pool, launch counts). On the
CPU a Graph calls its function as is: the CPU tests run the packed path
against the eager one.
"""

from __future__ import annotations

import numpy as np

from ..ops import heights, pruning_jc, pruning_vjp
from ..utils.graphs import PackedPrograms, host_f64
from ..utils.profiling import annotate

# Captures, replays and eager calls of the rooted programs;
# reset_counters() sets them to 0.
COUNTS = {"captures": 0, "replays": 0, "eager": 0}
# What a rooted program launches (K1-K3, K5 + K6 for GTR, the heights
# kernels) and the heights sweeps it runs.
_COUNTERS = (pruning_jc.LAUNCHES, pruning_vjp.LAUNCHES, heights.LAUNCHES,
             heights.SWEEPS)
_INT_NAMES = ("post_children", "pre_internal_node", "pre_internal_parent",
              "parent")


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def model_leaves(spec, params):
    """[((group, name), float64 host array)] of the parameters an engine
    of ``spec`` reads, in packing order."""
    names = []
    if spec.substitution == "GTR":
        names += [("substitution", "rates"), ("substitution", "frequencies")]
    if spec.site.startswith("weibull"):
        names.append(("site", "shape"))
    return [(n, host_f64(params[n[0]][n[1]])) for n in names]


def model_inputs(engine, params):
    """(the parameter leaves, GTR's eigensystem as host arrays or ()) that
    a graph of ``engine`` packs for ``params``; the eigensystem is solved
    from the leaves' float64 host copies, in one NumPy pass
    (``engine._shared_eigen``), so the card is read once a leaf. Span
    ``libsbn.engine.model_inputs``."""
    with annotate("libsbn.engine.model_inputs"):
        leaves = model_leaves(engine.spec, params)
        host = {}
        for (group, name), x in leaves:
            host.setdefault(group, {})[name] = x
        eigen = engine._shared_eigen(host)
        return leaves, () if eigen is None else tuple(x.numpy()
                                                      for x in eigen)


def unpack_model(names, views):
    """(params dict, eigen or None) from the float views of the leaves
    ``names`` and then the eigensystem's."""
    params = {}
    for (group, name), view in zip(names, views):
        params.setdefault(group, {})[name] = view
    return params, tuple(views[len(names):]) or None


class RootedGraphs:
    """The captured rooted programs of one LikelihoodEngine, by key."""

    def __init__(self, engine):
        self.engine = engine
        # The engine's graphs, rooted and unrooted, share its memory pool.
        self.programs = PackedPrograms(engine.device, _COUNTERS, COUNTS,
                                       engine.graph_pool)

    def log_likelihoods(self, sched, bounds, ratios, rates, params):
        """(LLs (B,), log-det-Jacobians (B,)) as rooted_log_likelihoods
        computes them, by one replay."""
        with annotate("libsbn.engine.call"):
            lls, ldjs = self._run("ll", sched, (bounds, ratios, rates),
                                  params)
            with annotate("libsbn.engine.clone"):
                return lls.clone(), ldjs.clone()

    def phylo_gradients(self, sched, bounds, ratios, rates, params,
                        strict_clock, route="hand"):
        """The gradient dict of the hand route (JC69 with rescaling) or the
        autograd route, by one replay."""
        if route not in ("hand", "autograd"):
            raise ValueError(f"route must be hand or autograd, got {route!r}")
        with annotate("libsbn.engine.call"):
            out = self._run((route, bool(strict_clock)), sched,
                            (bounds, ratios, rates), params)
            with annotate("libsbn.engine.clone"):
                return {k: v.clone() for k, v in out.items()}

    def _run(self, route, sched, arrays, params):
        """Fill the program's buffers (capturing it first if its key is
        new) and replay it once; returns its outputs, in its pool."""
        eng = self.engine
        eng._sched_cache(sched)  # checks the schedule once per object
        with annotate("libsbn.rooted.arrays"):
            arrays = [host_f64(x) for x in arrays]
            n_iters = eng._height_iters(sched)
        leaves, eigen = model_inputs(eng, params)
        names = [n for n, _ in leaves]
        B, S, _ = np.shape(sched.post_children)
        method = eng.heights_method
        key = (route, B, S, sched.node_count, sched.leaf_count, sched.root_id,
               n_iters, method, eng.spec.site_category_count(), eng.dtype,
               tuple(names))
        statics = {"n_iters": n_iters, "leaf_count": sched.leaf_count,
                   "root_id": sched.root_id}

        def make(ints, floats):
            pc, pre_node, pre_parent, parent = ints
            bounds, ratios, rates = floats[:3]
            params, eigen_v = unpack_model(names, floats[3:])

            def program():
                # The eager call's uploads: index arrays int32 and
                # time-tree arrays float64, the buffers' own types.
                a = {"pc": pc, "pre_node": pre_node, "pre_parent": pre_parent,
                     "parent": parent, "bounds": bounds, "ratios": ratios,
                     "rates": rates, **statics}
                if route == "ll":
                    return eng._rooted_lls(a, params, eigen_v)
                if route[0] == "autograd":
                    return eng._rooted_autograd(a, params, route[1], eigen_v)
                return eng._rooted_hand(a, params, strict_clock=route[1])

            return program

        return self.programs.run(
            key, [getattr(sched, n) for n in _INT_NAMES],
            arrays + [x for _, x in leaves] + list(eigen), make, sched)
