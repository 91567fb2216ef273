"""The rooted engine's calls as captured CUDA graphs: one replay a call.

The JAX engine jits its rooted hand route (libsbn_tpu/models/engine.py
``_rooted_phylo_gradients_hand``, cached by ("rooted_grad_hand", root_id,
n_height_iters, heights_method)) and its rooted LLs (``_rooted_core``), so
a call is one dispatch. Eagerly, the port's hand route is a few hundred
small launches (64 heights sweeps of fluA and their adjoint around one K1
launch), whose enqueue takes the host longer than the card takes to run
them. ``RootedGraphs`` captures each of the two programs once per key and
replays it:

* the key holds what the JAX cache keys hold, the shapes and the model's
  layout: (route, B, S, N, leaf_count, root_id, n_height_iters,
  heights_method, K, dtype, and the model parameters' shapes); never the
  schedule object, which RootedInstance rebuilds on every call;
* the inputs are two static buffers, filled by one host-to-device copy
  each: the schedule's index arrays packed as int32 (post_children,
  pre_internal_node, pre_internal_parent, parent; packed once per schedule
  object and cached on it), and float64 values (bounds, ratios, clock
  rates, then the model's parameters: the Weibull shape, GTR's rates and
  frequencies and the eigensystem of its Q, which the host solves ahead as
  ``expm_transition`` does, since a graph cannot read the device from the
  host);
* the captured function unpacks them, casting to the working dtype as the
  eager call's uploads do, and runs the engine's own code
  (``_rooted_hand``, ``_rooted_lls``), so a replay equals the eager call
  bit for bit where its sums have a fixed order (K1, K2, K3, K5 and the
  heights' gathers do);
* outputs are cloned out of the graph's pool.

utils/graphs.py's ``Graph`` does the capture (warm-up, pool, launch counts).
On the CPU a Graph calls its function as is: the CPU tests run the packed
path against the eager one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.phylo_model import substitution_tensors
from ..ops import pruning_jc, pruning_vjp
from ..utils.graphs import Graph

# Captures and replays of the rooted programs; reset_counters() sets them
# to 0.
COUNTS = {"captures": 0, "replays": 0}
# What a rooted program launches: K1-K3, and K5 for GTR LLs.
_COUNTERS = (pruning_jc.LAUNCHES, pruning_vjp.LAUNCHES)
_INT_NAMES = ("post_children", "pre_internal_node", "pre_internal_parent",
              "parent")


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def _host_f64(x):
    """An array or tensor anywhere as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


class _Program(NamedTuple):
    graph: Graph
    ints: torch.Tensor  # int32, the packed schedule
    floats: torch.Tensor  # float64: bounds, ratios, rates, the model


class RootedGraphs:
    """The captured rooted programs of one LikelihoodEngine, by key."""

    def __init__(self, engine):
        self.engine = engine
        self.programs = {}

    def log_likelihoods(self, sched, bounds, ratios, rates, params):
        """(LLs (B,), log-det-Jacobians (B,)) as rooted_log_likelihoods
        computes them, by one replay."""
        lls, ldjs = self._run("ll", sched, (bounds, ratios, rates), params)
        return lls.clone(), ldjs.clone()

    def phylo_gradients(self, sched, bounds, ratios, rates, params,
                        strict_clock):
        """The hand route's gradient dict, by one replay."""
        out = self._run(("hand", bool(strict_clock)), sched,
                        (bounds, ratios, rates), params)
        return {k: v.clone() for k, v in out.items()}

    def _model_leaves(self, params):
        """[((group, name), float64 host array)] of the parameters the
        engine's model reads, in packing order."""
        spec = self.engine.spec
        names = []
        if spec.substitution == "GTR":
            names += [("substitution", "rates"),
                      ("substitution", "frequencies")]
        if spec.site.startswith("weibull"):
            names.append(("site", "shape"))
        return [(n, _host_f64(params[n[0]][n[1]])) for n in names]

    def _eigen(self, params, route):
        """GTR's eigensystem of Q for the LL route, as float64 host arrays
        (_node_P solves it so), or ()."""
        eng = self.engine
        if route != "ll" or eng.spec.substitution != "GTR":
            return ()
        freqs, Q = substitution_tensors(eng.spec, params, device=eng.device)
        return tuple(x.numpy() for x in eng._gtr_eigen(Q, freqs))

    def _run(self, route, sched, arrays, params):
        """Fill the program's buffers (capturing it first if its key is
        new) and replay it once; returns its outputs, in its pool."""
        eng = self.engine
        cache = eng._sched_cache(sched)
        ints = cache.get("rooted_ints")
        if ints is None:
            ints = cache["rooted_ints"] = np.concatenate([
                np.asarray(getattr(sched, n), np.int32).ravel()
                for n in _INT_NAMES])
        arrays = [_host_f64(x) for x in arrays]
        leaves = self._model_leaves(params)
        eigen = self._eigen(params, route)
        floats = np.concatenate([x.ravel() for x in arrays]
                                + [x.ravel() for _, x in leaves]
                                + [x.ravel() for x in eigen])
        B, S, _ = np.shape(sched.post_children)
        key = (route, B, S, sched.node_count, sched.leaf_count, sched.root_id,
               eng._height_iters(sched), eng.heights_method,
               eng.spec.site_category_count(), eng.dtype,
               tuple(x.shape for x in arrays),
               tuple((n, x.shape) for n, x in leaves),
               tuple(x.shape for x in eigen))
        prog = self.programs.get(key)
        if prog is None:
            # Kept only once its graph has been captured and replayed.
            prog = self._program(
                key, sched, ints, floats, [x.shape for x in arrays],
                [(n, x.shape) for n, x in leaves], [x.shape for x in eigen])
            out = prog.graph()
            self.programs[key] = prog
            return out
        prog.ints.copy_(torch.from_numpy(ints))
        prog.floats.copy_(torch.from_numpy(floats))
        return prog.graph()

    def _program(self, key, sched, ints, floats, array_shapes, leaf_shapes,
                 eigen_shapes):
        """The buffers of a new key, filled, and the Graph of its route
        over views of them."""
        eng = self.engine
        dev, dt = eng.device, eng.dtype
        # Copies, also on the CPU: ints is the schedule's cached array.
        ints_t = torch.tensor(ints, device=dev)
        floats_t = torch.tensor(floats, device=dev)
        offset = [0, 0]

        def take(buf, i, shape):
            n = int(np.prod(shape, dtype=np.int64))
            view = buf[offset[i]:offset[i] + n].view(shape)
            offset[i] += n
            return view

        pc, pre_node, pre_parent, parent = (
            take(ints_t, 0, np.shape(getattr(sched, n))) for n in _INT_NAMES)
        bounds, ratios, rates = (take(floats_t, 1, s) for s in array_shapes)
        params = {}
        for (group, name), shape in leaf_shapes:
            params.setdefault(group, {})[name] = take(floats_t, 1, shape)
        eigen = tuple(take(floats_t, 1, s) for s in eigen_shapes) or None
        route = key[0]
        statics = {"n_iters": key[6], "leaf_count": sched.leaf_count,
                   "root_id": sched.root_id}

        def program():
            # The eager call's uploads: index arrays as int64 (the child
            # table int32), time-tree arrays in the working dtype.
            a = {"pc": pc, "pre_node": pre_node.long(),
                 "pre_parent": pre_parent.long(), "parent": parent.long(),
                 "bounds": bounds.to(dt), "ratios": ratios.to(dt),
                 "rates": rates.to(dt), **statics}
            if route == "ll":
                return eng._rooted_lls(a, params, eigen)
            return eng._rooted_hand(a, params, strict_clock=route[1])

        return _Program(Graph(program, dev, _COUNTERS, COUNTS), ints_t,
                        floats_t)
