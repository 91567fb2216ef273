"""Forest's evaluation surfaces as captured CUDA graphs: one replay a call.

The JAX package compiles each forest surface into one program
(``jax.jit(jax.vmap(...))`` over a closed-over schedule: the JAX
repository's tools/forest_scale.py and its bench's forest configuration).
Eagerly, a call of the port's ops/forest.py is hundreds of small launches,
one chain of gathers and elementwise ops a level, whose enqueue takes the
host longer than the card takes to run them. ``ForestGraphs`` captures
each surface once per key and replays it:

* surfaces: "ll" (``forest_jc_log_likelihoods_and_gradients(...,
  ll_only=True)``, the LLs), "grad" (the same with the per-tree branch
  gradients, at any ``gather_dtype``, bfloat16 in the bench) and "split"
  (``forest_jc_weighted_ll_and_split_gradient``: the LLs and the gradient
  summed onto splits, autograd's backward inside the capture);
* the key is (surface, forest schedule, the lengths' shape and dtype, the
  working dtype, the gather dtype). A ForestGraphs holds one alignment's
  tips and weights, uploaded once a working dtype, and every forest
  schedule a key names (so that an id in a key is never reused while the
  key exists);
* capture policy (utils/graphs.py ``PackedPrograms``): a key's first call
  runs the eager function, its second captures it, later calls replay it;
  the keys share one memory pool, and outputs are cloned out of it as soon
  as the replay is enqueued;
* the lengths are copied into the key's static buffer on each replay (a
  device-to-device copy when they lie on the card); the forest's index
  arrays are on the card already, uploaded once a schedule
  (``forest._device_schedule``).

A replay runs the eager function's own ops over the same inputs, so it
equals the eager call bit for bit: the gradient of the split surface is
the backward of forest's gathers, an ``index_put_`` with accumulation that
sums each index's terms in a fixed order. On a device that is not CUDA
(the CPU tests) every call runs the eager function.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..utils.graphs import SEEN_CAP, Graph
from . import forest

# Captures and replays of the forest programs; reset_counters() sets them
# to 0.
COUNTS = {"captures": 0, "replays": 0}
SURFACES = ("ll", "grad", "split")


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def eager(surface, fs, bl_splits, tips, weights, dtype=torch.float32,
          gather_dtype=None):
    """The eager call of ``surface``: "ll" returns the LLs, "grad" (LLs,
    per-tree branch gradients), "split" (LLs, split gradient)."""
    if surface == "ll":
        return forest.forest_jc_log_likelihoods_and_gradients(
            fs, bl_splits, tips, weights, ll_only=True, dtype=dtype)[0]
    if surface == "grad":
        return forest.forest_jc_log_likelihoods_and_gradients(
            fs, bl_splits, tips, weights, dtype=dtype,
            gather_dtype=gather_dtype)
    if surface == "split":
        return forest.forest_jc_weighted_ll_and_split_gradient(
            fs, bl_splits, tips, weights, dtype=dtype)
    raise ValueError(f"surface must be one of {SURFACES}, got {surface!r}")


class _Key:
    """A captured key: its graph and the static buffer of its lengths."""

    def __init__(self, graph, bl):
        self.graph = graph
        self.bl = bl


class ForestGraphs:
    """The captured forest surfaces over one alignment's tips (L, 4, P) and
    weights (P,), on ``device`` (the card unless "cpu"; tensors compute
    where they lie, as ops/forest.py's calls do)."""

    def __init__(self, tips, weights, device=None):
        self.device = forest._target_device(device, tips, weights)
        self.tips, self.weights = tips, weights
        self._inputs = {}  # working dtype -> (tips, weights) on the device
        self.forests = {}  # id -> every forest schedule a key names
        self.programs = {}
        self.seen = OrderedDict()
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)

    def __len__(self):
        return len(self.programs)

    def log_likelihoods(self, fs, bl_splits, dtype=torch.float32):
        """(T,) or (R, T) LLs, by one replay."""
        return self.run("ll", fs, bl_splits, dtype).clone()

    def log_likelihoods_and_gradients(self, fs, bl_splits,
                                      dtype=torch.float32, gather_dtype=None):
        """(LLs, per-tree branch gradients), by one replay."""
        ll, grad = self.run("grad", fs, bl_splits, dtype, gather_dtype)
        return ll.clone(), grad.clone()

    def weighted_ll_and_split_gradient(self, fs, bl_splits,
                                       dtype=torch.float32):
        """(LLs, gradient of their sum by split), by one replay."""
        ll, g = self.run("split", fs, bl_splits, dtype)
        return ll.clone(), g.clone()

    def inputs(self, dtype):
        """The tips and weights on the device at ``dtype``, uploaded once."""
        if dtype not in self._inputs:
            self._inputs[dtype] = tuple(
                forest._as(x, dtype, self.device)
                for x in (self.tips, self.weights))
        return self._inputs[dtype]

    def run(self, surface, fs, bl_splits, dtype=torch.float32,
            gather_dtype=None):
        """Fill the key's lengths (capturing it first on its second call)
        and replay it once; returns its outputs, in the pool on a
        replay."""
        if surface not in SURFACES:
            raise ValueError(f"surface must be one of {SURFACES}, "
                             f"got {surface!r}")
        bl = forest._tensor(bl_splits)
        if surface != "grad":
            gather_dtype = None
        key = (surface, id(fs), tuple(bl.shape), bl.dtype, dtype, gather_dtype)
        tips, weights = self.inputs(dtype)
        prog = self.programs.get(key)
        if prog is not None:
            prog.bl.copy_(bl)
            return prog.graph()
        bl = bl.to(self.device)
        if self.device.type != "cuda" or key not in self.seen:
            # The first call (or any call off the card) runs eagerly.
            self.seen[key] = fs
            if len(self.seen) > SEEN_CAP:
                self.seen.popitem(last=False)
            return eager(surface, fs, bl, tips, weights, dtype, gather_dtype)
        del self.seen[key]
        static = bl.clone()
        graph = Graph(lambda: eager(surface, fs, static, tips, weights, dtype,
                                    gather_dtype),
                      self.device, (), COUNTS, pool=self.pool)
        self.forests[id(fs)] = fs
        out = graph()
        self.programs[key] = _Key(graph, static)
        return out


def to_numpy(out):
    """A surface's outputs (a tensor or a tuple of tensors) as float64
    numpy arrays on the host."""
    if isinstance(out, torch.Tensor):
        return out.detach().to("cpu", torch.float64).numpy()
    return tuple(to_numpy(x) for x in out)


def bit_for_bit(a, b) -> bool:
    """Whether two surfaces' outputs are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return all(bit_for_bit(x, y) for x, y in zip(a, b))
