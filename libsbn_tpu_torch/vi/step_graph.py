"""One dispatch per window of VBPI steps on a card: captured CUDA graphs of
vi/jit_step.py's ``vbpi_train_steps_packed``.

The JAX package compiles a step, and a window of K steps (a lax.scan), into
one XLA program and dispatches it once. PyTorch runs eagerly: one step of
the port is a few hundred small kernel launches, whose enqueue takes the
host longer than an H100 takes to run them. A CUDA graph is PyTorch's
counterpart of a compiled program with fixed shapes, and every shape of a
VBPI step is fixed per JitVBPI (``touched`` is padded to 4L by
``_topology_artifacts``). So ``StepGraphs`` captures one graph per window
length K and replays it:

* the trainer's state tensors are the graphs' static buffers: a graph
  reads them at the window's start and copies the new state into them at
  its end, and ``assign`` copies a state into them between windows;
* the window's inputs are two static buffers, the packed ints (K, P, W)
  and the floats (eps (K, P, B), then betas (K,)), each filled by one
  host-to-device copy before the replay (spans ``libsbn.graphs.upload_ints``
  and ``libsbn.graphs.upload_floats``, as utils/graphs.py's);
* before a capture, one step of the window runs on a side stream and its
  result is dropped, its launches counted as any launch is;
* each graph has its own memory pool; the metrics are copied out of it
  after each replay.

The capture itself (the warm-up, the pool, the launch counts taken back at
capture and added at each replay, errors raised) is utils/graphs.py's
``Graph``. A window of other shapes than the first raises; nothing here
falls back to eager steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import pruning, pruning_jc
from ..utils.graphs import Graph
from ..utils.profiling import annotate

# Captures and replays of window graphs, so a run can show that a window
# was one replay. reset_counters() sets them to 0.
COUNTS = {"captures": 0, "replays": 0}
# The counters of what a step may launch or call (K1, or the scan engine).
_STEP_COUNTERS = (pruning_jc.LAUNCHES, pruning.CALLS)


def reset_counters():
    for name in COUNTS:
        COUNTS[name] = 0


def leaves(state):
    """The tensors of a state (nested tuples of tensors), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for part in state for leaf in leaves(part)]


class _Window(NamedTuple):
    graph: Graph  # returns (metrics, K), in the metrics' names' order
    packed: torch.Tensor  # (K, P, W) int32
    floats: torch.Tensor  # (K P B + K,): eps, then betas
    names: list  # the metrics' names, filled at capture


class StepGraphs:
    """The window graphs of one trainer, one per window length K.

    state: the trainer's state, whose tensors become the static buffers.
    window_fn(state, packed_k, eps_k, betas, shapes) -> (state, metrics):
    K steps in order (vbpi_train_steps_packed with the trainer's statics,
    optimizer and model data). device: the trainer's."""

    def __init__(self, state, window_fn, device):
        self.state = state
        self.window_fn = window_fn
        self.device = torch.device(device)
        self.windows = {}
        # (shapes, (P, W), (P, B)) of a step, fixed by the first window.
        self.step_shapes = None

    def assign(self, state):
        """Copy ``state`` into the buffers, which keep their shapes."""
        dst, src = leaves(self.state), leaves(state)
        shapes = [tuple(x.shape) for x in dst]
        if len(src) != len(dst) or [tuple(x.shape) for x in src] != shapes:
            raise ValueError(
                f"a state of shapes {[tuple(x.shape) for x in src]} for "
                f"buffers of shapes {shapes}")
        for d, s in zip(dst, src):
            d.copy_(s)

    def run(self, packed, floats, shapes, eps_shape):
        """One window: packed (K, P, W) int32 and floats (eps (K, P, B)
        raveled, then betas (K,)), numpy arrays on the host. Copies them
        into the window's buffers (capturing its graph first if K is new),
        replays the graph once and returns its metrics, each (K,)."""
        step_shapes = (tuple(shapes), tuple(packed.shape[1:]),
                       tuple(eps_shape[1:]))
        if self.step_shapes is None:
            self.step_shapes = step_shapes
        elif step_shapes != self.step_shapes:
            raise ValueError(
                f"a window of step shapes {step_shapes} after "
                f"{self.step_shapes}: the captured graphs have fixed shapes")
        K = packed.shape[0]
        window = self.windows.get(K)
        if window is None:
            # Kept only once its graph has been captured and replayed.
            window = self._new_window(packed, floats, shapes,
                                      tuple(eps_shape))
            out = window.graph()
            self.windows[K] = window
        else:
            with annotate("libsbn.graphs.upload_ints"):
                window.packed.copy_(torch.from_numpy(packed))
            with annotate("libsbn.graphs.upload_floats"):
                window.floats.copy_(torch.from_numpy(floats))
            out = window.graph()
        return dict(zip(window.names, out.clone()))

    def _new_window(self, packed, floats, shapes, eps_shape):
        dev = self.device
        with annotate("libsbn.graphs.upload_ints"):
            packed_t = torch.from_numpy(packed).to(dev)
        with annotate("libsbn.graphs.upload_floats"):
            floats_t = torch.from_numpy(floats).to(dev)
        n = math.prod(eps_shape)
        eps_t, betas_t = floats_t[:n].view(eps_shape), floats_t[n:]
        names = []

        def window():
            state, metrics = self.window_fn(self.state, packed_t, eps_t,
                                            betas_t, shapes)
            for dst, src in zip(leaves(self.state), leaves(state),
                                strict=True):
                dst.copy_(src)
            names[:] = metrics
            return torch.stack([metrics[name] for name in names])

        def first_step():
            self.window_fn(self.state, packed_t[:1], eps_t[:1], betas_t[:1],
                           shapes)

        return _Window(Graph(window, dev, _STEP_COUNTERS, COUNTS,
                             warmup=first_step), packed_t, floats_t, names)
