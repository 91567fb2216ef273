"""Captured CUDA graphs of functions over static buffers: the port's
counterpart of the JAX package's compiled programs.

PyTorch runs eagerly, one kernel launch at a time, and an H100 runs the
small kernels of a VBPI step, a GP ascent or a rooted gradient faster than
the host enqueues them. A CUDA graph records a function's launches once and
replays them in one call. ``Graph`` holds one such function:

* ``fn`` reads and writes only static buffers (tensors that the caller
  allocates once and fills between calls, each by one host-to-device copy
  or an in-place copy) and the tensors it allocates itself, which come from
  the graph's own memory pool; whatever it returns stays in that pool and
  is overwritten by the next replay, so callers clone what they keep;
* before the capture, ``warmup`` (by default ``fn``) runs once on a side
  stream and its result is dropped (PyTorch's rule for capture; it also
  loads the kernels' library, which may run nvcc); its launches are
  launches like any other and are counted;
* the kernel wrappers count launches in Python, so a capture would count
  launches that did not run: the capture's counts are taken back, and each
  replay adds them;
* the cyclic garbage collector runs before the capture and not during
  it: a dead cycle freed mid-capture may free pinned host memory (a VBPI
  trainer's parameter copy), whose event record on the default stream
  invalidates the capture, and PyTorch no longer collects at capture;
* a failed capture or replay raises; nothing here falls back to eager
  launches.

On a device that is not CUDA a Graph calls ``fn`` as it is, so the CPU
tests run the same functions over the same buffers.

``PackedPrograms`` keeps such Graphs by key over two static buffers each,
one int32 and one float64: a call packs its host arrays into them with one
host-to-device copy each and replays the key's graph, whose function reads
views of the buffers (the engines' graphs, models/rooted_graph.py and
models/unrooted_graph.py).
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch


class Graph:
    """fn, captured on its first call on a CUDA device and replayed on
    every call; called as is elsewhere.

    counters: the dicts of launch counts (kernel wrappers' LAUNCHES) whose
    capture-time counts a replay adds; counts: a dict with "captures" and
    "replays", the owner's record of what ran."""

    def __init__(self, fn, device, counters, counts, warmup=None):
        self.fn = fn
        self.warmup = fn if warmup is None else warmup
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.counts = counts
        self.graph = None
        self.counted = ()
        self.replays = 0
        # What the captured fn returned: the replays' outputs, in the pool.
        self.outputs = None

    def __call__(self):
        """Run fn once: a replay on a CUDA device (capturing first on the
        first call), a plain call elsewhere. Returns fn's outputs."""
        if self.device.type != "cuda":
            self.outputs = self.fn()
            return self.outputs
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        self.counts["replays"] += 1
        for counter, n in zip(self.counters, self.counted):
            for name, k in n.items():
                counter[name] += k
        return self.outputs

    def _capture(self):
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.warmup()
            torch.cuda.current_stream().wait_stream(side)
            before = [dict(c) for c in self.counters]
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    outputs = self.fn()
            finally:
                if collecting:
                    gc.enable()
                # Captured, not run: take the counts back (each replay adds
                # them), whether or not the capture succeeded.
                self.counted = tuple(
                    {k: c[k] - was[k] for k in c if c[k] != was[k]}
                    for c, was in zip(self.counters, before))
                for c, was in zip(self.counters, before):
                    c.update(was)
        self.graph, self.outputs = graph, outputs
        self.counts["captures"] += 1


def host_f64(x):
    """An array or tensor anywhere as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


class Packed(NamedTuple):
    graph: Graph
    ints: torch.Tensor  # int32, the packed int arrays
    floats: torch.Tensor  # float64, the packed float arrays


class PackedPrograms:
    """Graphs by key, each over one int32 and one float64 static buffer
    on ``device``; counters and counts as Graph takes them."""

    def __init__(self, device, counters, counts):
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.counts = counts
        self.programs = {}

    def __len__(self):
        return len(self.programs)

    def run(self, key, ints, floats, make):
        """Replay the program of ``key`` once on ``ints`` (host int arrays,
        packed as int32) and ``floats`` (host float64 arrays), capturing it
        first if its key is new: ``make(int_views, float_views)`` then
        returns the function to capture, which reads the buffers' views of
        the arrays' shapes, in order. The key is extended by the arrays'
        shapes. Returns the function's outputs, in the graph's pool."""
        ints = [np.asarray(x) for x in ints]
        floats = [np.asarray(x, np.float64) for x in floats]
        int_shapes = tuple(x.shape for x in ints)
        float_shapes = tuple(x.shape for x in floats)
        key = (key, int_shapes, float_shapes)
        flat_i = _flat(ints, np.int32)
        flat_f = _flat(floats, np.float64)
        prog = self.programs.get(key)
        if prog is not None:
            prog.ints.copy_(torch.from_numpy(flat_i))
            prog.floats.copy_(torch.from_numpy(flat_f))
            return prog.graph()
        ints_t = torch.tensor(flat_i, device=self.device)
        floats_t = torch.tensor(flat_f, device=self.device)
        fn = make(_views(ints_t, int_shapes), _views(floats_t, float_shapes))
        prog = Packed(Graph(fn, self.device, self.counters, self.counts),
                      ints_t, floats_t)
        out = prog.graph()
        # Kept only once its graph has been captured and replayed.
        self.programs[key] = prog
        return out


def _flat(arrays, dtype):
    """The arrays back to back in one flat array of ``dtype``."""
    if not arrays:
        return np.zeros(0, dtype)
    return np.concatenate([x.ravel() for x in arrays]).astype(dtype,
                                                              copy=False)


def _views(buf, shapes):
    """Views of the flat ``buf`` of the given shapes, back to back."""
    out, offset = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(buf[offset:offset + n].view(shape))
        offset += n
    return out
