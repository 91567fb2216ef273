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
"""

from __future__ import annotations

import gc

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
