"""Captured CUDA graphs of functions over static buffers: the port's
counterpart of the JAX package's compiled programs.

PyTorch runs eagerly, one kernel launch at a time, and an H100 runs the
small kernels of a VBPI step, a GP ascent or a rooted gradient faster than
the host enqueues them. A CUDA graph records a function's launches once and
replays them in one call. ``Graph`` holds one such function:

* ``fn`` reads and writes only static buffers (tensors that the caller
  allocates once and fills between calls, each by one host-to-device copy
  or an in-place copy) and the tensors it allocates itself, which come from
  the graph's memory pool (its own, or one it shares); whatever it returns
  stays in that pool and is overwritten by the next replay, so callers
  clone what they keep;
* before the capture, ``warmup`` (by default ``fn``) runs once on a side
  stream and its result is dropped (PyTorch's rule for capture; it also
  loads the kernels' library, which may run nvcc); its launches are
  launches like any other and are counted. Every capture on a device warms
  up on one side stream of that device (``_side_stream``): cuBLAS keeps a
  32 MB workspace for each stream it has run on, so a new stream a capture
  would add one each time;
* the kernel wrappers count launches in Python, so a capture would count
  launches that did not run: the capture's counts are taken back, and each
  replay adds them;
* the cyclic garbage collector is paused during the capture: a dead
  cycle freed mid-capture may free pinned host memory (a VBPI trainer's
  parameter copy), whose event record on the default stream invalidates
  the capture. It is not run before the capture (a full collection takes
  about 0.1 s in a process that has imported torch, which a program
  captured once a call, as the streamed GP ascent's are, would pay each
  call);
* a failed capture or replay raises; nothing here falls back to eager
  launches.

On a device that is not CUDA a Graph calls ``fn`` as it is, so the CPU
tests run the same functions over the same buffers.

``KeyedPrograms`` is the one capture policy of every cache of programs by
key: the engines' graphs (``PackedPrograms``, models/rooted_graph.py and
models/unrooted_graph.py), the forest surfaces (ops/forest_graph.py), the
hybrid marginals' program (gp/hybrid_graph.py) and the streamed GP
ascent's chunk programs (gp/streamed_graph.py). The caller gives a key's
eager callable and a way to build its program:

* a key's first call runs the eager callable, uncaptured (the function the
  program would capture, so the graph equals it bit for bit), and leaves
  nothing behind but a record that the key was seen. A one-off key (a
  final ELBO over 10,000 particles) never makes a graph or a pool;
* a key whose first call launched a kernel's slab route (a ``*_slab``
  launch count in the counters; its scratch is a slab per tree) stays
  eager, so that scratch goes back to the caching allocator after each
  call instead of staying in a pool;
* its second call builds the program (a Graph, or an object around one)
  and runs it: on a card a capture and one replay, elsewhere a plain call.
  The program is kept only once that run has returned, so a capture that
  raises leaves nothing kept and the key starts over;
* every later call runs the kept program;
* the record of keys seen once holds ``SEEN_CAP`` keys and forgets the
  oldest first; a forgotten key starts over;
* ``counts`` (the owner's COUNTS) holds "captures", "replays" and "eager",
  the calls run eagerly.

StepGraphs, AscentGraphs and EMStepGraph capture at their first call
instead: each holds one long-lived program, replayed many times a call.

``PackedPrograms`` is KeyedPrograms over two static buffers a key, one
int32 and one float64, for one engine. It holds what the JAX engine's
compiled programs hold, and no more:

* the engine's graphs share one memory pool (``pool``), which then holds
  about the largest key's temporaries plus every key's outputs, not the
  sum of all keys' temporaries. Two rules make that safe: no two of the
  engine's replays overlap (one stream, in order), and every caller copies
  a replay's outputs out before the next replay of any key, since another
  key's replay may write where they lie (the engines' graphs clone them
  as soon as the replay is enqueued);
* a call copies its floats into the key's buffer, and its ints only when
  they come from another schedule object than the last call's, held by a
  weak reference (an address can be recycled, an object cannot), as the
  JAX engine's ``_sched_dev`` uploads a schedule once.

``pool_mb`` reads what a memory pool holds from the caching allocator's
segments.

Spans (utils/profiling.py ``annotate``, recorded only while torch.profiler
records; none inside a captured function): ``libsbn.graphs.pack`` (a
PackedPrograms call's host arrays made flat), ``libsbn.graphs.upload_ints``
and ``libsbn.graphs.upload_floats`` (one a copy into a static buffer, so
their count is ``uploads``'), ``libsbn.graphs.eager`` (a call run eagerly),
``libsbn.graphs.capture`` (a capture with its warm-up) and
``libsbn.graphs.replay`` (a replay and its counts; on a device that is not
CUDA, the plain call that stands in for it).
"""

from __future__ import annotations

import gc
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .profiling import annotate


class Graph:
    """fn, captured on its first call on a CUDA device and replayed on
    every call; called as is elsewhere.

    counters: the dicts of launch counts (kernel wrappers' LAUNCHES) whose
    capture-time counts a replay adds; counts: a dict with "captures" and
    "replays", the owner's record of what ran."""

    def __init__(self, fn, device, counters, counts, warmup=None, pool=None):
        """pool: a memory pool handle (torch.cuda.graph_pool_handle()) that
        the capture shares with other graphs, or None for a pool of its
        own."""
        self.fn = fn
        self.pool = pool
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
            with annotate("libsbn.graphs.replay"):
                self.outputs = self.fn()
            return self.outputs
        if self.graph is None:
            self._capture()
        with annotate("libsbn.graphs.replay"):
            self.graph.replay()
            self.replays += 1
            self.counts["replays"] += 1
            for counter, n in zip(self.counters, self.counted):
                for name, k in n.items():
                    counter[name] += k
        return self.outputs

    def _capture(self):
        with annotate("libsbn.graphs.capture"), torch.cuda.device(
                self.device):
            side = _side_stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.warmup()
            torch.cuda.current_stream().wait_stream(side)
            before = [dict(c) for c in self.counters]
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
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


# The side stream of each device on which captures warm up.
_SIDE_STREAMS = {}


def _side_stream():
    """The current device's warm-up stream, made at its first capture."""
    device = torch.cuda.current_device()
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def host_f64(x):
    """An array or tensor anywhere as a float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


# Keys seen once and not kept that a KeyedPrograms remembers; the oldest is
# forgotten first, and a forgotten key's next call is a first call again.
SEEN_CAP = 256


class KeyedPrograms:
    """Programs by key under the capture policy of the module docstring, on
    ``device``; counters as Graph takes them; counts a dict with
    "captures", "replays" and "eager"; ``pool`` the memory pool every
    capture shares (None: a pool each)."""

    def __init__(self, device, counters, counts, pool=None):
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.counts = counts
        self.pool = pool
        self.programs = {}
        # key -> whether its first call launched a slab route (it then stays
        # eager): the keys called once and not kept.
        self.seen = OrderedDict()

    def __len__(self):
        return len(self.programs)

    def graph(self, fn, warmup=None):
        """A Graph of ``fn`` on this policy's device, counters, counts and
        pool."""
        return Graph(fn, self.device, self.counters, self.counts,
                     warmup=warmup, pool=self.pool)

    def call(self, key, eager, build, *args):
        """Run ``key`` once on ``args``: by ``eager(*args)`` on its first
        call (and every call of a slab key), by ``build()``'s program
        ``prog(*args)`` from its second. Returns what that call returns."""
        prog = self.programs.get(key)
        if prog is not None:
            return prog(*args)
        slab = self.seen.get(key)
        if slab is None or slab:
            before = slab_launches(self.counters)
            self.counts["eager"] += 1
            with annotate("libsbn.graphs.eager"):
                out = eager(*args)
            if slab is None:
                self.seen[key] = slab_launches(self.counters) != before
                if len(self.seen) > SEEN_CAP:
                    self.seen.popitem(last=False)
            return out
        del self.seen[key]
        prog = build()
        out = prog(*args)
        self.programs[key] = prog
        return out


def slab_launches(counters):
    """The slab-route launches so far in ``counters`` (dicts of launch
    counts), by name."""
    return [c[k] for c in counters for k in c if k.endswith("_slab")]


class Packed:
    """A captured key: its graph, its static buffers and the schedule object
    whose int arrays its int32 buffer holds (a weak reference, or None)."""

    def __init__(self, graph, ints, floats, source):
        self.graph = graph
        self.ints = ints  # int32, the packed int arrays
        self.floats = floats  # float64, the packed float arrays
        self.source = source

    def __call__(self):
        return self.graph()


class PackedPrograms(KeyedPrograms):
    """KeyedPrograms whose keys each run over one int32 and one float64
    static buffer on ``device``."""

    def __init__(self, device, counters, counts, pool=None):
        super().__init__(device, counters, counts, pool)
        # Host-to-device copies of the packed arrays, by buffer.
        self.uploads = {"ints": 0, "floats": 0}

    def run(self, key, ints, floats, make, source=None):
        """Run the program of ``key`` once on ``ints`` (host int arrays,
        packed as int32) and ``floats`` (host float64 arrays):
        ``make(int_views, float_views)`` returns the function, which reads
        the buffers' views of the arrays' shapes, in order. The key is
        extended by the arrays' shapes. ``source``: the object the int
        arrays come from (the schedule); on a replay, the same object as
        the last call's skips their copy. Returns the function's outputs
        (in the pool on a replay)."""
        with annotate("libsbn.graphs.pack"):
            ints = [np.asarray(x) for x in ints]
            floats = [np.asarray(x, np.float64) for x in floats]
            int_shapes = tuple(x.shape for x in ints)
            float_shapes = tuple(x.shape for x in floats)
            key = (key, int_shapes, float_shapes)
            prog = self.programs.get(key)
            copy_ints = (prog is None or source is None or prog.source is None
                         or prog.source() is not source)
            flat_ints = _flat(ints, np.int32) if copy_ints else None
            flat_floats = _flat(floats, np.float64)
        if prog is not None:
            if copy_ints:
                with annotate("libsbn.graphs.upload_ints"):
                    prog.ints.copy_(torch.from_numpy(flat_ints))
                prog.source = _ref(source)
                self.uploads["ints"] += 1
            with annotate("libsbn.graphs.upload_floats"):
                prog.floats.copy_(torch.from_numpy(flat_floats))
            self.uploads["floats"] += 1
            return prog.graph()
        with annotate("libsbn.graphs.upload_ints"):
            ints_t = torch.tensor(flat_ints, device=self.device)
        with annotate("libsbn.graphs.upload_floats"):
            floats_t = torch.tensor(flat_floats, device=self.device)
        self.uploads["ints"] += 1
        self.uploads["floats"] += 1
        fn = make(_views(ints_t, int_shapes), _views(floats_t, float_shapes))
        return self.call(key, fn, lambda: Packed(
            self.graph(fn), ints_t, floats_t, _ref(source)))


def pool_mb(pool):
    """MB of device memory that the graph memory pool ``pool`` (a
    torch.cuda.graph_pool_handle()) holds now, from the caching allocator's
    segments; 0 for None."""
    if pool is None:
        return 0.0
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool) / 2**20


def _ref(source):
    return None if source is None else weakref.ref(source)


def _flat(arrays, dtype):
    """The arrays back to back in one flat array of ``dtype`` (a single
    contiguous array of that dtype is not copied)."""
    if not arrays:
        return np.zeros(0, dtype)
    if len(arrays) == 1:
        return np.ascontiguousarray(arrays[0], dtype).ravel()
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
