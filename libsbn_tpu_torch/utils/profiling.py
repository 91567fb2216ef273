"""Tracing and per-phase timing utilities.

The counterpart of libsbn_tpu/utils/profiling.py, with the same names:

  * ``device_trace``: wraps ``torch.profiler.profile`` (the CPU and, when a
    card is present, its CUDA activity) and writes a Chrome trace into a
    directory, so a block's kernels can be read by name and time;
  * ``annotate``: a named ``torch.profiler.record_function`` span that
    shows up inside the trace;
  * ``PhaseTimer``: accumulates host wall time per named phase. With
    ``sync`` it synchronises the devices of the tensors it is handed before
    it stops the clock, since a CUDA call returns before its kernels have
    run and the time would otherwise go to the next phase;
  * ``timed_evals_per_sec``: the JAX bench's throughput harness (bench.py
    ``timed_evals_per_sec``): fixed iteration counts, the best of a few
    windows, a value fetch as each window's barrier;
  * ``host_and_device``: host-clock ms of a call beside the device ms that
    torch.profiler records for it, and the device's idle share.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch


def _tensors(*items):
    """The tensors in items, nested in tuples, lists and dicts."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            yield from _tensors(*x.values())
        elif isinstance(x, (tuple, list)):
            yield from _tensors(*x)


def block_until_ready(result):
    """Wait for the work that produces ``result``: synchronise each CUDA
    device that holds one of its tensors (CPU tensors are ready when
    returned). Returns ``result``."""
    for device in {x.device for x in _tensors(result) if x.is_cuda}:
        torch.cuda.synchronize(device)
    return result


def force(result):
    """Materialise ``result`` on the host: wait for the devices of its
    tensors (``torch.cuda.synchronize``), then fetch one value of its first
    tensor or array, the barrier that bench.py's ``_force`` is. Returns
    that value."""
    block_until_ready(result)
    leaf = next(_tensors(result), None)
    if leaf is None:
        return next(_arrays(result)).ravel()[0]
    return leaf.detach().reshape(-1)[0].item()


def _arrays(*items):
    """The numpy arrays in items, nested as _tensors nests."""
    for x in items:
        if isinstance(x, np.ndarray):
            yield x
        elif isinstance(x, dict):
            yield from _arrays(*x.values())
        elif isinstance(x, (tuple, list)):
            yield from _arrays(*x)


def timed_evals_per_sec(run, n_evals, windows=3, target_s=2.0):
    """Best-of-``windows`` throughput of ``run`` (which does ``n_evals``
    evaluations a call), in evaluations a second: a warm-up call (never
    timed), one timed call that sizes the windows, then each window runs a
    fixed number of calls (8 to 400, about ``target_s`` seconds) and ends
    in ``force``. Never an unbounded loop of asynchronous calls: the
    host would queue launches faster than the wall clock shows them
    running."""
    force(run())
    t0 = time.perf_counter()
    force(run())
    per = time.perf_counter() - t0
    iters = max(8, min(400, int(target_s / max(per, 1e-4))))
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = run()
        force(out)
        best = max(best, n_evals * iters / (time.perf_counter() - t0))
    return best


def host_and_device(fn, calls=5):
    """{"host_ms", "device_ms", "kernels", "idle"} of fn: the median
    host-clock ms of ``calls`` synchronised calls after one warm-up; then,
    over ``calls`` more under torch.profiler, the device ms a call summed
    over its kernels and copies and their number a call. ``idle`` is
    1 - device_ms / host_ms (the profiler slows the host, so the unprofiled
    median is the denominator). device_ms, kernels and idle are None when
    the profiler records no device time (on the CPU, or when it loses the
    device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(times)
    out = {"host_ms": host_ms, "device_ms": None, "kernels": None,
           "idle": None}
    if not cuda:
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total if hasattr(e, "self_device_time_total")
             else e.self_cuda_time_total for e in events)
    if us > 0:
        out["device_ms"] = us / 1e3 / calls
        out["kernels"] = sum(e.count for e in events) / calls
        out["idle"] = 1.0 - out["device_ms"] / host_ms
    return out


def format_host_and_device(t) -> str:
    """host_and_device's dict as one line."""
    line = f"host {t['host_ms']:.3f} ms a call (median, synchronised)"
    if t["device_ms"] is None:
        return line + "; device time not measured"
    return (line + f"; device {t['device_ms']:.3f} ms in {t['kernels']:.0f} "
            f"kernels and copies (torch.profiler), idle {t['idle']:.1%}")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile a block with torch.profiler and write its Chrome trace
    (``trace_<pid>_<ns>.json``, readable in chrome://tracing or Perfetto)
    into ``logdir``. The CUDA activity is recorded when a card is
    present. In a process that has already profiled much (thousands of
    kernels a session), torch.profiler has left out some or all of the
    device events of a small traced block on an H100 (torch 2.11): trace
    such a block in a fresh process."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a device trace (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Accumulate wall time per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("populate"):
    ...     pass
    >>> _ = timer.total("populate")
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, elapsed: float):
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        """Time a block; if ``sync``, wait for the tensors of ``result``
        (``block_until_ready``) before stopping the clock."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                block_until_ready(result)
            self._add(name, time.perf_counter() - start)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its output, and record the elapsed time."""
        start = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - start)
        return out

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def mean(self, name: str) -> Optional[float]:
        if not self.counts.get(name):
            return None
        return self.totals[name] / self.counts[name]

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}: total {self.totals[name] * 1e3:.2f} ms over "
                f"{self.counts[name]} calls "
                f"({self.mean(name) * 1e3:.3f} ms/call)"
            )
        return "\n".join(lines)
