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
    run and the time would otherwise go to the next phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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
