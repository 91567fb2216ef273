"""The reduction of a torch.profiler trace to what the per-layer metrics
read: device intervals, their union over the traced window, device time by
kernel name, and the idle gaps named by the benchmark's own spans.

The trace is torch.profiler's Chrome trace export: "X" events with ``ts``
and ``dur`` in microseconds on one clock for the host and the device.
Device work is every event of the categories in ``DEVICE_CATS``: kernels
(those replayed from a CUDA graph included), copies and memsets. Spans are
the ``record_function`` ranges the harness opens, named ``SPAN_PREFIX``...
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
# The span that wraps one whole call (or step window) of the traffic.
CALL_SPAN = SPAN_PREFIX + "call"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(union: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """How much of [lo, hi] the disjoint intervals ``union`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


@dataclass
class Trace:
    """calls: the CALL_SPAN intervals, in order; device: every device
    event (name, start, end); spans: every other harness span (name,
    start, end). Times in microseconds."""

    calls: List[Tuple[float, float]]
    device: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    @property
    def window(self) -> Tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    def in_window(self):
        lo, hi = self.window
        return [(n, s, e) for n, s, e in self.device if e > lo and s < hi]

    def busy_union(self):
        return merge([(s, e) for _, s, e in self.in_window()])

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return covered(self.busy_union(), lo, hi) / 1e6

    def device_s(self, patterns) -> float:
        """Summed duration of the window's device events whose name holds
        one of ``patterns``, in seconds."""
        return sum(e - s for n, s, e in self.in_window()
                   if any(p in n for p in patterns)) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        """[[name, seconds], ...]: the device operations that took most
        time in the window, by name (a kernel's name up to its arguments)."""
        by: Dict[str, float] = {}
        for n, s, e in self.in_window():
            key = n.replace("(anonymous namespace)::", "").split("(")[0]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[span, seconds], ...]: the window's idle device time summed by
        the innermost harness span that was open at each gap's middle,
        longest first."""
        lo, hi = self.window
        union = self.busy_union()
        edges = [lo] + [x for iv in union for x in iv] + [hi]
        spans = self.spans + [(CALL_SPAN, s, e) for s, e in self.calls]
        by: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            open_ = [(e - s, n) for n, s, e in spans if s <= mid <= e]
            name = min(open_)[1] if open_ else "between calls"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def host_s_per_call(self) -> float:
        """Mean over calls of the call span's length less the device's
        busy time inside it, in seconds."""
        union = self.busy_union()
        return sum((e - s) - covered(union, s, e)
                   for s, e in self.calls) / len(self.calls) / 1e6


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls, device, spans = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            (calls.append((s, e)) if name == CALL_SPAN
             else spans.append((name, s, e)))
    calls.sort()
    if not calls:
        raise RuntimeError(f"{path}: no {CALL_SPAN} span in the trace")
    return Trace(calls, device, spans)
