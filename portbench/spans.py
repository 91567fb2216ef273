"""The program's own spans in a traced run, and the split of each call's
host and idle time that they give.

The program (libsbn_tpu_torch/utils/profiling.py ``annotate``) opens
``record_function`` ranges named ``PROGRAM_PREFIX``... while a
torch.profiler session records; they lie on the device trace's clock.
trace.py keeps only the harness's spans, so the benchmark's result line
cannot read them yet: this module loads the same Chrome trace with them
(``load``), reads the split from it (``split``) and, run as

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout on a card, makes one cell's set-up, a warm
window of ``--seconds`` and the cell's traced calls, and prints one JSON
line: the split, the breakdown's idle gaps by the innermost span of the
harness or the program, and the same gaps by the harness's spans alone.
A program that opens no span of its own gives an empty split, and the
two breakdowns are the same.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Dict, Iterable

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import trace  # noqa: E402

PROGRAM_PREFIX = "libsbn."
# The program's span around a CUDA graph's replay (utils/graphs.py).
REPLAY_SPAN = PROGRAM_PREFIX + "graphs.replay"
UPLOADS = (PROGRAM_PREFIX + "graphs.upload_ints",
           PROGRAM_PREFIX + "graphs.upload_floats")


class SpanTrace(trace.Trace):
    """trace.Trace whose ``spans`` hold the program's spans too, so that
    ``idle_gaps`` names the innermost span, the program's or the
    harness's."""

    @property
    def has_program_spans(self) -> bool:
        return any(n.startswith(PROGRAM_PREFIX) for n, _, _ in self.spans)

    def span_s(self, names: Iterable[str]) -> float:
        """The union over the window of the spans named one of ``names``,
        in seconds: a span nested in another or repeated is counted
        once."""
        names = set(names)
        lo, hi = self.window
        return trace.covered(trace.merge(
            [(s, e) for n, s, e in self.spans if n in names]), lo, hi) / 1e6

    def span_count(self, name: str) -> int:
        """How many spans named ``name`` start in the window."""
        lo, hi = self.window
        return sum(1 for n, s, _ in self.spans if n == name and lo <= s < hi)

    def replay_gap_s(self) -> float:
        """Summed over calls: the device's idle time from the first device
        operation that starts after the call's first REPLAY_SPAN starts to
        the last device operation that starts in the call, in seconds;
        calls without a replay add nothing. What the host did before the
        replay (packing, copies) is left out."""
        union = self.busy_union()
        replays = sorted(s for n, s, _ in self.spans if n == REPLAY_SPAN)
        total = 0.0
        for lo, hi in self.calls:
            first = next((s for s in replays if lo <= s < hi), None)
            if first is None:
                continue
            ops = [(s, e) for _, s, e in self.device if lo <= s < hi]
            start = min((s for s, _ in ops if s >= first), default=None)
            if start is None:
                continue
            end = max(e for _, e in ops)
            total += (end - start) - trace.covered(union, start, end)
        return total / 1e6


def load(path: str) -> SpanTrace:
    """trace.load's reduced trace, with the program's spans added."""
    base = trace.load(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            for ev in events
            if ev.get("ph") == "X" and "dur" in ev
            and ev.get("cat") == "user_annotation"
            and ev.get("name", "").startswith(PROGRAM_PREFIX)]
    return SpanTrace(base.calls, base.device, base.spans + ours)


def split(tr: SpanTrace, work: Dict) -> Dict[str, float]:
    """The host and idle time of a call (an engine cell) or of a step (a
    VBPI cell, whose ``work`` has ``steps_per_call``) by the program's
    spans, in ms, and VBPI's lowering cache hits in %; empty where the
    program opened no span."""
    if not tr.has_program_spans:
        return {}
    p = PROGRAM_PREFIX
    if "steps_per_call" not in work:
        per = 1e3 / len(tr.calls)
        return {
            "inputs_ms_per_call.engine":
                per * tr.span_s([p + "engine.model_inputs"]),
            "stage_ms_per_call.engine":
                per * tr.span_s((p + "graphs.pack",) + UPLOADS),
            "replay_gap_ms_per_call.engine": per * tr.replay_gap_s()}
    steps = len(tr.calls) * work["steps_per_call"]
    per = 1e3 / steps
    lowered = steps * work["shape"].B
    return {
        "sample_ms_per_step.vbpi": per * tr.span_s([p + "vbpi.sample"]),
        "lower_ms_per_step.vbpi": per * tr.span_s([p + "vbpi.lower"]),
        "stage_ms_per_step.vbpi":
            per * tr.span_s((p + "vbpi.pack",) + UPLOADS),
        "artifact_hit_pct.vbpi":
            100.0 * (1.0 - tr.span_count(p + "vbpi.lower_miss") / lowered),
        "replay_gap_ms_per_step.vbpi": per * tr.replay_gap_s()}


def main(argv=None) -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.Cell(args.workload)
    dev = torch.device("cuda")
    drv = cell.driver().Driver(cell.config, cell.traffic, dev, None)
    drv.prepare(args.seed)
    drv.window(args.seconds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.traced(int(cell.traffic["trace_calls"]))
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        file = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(file)
        ours, bare = load(file), trace.load(file)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "host_ms_per_call": 1e3 * bare.host_s_per_call(),
        "split": split(ours, drv.work()),
        "idle_gaps": ours.idle_gaps(),
        "harness_idle_gaps": bare.idle_gaps()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
