"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json names its configuration (``configs[].file``) and its traffic
mix (``traffic/<traffic>.json``); ``workloads/<cell>.json`` holds the limits
of the numbers that decide ``correct``; each per-layer metric is a reader
in ``metrics/<metric>.py``. The traffic file names its driver
(``drivers/<driver>.py``), the general code that makes the traffic from
the seed and runs it.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout
# Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "libsbn_tpu")


def path(rel: str) -> str:
    """A path of the checkout, from one relative to its root."""
    return os.path.join(ROOT, rel)


def load_json(rel: str):
    with open(path(rel)) as f:
        return json.load(f)


def check_data(cfg: Dict):
    """The configuration's data files (the repository's, read by the
    program and the reference alike) against the SHA-256 sums it pins, so
    that a changed file stops every run rather than moving the yardstick."""
    for key, want in cfg.get("sha256", {}).items():
        with open(path(cfg[key]), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise RuntimeError(f"{cfg[key]}: SHA-256 {got}, the configuration "
                               f"{cfg['name']!r} pins {want}")


def _module(file: str, name: str):
    spec = importlib.util.spec_from_file_location(name, file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic, limits,
    end-to-end metrics and per-layer readers."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = load_json("BENCHMARK.json") if bench is None else bench
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = by_name[name]
        config = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(config["file"])
        check_data(self.config)
        self.traffic = load_json(
            os.path.join("portbench", "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(
            os.path.join("portbench", "workloads", name + ".json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]

    def reader(self, metric: str):
        return _module(os.path.join(HERE, "metrics", metric + ".py"),
                       "portbench_metric_" + metric.replace(".", "_"))

    def driver(self):
        return _module(os.path.join(HERE, "drivers",
                                    self.traffic["driver"] + ".py"),
                       "portbench_driver_" + self.traffic["driver"])


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the value that 95% of the
    values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def profile(driver, n: int, device):
    """Run ``n`` calls of the cell's driver under torch.profiler, with the
    harness's spans; returns the reduced trace (trace.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from portbench import trace as trace_mod

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        driver.traced(n)
        if device.type == "cuda":
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        file = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(file)
        return trace_mod.load(file)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", overrides: Optional[Dict] = None,
             fault: Optional[str] = None):
    """One run. Returns (result dict, check lines for standard error);
    the result is None when a forbidden module was loaded (the lines say
    which). ``overrides`` replace keys of the traffic and ``fault`` breaks
    the timed path underneath (both for the harness's own tests on the
    CPU); t0: the process's start on the host clock."""
    import torch

    cell = Cell(name)
    traffic = dict(cell.traffic, **(overrides or {}))
    dev = torch.device(device)
    drv = cell.driver().Driver(cell.config, traffic, dev, fault)
    drv.prepare(seed)
    # Set-up's live objects (trees, schedules, the program's tables) move
    # out of the collector's generations, so that a collection in the
    # window walks only what the window allocates.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    stats = drv.window(seconds)
    tr = profile(drv, int(traffic["trace_calls"]), dev) if trace else None
    gc.unfreeze()
    found = forbidden_modules()
    if found:
        return None, [f"forbidden modules loaded: {', '.join(found)}"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = all(v <= cell.limits[k] for k, v in checks.items())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(drv.failed_calls(cell.limits))}
    if trace:
        ctx = {"trace": tr, "stats": stats, "work": drv.work()}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else stats[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in checks.items()}
    lines = [f"check {k}: {v!r} (limit {cell.limits[k]!r})"
             for k, v in checks.items()]
    return result, lines
