"""run.py from a checkout's root: it refuses to measure without a card, and
a cell added as files alone (a traffic mix, a limits file and an entry in
BENCHMARK.json) runs with no code edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ds1_jc69.bgrad_b2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ds1_jc69.bgrad_b2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "data"), tmp_path / "data")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (tmp_path / "portbench/traffic/bgrad_b16.json").write_text(json.dumps({
        "driver": "engine", "entry": "branch_gradients", "batch": 16,
        "length_sets": 4, "length_scale": [0.9, 1.1], "check_calls": 1,
        "trace_calls": 2}))
    (tmp_path / "portbench/workloads/ds1_jc69.bgrad_b16.json").write_text(
        json.dumps({"limits": {"ll_rel": 1e-5, "bgrad_rel": 1e-3}}))
    bench["workloads"].append({
        "name": "ds1_jc69.bgrad_b16", "config": "ds1_jc69",
        "traffic": "bgrad_b16", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ds1_jc69.bgrad_b2048" in m.get("workloads", []):
            m["workloads"].append("ds1_jc69.bgrad_b16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from portbench import harness\n"
        "res, _ = harness.run_cell('ds1_jc69.bgrad_b16', 3, 0.2, True, 0.0,"
        " device='cpu')\n"
        "print(json.dumps(res))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ,
                                PYTHONPATH=f"{tmp_path}:{ROOT}"))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert "launches_per_call.engine" in res["metrics"]
