"""On a card: each cell's run as run.py makes it, short, reads
``correct`` true; and the control at each cell's own size fails a limit.

    python -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.load_json("BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    rows, _ = control.readings(cell, [2**31 + 5], [2**31 + 5], 1.0)
    limits = harness.Cell(cell).limits
    assert any(rows[0]["control"][k] > limits[k] for k in limits)
    assert all(rows[0]["program"][k] <= limits[k] for k in limits)
