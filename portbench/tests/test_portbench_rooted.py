"""The rooted cell: its plain reference (reference/rooted.py) against
physher's fluA goldens and against central differences of its own LL; the
cell run whole on the CPU at a cut batch; each fault and the control
breaking a limit; the per-layer readers; and work_rooted's counts against
a hand count."""

import ast
import json
import os
import types

import numpy as np
import pytest
import torch

from portbench import harness, work
from portbench.reference import alignment, rooted
from portbench.work_rooted import RootedShape

CELL = "flua_jc69.rooted_b256"
SMALL = {"batch": 8, "check_calls": 2}
DATA = "data/"
HEIGHTS = "libsbn_tpu_torch.ops.heights"


def _physher_ratio_gradients():
    """The 68 physher ratio and root-height gradients of fluA at its own
    heights, as tests/test_torch_rooted.py holds them (rooted_sbn_instance
    .hpp:262-284)."""
    src = open(os.path.join(harness.ROOT, "tests",
                            "test_torch_rooted.py")).read()
    start = src.index("PHYSHER_RATIO_GRADIENTS = [")
    return np.array(ast.literal_eval(src[src.index("[", start):
                                         src.index("]", start) + 1]))


@pytest.fixture(scope="module")
def flua():
    tree = rooted.read_time_tree(harness.path(DATA + "fluA.tree"))
    pats = alignment.patterns(harness.path(DATA + "fluA.fa"), tree.taxa)
    return tree, pats


def test_flua_goldens(flua):
    """physher at the file's heights, strict clock 0.001: LL -4777.616349,
    log-det-Jacobian -9.25135166 and the 68 ratio and root-height
    gradients, each to 1e-4 (the reference's internal nodes are in the
    file's postorder, as libsbn numbers them)."""
    tree, pats = flua
    assert tree.leaf_count == 69 and pats.site_count == 987
    assert len(pats.weights) == 238
    out = rooted.evaluate(tree, pats, tree.ratios[None], 0.001)
    assert out["ll"][0] == pytest.approx(-4777.616349, abs=1e-4)
    assert out["ldj"][0] == pytest.approx(-9.25135166, abs=1e-4)
    golden = _physher_ratio_gradients()
    assert golden.shape == (68,)
    np.testing.assert_allclose(out["ratio"][0], golden, atol=1e-4)


def test_gradients_against_differences(flua):
    """d LL / d clock rate and two ratio gradients against central
    differences of the reference's own LL and log-det-Jacobian."""
    tree, pats = flua
    r = tree.ratios[None].copy()
    out = rooted.evaluate(tree, pats, r, 0.001)
    h = 1e-9
    up = rooted.evaluate(tree, pats, r, 0.001 + h)["ll"]
    dn = rooted.evaluate(tree, pats, r, 0.001 - h)["ll"]
    assert out["clock"][0] == pytest.approx((up - dn)[0] / (2 * h), rel=1e-6)
    for j in (5, 67):  # an internal node's ratio, the root height
        step = np.zeros_like(r)
        step[0, j] = 1e-6
        hi, lo = (rooted.evaluate(tree, pats, r + s, 0.001)
                  for s in (step, -step))
        fd = ((hi["ll"] + hi["ldj"]) - (lo["ll"] + lo["ldj"]))[0] / 2e-6
        assert out["ratio"][0, j] == pytest.approx(fd, rel=1e-5)


def _run(fault=None, overrides=SMALL, trace=False):
    torch.set_num_threads(2)
    res, _ = harness.run_cell(CELL, 2**31 + 4242, 0.2, trace, 0.0,
                              device="cpu", overrides=overrides, fault=fault)
    return res


def test_port_cpu_route_is_correct():
    """A whole run on the CPU at a cut batch: the port's CPU route (K1's
    twin and the hand adjoint) within every limit, no call failed."""
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["checks"]) == {"ll_rel", "ratio_rel", "clock_rel"}
    assert set(res["metrics"]) == {"tree_evals_per_s", "call_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch",
                                   "no_jacobian"])
def test_fault_reads_incorrect(fault):
    res = _run(fault)
    assert not res["correct"]
    assert res["failed"] > 0


def test_control_fails_a_limit():
    from portbench import control

    torch.set_num_threads(2)
    rows, _ = control.readings(CELL, [5], [5], 0.2, device="cpu",
                               overrides=SMALL)
    limits = harness.Cell(CELL).limits
    ctrl = rows[0]["control"]
    assert any(ctrl[k] > limits[k] for k in limits), ctrl
    assert all(rows[0]["program"][k] <= limits[k] for k in limits)


def test_traced_run_reads_the_sweeps():
    """A traced run on the CPU: the counter gives fluA's 32 forward and 32
    adjoint sweeps a call; the device readers find no device work there
    (K1_roofline.rooted none, heights_ms_per_call.rooted 0)."""
    res = _run(overrides=dict(SMALL, trace_calls=2), trace=True)
    m = res["metrics"]
    assert m["height_sweeps_per_call.rooted"]["value"] == 64
    assert "K1_roofline.rooted" not in m
    assert m["heights_ms_per_call.rooted"]["value"] == 0
    assert {"idle_pct.rooted", "mfu_pct.rooted"} <= set(m)


def _ctx(sweeps):
    trace = types.SimpleNamespace(calls=[(0, 1), (1, 2)])
    return {"trace": trace, "stats": {}, "work": {"height_sweeps": sweeps}}


def test_sweeps_reader_without_the_counter(monkeypatch):
    """The reader divides the count drivers/rooted.py took by the traced
    calls, and gives None where the program has no counter (that count is
    then None)."""
    cell = harness.Cell(CELL)
    reader = cell.reader("height_sweeps_per_call.rooted")
    assert reader.read(_ctx(128)) == 64
    assert reader.read(_ctx(None)) is None
    import libsbn_tpu_torch.ops

    drv = cell.driver().Driver(cell.config, dict(cell.traffic, **SMALL),
                               torch.device("cpu"))
    monkeypatch.setattr(libsbn_tpu_torch.ops, "heights",
                        types.ModuleType(HEIGHTS))
    drv.sets = np.zeros((1, 8, 68))
    drv._call = lambda j: None
    drv.traced(2)
    assert drv.work()["height_sweeps"] is None


def test_cell_entries():
    """The cell's entries in BENCHMARK.json: its configuration's file, its
    five per-layer metrics listing it alone, and the two engine metrics
    that list it."""
    bench = harness.load_json("BENCHMARK.json")
    cell = harness.Cell(CELL, bench)
    assert cell.config["reduced"] == [] and cell.config["taxa"] == 69
    assert {m["name"] for m in cell.end_to_end} == {
        "tree_evals_per_s", "call_p95_ms", "setup_s"}
    ours = [m["name"] for m in cell.per_layer]
    assert ours == ["K1_roofline.rooted", "heights_ms_per_call.rooted",
                    "height_sweeps_per_call.rooted", "idle_pct.rooted",
                    "mfu_pct.rooted"]
    for m in bench["per_layer"]:
        assert (m["workloads"] == [CELL]) == (m["name"] in ours)
    traffic = json.load(open(harness.path(
        "portbench/traffic/rooted_b256.json")))
    assert traffic["driver"] == "rooted" and traffic["batch"] == 256


def test_rooted_work_hand_count():
    """Two taxa, rooted: E = 2 edges (the root's two children), I = 1
    internal node (the root, two children), K = 1, JC69's apply 15."""
    s = RootedShape("JC69", B=1, L=2, K=1, P=1)
    assert (s.E, s.I) == (2, 1)
    # forward: 2 applies (30), 1 child product of 4 (4), the root's
    # rescale (8 + 2), its frequencies, mix, log, log-scale add and
    # weighted sum (9 + 3)
    assert work.forward(s) == 30 + 4 + 10 + 12
    # upper: no non-root internal node; 2 products of 4
    assert work.upper(s) == 8
    # each edge: the rate-matrix apply (15), dot (7), mix (1), divide and
    # weighted sum (3)
    assert work.edge_derivatives(s) == 2 * 26
    assert work.ops(s, "ll_bgrad") == 56 + 8 + 52 + 2 * 6
    # fluA: 137 nodes, 136 edges, 68 internal nodes
    f = RootedShape("JC69", 256, 69, 1, 238)
    assert (f.E, f.I) == (136, 68)
    assert work.Shape("JC69", 256, 69, 1, 238).E == 135
