"""spans.py and the lowering cache's reader on synthetic Chrome traces,
times in microseconds, values worked out by hand: two engine calls and two
VBPI windows, each with the harness's spans, the program's ``libsbn.``
spans and device events. trace.load, what the harness reads, reads the
same with the program's spans as without them; spans.load adds them, and
on a trace without them its split is empty and its breakdown the
harness's."""

import json
import sys
import types

import pytest

from portbench import harness, spans, trace, work

ENGINE_CELL = "ds1_100_gtr_w4.phylo_b256"
VBPI_CELL = "ds1_jc69.vbpi_p10"
ENGINE = "portbench.engine.branch_gradients"
STEP_MANY = "portbench.JitVBPI.step_many"
WAIT = "portbench.wait"
JIT_STEP = "libsbn_tpu_torch.vi.jit_step"


def _span(name, s, e):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": s,
            "dur": e - s}


def _device(name, s, e, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s}


def _engine_events():
    """Two calls of 100 us. The device is busy on the copies, a K4 launch,
    a small kernel and the outputs' copy; it idles between the replay's
    kernels for 5 us in the first call and 2 in the second."""
    ev = []
    for base, ints in ((0, True), (100, False)):
        def at(name, s, e):
            ev.append(_span(name, base + s, base + e))
        at("portbench.call", 0, 100)
        at("portbench.pick_lengths", 1, 2)
        at(ENGINE, 2, 80 if ints else 50)
        at("libsbn.engine.model_inputs", 3, 13)
        at("libsbn.graphs.pack", 14, 20)
        if ints:
            at("libsbn.graphs.upload_ints", 20, 24)
        at("libsbn.graphs.upload_floats", 24 if ints else 20, 30)
        at("libsbn.graphs.replay", 31, 36)
        at("libsbn.engine.clone", 36.5, 40)
        at(WAIT, 80 if ints else 50, 100)
        if ints:
            ev.append(_device("Memcpy HtoD", 22, 23, "gpu_memcpy"))
        ev.append(_device("Memcpy HtoD", base + 27, base + 30, "gpu_memcpy"))
        ev.append(_device("void generic_ll_grad_kernel<float, 4>()",
                          base + 40, base + 70))
        small = (75, 85) if ints else (72, 80)
        ev.append(_device("void elementwise_kernel()", base + small[0],
                          base + small[1]))
        ev.append(_device("void copy_kernel()", base + small[1],
                          base + small[1] + 5))
    # Not device work: the profiler's copy of a span on the device's row.
    ev.append({"ph": "X", "cat": "gpu_user_annotation",
               "name": "libsbn.graphs.replay", "ts": 40, "dur": 30})
    return ev


def _vbpi_events():
    """Two step_many windows of 2 steps and 3 particles: 3 lowering
    misses; the device idles 3 us between the replay's kernels in the
    first window and 1 us in the second."""
    ev = []
    for base, misses, sample, lower in ((0, ((16, 20), (22, 26)), (5, 15),
                                         (15, 35)),
                                        (100, ((11, 15),), (5, 10),
                                         (10, 20))):
        def at(name, s, e):
            ev.append(_span(name, base + s, base + e))
        at("portbench.call", 0, 100)
        at(STEP_MANY, 1, 90)
        at("libsbn.vbpi.wait_params", 2, 4)
        at("libsbn.vbpi.sample", *sample)
        at("libsbn.vbpi.lower", *lower)
        for s, e in misses:
            at("libsbn.vbpi.lower_miss", s, e)
        at("libsbn.vbpi.pack", 36, 40)
        at("libsbn.vbpi.pack", 41, 45)
        at("libsbn.graphs.upload_ints", 45, 48)
        at("libsbn.graphs.upload_floats", 48, 50)
        at("libsbn.graphs.replay", 51, 55)
        at("libsbn.vbpi.params_copy", 56, 58)
        at(WAIT, 90, 100)
        ev.append(_device("Memcpy HtoD", base + 47, base + 48, "gpu_memcpy"))
        ev.append(_device("Memcpy HtoD", base + 49, base + 50, "gpu_memcpy"))
        gap = 3 if base == 0 else 1
        ev.append(_device("void jc69_ll_grad_kernel<float, 1>()", base + 60,
                          base + 70))
        ev.append(_device("void index_put()", base + 70 + gap,
                          base + 80))
        ev.append(_device("Memcpy DtoH", base + 80, base + 81, "gpu_memcpy"))
    return ev


def _write(tmp_path, events, program=True):
    if not program:
        events = [e for e in events if not (
            e["cat"] == "user_annotation" and e["name"].startswith("libsbn."))]
    path = tmp_path / ("with.json" if program else "without.json")
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _work(cell):
    if cell == ENGINE_CELL:
        return {"shape": work.Shape("GTR", 256, 27, 4, 934),
                "call_job": "phylo"}
    return {"shape": work.Shape("JC69", 3, 27, 1, 934),
            "call_job": "ll_bgrad", "steps_per_call": 2}


def _read(cell, name, tr):
    ctx = {"trace": tr, "stats": {"attempted": 10, "window_s": 1.0},
           "work": _work(cell)}
    return harness.Cell(cell).reader(name).read(ctx)


def _traces(tmp_path, events):
    """(with the program's spans, spans.load of a trace without them,
    trace.load of the trace with them)."""
    with_path = _write(tmp_path, events)
    return (spans.load(with_path),
            spans.load(_write(tmp_path, events, program=False)),
            trace.load(with_path))


@pytest.fixture
def engine(tmp_path):
    return _traces(tmp_path, _engine_events())


@pytest.fixture
def vbpi(tmp_path):
    return _traces(tmp_path, _vbpi_events())


def test_engine_split_by_hand(engine):
    tr = engine[0]
    assert tr.has_program_spans
    # model_inputs: 10 us a call; packing and copies: [14, 30] a call; the
    # device idle after the replay began: 5 and 2 us.
    assert spans.split(tr, _work(ENGINE_CELL)) == pytest.approx({
        "inputs_ms_per_call.engine": 0.010,
        "stage_ms_per_call.engine": 0.016,
        "replay_gap_ms_per_call.engine": 0.0035})
    assert tr.span_count("libsbn.graphs.upload_ints") == 1
    assert tr.span_count("libsbn.graphs.upload_floats") == 2


def test_vbpi_split_by_hand(vbpi):
    assert spans.split(vbpi[0], _work(VBPI_CELL)) == pytest.approx({
        "sample_ms_per_step.vbpi": 15e-3 / 4,
        "lower_ms_per_step.vbpi": 30e-3 / 4,
        "stage_ms_per_step.vbpi": 26e-3 / 4,
        "artifact_hit_pct.vbpi": 75.0,
        "replay_gap_ms_per_step.vbpi": 4e-3 / 4})


def test_span_s_counts_nested_and_repeated_spans_once(vbpi):
    tr = vbpi[0]
    # lower_miss lies inside lower; a window packs twice.
    assert tr.span_s(("libsbn.vbpi.lower", "libsbn.vbpi.lower_miss")) == \
        pytest.approx(30e-6)
    assert tr.span_s(("libsbn.vbpi.pack",)) == pytest.approx(16e-6)


def test_replay_gap_leaves_out_the_idle_time_before_the_replay(engine,
                                                               vbpi):
    for tr, want in ((engine[0], 7e-6), (vbpi[0], 4e-6)):
        idle = sum((e - s) / 1e6 - trace.covered(tr.busy_union(), s, e) / 1e6
                   for s, e in tr.calls)
        assert tr.replay_gap_s() == pytest.approx(want)
        assert idle > 5 * want


@pytest.mark.parametrize("cell", [ENGINE_CELL, VBPI_CELL])
def test_split_empty_without_program_spans(engine, vbpi, cell):
    ours, bare, harness_view = engine if cell == ENGINE_CELL else vbpi
    assert not bare.has_program_spans
    assert spans.split(bare, _work(cell)) == {}
    assert bare.idle_gaps() == harness_view.idle_gaps()


@pytest.mark.parametrize("cell", [ENGINE_CELL, VBPI_CELL])
def test_harness_reads_the_same_with_program_spans(engine, vbpi, tmp_path,
                                                   cell):
    """What a program with spans gives the harness is what one without
    them gives: every reader and the breakdown read the same."""
    ours, _, harness_view = engine if cell == ENGINE_CELL else vbpi
    events = _engine_events() if cell == ENGINE_CELL else _vbpi_events()
    older = trace.load(_write(tmp_path, events, program=False))
    assert harness_view == older
    names = [m["name"] for m in harness.Cell(cell).per_layer
             if m["name"] != "artifact_hit_pct.vbpi"]
    assert names
    for name in names:
        assert _read(cell, name, ours) == _read(cell, name, older), name
    assert ours.device_ops() == older.device_ops()
    assert ours.host_s_per_call() == older.host_s_per_call()


def test_engine_breakdown_by_hand(engine):
    """By the harness's spans each idle gap falls on them, as before; with
    the program's, on the innermost span, the program's."""
    with_spans, bare, _ = engine
    assert bare.host_s_per_call() == pytest.approx(52.5e-6)
    assert _read(ENGINE_CELL, "launches_per_call.engine", bare) == 4.5
    gaps = dict(bare.idle_gaps())
    assert list(gaps) == [ENGINE, WAIT]
    assert gaps[ENGINE] == pytest.approx(88e-6)
    assert gaps[WAIT] == pytest.approx(17e-6)
    gaps = dict(with_spans.idle_gaps())
    assert list(gaps) == ["libsbn.engine.model_inputs",
                          "libsbn.graphs.replay", WAIT, ENGINE,
                          "libsbn.graphs.upload_floats"]
    want = [59e-6, 20e-6, 17e-6, 5e-6, 4e-6]
    assert list(gaps.values()) == pytest.approx(want)


def test_vbpi_breakdown_by_hand(vbpi):
    with_spans, bare, _ = vbpi
    gaps = dict(bare.idle_gaps())
    assert list(gaps) == [STEP_MANY, WAIT]
    assert gaps[STEP_MANY] == pytest.approx(139e-6)
    assert gaps[WAIT] == pytest.approx(19e-6)
    gaps = dict(with_spans.idle_gaps())
    assert list(gaps) == ["libsbn.vbpi.lower_miss", "libsbn.graphs.replay",
                          WAIT, STEP_MANY, "libsbn.graphs.upload_floats"]
    want = [113e-6, 20e-6, 19e-6, 4e-6, 2e-6]
    assert list(gaps.values()) == pytest.approx(want)


@pytest.mark.parametrize("counts,want", [
    ({"hits": 30, "misses": 10}, 75.0),   # the program's counter
    (None, None),                         # a program without it
    ({"hits": 0, "misses": 0}, None),     # nothing lowered yet
])
def test_artifact_hit_pct_reads_the_counter(vbpi, monkeypatch, counts,
                                            want):
    module = types.ModuleType(JIT_STEP)
    if counts is not None:
        module.ARTIFACTS = counts
    monkeypatch.setitem(sys.modules, JIT_STEP, module)
    got = _read(VBPI_CELL, "artifact_hit_pct.vbpi", vbpi[2])
    assert got == (pytest.approx(want) if want is not None else None)
