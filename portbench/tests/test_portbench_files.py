"""BENCHMARK.json against the rules its format keeps, and every file it
names found by name; no module of the harness loads JAX or the JAX
package, and the reference loads nothing of the measured program."""

import ast
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
HERE = harness.HERE


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200


def test_end_to_end_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        c = harness.Cell(cell, BENCH)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, cell
        assert c.per_layer, cell
        for m in c.per_layer:
            assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell, BENCH)
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       c.traffic["driver"] + ".py"))
    for m in c.per_layer:
        assert hasattr(c.reader(m["name"]), "read"), m["name"]
    for key in ("alignment", "trees"):
        assert os.path.exists(harness.path(c.config[key]))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("portbench/")
    data = harness.load_json(cfg["file"])
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in _sources():
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = set(_imports(path))
        assert "libsbn_tpu_torch" not in tops and not (
            tops & set(harness.FORBIDDEN)), path


def test_changed_data_file_stops_the_run(tmp_path):
    cfg = dict(harness.load_json(BENCH["configs"][0]["file"]))
    harness.check_data(cfg)
    bad = tmp_path / "DS1.fasta"
    bad.write_bytes(open(harness.path(cfg["alignment"]), "rb").read() + b"\n")
    cfg["alignment"] = str(bad)
    with pytest.raises(RuntimeError, match="SHA-256"):
        harness.check_data(cfg)
