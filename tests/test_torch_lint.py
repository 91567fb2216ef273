"""tools/lint.py's checks on the port, read-only: tools/lint.py lints
libsbn_tpu/, tests/ and tools/, and not libsbn_tpu_torch/ or
chip_smoke.py. Its text checks (tabs, trailing whitespace, the newline at
the end, line length) and its unused-import check apply here at its own
widths: MAX_PY (88) for the port's Python, MAX_PY_TEST (100) for
chip_smoke.py, MAX_CPP (100) for the port's CUDA sources."""

import ast
import pathlib

from tools import lint

ROOT = pathlib.Path(lint.ROOT)


def _python_issues(paths, max_len):
    errors = []
    for path in paths:
        text = path.read_text()
        lint.check_text(path, text, max_len, errors)
        lint.unused_imports(path, ast.parse(text), errors)
    return errors


def test_port_python_is_clean():
    paths = sorted((ROOT / "libsbn_tpu_torch").rglob("*.py"))
    assert len(paths) > 70
    assert _python_issues(paths, lint.MAX_PY) == []


def test_chip_smoke_is_clean():
    assert _python_issues([ROOT / "chip_smoke.py"], lint.MAX_PY_TEST) == []


def test_port_cuda_sources_are_clean():
    paths = sorted((ROOT / "libsbn_tpu_torch" / "csrc").glob("*.cu"))
    assert len(paths) == 4
    errors = []
    for path in paths:
        lint.check_text(path, path.read_text(), lint.MAX_CPP, errors)
    assert errors == []
