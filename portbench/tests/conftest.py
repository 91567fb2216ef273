"""The benchmark's own tests. ``cuda`` marks a test that needs a card: it
decides inside a fixture (``card``) and skips here with a reason. Run the
CPU tests with ``python -m pytest portbench/tests`` and the card's with
``python -m pytest portbench/tests -m cuda`` on a machine with one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is present")
    return torch.device("cuda")
