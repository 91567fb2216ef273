"""Variational Bayesian phylogenetics: the device VBPI step (jit_step).

The Burrito and the rest of the vip layer are ROADMAP queue 1, item 10.
"""

from . import jit_step  # noqa: F401
from .jit_step import JitVBPI  # noqa: F401

__all__ = ["JitVBPI", "jit_step"]
