"""A FASTA alignment read for the reference: its distinct site columns,
their counts, and each taxon's tip partial likelihoods.

A, C, G and T (either case) are the four states; every other symbol (gap,
N, ambiguity codes) is a tip partial of all ones, the convention of
libsbn's site_pattern.cpp. Plain NumPy; no import of the measured program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

_STATE = {"A": 0, "C": 1, "G": 2, "T": 3}


def read_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, list] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].strip()
                seqs[name] = []
            elif name is None:
                raise ValueError(f"{path}: sequence before a name")
            else:
                seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


@dataclass(frozen=True)
class Patterns:
    """tips (taxa, patterns, 4) in the order of ``taxa``; weights
    (patterns,): how many sites each distinct column stands for."""

    taxa: Tuple[str, ...]
    tips: np.ndarray
    weights: np.ndarray

    @property
    def site_count(self) -> int:
        return int(self.weights.sum())


def patterns(path: str, taxa: Sequence[str]) -> Patterns:
    """The alignment's distinct columns over ``taxa``, in that order."""
    seqs = read_fasta(path)
    missing = [t for t in taxa if t not in seqs]
    if missing:
        raise ValueError(f"{path} lacks taxa {missing}")
    codes = np.array([[_STATE.get(c.upper(), 4) for c in seqs[t]]
                      for t in taxa], dtype=np.int8)
    cols, counts = np.unique(codes.T, axis=0, return_counts=True)
    n_taxa, n_pat = len(taxa), cols.shape[0]
    tips = np.ones((n_taxa, n_pat, 4))
    known = cols.T < 4
    for t in range(n_taxa):
        rows = np.nonzero(known[t])[0]
        tips[t, rows] = 0.0
        tips[t, rows, cols[rows, t]] = 1.0
    return Patterns(tuple(taxa), tips, counts.astype(np.float64))
