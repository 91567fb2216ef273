"""A subsplit Bayesian network over unrooted trees, for the reference:
its support and simple-average start from a tree sample, and each
topology's rooted representations (Zhang and Matsen, NeurIPS 2018; libsbn's
sbn_maps.cpp and sbn_probability.cpp).

A rooting on an edge splits the taxa in two: its rootsplit. Under it every
internal node has a clade C, a sister clade S (the other child of its
parent) and two child clades; the network holds P(rootsplit) and
P({C0, C1} | S, C) for each parent subsplit S|C (ordered). A rooted tree's
probability is the product of its rootsplit's and its nodes'; an unrooted
tree's is the sum over its rootings. Clades are bitmasks over the sorted
taxa (reference/trees.py). Plain NumPy and PyTorch; no import of the
measured program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .trees import Tree

Key = Tuple  # ("root", split) or (sister, clade, (child, child))


def _neighbours(tree: Tree):
    adj: Dict[int, List[int]] = {v: [] for v in range(tree.node_count)}
    parent: Dict[int, int] = {}
    for v, kids in tree.post:
        for c in kids:
            adj[v].append(c)
            adj[c].append(v)
            parent[c] = v
    return adj, parent


def _below(tree: Tree):
    n = len(tree.taxa)
    mask = {v: 1 << v for v in range(n)}
    for v, kids in tree.post:
        mask[v] = 0
        for c in kids:
            mask[v] |= mask[c]
    return mask


def rootings(tree: Tree) -> List[List[Key]]:
    """One rooted representation per edge, in the tree's edge order: the
    rootsplit's key, then each internal node's (sister, clade, children)."""
    n = len(tree.taxa)
    full = (1 << n) - 1
    adj, parent = _neighbours(tree)
    below = _below(tree)

    def clade(x, came_from):
        return below[x] if parent.get(x) == came_from else full ^ below[came_from]

    def visit(x, came_from, sister, out):
        kids = [y for y in adj[x] if y != came_from]
        if not kids:
            return
        c = clade(x, came_from)
        a, b = (clade(y, x) for y in kids)
        out.append((sister, c, (min(a, b), max(a, b))))
        visit(kids[0], x, b, out)
        visit(kids[1], x, a, out)

    reps: List[List[Key]] = [[] for _ in tree.splits]
    for u in range(tree.root):
        w = parent[u]
        a = below[u]
        out: List[Key] = [("root", a if not a & 1 else full ^ a)]
        visit(u, w, full ^ a, out)
        visit(w, u, a, out)
        reps[tree.edge_of[u]] = out
    return reps


class Support:
    """The network's parameters over the rootsplits and subsplit pairs that
    the sample's rootings hold: index 0.. the rootsplits, then the pairs
    grouped by parent subsplit. ``counts``: how often each appears over
    every rooting of every tree of the sample."""

    def __init__(self, trees: Sequence[Tree]):
        counts: Dict[Key, int] = {}
        for t in trees:
            for rep in rootings(t):
                for k in rep:
                    counts[k] = counts.get(k, 0) + 1
        roots = sorted(k for k in counts if k[0] == "root")
        pairs = sorted(k for k in counts if k[0] != "root")
        self.keys: List[Key] = roots + pairs
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.counts = np.array([counts[k] for k in self.keys], np.float64)
        parents: Dict[Tuple, int] = {}
        seg = [0] * len(roots)
        for k in pairs:
            seg.append(parents.setdefault(k[:2], len(parents) + 1))
        self.segment = np.array(seg, np.int64)
        self.segments = len(parents) + 1
        # The branch-length variables: one a split, as the rootsplits.
        self.splits = [k[1] for k in roots]

    def simple_average(self) -> np.ndarray:
        """The simple-average estimate: the log of each count, normalised
        within each parent's block when probabilities are taken."""
        return np.log(self.counts)

    def representation(self, tree: Tree) -> np.ndarray:
        """(E, n - 1) parameter indices of each rooting; a key outside the
        support maps to len(keys), whose log-probability is -inf."""
        miss = len(self.keys)
        return np.array([[self.index.get(k, miss) for k in rep]
                         for rep in rootings(tree)], np.int64)


def normalized_log(params, segment, segments: int):
    """Log-probabilities: each parameter less the logsumexp of its
    parent's block (the rootsplits one block)."""
    seg = torch.as_tensor(segment, device=params.device)
    top = torch.full((segments,), -torch.inf, dtype=params.dtype,
                     device=params.device).scatter_reduce(
        0, seg, params.detach(), "amax")
    z = torch.zeros((segments,), dtype=params.dtype,
                    device=params.device).index_add(
        0, seg, torch.exp(params - top[seg]))
    return params - (top + torch.log(z))[seg]


def log_q(normalized, reps):
    """log q(tree) of each representation (T, E, R): the logsumexp over
    rootings of the sum of each rooting's log-probabilities."""
    ext = torch.cat([normalized, normalized.new_full((1,), -torch.inf)])
    return torch.logsumexp(ext[reps].sum(-1), dim=-1)
