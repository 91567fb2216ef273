"""Ancestral sampling of topologies from a trained SBN.

A copy of libsbn_tpu.sbn.sampling. Reference: generic_sbn_instance.hpp
SampleTopology (recursion over
parent_to_range + discrete_distribution). Host-side with a numpy Generator;
the per-range categorical probabilities are normalized on the fly exactly as
the reference does (SampleIndex normalizes the log-parameter segment).
"""

from __future__ import annotations


import numpy as np

from ..core.topology import Topology
from ..utils.bitset import Bitset
from .support import SBNSupport


class SBNSampler:
    def __init__(self, support: SBNSupport, sbn_parameters, seed: int = 0):
        self.support = support
        self.params = np.asarray(sbn_parameters, dtype=np.float64)
        self.rng = np.random.default_rng(seed)
        # Cache normalized linear probabilities per range.
        self._range_probs = {}

    def set_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def refresh_parameters(self, sbn_parameters):
        self.params = np.asarray(sbn_parameters, dtype=np.float64)
        self._range_probs = {}

    def _probs_of_range(self, rng_pair):
        probs = self._range_probs.get(rng_pair)
        if probs is None:
            start, end = rng_pair
            seg = self.params[start:end]
            m = np.max(seg)
            p = np.exp(seg - m)
            probs = p / p.sum()
            self._range_probs[rng_pair] = probs
        return probs

    def sample_index(self, rng_pair) -> int:
        start, end = rng_pair
        assert start < end <= self.params.size
        return start + int(
            self.rng.choice(end - start, p=self._probs_of_range(rng_pair))
        )

    def sample_topology(self, rooted: bool) -> Topology:
        rootsplit_idx = self.sample_index((0, self.support.rootsplit_count()))
        rootsplit = self.support.rootsplits[rootsplit_idx]
        subsplit = rootsplit + ~rootsplit
        top = self._sample_subtree(subsplit)
        if not rooted:
            top.polish()
            top = top.deroot()
        top.polish()
        return top

    def _sample_subtree(self, parent_subsplit: Bitset) -> Topology:
        def process(parent: Bitset) -> Topology:
            focal = parent.subsplit_chunk(1)
            singleton = focal.singleton_option()
            if singleton is not None:
                return Topology.leaf(singleton)
            child_index = self.sample_index(
                self.support.parent_to_range[parent]
            )
            return self._sample_subtree(self.support.index_to_child[child_index])

        return Topology.join2(
            process(parent_subsplit), process(parent_subsplit.rotate_subsplit())
        )


# -- native bulk sampler ------------------------------------------------------


def build_sampler_tables(support: SBNSupport):
    """Lower the support's bitset recursion into the dense int32 tables the
    native sampler consumes (native/libsbn_native.cpp lsbn_sample_topologies).

    Row layout (both tables): [leaf1, r1s, r1e, leaf2, r2s, r2e] where side 1
    is ``process(parent)`` and side 2 is ``process(parent.rotate_subsplit())``
    of the recursion above; leafK >= 0 marks a leaf, otherwise [rKs, rKe) is
    the categorical range. Returns (root_tab, child_tab) or None if any
    reachable parent is missing from parent_to_range (degenerate support)."""

    def side_entry(parent):
        focal = parent.subsplit_chunk(1)
        singleton = focal.singleton_option()
        if singleton is not None:
            return (singleton, -1, -1)
        rng = support.parent_to_range.get(parent)
        if rng is None:
            return None
        return (-1, rng[0], rng[1])

    def row_of(subsplit):
        side1 = side_entry(subsplit)
        side2 = side_entry(subsplit.rotate_subsplit())
        if side1 is None or side2 is None:
            return None
        return side1 + side2

    rs_count = support.rootsplit_count()
    root_tab = np.empty((rs_count, 6), dtype=np.int32)
    for s, rootsplit in enumerate(support.rootsplits):
        row = row_of(rootsplit + ~rootsplit)
        if row is None:
            return None
        root_tab[s] = row
    child_tab = np.full((support.gpcsp_count, 6), -1, dtype=np.int32)
    for index, child in support.index_to_child.items():
        row = row_of(child)
        if row is None:
            return None
        child_tab[index] = row
    return root_tab, child_tab


def normalized_range_probs(support: SBNSupport, sbn_parameters) -> np.ndarray:
    """Linear probabilities normalized within each sibling block (the
    rootsplit block plus every parent_to_range segment). Vectorized as
    segment max/sum scatters over segment_ids."""
    params = np.asarray(sbn_parameters, dtype=np.float64)
    seg = getattr(support, "_segment_ids_cache", None)
    if seg is None:
        seg = support.segment_ids()
        object.__setattr__(support, "_segment_ids_cache", seg)
    num_segments = int(seg.max(initial=0)) + 1
    m = np.full(num_segments, -np.inf)
    np.maximum.at(m, seg, params)
    p = np.exp(params - m[seg])
    sums = np.zeros(num_segments)
    np.add.at(sums, seg, p)
    return p / sums[seg]


class NativeSBNSampler:
    """Bulk ancestral sampling through the C++ core. Produces canonical
    polished parent-id vectors (same form as Topology.parent_id_vector after
    polish/deroot), suitable as artifact-cache keys without constructing
    Python topologies. Falls back to None when the native library or the
    tables are unavailable."""

    def __init__(self, support: SBNSupport, sbn_parameters, seed: int = 0):
        self.support = support
        self.tables = build_sampler_tables(support)
        self.rng = np.random.default_rng(seed)
        self.refresh_parameters(sbn_parameters)

    def set_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def refresh_parameters(self, sbn_parameters):
        if self.tables is not None:
            self.probs = normalized_range_probs(self.support, sbn_parameters)

    def sample_parent_vectors(self, count: int, rooted: bool):
        """(count, n_nodes - 1) int32 parent vectors, or None."""
        if self.tables is None:
            return None
        from ..io import native

        root_tab, child_tab = self.tables
        return native.sample_topologies(
            self.probs, root_tab, child_tab, self.support.taxon_count(),
            count, int(self.rng.integers(2**63)), rooted,
        )
