"""SBN support: the indexing structures over rootsplits and PCSPs, plus the
dense lowering used by the device code.

A copy of libsbn_tpu.sbn.support (the reference's src/sbn_support.hpp and
psp_indexer.{hpp,cpp}).

The support is host-side; its dense artifacts are:
  * ``segment_ids`` (G,): normalization segment of each parameter (segment 0
    is the rootsplit block, then one segment per parent subsplit block) —
    drives segment-logsumexp normalization on device;
  * padded indexer-representation arrays for tree collections — drive
    SA/EM/probability/gradient kernels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.topology import Topology
from ..utils.bitset import Bitset
from . import maps


class SBNSupport:
    """Common support machinery; see UnrootedSBNSupport / RootedSBNSupport."""

    rooted: bool = True

    def __init__(self, topology_counter=None, taxon_names: Sequence[str] = ()):
        self.taxon_names = list(taxon_names)
        self.rootsplits: List[Bitset] = []
        self.indexer: Dict[Bitset, int] = {}
        self.index_to_child: Dict[int, Bitset] = {}
        self.parent_to_range: Dict[Bitset, Tuple[int, int]] = {}
        self.gpcsp_count = 0
        if topology_counter:
            rootsplit_counter = self._rootsplit_counter(topology_counter)
            pcsp_counter = self._pcsp_counter(topology_counter)
            (
                self.rootsplits,
                self.indexer,
                self.index_to_child,
                self.parent_to_range,
                self.gpcsp_count,
            ) = maps.build_indexer_bundle(rootsplit_counter, pcsp_counter)

    # -- basic queries -------------------------------------------------------
    def empty(self) -> bool:
        return self.gpcsp_count == 0

    def taxon_count(self) -> int:
        return len(self.taxon_names)

    def rootsplit_count(self) -> int:
        return len(self.rootsplits)

    def parent_in_support(self, parent: Bitset) -> bool:
        return parent in self.parent_to_range

    def pretty_indexer(self) -> List[str]:
        """ith entry = string form of the ith GPCSP: rootsplits as plain
        bitstrings, PCSPs as sister|focal|child0."""
        out = [""] * self.gpcsp_count
        for bitset, index in self.indexer.items():
            if index < self.rootsplit_count():
                out[index] = bitset.to_string()
            else:
                out[index] = bitset.pcsp_to_string()
        return out

    # -- representations -----------------------------------------------------
    def indexer_representation_of(self, top: Topology, default_index=None):
        if default_index is None:
            default_index = self.gpcsp_count
        if self.rooted:
            return maps.rooted_indexer_representation_of(
                self.indexer, top, default_index
            )
        return maps.unrooted_indexer_representation_of(
            self.indexer, top, default_index
        )

    def indexer_representation_counter_of(self, topology_counter, default_index=None):
        return [
            (self.indexer_representation_of(top, default_index), count)
            for top, count in topology_counter.items()
        ]

    # -- dense lowering ------------------------------------------------------
    def segment_ids(self) -> np.ndarray:
        """(G,) normalization segment per parameter; (S,) segment count via
        .max()+1. Segment 0 = rootsplits; one per parent block after."""
        seg = np.zeros(self.gpcsp_count, dtype=np.int32)
        for s, (_, (start, end)) in enumerate(self.parent_to_range.items(), start=1):
            seg[start:end] = s
        return seg

    def segment_of_range(self) -> Dict[Tuple[int, int], int]:
        """range -> segment id (segment 0 is the rootsplit block)."""
        out = {(0, self.rootsplit_count()): 0}
        for s, (_, rng) in enumerate(self.parent_to_range.items(), start=1):
            out[rng] = s
        return out

    def dense_representations(self, topologies: Sequence[Topology]) -> np.ndarray:
        """Stack indexer representations: rooted -> (T, R) int32; unrooted ->
        (T, E, R) int32 (E = rootings). Out-of-support -> sentinel G."""
        reps = [self.indexer_representation_of(t) for t in topologies]
        return np.asarray(reps, dtype=np.int32)

    def build_psp_indexer(self) -> "PSPIndexer":
        return PSPIndexer(self.rootsplits, self.indexer)

    def _rootsplit_counter(self, topology_counter):
        raise NotImplementedError

    def _pcsp_counter(self, topology_counter):
        raise NotImplementedError


class UnrootedSBNSupport(SBNSupport):
    rooted = False

    def _rootsplit_counter(self, topology_counter):
        return maps.unrooted_rootsplit_counter_of(topology_counter)

    def _pcsp_counter(self, topology_counter):
        return maps.unrooted_pcsp_counter_of(topology_counter)

    def native_indexer_handle(self):
        """Cached C++ indexer handle (io/native.py NativeIndexerHandle), or
        None when the native library is unavailable."""
        cached = getattr(self, "_native_indexer_cache", "unset")
        if cached != "unset":
            return cached
        handle = None
        try:
            from ..io import native

            n = self.taxon_count()
            split_items = [
                (b.bits, i) for b, i in self.indexer.items() if b.size == n
            ]
            pcsp_items = [
                (b.bits, i) for b, i in self.indexer.items() if b.size == 3 * n
            ]
            handle = native.NativeIndexerHandle(split_items, pcsp_items, n)
        except RuntimeError:  # the native library is unavailable
            handle = None
        object.__setattr__(self, "_native_indexer_cache", handle)
        return handle

    def dense_representations_of_parent_vectors(self, parent_vectors):
        """(T, E, R) int32 representations straight from canonical parent-id
        vectors via the native core — no Python Topology construction.
        Returns None when the native path is unavailable. Unlike the Python
        path (which raises on splits outside the support), out-of-support
        splits and PCSPs map to the sentinel index."""
        handle = self.native_indexer_handle()
        if handle is None:
            return None
        return handle.representations(parent_vectors, self.gpcsp_count)


class RootedSBNSupport(SBNSupport):
    rooted = True

    def _rootsplit_counter(self, topology_counter):
        return maps.rooted_rootsplit_counter_of(topology_counter)

    def _pcsp_counter(self, topology_counter):
        return maps.rooted_pcsp_counter_of(topology_counter)


class PSPIndexer:
    """Primary Subsplit Pair branch-length indexer (psp_indexer.cpp).

    Layout: rootsplits at [0, after_rootsplits_index), then primary subsplit
    pairs (subsplits whose parent is a rootsplit, keyed focal|child0);
    first_empty_index is the "not present" sentinel for pendant branches.
    """

    def __init__(self, rootsplits=None, in_indexer=None):
        self.indexer: Dict[Bitset, int] = {}
        self.after_rootsplits_index = 0
        self.first_empty_index = 0
        if rootsplits is None:
            return
        index = 0
        for rootsplit in rootsplits:
            self.indexer[rootsplit] = index
            index += 1
        self.after_rootsplits_index = index
        for pcsp, idx in in_indexer.items():
            if idx >= len(rootsplits) and pcsp.pcsp_is_rootsplit():
                self.indexer[pcsp.pcsp_without_parent()] = index
                index += 1
        self.first_empty_index = index

    def details(self) -> Dict[str, int]:
        return {
            "after_rootsplits_index": self.after_rootsplits_index,
            "first_empty_index": self.first_empty_index,
            "rootsplit_position": 0,
            "subsplit_down_position": 1,
            "subsplit_up_position": 2,
        }

    def to_string_vector(self) -> List[str]:
        out = [""] * (len(self.indexer) + 1)
        for bitset, idx in self.indexer.items():
            if idx < self.after_rootsplits_index:
                out[idx] = bitset.to_string()
            else:
                out[idx] = bitset.subsplit_to_string()
        return out

    def representation_of(self, top: Topology) -> List[List[int]]:
        """[rootsplit indices, subsplit-down indices, subsplit-up indices],
        each indexed by node id (psp_indexer.cpp RepresentationOf)."""
        assert self.first_empty_index > 0, "This PSPIndexer is uninitialized."
        sentinel = self.first_empty_index
        n_edges = top.id
        rootsplit_result = [sentinel] * n_edges
        psp_down = [sentinel] * n_edges
        psp_up = [sentinel] * n_edges
        leaf_count = top.leaf_count

        def rootsplit_index(node):
            return self.indexer[node.leaves.minorize()]

        def psp_index(z1: Bitset, z2: Bitset, z: Bitset):
            return self.indexer[z + min(z1, z2)]

        def f_root(node0, node1, node2):
            rootsplit_result[node0.id] = rootsplit_index(node0)
            psp_up[node0.id] = psp_index(
                node1.leaves, node2.leaves, ~node0.leaves
            )

        def f_internal(node, sister, parent):
            rootsplit_result[node.id] = rootsplit_index(node)
            psp_up[node.id] = psp_index(
                ~parent.leaves, sister.leaves, ~node.leaves
            )
            psp_down[parent.id] = psp_index(
                node.leaves, sister.leaves, parent.leaves
            )

        top.triple_preorder(f_root, f_internal)
        return [rootsplit_result, psp_down, psp_up]

    def string_representation_of(self, top: Topology) -> List[List[str]]:
        rev = self.to_string_vector()
        return [[rev[i] for i in part] for part in self.representation_of(top)]

    def native_handle(self):
        """Cached C++ PSP handle (io/native.py NativePSPHandle) or None."""
        cached = getattr(self, "_native_cache", "unset")
        if cached != "unset":
            return cached
        handle = None
        try:
            from ..io import native

            split_items = []
            subsplit_items = []
            n = None
            for b, i in self.indexer.items():
                if i < self.after_rootsplits_index:
                    split_items.append((b.bits, i))
                    n = b.size
                else:
                    subsplit_items.append((b.bits, i))
            if n is not None:
                handle = native.NativePSPHandle(split_items, subsplit_items, n)
        except RuntimeError:  # the native library is unavailable
            handle = None
        self._native_cache = handle
        return handle

    def dense_representations_of_parent_vectors(self, parent_vectors):
        """(T, 3, E) int32 PSP rows [rootsplit, down, up] straight from
        canonical parent-id vectors via the native core, sentinel =
        first_empty_index. Returns None when unavailable."""
        handle = self.native_handle()
        if handle is None:
            return None
        return handle.representations(parent_vectors, self.first_empty_index)

    def split_lengths(self, tree_collection) -> List[List[float]]:
        """ith entry: branch lengths observed for the ith split across the
        collection (psp_indexer.cpp SplitLengths)."""
        result: List[List[float]] = [[] for _ in range(self.after_rootsplits_index)]
        for tree in tree_collection.trees:
            split_indices = self.representation_of(tree.topology)[0]
            for edge_index, split_index in enumerate(split_indices):
                result[split_index].append(float(tree.branch_lengths[edge_index]))
        return result
