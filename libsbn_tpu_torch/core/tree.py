"""Unrooted trees and tree collections.

The part of libsbn_tpu.core.tree that the likelihood path uses (the
reference's src/{tree,unrooted_tree,generic_tree_collection}.*): host-side
containers pairing a Topology with branch lengths indexed by node id.
Rooted time trees are not on this slice (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .topology import Topology, topology_counter


class Tree:
    """Topology + branch lengths indexed by node id."""

    def __init__(self, topology: Topology, branch_lengths: Sequence[float]):
        if topology.id < 0:
            topology.polish()
        assert topology.id + 1 == len(branch_lengths), (
            "Root id is too large relative to the branch_lengths size."
        )
        self.topology = topology
        self.branch_lengths = np.asarray(branch_lengths, dtype=np.float64).copy()


class UnrootedTree(Tree):
    """A tree with a trifurcation at the root (the usual unrooted encoding)."""

    def __init__(self, topology: Topology, branch_lengths: Sequence[float]):
        super().__init__(topology, branch_lengths)
        assert len(topology.children) == 3, (
            "Expected a tree with a trifurcation at the root for UnrootedTree."
        )


class TreeCollection:
    """Trees on a shared taxon set (generic_tree_collection.hpp analog)."""

    tree_class = Tree

    def __init__(self, trees: Sequence[Tree], tag_taxon_map):
        self.trees: List[Tree] = list(trees)
        if hasattr(tag_taxon_map, "items"):  # any Mapping, not just dict
            self.tag_taxon_map = dict(tag_taxon_map)
        else:
            # A plain taxon-name list: leaf i gets tag (i, 1).
            self.tag_taxon_map = {
                (i, 1): name for i, name in enumerate(tag_taxon_map)
            }

    def tree_count(self) -> int:
        return len(self.trees)

    def taxon_names(self) -> List[str]:
        return [
            self.tag_taxon_map[(i, 1)] for i in range(len(self.tag_taxon_map))
        ]

    def topology_counter(self):
        return topology_counter([t.topology for t in self.trees])

    def branch_length_matrix(self) -> np.ndarray:
        """(trees, nodes) matrix of branch lengths — the dense runtime form."""
        return np.stack([t.branch_lengths for t in self.trees])


class UnrootedTreeCollection(TreeCollection):
    tree_class = UnrootedTree
