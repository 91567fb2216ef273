"""Trees and tree collections.

A copy of libsbn_tpu.core.tree (the reference's src/{tree,unrooted_tree,
rooted_tree,generic_tree_collection,rooted_tree_collection}.*): host-side
numpy containers pairing a Topology with branch lengths (indexed by node
id) and, for rooted time trees, node heights / height-ratio state. The
rooted trees serve generalized pruning (``gp/``) and the time-tree
likelihood (``instance/rooted.py``).

The height-ratio parameterization (rooted_tree.hpp:19-24): for internal node
n with parent p, ratio = (h_n - bound_n) / (h_p - bound_n), where bound_n is
the max tip date below n; the root's "ratio" is its height.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import taxon_names
from .topology import Topology, topology_counter

Tag = Tuple[int, int]

BRANCH_LENGTH_TOLERANCE = 1e-4


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

    def leaf_count(self) -> int:
        return self.topology.leaf_count

    def node_count(self) -> int:
        return self.topology.id + 1

    def parent_id_vector(self) -> List[int]:
        return self.topology.parent_id_vector()

    @classmethod
    def of_parent_id_vector(cls, ids: Sequence[int]) -> "Tree":
        """Unit-branch-length tree from a parent-id vector (tree.cpp:59-62;
        bound per tree class at pylibsbn.cpp)."""
        topology = Topology.of_parent_id_vector(list(ids))
        return cls(topology, np.ones(topology.id + 1))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Tree)
            and self.topology == other.topology
            and np.array_equal(self.branch_lengths, other.branch_lengths)
        )

    def newick(self, tag_taxon_map: Optional[Dict[Tag, str]] = None) -> str:
        return self.topology.newick(self.branch_lengths, tag_taxon_map)

    def slide_root_position(self):
        """Move the root so the first root child holds the full branch length
        (tree.cpp SlideRootPosition)."""
        fixed_node_id = self.topology.children[1].id
        root_child_id = self.topology.children[0].id
        self.branch_lengths[root_child_id] += self.branch_lengths[fixed_node_id]
        self.branch_lengths[fixed_node_id] = 0.0


class UnrootedTree(Tree):
    """A tree with a trifurcation at the root (the usual unrooted encoding)."""

    def __init__(self, topology: Topology, branch_lengths: Sequence[float]):
        super().__init__(topology, branch_lengths)
        assert len(topology.children) == 3, (
            "Expected a tree with a trifurcation at the root for UnrootedTree."
        )

    @staticmethod
    def of_tree(tree: Tree) -> "UnrootedTree":
        return UnrootedTree(tree.topology, tree.branch_lengths)

    def detrifurcate(self) -> Tree:
        """(s0,s1,s2) -> (s0,(s1,s2):0):0 reusing the root id for the new
        join node (unrooted_tree.cpp Detrifurcate)."""
        c = self.topology.children
        joined = Topology.join([c[1], c[2]])
        new_root = Topology.join([c[0], joined])
        bl = np.concatenate([self.branch_lengths, [0.0]])
        bl[self.topology.id] = 0.0
        new_root.polish()
        return Tree(new_root, bl)


class RootedTree(Tree):
    """A bifurcating-root tree with optional time-tree state."""

    def __init__(self, topology: Topology, branch_lengths: Sequence[float]):
        super().__init__(topology, branch_lengths)
        assert len(topology.children) == 2, (
            "Failed to create a RootedTree out of a topology that isn't "
            "bifurcating at the root."
        )
        self.node_bounds: Optional[np.ndarray] = None
        self.height_ratios: Optional[np.ndarray] = None
        self.node_heights: Optional[np.ndarray] = None
        self.rates: Optional[np.ndarray] = None
        self.rate_count: int = 0

    @staticmethod
    def of_tree(tree: Tree) -> "RootedTree":
        return RootedTree(tree.topology, tree.branch_lengths)

    # -- time-tree state ----------------------------------------------------
    def set_tip_dates(self, tag_date_map: Dict[Tag, float]):
        n = self.node_count()
        self.node_heights = np.zeros(n)
        self.rates = np.ones(n - 1)
        self.rate_count = 1
        self._set_node_bounds(tag_date_map)
        for (leaf_id, _), date in tag_date_map.items():
            self.node_heights[leaf_id] = date

    def _set_node_bounds(self, tag_date_map: Dict[Tag, float]):
        leaf_count = self.leaf_count()
        n = self.node_count()
        self.node_bounds = np.zeros(n)
        for (leaf_id, _), date in tag_date_map.items():
            self.node_bounds[leaf_id] = date
        for node in self.topology.postorder():
            if not node.is_leaf():
                c0, c1 = node.children
                self.node_bounds[node.id] = max(
                    self.node_bounds[c0.id], self.node_bounds[c1.id]
                )

    def initialize_time_tree_using_branch_lengths(self):
        assert self.node_bounds is not None, "Set tip dates first."
        leaf_count = self.leaf_count()
        root_id = self.topology.id
        self.height_ratios = np.zeros(leaf_count - 1)
        for node in self.topology.postorder():
            if not node.is_leaf():
                c0, c1 = node.children
                self.node_heights[node.id] = (
                    self.node_heights[c0.id] + self.branch_lengths[c0.id]
                )
                diff = abs(
                    self.node_heights[c1.id]
                    + self.branch_lengths[c1.id]
                    - self.node_heights[node.id]
                )
                if diff > BRANCH_LENGTH_TOLERANCE:
                    raise ValueError(
                        f"Tree isn't time-calibrated. Height difference: {diff}"
                    )
        self.height_ratios[root_id - leaf_count] = self.node_heights[root_id]

        def visit(node_id: int, parent_id: int):
            if node_id >= leaf_count:
                self.height_ratios[node_id - leaf_count] = (
                    self.node_heights[node_id] - self.node_bounds[node_id]
                ) / (self.node_heights[parent_id] - self.node_bounds[node_id])

        self.topology.triple_id_preorder_bifurcating(
            lambda n, s, p: visit(n, p)
        )

    def initialize_time_tree_using_height_ratios(self, height_ratios):
        assert self.node_bounds is not None, "Set tip dates first."
        leaf_count = self.leaf_count()
        root_id = self.topology.id
        height_ratios = np.asarray(height_ratios, dtype=np.float64)
        self.height_ratios = height_ratios.copy()
        self.node_heights[root_id] = height_ratios[root_id - leaf_count]

        def visit(node_id: int, parent_id: int):
            if node_id >= leaf_count:
                self.node_heights[node_id] = self.node_bounds[node_id] + height_ratios[
                    node_id - leaf_count
                ] * (self.node_heights[parent_id] - self.node_bounds[node_id])
            self.branch_lengths[node_id] = (
                self.node_heights[parent_id] - self.node_heights[node_id]
            )

        self.topology.triple_id_preorder_bifurcating(
            lambda n, s, p: visit(n, p)
        )

    def tag_date_map_of_date_vector(
        self, leaf_dates: Sequence[float]
    ) -> Dict[Tag, float]:
        assert len(leaf_dates) == self.leaf_count()
        return {(i, 1): d for i, d in enumerate(leaf_dates)}

    @staticmethod
    def example() -> "RootedTree":
        """The tree (0:2,(1:1.5,(2:2,3:1):2.5):2.5):0 (rooted_tree.cpp)."""
        top = Topology.example_topologies()[3]
        tree = RootedTree(top, [2.0, 1.5, 2.0, 1.0, 2.5, 2.5, 0.0])
        tree.set_tip_dates(tree.tag_date_map_of_date_vector([5.0, 3.0, 0.0, 1.0]))
        tree.initialize_time_tree_using_branch_lengths()
        return tree


class TreeCollection:
    """Trees on a shared taxon set (generic_tree_collection.hpp analog)."""

    tree_class = Tree

    def __init__(self, trees: Sequence[Tree], tag_taxon_map):
        self.trees: List[Tree] = list(trees)
        if hasattr(tag_taxon_map, "items"):  # any Mapping, not just dict
            self.tag_taxon_map = dict(tag_taxon_map)
        else:
            # The reference's collection constructors also accept a plain
            # taxon-name list (test/test_libsbn.py:27-30); leaf i gets
            # tag (i, 1).
            self.tag_taxon_map = {
                (i, 1): name for i, name in enumerate(tag_taxon_map)
            }

    def tree_count(self) -> int:
        return len(self.trees)

    def taxon_count(self) -> int:
        return len(self.tag_taxon_map)

    def taxon_names(self) -> List[str]:
        return [
            self.tag_taxon_map[(i, 1)] for i in range(len(self.tag_taxon_map))
        ]

    def topology_counter(self):
        return topology_counter([t.topology for t in self.trees])

    def erase(self, begin: int, end: int):
        del self.trees[begin:end]

    def drop_first(self, fraction: float):
        assert 0.0 <= fraction <= 1.0
        self.erase(0, int(fraction * len(self.trees)))

    def newick(self) -> str:
        return "\n".join(t.newick(self.tag_taxon_map) for t in self.trees) + "\n"

    def to_newick_file(self, path: str):
        with open(path, "w") as f:
            f.write(self.newick())

    def branch_length_matrix(self) -> np.ndarray:
        """(trees, nodes) matrix of branch lengths — the dense runtime form."""
        return np.stack([t.branch_lengths for t in self.trees])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TreeCollection)
            and self.tag_taxon_map == other.tag_taxon_map
            and len(self.trees) == len(other.trees)
            and all(a == b for a, b in zip(self.trees, other.trees))
        )


class UnrootedTreeCollection(TreeCollection):
    tree_class = UnrootedTree

    @staticmethod
    def of_tree_collection(collection: TreeCollection) -> "UnrootedTreeCollection":
        return UnrootedTreeCollection(
            [UnrootedTree.of_tree(t) for t in collection.trees],
            collection.tag_taxon_map,
        )


class RootedTreeCollection(TreeCollection):
    tree_class = RootedTree

    def __init__(self, trees, tag_taxon_map, tag_date_map: Optional[Dict] = None):
        super().__init__(trees, tag_taxon_map)
        self.tag_date_map: Dict[Tag, float] = tag_date_map or {}

    @staticmethod
    def of_tree_collection(collection: TreeCollection) -> "RootedTreeCollection":
        return RootedTreeCollection(
            [RootedTree.of_tree(t) for t in collection.trees],
            collection.tag_taxon_map,
        )

    def set_dates_to_be_constant(self, initialize_time_trees: bool):
        self.tag_date_map = taxon_names.constant_dates_for_tag_taxon_map(
            self.tag_taxon_map
        )
        self._process_tree_dates(initialize_time_trees)

    def parse_dates_from_taxon_names(self, initialize_time_trees: bool):
        self.tag_date_map = taxon_names.parse_dates_from_tag_taxon_map(
            self.tag_taxon_map
        )
        self._process_tree_dates(initialize_time_trees)

    def parse_dates_from_csv(self, csv_path: str, initialize_time_trees: bool):
        import csv as csv_mod

        taxon_date_map = {}
        with open(csv_path) as f:
            for row in csv_mod.reader(f):
                if len(row) >= 2:
                    taxon_date_map[row[0]] = float(row[1])
        tag_date_map = {}
        for tag, taxon in self.tag_taxon_map.items():
            if taxon not in taxon_date_map:
                raise ValueError(
                    f"Taxon {taxon} found in current tree collection but not in "
                    f"{csv_path}"
                )
            tag_date_map[tag] = taxon_date_map[taxon]
        self.tag_date_map = taxon_names.make_dates_relative_to_maximum(tag_date_map)
        self._process_tree_dates(initialize_time_trees)

    def _process_tree_dates(self, initialize_time_trees: bool):
        for tree in self.trees:
            tree.set_tip_dates(self.tag_date_map)
        if initialize_time_trees:
            for tree in self.trees:
                tree.initialize_time_tree_using_branch_lengths()
