"""The program's node numbering read into the reference's terms.

A program's schedule numbers a tree's nodes its own way: leaves by its
taxon numbering, internal nodes in postorder (step s combines into node
leaf_count + s, the root last), each non-root node standing for the edge
above it. Here each node's leaf set gives the split its edge cuts, which
names the edge in the reference (reference/trees.py); and a schedule the
program lowered from a topology it sampled becomes a reference tree. Only
the harness reads the program this way; the reference never does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.reference.trees import Node, Tree, tree_of


def node_masks(post_children, leaf_count: int, taxon_of_leaf: Dict[int, int]):
    """{program node: bitmask of its leaves over the reference's taxa} for
    one schedule row, post_children (S, 3) with node leaf_count + s made at
    step s (ids past the root are padding)."""
    mask = {v: 1 << taxon_of_leaf[v] for v in range(leaf_count)}
    for s, kids in enumerate(np.asarray(post_children)):
        m = 0
        for c in kids:
            m |= mask.get(int(c), 0)
        mask[leaf_count + s] = m
    return mask


def split_edges(post_children, leaf_count: int, taxon_of_leaf,
                trees: Sequence[Tree]) -> np.ndarray:
    """(B, N - 1): for each row and non-root node of the program's
    schedule, the reference edge of ``trees[b]`` its edge cuts. Raises
    where a split is not an edge of that tree (the program holds another
    tree than the reference)."""
    pc = np.asarray(post_children)
    B, S = pc.shape[:2]
    root = leaf_count + S - 1
    full = (1 << leaf_count) - 1
    out = np.zeros((B, root), np.int64)
    for b in range(B):
        order = {s: e for e, s in enumerate(trees[b].splits)}
        mask = node_masks(pc[b], leaf_count, taxon_of_leaf)
        for v in range(root):
            m = mask[v]
            canon = m if not m & 1 else full ^ m
            if canon not in order:
                raise RuntimeError(f"row {b}: node {v}'s split is not an edge "
                                   "of the reference's tree")
            out[b, v] = order[canon]
    return out


def tree_of_schedule(post_children, leaf_count: int,
                     taxon_names: Sequence[str]) -> Tuple[Tree, np.ndarray]:
    """(reference tree, (N - 1,) its edge for each program node) of one
    schedule row; taxon_names: the program's, by leaf id."""
    pc = np.asarray(post_children)
    root = leaf_count + pc.shape[0] - 1
    nodes: Dict[int, Node] = {
        v: Node(taxon_names[v], 0.0, []) for v in range(leaf_count)}
    for s, kids in enumerate(pc):
        nodes[leaf_count + s] = Node(
            None, 0.0, [nodes[int(c)] for c in kids if int(c) in nodes])
    tree = tree_of(nodes[root])
    taxon_of_leaf = {v: tree.taxa.index(n) for v, n in enumerate(taxon_names)}
    edges = split_edges(pc[None], leaf_count, taxon_of_leaf, [tree])[0]
    return tree, edges


def taxon_map(program_names: List[str], taxa: Sequence[str]) -> Dict[int, int]:
    """{program leaf id: reference taxon index}."""
    return {i: list(taxa).index(n) for i, n in enumerate(program_names)}


def _mask(bitset, lo: int, n: int, taxon_of_leaf) -> int:
    """The reference bitmask of taxa chunk ``lo`` of a program bitset whose
    chunks are n wide (its taxon 0 the chunk's highest bit)."""
    bits = (bitset.bits >> (bitset.size - (lo + 1) * n)) & ((1 << n) - 1)
    return sum(1 << taxon_of_leaf[i] for i in range(n)
               if bits >> (n - 1 - i) & 1)


def sbn_keys(support, taxon_of_leaf) -> List[Tuple]:
    """The reference's key (reference/sbn.py) of each of the program's
    network parameters, by the program's index: its rootsplits, then its
    subsplit pairs (sister | clade | one child, a bitset in three chunks)."""
    n = len(taxon_of_leaf)
    full = (1 << n) - 1
    keys: List[Tuple] = [None] * support.gpcsp_count
    for bitset, index in support.indexer.items():
        if index < support.rootsplit_count():
            m = _mask(bitset, 0, n, taxon_of_leaf)
            keys[index] = ("root", m if not m & 1 else full ^ m)
        else:
            s, c, c0 = (_mask(bitset, k, n, taxon_of_leaf) for k in range(3))
            c1 = c ^ c0
            keys[index] = (s, c, (min(c0, c1), max(c0, c1)))
    return keys
