"""Tree files read for the reference: Newick and Nexus (with a translate
block) parsed into unrooted trees whose edges are named by the split of
taxa that each one cuts.

An edge's split is the set of taxa on the side of the edge away from the
tree's first taxon in sorted order, as a bitmask over the sorted taxon
names. Splits name edges the same way whatever numbering a program gives
the nodes, so results of two programs meet edge by edge. Plain Python; no
import of the measured program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_TOKEN = re.compile(r"\s*(\(|\)|,|:|;|[^(),:;\s]+)")


@dataclass
class Node:
    """A parsed node: a leaf's taxon name (None inside), the length of the
    edge above it, its children."""

    name: Optional[str]
    length: float
    children: List["Node"]


def _strip_comments(s: str) -> str:
    return re.sub(r"\[[^\]]*\]", "", s)


def _parse(s: str, translate: Dict[str, str]) -> Node:
    tokens = _TOKEN.findall(_strip_comments(s))
    pos = 0

    def node() -> Node:
        nonlocal pos
        children = []
        name = None
        if tokens[pos] == "(":
            pos += 1
            children.append(node())
            while tokens[pos] == ",":
                pos += 1
                children.append(node())
            if tokens[pos] != ")":
                raise ValueError(f"expected ')' at token {pos}")
            pos += 1
        if pos < len(tokens) and tokens[pos] not in "(),:;":
            name = tokens[pos]
            pos += 1
        length = 0.0
        if pos < len(tokens) and tokens[pos] == ":":
            length = float(tokens[pos + 1])
            pos += 2
        if not children:
            if name is None:
                raise ValueError("a leaf without a name")
            name = translate.get(name, name).strip("'\"")
        return Node(name if not children else None, length, children)

    root = node()
    if tokens[pos] != ";":
        raise ValueError("a tree must end with ';'")
    return root


@dataclass(frozen=True)
class Tree:
    """An unrooted tree with a trifurcating root, as read from its file.

    taxa: the sorted taxon names. post: internal nodes in postorder, each
    (node, children) over node numbers: leaves 0..n-1 are the taxa in
    sorted order, internal nodes n.. with the root last. edge_of[v]: the
    edge above non-root node v, an index into ``splits``, which are the
    edges' split bitmasks in increasing order. lengths: the file's edge
    lengths in that order."""

    taxa: Tuple[str, ...]
    post: Tuple[Tuple[int, Tuple[int, ...]], ...]
    edge_of: Tuple[int, ...]
    splits: Tuple[int, ...]
    lengths: Tuple[float, ...]

    @property
    def node_count(self) -> int:
        return len(self.taxa) + len(self.post)

    @property
    def root(self) -> int:
        return self.node_count - 1


def tree_of(root: Node) -> Tree:
    """The Tree of a parsed root with three children."""
    if len(root.children) != 3:
        raise ValueError(f"an unrooted tree needs 3 children at its root, "
                         f"got {len(root.children)}")
    leaves: List[Node] = []

    def collect(nd):
        if not nd.children:
            leaves.append(nd)
        for c in nd.children:
            collect(c)

    collect(root)
    taxa = tuple(sorted(nd.name for nd in leaves))
    if len(set(taxa)) != len(taxa):
        raise ValueError("a taxon appears twice")
    index = {name: i for i, name in enumerate(taxa)}
    full = (1 << len(taxa)) - 1
    masks: Dict[int, int] = {}
    lengths: Dict[int, float] = {}
    post: List[Tuple[int, Tuple[int, ...]]] = []
    counter = [len(taxa)]

    def walk(nd) -> int:
        if not nd.children:
            v = index[nd.name]
            masks[v] = 1 << v
        else:
            kids = tuple(walk(c) for c in nd.children)
            v = counter[0]
            counter[0] += 1
            masks[v] = 0
            for k in kids:
                masks[v] |= masks[k]
            post.append((v, kids))
        lengths[v] = nd.length
        return v

    root_id = walk(root)
    canon = {v: (m if not m & 1 else full ^ m)
             for v, m in masks.items() if v != root_id}
    splits = tuple(sorted(canon.values()))
    if len(set(splits)) != len(splits):
        raise ValueError("two edges cut the same split")
    order = {s: e for e, s in enumerate(splits)}
    edge_of = tuple(order[canon[v]] for v in range(root_id))
    edge_lengths = [0.0] * len(splits)
    for v in range(root_id):
        edge_lengths[edge_of[v]] = lengths[v]
    return Tree(taxa, tuple(post), edge_of, splits, tuple(edge_lengths))


def read_newick(path: str) -> List[Tree]:
    """Every tree of a Newick file, one to a line."""
    trees = []
    with open(path) as f:
        for line in f:
            start = line.find("(")
            if start >= 0:
                trees.append(tree_of(_parse(line[start:], {})))
    return trees


def read_nexus(path: str) -> List[Tree]:
    """Every tree of a Nexus trees block, names taken from its translate
    block."""
    with open(path) as f:
        text = f.read()
    block = re.search(r"begin trees;(.*?)end;", text, re.IGNORECASE | re.S)
    if block is None:
        raise ValueError(f"{path}: no trees block")
    body = block.group(1)
    translate: Dict[str, str] = {}
    m = re.search(r"translate(.*?);", body, re.IGNORECASE | re.S)
    if m:
        for item in m.group(1).split(","):
            parts = item.split()
            if len(parts) == 2:
                translate[parts[0]] = parts[1]
    trees = []
    for m in re.finditer(r"tree\s+\S+\s*=\s*(.*?;)", body, re.IGNORECASE):
        s = m.group(1)
        trees.append(tree_of(_parse(s[s.find("("):], translate)))
    return trees


def read_trees(path: str, fmt: str) -> List[Tree]:
    if fmt == "nexus":
        return read_nexus(path)
    if fmt == "newick":
        return read_newick(path)
    raise ValueError(f"tree format must be nexus or newick, got {fmt!r}")
