"""SBN maps: counters, indexers, and indexer representations of topologies.

A copy of libsbn_tpu.sbn.maps: the host-side reimplementation of the
reference's src/sbn_maps.cpp and the PCSP traversals of node.cpp. A
topology's *indexer representation*
digests it into flat indices into the sbn_parameters vector:

  * rooted: [rootsplit index, PCSP indices...] — length leaf_count-1;
  * unrooted: one rooted representation per virtual rooting (one per edge,
    i.e. per non-root node) — shape (2n-3, n-1).

Unknown rootsplits/PCSPs map to ``default_index`` (the out-of-support
sentinel). The runtime layer (sbn/probability.py) consumes these as dense
int32 arrays with an extra -inf parameter slot at the sentinel, so
out-of-support handling costs nothing on device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..core.topology import Topology
from ..utils.bitset import Bitset

# direction=True means "flip the leaf set" (the clade on the other side).
UnrootedPCSPFun = Callable

def _leaves(node: Topology, flip: bool, leaf_count: int) -> Bitset:
    b = node.leaves
    assert b is not None, "topology must be polished"
    return ~b if flip else b


def pcsp_bitset_of(
    leaf_count: int,
    sister: Topology, sister_dir: bool,
    focal: Topology, focal_dir: bool,
    child0: Topology, child0_dir: bool,
    child1: Topology, child1_dir: bool,
) -> Bitset:
    """sister|focal|min(child0,child1) (sbn_maps.cpp PCSPBitsetOf)."""
    s = _leaves(sister, sister_dir, leaf_count)
    f = _leaves(focal, focal_dir, leaf_count)
    c0 = _leaves(child0, child0_dir, leaf_count)
    c1 = _leaves(child1, child1_dir, leaf_count)
    return s + f + min(c0, c1)


def parent_bitset_of(
    leaf_count: int,
    sister: Topology, sister_dir: bool,
    focal: Topology, focal_dir: bool,
) -> Bitset:
    return (_leaves(sister, sister_dir, leaf_count)
            + _leaves(focal, focal_dir, leaf_count))


def unrooted_pcsp_preorder(top: Topology, f):
    """Iterate f over every PCSP of every virtual rooting of an unrooted
    (trifurcating-root) topology (node.cpp UnrootedPCSPPreorder).

    f(sister, sister_dir, focal, focal_dir, child0, child0_dir,
      child1, child1_dir, virtual_root_clade_or_None).
    """
    def f_root(node0, node1, node2):
        # Virtual root on node2's edge, with subsplit pointing up.
        f(node2, False, node2, True, node0, False, node1, False, None)
        if not node2.is_leaf():
            assert len(node2.children) == 2
            child0, child1 = node2.children
            f(node0, False, node2, False, child0, False, child1, False, node1)
            f(node1, False, node2, False, child0, False, child1, False, node0)
            f(node2, True, node2, False, child0, False, child1, False, None)
            f(child1, False, node2, True, node0, False, node1, False, child0)
            f(child0, False, node2, True, node0, False, node1, False, child1)

    def f_internal(node, sister, parent):
        f(node, False, node, True, parent, True, sister, False, None)
        if not node.is_leaf():
            assert len(node.children) == 2
            child0, child1 = node.children
            f(sister, False, node, False, child0, False, child1, False, top)
            f(parent, True, node, False, child0, False, child1, False, sister)
            f(node, True, node, False, child0, False, child1, False, None)
            f(child1, False, node, True, sister, False, parent, True, child0)
            f(child0, False, node, True, sister, False, parent, True, child1)

    top.triple_preorder(f_root, f_internal)


def rooted_pcsp_preorder(top: Topology, f):
    """f(sister, focal, child0, child1) over internal non-root nodes
    (node.cpp RootedPCSPPreorder)."""
    def visit(node: Topology, sister: Topology):
        if not node.is_leaf():
            c0, c1 = node.children
            f(sister, node, c0, c1)

    def recur(node: Topology):
        if not node.is_leaf():
            c0, c1 = node.children
            visit(c0, c1)
            recur(c0)
            visit(c1, c0)
            recur(c1)

    assert len(top.children) == 2
    recur(top)


# -- counters ---------------------------------------------------------------
def unrooted_rootsplit_counter_of(topology_counter) -> Dict[Bitset, int]:
    counter: Dict[Bitset, int] = {}
    for top, count in topology_counter.items():
        for child in top.children:
            for node in child.preorder():
                split = node.leaves.minorize()
                counter[split] = counter.get(split, 0) + count
    return counter


def rooted_rootsplit_counter_of(topology_counter) -> Dict[Bitset, int]:
    counter: Dict[Bitset, int] = {}
    for top, count in topology_counter.items():
        assert len(top.children) == 2, "rooted rootsplit needs a bifurcating root"
        split = top.children[0].leaves.minorize()
        counter[split] = counter.get(split, 0) + count
    return counter


def _add_to_pcsp_counter(pcsp_dict, count, leaf_count, sister, sister_dir,
                         focal, focal_dir, child0, child0_dir, child1, child1_dir):
    parent = parent_bitset_of(leaf_count, sister, sister_dir, focal, focal_dir)
    c0 = _leaves(child0, child0_dir, leaf_count)
    c1 = _leaves(child1, child1_dir, leaf_count)
    child = min(c0, c1)
    children = pcsp_dict.setdefault(parent, {})
    children[child] = children.get(child, 0) + count


def unrooted_pcsp_counter_of(topology_counter) -> Dict[Bitset, Dict[Bitset, int]]:
    pcsp_dict: Dict[Bitset, Dict[Bitset, int]] = {}
    for top, count in topology_counter.items():
        leaf_count = top.leaf_count
        assert len(top.children) == 3, (
            "unrooted PCSP counter expects a trifurcation at the root"
        )
        unrooted_pcsp_preorder(
            top,
            lambda s, sd, fo, fd, c0, c0d, c1, c1d, _vr: _add_to_pcsp_counter(
                pcsp_dict, count, leaf_count, s, sd, fo, fd, c0, c0d, c1, c1d
            ),
        )
    return pcsp_dict


def rooted_pcsp_counter_of(topology_counter) -> Dict[Bitset, Dict[Bitset, int]]:
    pcsp_dict: Dict[Bitset, Dict[Bitset, int]] = {}
    for top, count in topology_counter.items():
        leaf_count = top.leaf_count
        assert len(top.children) == 2, "rooted PCSP counter expects a bifurcating root"
        rooted_pcsp_preorder(
            top,
            lambda s, fo, c0, c1: _add_to_pcsp_counter(
                pcsp_dict, count, leaf_count, s, False, fo, False, c0, False, c1, False
            ),
        )
    return pcsp_dict


# -- indexer bundle ---------------------------------------------------------
def build_indexer_bundle(rootsplit_counter, pcsp_counter):
    """Indexer layout: rootsplits at [0, k), then PCSP blocks grouped by
    parent subsplit (sbn_maps.cpp BuildIndexerBundle). Insertion order of the
    Python dicts gives a deterministic layout."""
    rootsplits: List[Bitset] = []
    indexer: Dict[Bitset, int] = {}
    index_to_child: Dict[int, Bitset] = {}
    parent_to_range: Dict[Bitset, Tuple[int, int]] = {}
    index = 0
    for rootsplit in rootsplit_counter:
        indexer[rootsplit] = index
        rootsplits.append(rootsplit)
        index += 1
    for parent, child_counter in pcsp_counter.items():
        parent_to_range[parent] = (index, index + len(child_counter))
        for child in child_counter:
            indexer[parent + child] = index
            index_to_child[index] = Bitset.child_subsplit(parent, child)
            index += 1
    return rootsplits, indexer, index_to_child, parent_to_range, index


# -- indexer representations ------------------------------------------------
def split_indices_of(indexer, top: Topology) -> List[int]:
    """Index of the (minorized) split below every non-root node
    (sbn_maps.cpp SplitIndicesOf)."""
    out = [0] * top.id
    for node in top.preorder():
        if node is not top:
            out[node.id] = indexer[node.leaves.minorize()]
    return out


def rootsplit_of(top: Topology) -> Bitset:
    assert len(top.children) == 2
    return top.children[0].leaves.minorize()


def rooted_indexer_representation_of(
    indexer, top: Topology, default_index: int
) -> List[int]:
    leaf_count = top.leaf_count
    result = [indexer.get(rootsplit_of(top), default_index)]
    rooted_pcsp_preorder(
        top,
        lambda s, fo, c0, c1: result.append(
            indexer.get(
                pcsp_bitset_of(leaf_count, s, False, fo, False, c0, False, c1, False),
                default_index,
            )
        ),
    )
    return result


def unrooted_indexer_representation_of(
    indexer, top: Topology, default_index: int
) -> List[List[int]]:
    """One rooted representation per virtual rooting (per non-root node);
    see sbn_maps.cpp UnrootedSBNMaps::IndexerRepresentationOf."""
    leaf_count = top.leaf_count
    result = [[idx] for idx in split_indices_of(indexer, top)]

    def visit(sister, sister_dir, focal, focal_dir, child0, child0_dir,
              child1, child1_dir, virtual_root_clade):
        bitset = pcsp_bitset_of(
            leaf_count, sister, sister_dir, focal, focal_dir,
            child0, child0_dir, child1, child1_dir,
        )
        position = indexer.get(bitset, default_index)
        if sister is focal:
            # Bidirectional edge: rooting on this edge realizes the PCSP.
            result[focal.id].append(position)
        else:
            assert virtual_root_clade is not None
            # Every rooting inside the virtual root clade (except the sister
            # and focal clades themselves, and the root) realizes this PCSP.
            stack = [virtual_root_clade]
            while stack:
                node = stack.pop()
                if node is sister or node is focal:
                    continue
                if node is not top:
                    result[node.id].append(position)
                stack.extend(node.children)

    unrooted_pcsp_preorder(top, visit)
    return result


def string_indexer_representation_of(reversed_indexer, indexer_representation):
    """String forms for testing (sbn_maps.cpp StringIndexerRepresentationOf).
    Indices beyond the indexer map to "out_of_sample"."""

    def at(i):
        return (
            reversed_indexer[i] if i < len(reversed_indexer) else "out_of_sample"
        )

    if indexer_representation and isinstance(indexer_representation[0], list):
        return [set(at(i) for i in rooted) for rooted in indexer_representation]
    return set(at(i) for i in indexer_representation)
