"""Tree-count combinatorics (the reference's src/combinatorics.cpp; a copy
of libsbn_tpu.utils.combinatorics)."""

from __future__ import annotations

import math


def topology_count(taxon_count: int) -> float:
    """(2n-3)!! — the number of unrooted topologies on n taxa."""
    result = 1.0
    for i in range(2, taxon_count + 1):
        result *= 2.0 * i - 3.0
    return result


def log_tree_count(taxon_count: int) -> float:
    result = 0.0
    for i in range(2, taxon_count + 1):
        result += math.log(2.0 * i - 3.0)
    return result


def log_child_subsplit_count_ratio(
    child0_taxon_count: int, child1_taxon_count: int
) -> float:
    """log[ T(n0) T(n1) / T(n0+n1) ]: uniform-over-topologies prior for a
    child subsplit with (n0, n1) taxa."""
    total = child0_taxon_count + child1_taxon_count
    total_without_child1 = 0.0
    for i in range(child1_taxon_count + 1, total + 1):
        total_without_child1 += math.log(2.0 * i - 3.0)
    return log_tree_count(child0_taxon_count) - total_without_child1
