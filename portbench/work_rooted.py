"""The work of a call on rooted trees, for work.py's counts.

work.py counts a batch by its tree's edges E and internal nodes I, taking
the trees unrooted with a trifurcating root (E = 2L - 3, I = L - 2). A
rooted binary tree of L taxa has E = 2L - 2 edges and I = L - 1 internal
nodes, the root's two children each with an edge; every internal node has
two children, so E - I = L - 1 extra child products, as work.forward
counts them. With these two numbers work.py's counts read rooted trees
unchanged: the pruning's forward and upper passes, each edge's derivative,
the transition matrices.

Left out: the heights' work, O(N) a tree (the ratios to heights, the
branch lengths times the clock rate, the adjoint of the heights and the
log-det-Jacobian), next to the pruning's O(N P) a tree.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench import work


@dataclass(frozen=True)
class RootedShape(work.Shape):
    """A batch of B rooted trees of L taxa over P site patterns, K
    categories."""

    @property
    def E(self) -> int:
        return 2 * self.L - 2

    @property
    def I(self) -> int:  # noqa: E743
        return self.L - 1
