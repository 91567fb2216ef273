"""The work a call requires, counted from its shapes, and the card's peaks.

Frozen with the benchmark: the counts follow the algorithm (Felsenstein's
pruning, the two-pass edge derivatives, the sums of d LL / d P and the
adjoint of the matrix exponential), never the source of a kernel, so they
read the same work whatever implements it. Each unit of work is counted
once, however often an implementation recomputes it; each input is read
once and each output written once.

Counts are operations (an add, multiply, divide, compare, exp or log each
one) for one tree and one site pattern, unless named per tree. A tree of
L taxa, unrooted with a trifurcating root, has E = 2L - 3 edges and
I = L - 2 internal nodes; its internal nodes have E - I more children than
one each. K is the number of rate categories.
"""

from __future__ import annotations

from dataclasses import dataclass

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
ITEM = {"float32": 4, "float64": 8}

# A transition or rate matrix applied to a 4-vector. GTR: a 4x4 matrix
# times a vector, 16 multiplies and 12 adds. JC69's matrices are
# a I + b 11^T: the vector's sum (3), then a product and a multiply-add a
# state (12).
APPLY = {"GTR": 28, "JC69": 15}
# A transition matrix from its branch length, per tree, edge and category:
# JC69 two exponentials' worth (one exp, the scale, two combinations);
# GTR V diag(exp(lambda t)) V^-1 (4 exps and scales, then 4x4x4 products).
MATRIX = {"JC69": 6, "GTR": 8 + 64 + 112}


@dataclass(frozen=True)
class Shape:
    """A batch: B trees of L taxa over P site patterns, K categories."""

    model: str  # "JC69" or "GTR"
    B: int
    L: int
    K: int
    P: int
    dtype: str = "float32"

    @property
    def E(self) -> int:
        return 2 * self.L - 3

    @property
    def I(self) -> int:  # noqa: E743
        return self.L - 2


def forward(s: Shape) -> int:
    """Per tree and pattern: every edge's matrix applied to its child's
    partial; the children multiplied together; each internal node's
    partial rescaled (a max over 4K, a reciprocal, 4K multiplies, a log
    and an add: 8K + 2); at the root the frequencies' dot product (7K),
    the categories' mix (2K - 1), a log, the log-scales' add and the
    weighted sum (4)."""
    K = s.K
    return (s.E * K * APPLY[s.model] + (s.E - s.I) * 4 * K
            + s.I * (8 * K + 2) + 9 * K + 3)


def upper(s: Shape) -> int:
    """Per tree and pattern: the preorder pass. Each non-root internal
    node's message from above, carried down its edge (an apply) and
    rescaled (8K + 2); each non-root node's upper partial as the product
    of its two other neighbours' (4K)."""
    K = s.K
    return ((s.I - 1) * (K * APPLY[s.model] + 8 * K + 2)
            + s.E * 4 * K)


def edge_derivatives(s: Shape) -> int:
    """Per tree and pattern: each edge's d P / d t applied to the child's
    evolved partial (the rate matrix, an apply), its dot product with the
    upper partial (7K), the categories' mix (2K - 1), the division by the
    site likelihood and the weighted sum (3)."""
    K = s.K
    return s.E * (K * APPLY[s.model] + 9 * K + 2)


def dp_sums(s: Shape) -> int:
    """Per tree and pattern: d LL / d P for every edge and category, the
    outer product of the upper and the child's partial scaled by weight
    over site likelihood and summed over patterns (16 + 4 + 16), the
    weight over site likelihood (2), and d LL / d frequencies and
    proportions at the root (10K)."""
    K = s.K
    return s.E * K * 36 + 2 + 10 * K


def matrices(s: Shape) -> int:
    """Per tree: every edge's and category's transition matrix."""
    return s.E * s.K * MATRIX[s.model]


def model_contractions(s: Shape) -> int:
    """Per tree: the adjoint of each matrix exponential (V^T G V^-T, two
    4x4 products, 224; the divided differences' product and sum, 32) and,
    per tree, d LL / d Q carried back to the rate matrix (224) and to the
    stick-breaking coordinates and the Weibull shape (800)."""
    return s.E * s.K * 256 + 224 + 800


def ops(s: Shape, job: str) -> int:
    """Operations a job requires over the whole batch.

    "ll": log-likelihoods; "ll_bgrad": log-likelihoods and branch-length
    gradients; "dp": d LL / d P for every edge and category (what the
    model gradients' backward kernel computes); "phylo": log-likelihoods,
    branch-length and model-parameter gradients."""
    per_pattern = {
        "ll": forward(s),
        "ll_bgrad": forward(s) + upper(s) + edge_derivatives(s),
        "dp": forward(s) + upper(s) + dp_sums(s),
        "phylo": forward(s) + upper(s) + edge_derivatives(s) + dp_sums(s),
    }[job]
    per_tree = matrices(s) + (model_contractions(s) if job == "phylo" else 0)
    return s.B * (s.P * per_pattern + per_tree)


def bytes_moved(s: Shape, job: str) -> int:
    """Bytes a job must move: the tip partials (L x 4 x P), the weights,
    each tree's child table (I x 3 int32) and branch lengths read once;
    the log-likelihoods and the job's gradients written once."""
    item = ITEM[s.dtype]
    read = (s.L * 4 * s.P + s.P) * item + s.B * (s.I * 3 * 4 + s.E * item)
    written = s.B * item
    if job in ("ll_bgrad", "phylo"):
        written += s.B * s.E * item
    if job == "dp":
        written += s.B * s.E * s.K * 16 * item
    if job == "phylo":
        written += s.B * 9 * 8  # 8 stick-breaking coordinates, 1 shape
    return read + written


def least_seconds(s: Shape, job: str) -> float:
    """The least time the card could take: the larger of the job's
    operations at the peak of its type and its bytes at the HBM rate."""
    return max(ops(s, job) / PEAK_FLOPS[s.dtype],
               bytes_moved(s, job) / HBM_BYTES_PER_S)
