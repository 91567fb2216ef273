"""The port's rooted engine against the benchmark's plain rooted reference
(portbench/reference/rooted.py: its own dates, bounds, heights, pruning and
Jacobian, every gradient by autograd in float64), and the heights layer's
sweep counter (ops/heights.py ``SWEEPS``).

On the CPU, at B = 4 seeded time trees of fluA's topology (ratios
U(0.1, 0.9), root height 0.5-3 years above the latest bound), on the
whole alignment and on a slice of its first 120 sites: LL, log-det-Jacobian,
the ratio and root-height gradient and the strict clock's gradient of the
hand route (K1's twin and the hand adjoint) and of the autograd route (K2
and K3's twins through the sweeps), float64 and float32. The nodes are
matched by their leaf sets (portbench/layout.py).

Tolerances: float64 at 1e-10 (LL, log-det-Jacobian and the clock gradient,
relative) and 1e-9 (the ratio gradient, relative to each tree's largest
entry): the same arithmetic in other orders, seen at 1e-15. Float32 at 2e-6
each: the pruning in float32 (unit roundoff 6e-8) over 68 combine steps
and 238 patterns' logs, seen at 3e-7 and below; the reference computed in
TF32 (the benchmark's control) is 8e-5 to 1.7e-3 off on these numbers,
so a route in that precision fails them.
"""

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.models import rooted_graph
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.models.phylo_model import PhyloModelSpec
from libsbn_tpu_torch.ops import heights, schedule
from portbench import layout
from portbench.reference import alignment, rooted

torch.set_num_threads(2)

CLOCK_RATE = 0.001
B = 4
TOL = {torch.float64: {"ll": 1e-10, "ldj": 1e-10, "ratio": 1e-9,
                       "clock": 1e-10},
       torch.float32: {"ll": 2e-6, "ldj": 2e-6, "ratio": 2e-6,
                       "clock": 2e-6}}


def _fasta(data_dir, tmp_path, sites):
    """fluA's alignment, or its first ``sites`` columns in a file of its
    own."""
    path = f"{data_dir}/fluA.fa"
    if sites is None:
        return path
    seqs = alignment.read_fasta(path)
    out = tmp_path / "fluA_slice.fa"
    out.write_text("".join(f">{k}\n{v[:sites]}\n" for k, v in seqs.items()))
    return str(out)


class Case:
    """The port's engine and the reference over one alignment, with B
    seeded time trees in both node orders."""

    def __init__(self, data_dir, fasta, dtype, seed=7):
        tops, bls, ttm = newick.parse_newick_file(f"{data_dir}/fluA.tree")
        coll = RootedTreeCollection(
            [RootedTree(t, b) for t, b in zip(tops, bls)], ttm)
        coll.parse_dates_from_taxon_names(True)
        tree = coll.trees[0]
        self.ref = rooted.read_time_tree(f"{data_dir}/fluA.tree")
        self.pats = alignment.patterns(fasta, self.ref.taxa)
        self.engine = LikelihoodEngine(
            SitePattern(Alignment.read_fasta(fasta), ttm),
            PhyloModelSpec("JC69", "constant", "strict"), dtype=dtype,
            device="cpu")
        self.sched = schedule.schedules_of_topologies([tree.topology] * B)
        L = self.sched.leaf_count
        taxon_of_leaf = layout.taxon_map(
            [ttm[(i, 1)] for i in range(len(ttm))], self.ref.taxa)
        mask = layout.node_masks(self.sched.post_children[0], L,
                                 taxon_of_leaf)
        ref_index = {m: j for j, m in enumerate(self.ref.masks)}
        self.order = np.array([ref_index[mask[L + j]] for j in range(L - 1)])
        rng = np.random.default_rng(seed)
        self.ref_ratios = rng.uniform(0.1, 0.9, (B, L - 1))
        self.ref_ratios[:, -1] = self.ref.bounds.max() + rng.uniform(
            0.5, 3.0, B)
        self.bounds = np.tile(tree.node_bounds, (B, 1))
        self.rates = np.full((B, self.sched.node_count - 1), CLOCK_RATE)
        self.params = {"clock": {"rate": torch.tensor(1.0,
                                                      dtype=torch.float64)}}

    def args(self):
        return (self.sched, self.bounds, self.ref_ratios[:, self.order],
                self.rates, self.params)

    def in_reference_order(self, ratio_gradient):
        g = np.zeros(ratio_gradient.shape)
        g[:, self.order] = ratio_gradient
        return g

    def reference(self):
        return rooted.evaluate(self.ref, self.pats, self.ref_ratios,
                               CLOCK_RATE)


def _rel(got, want, per_row_max=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if per_row_max:
        return (np.abs(got - want).max(1) / np.abs(want).max(1)).max()
    return (np.abs(got - want) / np.abs(want)).max()


@pytest.fixture(scope="module", params=[None, 120], ids=["whole", "slice"])
def sites(request):
    return request.param


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["hand", "autograd"])
def test_rooted_routes_match_the_reference(data_dir, tmp_path, sites, dtype,
                                           route):
    case = Case(data_dir, _fasta(data_dir, tmp_path, sites), dtype)
    ref = case.reference()
    eng = case.engine
    fn = {"hand": eng._rooted_phylo_gradients_hand,
          "autograd": eng._rooted_phylo_gradients_autograd}[route]
    got = fn(*case.args(), True)
    lls, ldjs = eng.rooted_log_likelihoods(*case.args(), return_parts=True)
    tol = TOL[dtype]
    assert got["ratios_root_height"].dtype == dtype
    assert _rel(got["log_likelihood"], ref["ll"]) < tol["ll"]
    assert _rel(lls, ref["ll"]) < tol["ll"]
    assert _rel(ldjs, ref["ldj"]) < tol["ldj"]
    assert _rel(case.in_reference_order(got["ratios_root_height"]),
                ref["ratio"], per_row_max=True) < tol["ratio"]
    assert _rel(got["clock_model"][:, 0], ref["clock"]) < tol["clock"]
    assert len(set(np.round(ref["ll"], 6))) == B  # four distinct trees


def test_public_entry_takes_the_hand_route(data_dir):
    """rooted_phylo_gradients on a CPU engine (no graphs) is the hand
    route: one K1 twin call, and the same dict as _rooted_phylo_gradients_
    hand."""
    from libsbn_tpu_torch.ops import pruning_jc

    case = Case(data_dir, f"{data_dir}/fluA.fa", torch.float32)
    pruning_jc.reset_counters()
    got = case.engine.rooted_phylo_gradients(*case.args())
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 1, "ll_jc69": 0,
                                     "ll_dea_jc69": 0}
    want = case.engine._rooted_phylo_gradients_hand(*case.args(), True)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _sweeps_of(fn):
    heights.reset_counters()
    fn()
    return dict(heights.SWEEPS)


def test_sweep_counter_counts_one_set_a_call(data_dir):
    """fluA's deepest internal node is 32 levels down: the hand route
    builds 32 forward sweeps and 32 adjoint ones a call, eagerly and by
    RootedGraphs on the CPU (its first call eager, its second the plain
    call a card would capture, its third the one a card would replay);
    the autograd route and the LLs build the forward sweeps alone; under
    heights_method "squaring" a call builds ceil(log2 32) = 5 squarings
    each way."""
    case = Case(data_dir, f"{data_dir}/fluA.fa", torch.float32)
    eng = case.engine
    assert eng._height_iters(case.sched) == 32
    one_set = {"forward": 32, "adjoint": 32}
    assert _sweeps_of(lambda: eng.rooted_phylo_gradients(
        *case.args())) == one_set
    graphs = rooted_graph.RootedGraphs(eng)
    for n in range(3):
        assert _sweeps_of(lambda: graphs.phylo_gradients(
            *case.args(), True)) == one_set
        assert len(graphs.programs) == (1 if n else 0)
    assert _sweeps_of(lambda: eng._rooted_phylo_gradients_autograd(
        *case.args(), True)) == {"forward": 32, "adjoint": 0}
    assert _sweeps_of(lambda: eng.rooted_log_likelihoods(
        *case.args())) == {"forward": 32, "adjoint": 0}
    eng.heights_method = "squaring"
    assert _sweeps_of(lambda: eng.rooted_phylo_gradients(
        *case.args())) == {"forward": 5, "adjoint": 5}
    assert rooted_graph.COUNTS["replays"] == 0  # no card, no replay
