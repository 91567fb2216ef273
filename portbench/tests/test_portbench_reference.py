"""The plain reference against published goldens and against the port's
CPU route at a cut batch (only a test may import both), and work.py
against a hand count."""

import numpy as np
import pytest
import torch

from portbench import harness, work
from portbench.reference import alignment, likelihood, sbn, trees

DATA = "data/"


def test_hello_golden():
    t = trees.read_newick(harness.path(DATA + "hello.nwk"))
    pats = alignment.patterns(harness.path(DATA + "hello.fasta"), t[0].taxa)
    out = likelihood.evaluate(t, [0], [t[0].lengths], pats,
                              likelihood.Model("JC69", "constant"))
    assert out["ll"][0] == pytest.approx(-84.852358, abs=1e-6)


def test_ds1_golden():
    t = trees.read_nexus(harness.path(DATA + "DS1.subsampled_10.t"))
    pats = alignment.patterns(harness.path(DATA + "DS1.fasta"), t[0].taxa)
    assert pats.site_count == 1949 and len(pats.weights) == 934
    out = likelihood.evaluate(t[:1], [0], [t[0].lengths], pats,
                              likelihood.Model("JC69", "constant"))
    assert out["ll"][0] == pytest.approx(-14582.9953, abs=1e-3)


def test_gradients_against_differences():
    """The reference's GTR + Weibull gradients against central
    differences of its own log-likelihood."""
    t = trees.read_newick(harness.path(DATA + "hello.nwk"))
    pats = alignment.patterns(harness.path(DATA + "hello.fasta"), t[0].taxa)
    m = likelihood.Model("GTR", "weibull", 4, [0.1, 0.2, 0.15, 0.25, 0.2,
                                               0.1], [0.3, 0.25, 0.2, 0.25],
                         0.5)
    bl = np.array([t[0].lengths])
    out = likelihood.evaluate(t, [0], bl, pats, m, want_model=True)
    h = 1e-6
    for e in range(bl.shape[1]):
        up, dn = bl.copy(), bl.copy()
        up[0, e] += h
        dn[0, e] -= h
        fd = (likelihood.evaluate(t, [0], up, pats, m)["ll"]
              - likelihood.evaluate(t, [0], dn, pats, m)["ll"]) / (2 * h)
        assert out["bgrad"][0, e] == pytest.approx(fd[0], rel=1e-5)
    shape = lambda s: likelihood.evaluate(  # noqa: E731
        t, [0], bl, pats, likelihood.Model(m.substitution, m.site, 4,
                                           m.gtr_rates, m.frequencies, s)
    )["ll"][0]
    fd = (shape(0.5 + h) - shape(0.5 - h)) / (2 * h)
    assert out["shape"][0] == pytest.approx(fd, rel=1e-5)


@pytest.mark.parametrize("cell", ["ds1_jc69.bgrad_b2048",
                                  "ds1_100_gtr_w4.phylo_b256",
                                  "ds1_100_gtr_w4.bgrad_b256",
                                  "ds1_jc69.vbpi_p10"])
def test_port_cpu_route_is_correct(cell):
    """A whole run on the CPU at a cut batch: the port's CPU route (the
    kernels' plain twins) within every limit."""
    torch.set_num_threads(2)
    res, _ = harness.run_cell(cell, 2**31 + 12345, 0.2, False, 0.0,
                              device="cpu", overrides=_small(cell))
    assert res["correct"], res["checks"]


def _small(cell):
    if "vbpi" in cell:
        return {"window_steps": 4}
    return {"batch": 12, "check_calls": 2}


def test_sbn_against_port():
    """The reference's network against the port's: the same support, the
    same simple-average start and the same probabilities of the sample."""
    import libsbn_tpu_torch as lt

    from portbench import layout

    path = harness.path(DATA + "DS1.subsampled_10.t")
    inst = lt.UnrootedInstance("t")
    inst.read_nexus_file(path)
    inst.process_loaded_trees()
    inst.train_simple_average()
    T = trees.read_nexus(path)
    S = sbn.Support(T)
    keys = layout.sbn_keys(inst.sbn_support,
                           layout.taxon_map(inst.taxon_names(), T[0].taxa))
    order = [S.index[k] for k in keys]
    assert sorted(order) == list(range(len(S.keys)))
    np.testing.assert_array_equal(np.asarray(inst.sbn_parameters),
                                  S.simple_average()[order])
    nl = sbn.normalized_log(torch.tensor(S.simple_average()), S.segment,
                            S.segments)
    reps = torch.tensor(np.stack([S.representation(t) for t in T]))
    np.testing.assert_allclose(np.exp(sbn.log_q(nl, reps).numpy()),
                               inst.calculate_sbn_probabilities(), rtol=1e-12)


def test_work_hand_count_on_hello():
    """hello: 3 taxa, so E = 3 edges, I = 1 internal node (the root, 3
    children), K = 1, JC69's apply 15 operations."""
    s = work.Shape("JC69", B=1, L=3, K=1, P=1)
    # forward: 3 applies (45), 2 child products of 4 (8), the root's
    # rescale (8 + 2), its frequencies (7), mix (1), log, log-scale add and
    # weighted sum (4)
    assert work.forward(s) == 45 + 8 + 10 + 7 + 1 + 4
    # upper: no non-root internal node; 3 products of 4
    assert work.upper(s) == 12
    # each edge: the rate-matrix apply (15), dot (7), mix (1), divide and
    # weighted sum (3)
    assert work.edge_derivatives(s) == 3 * 26
    assert work.ops(s, "ll_bgrad") == 75 + 12 + 78 + 3 * 6
    # bytes, f32: tips 3 x 4 + weight, the child table (1 x 3 int32), 3
    # lengths; out 1 LL and 3 gradients
    assert work.bytes_moved(s, "ll_bgrad") == (12 + 1) * 4 + 12 + 12 + 4 + 12
