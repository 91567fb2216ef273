"""The GP ascent's phase structure (gp/ascent_graph.py), run on the CPU.

On a card ``run_branch_ascent`` replays captured graphs of the ascent's
phases (start, propose, damp, accept) over static buffers, the host reading
one flag buffer after each populate. On the CPU the same phases run as
plain calls over the same buffers (``_run_branch_ascent_graphed``), so:

* against libsbn_tpu's one-program ascent (``_ascent_impl``, jitted on the
  CPU) on five_taxon and fluA, f64, the level route: the marginal within
  1e-9, the same sweep count and the same ``last_ascent_converged``, for a
  converged fit, an rtol > 0 stop and (five_taxon) a fit capped at one
  sweep;
* against the port's eager host loop on both routes (the level route and
  the K7/K8 twins): marginal, branch lengths, sweeps, the converged flag
  and the PLVs bit for bit;
* ``_newton_sweep`` run for all NEWTON_ITERS (as a graph must) against the
  early-exit version, bit for bit;
* the quartet hybrid marginals' program over static buffers
  (gp/hybrid_graph.py, as a card runs it from an engine's second call):
  against libsbn_tpu in chunks smaller than the combinations (the last
  padded with rows of zeros) and in one, at atol 1e-12, and against the
  eager program bit for bit on both routes, reading each call's PLVs.
"""

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.gp import ascent_graph, engine_kernels

from test_torch_gp import COMPOSITE, FLUA, make_pair, make_port, random_lengths

torch.set_num_threads(2)

FIVE = COMPOSITE[1]  # five_taxon.fasta, five_taxon_rooted.nwk
# (tol, max_iter, rtol) per data set: a converged fit, an rtol stop (five
# sweeps of six on five_taxon, ten of twelve on fluA), a fit capped at one
# sweep.
CASES = {
    "five_taxon": (FIVE, [(1e-6, 100, 0.0), (1e-6, 100, 1e-3),
                          (1e-12, 1, 0.0)]),
    "fluA": (FLUA, [(1e-6, 100, 0.0), (1e-6, 100, 1e-7)]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_fits(request, data_dir):
    """(name, port engine, starting lengths, [(case, libsbn_tpu's marginal,
    sweeps, converged)]) from one jitted libsbn_tpu engine per data set."""
    files, cases = CASES[request.param]
    jinst, inst = make_pair(data_dir, *files)
    jeng, eng = jinst.get_engine(), inst.get_engine()
    bl0 = np.array(eng.branch_lengths)
    fits = []
    for case in cases:
        jeng.branch_lengths = bl0.copy()
        m, sweeps = jeng.run_branch_ascent(case[0], case[1], rtol=case[2])
        fits.append((case, m, int(sweeps), jeng.last_ascent_converged))
    return request.param, eng, bl0, fits


def test_phase_ascent_matches_jax(jax_fits):
    name, eng, bl0, fits = jax_fits
    for (tol, max_iter, rtol), want, sweeps, converged in fits:
        eng.branch_lengths = bl0.copy()
        m, got_sweeps = eng._run_branch_ascent_graphed(tol, max_iter, rtol)
        assert abs(m - want) < 1e-9, (name, tol, max_iter, rtol, m, want)
        assert got_sweeps == sweeps, (name, rtol, got_sweeps, sweeps)
        assert eng.last_ascent_converged == converged
        assert eng.get_log_marginal_likelihood() == pytest.approx(m, abs=1e-9)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["level", "kernel_twins"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_phase_ascent_equals_eager_loop(data_dir, name, use_kernels):
    """The phases against GPEngine's eager host loop on the same engine,
    bit for bit, from random starting lengths."""
    files, cases = CASES[name]
    eng = make_port(data_dir, *files, use_kernels=use_kernels).get_engine()
    bl0 = random_lengths(eng.branch_lengths.size, seed=4)
    for tol, max_iter, rtol in cases[:2]:
        out = []
        for run in (eng._run_branch_ascent_graphed, eng.run_branch_ascent):
            eng.branch_lengths = bl0.copy()
            m, sweeps = run(tol, max_iter, rtol)
            out.append((m, sweeps, eng.last_ascent_converged,
                        eng.branch_lengths.copy(), eng.plvs))
        (m1, s1, c1, b1, p1), (m2, s2, c2, b2, p2) = out
        assert (m1, s1, c1) == (m2, s2, c2)
        np.testing.assert_array_equal(b1, b2)
        for k in engine_kernels.PLV_KEYS:
            assert torch.equal(p1[k], p2[k]), k


def test_phase_ascent_counts_its_populates(data_dir, monkeypatch):
    """On the kernel twins, one K7 twin call per populate: start, one per
    sweep's proposal and one per damping step; K8's twin once a sweep."""
    eng = make_port(data_dir, *FIVE, use_kernels=True).get_engine()
    engine_kernels.reset_counters()
    damps = []
    real = ascent_graph.AscentGraphs._damp
    monkeypatch.setattr(ascent_graph.AscentGraphs, "_damp",
                        lambda self: damps.append(1) or real(self))
    _, sweeps = eng._run_branch_ascent_graphed(1e-6, 100, 0.0)
    assert engine_kernels.TWIN_CALLS == {
        "populate_plvs": 1 + sweeps + len(damps), "golden_sweep": sweeps}


@pytest.mark.parametrize("name", sorted(CASES))
def test_newton_sweep_all_iterations_equal_early_exit(data_dir, name):
    """_newton_sweep with early_exit=False (all NEWTON_ITERS, no host read)
    equals the early-exit sweep bit for bit: lanes that stopped keep their
    u. From the PLVs at random lengths and at the default ones."""
    files, _ = CASES[name]
    eng = make_port(data_dir, *files).get_engine()
    for seed in (None, 1, 2):
        if seed is not None:
            eng.branch_lengths = random_lengths(eng.branch_lengths.size, seed)
        eng.populate_plvs()
        bl = eng._tensor(eng.branch_lengths)
        a = eng._sweep(eng.plvs, bl)
        b = eng._sweep(eng.plvs, bl, early_exit=False)
        assert torch.equal(a, b)
        assert not torch.equal(a, bl)


def test_cuda_graphs_switch_is_ignored_on_cpu(data_dir):
    """On the CPU run_branch_ascent stays the eager loop: no phase graphs
    are made."""
    eng = make_port(data_dir, *FIVE).get_engine()
    eng.run_branch_ascent(1e-6, 5)
    assert eng.graphs is None and eng.cuda_graphs


# -- the quartet hybrid marginals' program (gp/hybrid_graph.py) -------------
# tests/test_gp_hybrid.py's two DAGs and their length seeds; 9 and 13
# quartet rows.
HYBRID = {"simplest": 7, "second_simplest": 11}


def hybrid_pair(data_dir, which, **kw):
    """(libsbn_tpu instance, port instance) on a hybrid DAG at the seeded
    lengths, PLVs populated; ``kw`` goes to the port's make_engine."""
    files = ("7-taxon-slice-of-ds1.fasta",
             f"{which.replace('_', '-')}-hybrid-marginal.nwk")
    jinst, inst = make_pair(data_dir, *files, **kw)
    bl = np.random.default_rng(HYBRID[which]).uniform(
        1e-6, 0.1, inst.dag.gpcsp_count_with_fake())
    for i in (jinst, inst):
        i.get_engine().branch_lengths = bl.copy()
        i.populate_plvs()
    return jinst, inst


def hybrid_requests(inst, quartet_hybrid_request_of):
    return [quartet_hybrid_request_of(inst.dag, p, r, c)
            for p, r, c, _ in inst.dag.reverse_postorder_index_traversal()]


def hybrid_values(eng, reqs, chunk, graphed):
    eng.hybrid_marginal_log_likelihoods[:] = -np.inf
    eng._process_hybrid(reqs, chunk, graphed=graphed)
    return eng.hybrid_marginal_log_likelihoods.copy()


@pytest.mark.parametrize("chunk", [2, 4, 4096])
@pytest.mark.parametrize("which", sorted(HYBRID))
def test_padded_hybrid_program_matches_jax(data_dir, which, chunk):
    """Chunks of 2 and 4 rows (fewer than the 9 and 13 combinations: the
    last chunk padded with rows of zeros, as libsbn_tpu pads it) and of
    4,096 (one unpadded chunk): the program over static buffers, called
    three times (its first call eager, then the program made and reused),
    against libsbn_tpu's process_quartet_hybrid_requests with the same
    chunk at atol 1e-12, and each call equal to the eager route bit for
    bit. On the CPU a Graph is a plain call: only the first call counts as
    eager."""
    from libsbn_tpu.gp.quartet import quartet_hybrid_request_of as jq
    from libsbn_tpu_torch.gp import hybrid_graph
    from libsbn_tpu_torch.gp.quartet import quartet_hybrid_request_of as tq

    jinst, inst = hybrid_pair(data_dir, which)
    jeng, eng = jinst.get_engine(), inst.get_engine()
    jeng.process_quartet_hybrid_requests(hybrid_requests(jinst, jq),
                                         chunk=chunk)
    want = np.asarray(jeng.hybrid_marginal_log_likelihoods)
    fin = np.isfinite(want)
    assert fin.any()
    reqs = hybrid_requests(inst, tq)
    eager = hybrid_values(eng, reqs, chunk, graphed=False)
    hybrid_graph.reset_counters()
    for _ in range(3):
        got = hybrid_values(eng, reqs, chunk, graphed=True)
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-12)
    assert hybrid_graph.COUNTS == {"captures": 0, "replays": 0, "eager": 1}
    graphs = eng.hybrid_graphs
    assert len(graphs.programs) == 1 and not graphs.programs.seen
    assert graphs.held_mb() > 0


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["level", "kernel_twins"])
def test_hybrid_program_reads_each_calls_plvs(data_dir, use_kernels):
    """populate_plvs replaces the engine's PLV tensors: once the program is
    made, a call at new branch lengths (new PLVs, new parameters) equals the
    eager route at those lengths bit for bit, on both routes."""
    from libsbn_tpu_torch.gp.quartet import quartet_hybrid_request_of as tq

    _, inst = hybrid_pair(data_dir, "second_simplest",
                          use_kernels=use_kernels)
    eng = inst.get_engine()
    reqs = hybrid_requests(inst, tq)
    for _ in range(2):
        hybrid_values(eng, reqs, 4, graphed=True)
    eng.branch_lengths = random_lengths(eng.branch_lengths.size, seed=9)
    eng.q = eng.q * 0.9
    inst.populate_plvs()
    got = hybrid_values(eng, reqs, 4, graphed=True)
    want = hybrid_values(eng, reqs, 4, graphed=False)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum() == 10


def test_hybrid_marginals_stay_eager_on_cpu(data_dir):
    """GPInstance.calculate_hybrid_marginals on the CPU runs the eager
    program: no hybrid graphs are made."""
    inst = make_port(data_dir, "7-taxon-slice-of-ds1.fasta",
                     "simplest-hybrid-marginal.nwk")
    inst.calculate_hybrid_marginals()
    eng = inst.get_engine()
    assert eng.hybrid_graphs is None
    assert np.isfinite(eng.hybrid_marginal_log_likelihoods).sum() == 6
