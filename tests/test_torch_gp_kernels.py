"""The GP kernel route (use_kernels=True) against libsbn_tpu's Pallas route.

On the CPU the kernel route runs the plain PyTorch twins of K7 and K8
(gp/engine_kernels.py); the JAX package's kernels run in interpret mode, as
tests/test_gp_pallas.py runs them. Same numpy inputs on both sides:

* the K7 twin against ``populate_plvs_pallas`` on all 12 arrays: f64 rtol
  1e-12 (log-scales also atol 1e-12); f32 rtol 1e-5 with atol 1e-6 on
  PLVs and 1e-4 on log-scales;
* the K8 twin against ``optimize_sweep_pallas``, both fed the JAX
  package's PLVs (``plvs_from_numpy``): the objective at the two outputs
  within 1e-12 (f64) or 1e-5 (f32) of |f| + sum(w), and in f64 the log
  branch lengths within 1e-6 wherever the objective is not flat;
* GPInstance through the twins: the hello and gradient goldens, the
  composite marginals against the JAX engine at the same lengths (1e-9)
  and against enumeration (1e-6), the fluA rescaling marginal, hybrids and
  SBN estimation against the JAX engine, and the two routes against each
  other on scale-invariant quantities;
* the fluA fit run_branch_ascent(1e-6, 100) on both routes: f64 at
  -4337.885058592 within 1e-7 in 12 sweeps, f32 within 1e-2 of that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libsbn_tpu.gp.engine_pallas import (
    optimize_sweep_pallas, populate_plvs_pallas,
)
from libsbn_tpu_torch.gp import engine_kernels
from libsbn_tpu_torch.gp.engine import _jc69_transition

from test_torch_gp import (
    COMPOSITE, FIVE_MORE, FLUA, HELLO, HELLO_BL, assert_plvs_close,
    check_composite_against_jax, fit_and_score, make_pair, make_port,
    random_lengths,
)

torch.set_num_threads(1)

KERNEL_SETS = [HELLO, FIVE_MORE, FLUA]
KERNEL_IDS = ["hello", "five_taxon_more", "fluA"]
DTYPES = [torch.float64, torch.float32]
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}
# run_branch_ascent(1e-6, 100) on fluA, f64: the JAX package's Pallas route
# in interpret mode gives -4337.885058592593 and its level route
# -4337.885058592374, both in 12 sweeps.
FLUA_F64 = -4337.885058592
FLUA_SWEEPS = 12


def jax_pair(data_dir, files, dtype):
    """(JAX engine, port engine on the kernel route), both in ``dtype``."""
    jinst, inst = make_pair(data_dir, *files, use_kernels=True, dtype=dtype)
    jinst.make_engine(dtype=NP_DTYPE[dtype])
    return jinst.get_engine(), inst.get_engine()


def twin_populate(eng, bl, q):
    """The K7 twin on the port engine's streams for numpy bl and q."""
    blt, qt = eng._tensor(bl), eng._tensor(q)
    return engine_kernels.populate_plvs_twin(
        eng._edge_streams(), qt, _jc69_transition(blt).contiguous(), eng._tips)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("files", KERNEL_SETS, ids=KERNEL_IDS)
def test_populate_twin_matches_pallas(data_dir, files, dtype):
    """The K7 twin against libsbn_tpu's K7 in interpret mode on all 12
    arrays, at random branch lengths and the uniform prior."""
    jeng, eng = jax_pair(data_dir, files, dtype)
    bl = random_lengths(eng.branch_lengths.size, seed=2)
    want = populate_plvs_pallas(jeng, jnp.asarray(bl, NP_DTYPE[dtype]),
                                jnp.asarray(jeng.q, NP_DTYPE[dtype]),
                                interpret=True)
    engine_kernels.reset_counters()
    got = twin_populate(eng, bl, eng.q)
    assert engine_kernels.TWIN_CALLS["populate_plvs"] == 1
    assert got["ls_p"].shape == (eng.dag.node_count(), eng.patterns)
    if dtype == torch.float64:
        assert_plvs_close(got, want, rtol=1e-12, atol=1e-300, ls_atol=1e-12)
    else:
        assert_plvs_close(got, want, rtol=1e-5, atol=1e-6, ls_atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("files", KERNEL_SETS, ids=KERNEL_IDS)
def test_golden_sweep_twin_matches_pallas(data_dir, files, dtype):
    """The kernel route's sweep (sweep_stats + the K8 twin + the scatter
    into the GPCSP order) against libsbn_tpu's optimize_sweep_pallas in
    interpret mode, both fed the JAX package's K7 output: the objective at
    the two outputs within 1e-12 (f64) or 1e-5 (f32) of |f| + sum(w), and
    in f64 the log branch lengths within 1e-6 where the objective is not
    flat (engine_kernels.sweep_disagreement: a golden section resolves the
    minimiser only to about sqrt(eps), so summation order alone moves it
    by that much). Observed: 3.6e-16 and 1.1e-7."""
    jeng, eng = jax_pair(data_dir, files, dtype)
    npdt = NP_DTYPE[dtype]
    bl = random_lengths(eng.branch_lengths.size, seed=3)
    jplvs = populate_plvs_pallas(jeng, jnp.asarray(bl, npdt),
                                 jnp.asarray(jeng.q, npdt), interpret=True)
    want = np.array(optimize_sweep_pallas(jeng, jplvs, jnp.asarray(bl, npdt),
                                            interpret=True))
    plvs = engine_kernels.plvs_from_numpy(
        {k: np.asarray(v) for k, v in jplvs.items()}, "cpu", dtype)
    A, B = engine_kernels.sweep_stats(plvs, eng._pa, eng._ch, eng._rot)
    engine_kernels.reset_counters()
    got = eng._golden_sweep(A, B, eng._w, eng._tensor(bl))
    assert engine_kernels.TWIN_CALLS["golden_sweep"] == 1
    assert not np.array_equal(got.numpy(), bl.astype(npdt))
    g = eng._g
    obj_gap, lb_gap, _ = engine_kernels.sweep_disagreement(
        A, B, eng._w, torch.log(got[g]), torch.log(torch.as_tensor(want)[g]))
    if dtype == torch.float64:
        assert obj_gap <= 1e-12 and lb_gap <= 1e-6, (obj_gap, lb_gap)
    else:
        assert obj_gap <= 1e-5, obj_gap


def test_golden_sweep_keeps_a_worse_step_out(data_dir):
    """K8's twin rejects a search result that makes the objective worse:
    started at each edge's own optimum, no edge's objective rises."""
    eng = make_port(data_dir, *FIVE_MORE, use_kernels=True).get_engine()
    eng.populate_plvs()
    A, B = engine_kernels.sweep_stats(eng.plvs, eng._pa, eng._ch, eng._rot)
    cur = torch.log(eng._tensor(eng.branch_lengths)[eng._g])
    once = engine_kernels.golden_sweep(A, B, eng._w, cur)
    twice = engine_kernels.golden_sweep(A, B, eng._w, once)
    f1 = engine_kernels.objective(A, B, eng._w, once)
    f2 = engine_kernels.objective(A, B, eng._w, twice)
    assert (f2 <= f1).all()
    assert ((once >= engine_kernels.MIN_LOG_BL - 1e-12)
            & (once <= engine_kernels.MAX_LOG_BL + 1e-12)).all()


# -- GPInstance through the twins ---------------------------------------------


def test_hello_goldens_on_the_kernel_route(data_dir):
    """The hello marginal golden -84.77961943 and the gradient golden
    -4.806671945 / -0.6109379521 (tests/test_gp.py), within 1e-6, through
    K7's twin; no level-route populate runs."""
    inst = make_port(data_dir, *HELLO, use_kernels=True)
    eng = inst.get_engine()
    eng.branch_lengths = HELLO_BL.copy()
    engine_kernels.reset_counters()
    inst.populate_plvs()
    inst.compute_likelihoods()
    assert engine_kernels.TWIN_CALLS["populate_plvs"] == 1
    np.testing.assert_allclose(eng.get_per_gpcsp_log_likelihoods(),
                               -84.77961943, atol=1e-6)
    assert abs(eng.get_log_marginal_likelihood() - -84.77961943) < 1e-6

    inst = make_port(data_dir, "hello_single_nucleotide.fasta",
                     "hello_rooted.nwk", use_kernels=True)
    inst.get_engine().branch_lengths = HELLO_BL.copy()
    inst.populate_plvs()
    ll, dll = inst.get_engine().log_likelihood_and_derivative(
        inst.dag.node_count() - 1, 0)
    assert abs(ll - -4.806671945) < 1e-6
    assert abs(dll - -0.6109379521) < 1e-6


@pytest.mark.parametrize("files", COMPOSITE,
                         ids=["two_trees", "five_taxon", "ds1_reduced_5",
                              "seven_taxon"])
def test_composite_marginal_on_the_kernel_route(data_dir, files):
    """TestCompositeMarginal through the twins (golden-section sweeps):
    after the fit, the marginal and per-GPCSP components against the JAX
    engine's at the same branch lengths within 1e-9, and against the exact
    marginal by enumerating every tree the DAG spans within 1e-6 (1e-5 per
    GPCSP), the reference's gate (gp_doctest.cpp:180-196). The fit itself
    ends within 1e-4 (its tolerance) of the JAX Pallas route's fit: the two
    golden sections take their own paths (see assert_sweeps_agree)."""
    jinst, inst = make_pair(data_dir, *files, use_kernels=True)
    engine_kernels.reset_counters()
    m, comp, bl = fit_and_score(inst)
    assert engine_kernels.TWIN_CALLS["golden_sweep"] >= 1
    check_composite_against_jax(jinst, m, comp, bl)
    jeng = jinst.get_engine()
    jeng.use_pallas = jeng.pallas_interpret = True
    jinst.make_engine()
    jeng = jinst.get_engine()
    jeng.use_pallas = jeng.pallas_interpret = True
    jm, _, _ = fit_and_score(jinst)
    assert abs(m - jm) < 1e-4, (m, jm)


def test_routes_agree_on_scale_invariants(data_dir):
    """fluA at the same branch lengths on both routes: likelihood rows,
    marginal and per-GPCSP log likelihoods within 1e-9 (the routes keep
    different log-scales, so the PLVs themselves differ); against the JAX
    engine's marginal within 1e-8 (the rescaling stress test)."""
    jinst, inst = make_pair(data_dir, *FLUA)
    kinst = make_port(data_dir, *FLUA, use_kernels=True)
    out = []
    for i in (jinst, inst, kinst):
        i.get_engine().branch_lengths = np.full(
            i.dag.gpcsp_count_with_fake(), 0.01)
        i.populate_plvs()
        i.compute_likelihoods()
        eng = i.get_engine()
        out.append((np.asarray(eng.log_likelihood_rows),
                    eng.get_log_marginal_likelihood(),
                    eng.get_per_gpcsp_log_likelihoods()))
    (_, jm, _), (rows_l, m_l, per_l), (rows_k, m_k, per_k) = out
    assert inst.get_engine().plvs["ls_p"].dim() == 1
    assert kinst.get_engine().plvs["ls_p"].dim() == 2
    fin = np.isfinite(rows_l)
    assert (np.isfinite(rows_k) == fin).all()
    np.testing.assert_allclose(rows_k[fin], rows_l[fin], rtol=0, atol=1e-9)
    assert abs(m_k - m_l) < 1e-9 and abs(m_k - jm) < 1e-8
    np.testing.assert_allclose(per_k, per_l, rtol=0, atol=1e-9)


@pytest.mark.parametrize("which", ["simplest", "second_simplest"])
def test_hybrids_and_sbn_on_the_kernel_route(data_dir, which):
    """Hybrid marginals from K7-twin PLVs (per-pattern log-scales) against
    the JAX engine's, 1e-12 relative; then estimate_sbn_parameters' q
    against the JAX engine's, 1e-10."""
    files = ("7-taxon-slice-of-ds1.fasta",
             f"{which.replace('_', '-')}-hybrid-marginal.nwk")
    jinst, inst = make_pair(data_dir, *files, use_kernels=True)
    bl = np.random.default_rng(7 if which == "simplest" else 11).uniform(
        1e-6, 0.1, inst.dag.gpcsp_count_with_fake())
    for i in (jinst, inst):
        i.get_engine().branch_lengths = bl.copy()
        i.calculate_hybrid_marginals()
    got = inst.get_engine().hybrid_marginal_log_likelihoods
    want = jinst.get_engine().hybrid_marginal_log_likelihoods
    fin = np.isfinite(want)
    assert fin.any() and (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    for i in (jinst, inst):
        i.estimate_sbn_parameters()
    np.testing.assert_allclose(inst.get_engine().q, jinst.get_engine().q,
                               rtol=0, atol=1e-10)


# -- the fluA fit --------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "level"])
def test_flua_fit(data_dir, use_kernels, dtype):
    """run_branch_ascent(1e-6, 100) on fluA, the JAX bench's GP fit with
    nothing cut: f64 lands on -4337.885058592 within 1e-7 in the JAX
    package's 12 sweeps on either route; f32 within 1e-2 of the f64 value.
    The kernel route runs K7's and K8's twins only."""
    inst = make_port(data_dir, *FLUA, use_kernels=use_kernels, dtype=dtype)
    eng = inst.get_engine()
    engine_kernels.reset_counters()
    m, sweeps = eng.run_branch_ascent(1e-6, 100)
    calls = engine_kernels.TWIN_CALLS
    if use_kernels:
        assert calls["golden_sweep"] == sweeps
        assert calls["populate_plvs"] > sweeps
    else:
        assert sum(calls.values()) == 0
    assert eng.last_ascent_converged
    assert eng.branch_lengths.dtype == NP_DTYPE[dtype]
    if dtype == torch.float64:
        assert abs(m - FLUA_F64) < 1e-7, m
        assert sweeps == FLUA_SWEEPS
    else:
        assert abs(m - FLUA_F64) < 1e-2, m
    assert abs(eng.get_log_marginal_likelihood() - m) < 1e-6 * abs(m)
