"""The port's generalized pruning (libsbn_tpu_torch.gp) against libsbn_tpu.gp.

Same numpy inputs through both packages, float64 on the CPU unless stated:

* the host layer: the subsplit DAG, its GPCSP indexer, priors, level
  schedules, edge list and K7's edge streams, exactly equal on five
  datasets;
* the level route (``use_kernels=False``): populate against the JAX
  engine's ``_populate_impl`` on all 12 PLV arrays, and the Newton sweep
  against ``_optimize_impl``, both fed the same state, rtol 1e-10;
* GPInstance on the level route: the reference's goldens (hello marginal,
  the gradient, hot start, DOT bytes), the composite marginals and the fluA
  rescaling marginal against the JAX engine, hybrid marginals, SBN
  estimation, the host-loop ascent, tree export and the CSV files.

The kernel route (K7 and K8 twins against the JAX package's Pallas kernels
in interpret mode, the same goldens through the twins, and the fluA fits):
tests/test_torch_gp_kernels.py. The CUDA kernels: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libsbn_tpu.gp import GPInstance as JGPInstance
from libsbn_tpu.gp.engine_pallas import build_edge_streams as jbuild_streams
from libsbn_tpu_torch.gp import GPInstance, engine_kernels
from libsbn_tpu_torch.gp.instance import dag_to_dot

torch.set_num_threads(1)

HELLO = ("hello.fasta", "hello_rooted.nwk")
FIVE_MORE = ("five_taxon.fasta", "five_taxon_rooted_more.nwk")
FLUA = ("fluA.fa", "fluA.tree")
# The four datasets of the brute-force composite-marginal check
# (tests/test_gp.py) and fluA.
COMPOSITE = [
    ("hello.fasta", "hello_rooted_two_trees.nwk"),
    ("five_taxon.fasta", "five_taxon_rooted.nwk"),
    ("ds1-reduced-5.fasta", "ds1-reduced-5.nwk"),
    ("7-taxon-slice-of-ds1.fasta", "simplest-hybrid-marginal-all-trees.nwk"),
]
DATASETS = [HELLO, FIVE_MORE, COMPOSITE[2], COMPOSITE[3], FLUA]
IDS = ["hello", "five_taxon_more", "ds1_reduced_5", "seven_taxon", "fluA"]
HELLO_BL = np.array([0.0, 0.22, 0.113, 0.15, 0.1])


def make_pair(data_dir, fasta, newick, **kw):
    """(JAX GPInstance, port GPInstance) on the same files, f64 engines;
    ``kw`` goes to the port's make_engine (on the CPU unless it names a
    device)."""
    out = []
    for cls, ekw in ((JGPInstance, {}), (GPInstance, {"device": "cpu", **kw})):
        inst = cls()
        inst.read_fasta_file(f"{data_dir}/{fasta}")
        inst.read_newick_file(f"{data_dir}/{newick}")
        inst.make_engine(**ekw)
        out.append(inst)
    return tuple(out)


def make_port(data_dir, fasta, newick, **kw):
    """The port's GPInstance; ``kw`` goes to make_engine (on the CPU unless
    it names a device)."""
    inst = GPInstance()
    inst.read_fasta_file(f"{data_dir}/{fasta}")
    inst.read_newick_file(f"{data_dir}/{newick}")
    inst.make_engine(**{"device": "cpu", **kw})
    return inst


def random_lengths(n, seed=0):
    return np.random.default_rng(seed).uniform(0.01, 0.3, n)


def assert_plvs_close(got, want, rtol, atol=0.0, ls_atol=None):
    """The port's 12-entry PLV dict (tensors) against the JAX package's
    (arrays); log-scales at ``ls_atol`` where given."""
    assert set(got) == set(want) == set(engine_kernels.PLV_KEYS)
    for k in engine_kernels.PLV_KEYS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        tol = ls_atol if (k.startswith("ls_") and ls_atol is not None) else atol
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=k)


# -- the host layer -----------------------------------------------------------


@pytest.mark.parametrize("files", DATASETS, ids=IDS)
def test_dag_matches_jax(data_dir, files):
    """Node and GPCSP counts, the GPCSP indexer (as strings), pretty
    indexer, priors, level schedules, edge list and K7's edge streams are
    exactly those of libsbn_tpu's DAG and engine."""
    jinst, inst = make_pair(data_dir, *files)
    jd, d = jinst.dag, inst.dag
    assert (d.node_count(), d.gpcsp_count_with_fake(), d.rootsplit_count(),
            d.taxon_count) == (jd.node_count(), jd.gpcsp_count_with_fake(),
                               jd.rootsplit_count(), jd.taxon_count)
    assert ({k.to_string(): v for k, v in d.build_gpcsp_indexer().items()}
            == {k.to_string(): v for k, v in jd.build_gpcsp_indexer().items()})
    assert d.pretty_indexer() == jd.pretty_indexer()
    assert d.edge_list() == jd.edge_list()
    assert int(d.topology_count) == int(jd.topology_count)
    for name in ("build_uniform_on_topological_support_prior",
                 "build_uniform_on_all_topologies_prior"):
        np.testing.assert_array_equal(getattr(d, name)(), getattr(jd, name)())
    prior = d.build_uniform_on_topological_support_prior()
    nodes = d.unconditional_node_probabilities(prior)
    np.testing.assert_array_equal(nodes, jd.unconditional_node_probabilities(prior))
    np.testing.assert_array_equal(
        d.inverted_gpcsp_probabilities(prior, nodes),
        jd.inverted_gpcsp_probabilities(prior, nodes))
    for got, want in zip(d.level_schedules(), jd.level_schedules()):
        assert len(got) == len(want)
        for lg, lw in zip(got, want):
            assert lg.keys() == lw.keys()
            for k in lg:
                np.testing.assert_array_equal(lg[k], lw[k])
    eng, jeng = inst.get_engine(), jinst.get_engine()
    for got, want in zip(engine_kernels.build_edge_streams(eng),
                         jbuild_streams(jeng)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.q, jeng.q)
    np.testing.assert_array_equal(eng.tips, jeng.tips)
    np.testing.assert_array_equal(eng.weights, jeng.weights)


def test_edge_streams_refuse_bad_indices(data_dir):
    """edge_streams checks every stream index once on the host."""
    eng = make_port(data_dir, *HELLO).get_engine()
    streams = engine_kernels.edge_streams(eng, "cpu")
    assert streams.rootward.dtype == torch.int32
    assert streams.node_count == eng.dag.node_count()
    eng.root_gpcsps = eng.root_gpcsps + 100
    with pytest.raises(ValueError, match="roots stream"):
        engine_kernels.edge_streams(eng, "cpu")


# -- the level route against the JAX engine -----------------------------------


@pytest.mark.parametrize("files", DATASETS, ids=IDS)
def test_level_populate_matches_jax(data_dir, files):
    """The level route's populate against libsbn_tpu's _populate_impl on
    all 12 arrays (per-node scalar log-scales in both), rtol 1e-10, at
    random branch lengths and the uniform prior."""
    jinst, inst = make_pair(data_dir, *files)
    jeng, eng = jinst.get_engine(), inst.get_engine()
    assert not eng.use_kernels
    bl = random_lengths(eng.branch_lengths.size)
    want = jeng._populate_impl(jnp.asarray(bl), jnp.asarray(jeng.q))
    engine_kernels.reset_counters()
    got = eng._populate(eng._tensor(bl), eng._tensor(eng.q))
    assert sum(engine_kernels.TWIN_CALLS.values()) == 0
    assert got["ls_p"].shape == (eng.dag.node_count(),)
    assert_plvs_close(got, want, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("files", DATASETS, ids=IDS)
def test_newton_sweep_matches_jax(data_dir, files):
    """One Newton-bisection sweep against libsbn_tpu's _optimize_impl, both
    fed the JAX engine's PLVs (carried across with plvs_from_numpy):
    branch lengths within rtol 1e-10, atol 1e-12. The atol is the sweep's
    own resolution: it stops once u = exp(-4b/3) moves by less than 1e-12 u,
    which leaves b = -3/4 log u uncertain by 7.5e-13 where b is small
    (observed: 6.9e-13 on edges near 1e-4, from summation order alone)."""
    jinst, inst = make_pair(data_dir, *files)
    jeng, eng = jinst.get_engine(), inst.get_engine()
    bl = random_lengths(eng.branch_lengths.size, seed=1)
    jplvs = jeng._populate_impl(jnp.asarray(bl), jnp.asarray(jeng.q))
    want = np.asarray(jeng._optimize_impl(jplvs, jnp.asarray(bl)))
    plvs = engine_kernels.plvs_from_numpy(
        {k: np.asarray(v) for k, v in jplvs.items()}, "cpu", torch.float64)
    A, B = engine_kernels.sweep_stats(plvs, eng._pa, eng._ch, eng._rot)
    got = eng._newton_sweep(A, B, eng._w, eng._tensor(bl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert not np.array_equal(got, bl)


def test_plvs_from_numpy(data_dir):
    """The carried state: 12 tensors on the device in the dtype asked for,
    equal to the arrays."""
    jeng = make_pair(data_dir, *HELLO)[0].get_engine()
    jplvs = {k: np.asarray(v) for k, v in jeng._populate_jit(
        jnp.asarray(jeng.branch_lengths), jnp.asarray(jeng.q)).items()}
    for dt in (torch.float64, torch.float32):
        got = engine_kernels.plvs_from_numpy(jplvs, "cpu", dt)
        assert all(v.dtype == dt for v in got.values())
        assert_plvs_close(got, jplvs, rtol=1e-7 if dt == torch.float32 else 0)


# -- GPInstance on the level route ---------------------------------------------


def test_hello_marginal_golden(data_dir):
    """Golden -84.77961943 per GPCSP and as the marginal (gp_doctest.cpp:
    89-101, tests/test_gp.py), within 1e-6."""
    inst = make_port(data_dir, *HELLO)
    eng = inst.get_engine()
    eng.branch_lengths = HELLO_BL.copy()
    inst.populate_plvs()
    inst.compute_likelihoods()
    np.testing.assert_allclose(eng.get_per_gpcsp_log_likelihoods(),
                               -84.77961943, atol=1e-6)
    assert abs(eng.get_log_marginal_likelihood() - -84.77961943) < 1e-6


def test_gradient_golden(data_dir):
    """Golden LL -4.806671945 and dLL/db -0.6109379521 (gp_doctest.cpp:
    236-239), within 1e-6."""
    inst = make_port(data_dir, "hello_single_nucleotide.fasta",
                     "hello_rooted.nwk")
    inst.get_engine().branch_lengths = HELLO_BL.copy()
    inst.populate_plvs()
    inst.compute_likelihoods()
    ll, dll = inst.get_engine().log_likelihood_and_derivative(
        inst.dag.node_count() - 1, 0)
    assert abs(ll - -4.806671945) < 1e-6
    assert abs(dll - -0.6109379521) < 1e-6


def fit_and_score(inst):
    """The composite-marginal recipe of tests/test_gp.py: fit, repopulate,
    score. Returns (marginal, per-GPCSP components, branch lengths)."""
    inst.estimate_branch_lengths(1e-4, 100)
    inst.populate_plvs()
    inst.compute_likelihoods()
    eng = inst.get_engine()
    return (eng.get_log_marginal_likelihood(),
            eng.get_per_gpcsp_components_of_full_log_marginal(),
            np.asarray(eng.branch_lengths))


def check_composite_against_jax(jinst, m, comp, bl):
    """A port fit's marginal m and per-GPCSP components comp at branch
    lengths bl against the JAX instance on the same files set to bl: the
    JAX engine's within 1e-9, and the exact marginal by enumerating every
    tree the DAG spans within 1e-6, 1e-5 per GPCSP (TestCompositeMarginal,
    gp_doctest.cpp:180-196, with tests/test_gp.py's enumeration)."""
    from test_gp import compute_exact_marginal

    jeng = jinst.get_engine()
    jeng.branch_lengths = np.array(bl, dtype=np.float64)
    jinst.populate_plvs()
    jinst.compute_likelihoods()
    assert abs(m - jeng.get_log_marginal_likelihood()) < 1e-9
    jcomp = jeng.get_per_gpcsp_components_of_full_log_marginal()
    fin = np.isfinite(jcomp)
    assert (np.isfinite(comp) == fin).all()
    np.testing.assert_allclose(comp[fin], jcomp[fin], rtol=0, atol=1e-9)
    exact, exact_per_pcsp = compute_exact_marginal(
        jinst.generate_complete_rooted_tree_collection(), jeng.site_pattern,
        jinst.dag)
    assert abs(m - exact) < 1e-6, (m, exact)
    for key, value in zip(jinst.dag.pretty_indexer(), comp):
        want = exact_per_pcsp.get(key, -np.inf)
        if np.isfinite(want):
            assert abs(value - want) < 1e-5, (key, value, want)


@pytest.mark.parametrize("files", COMPOSITE,
                         ids=["two_trees", "five_taxon", "ds1_reduced_5",
                              "seven_taxon"])
def test_composite_marginal_matches_jax(data_dir, files):
    """The fitted composite marginal and its per-GPCSP components against
    the JAX engine's same fit (Newton sweeps on both sides), within 1e-9,
    the fitted branch lengths within rtol 1e-6; and at the port's lengths,
    against the JAX engine and the exact enumeration
    (check_composite_against_jax)."""
    jinst, inst = make_pair(data_dir, *files)
    jm, jcomp, jbl = fit_and_score(jinst)
    m, comp, bl = fit_and_score(inst)
    assert abs(m - jm) < 1e-9, (m, jm)
    fin = np.isfinite(jcomp)
    assert (np.isfinite(comp) == fin).all()
    np.testing.assert_allclose(comp[fin], jcomp[fin], rtol=0, atol=1e-9)
    np.testing.assert_allclose(bl, jbl, rtol=1e-6)
    check_composite_against_jax(jinst, m, comp, bl)


def test_flua_rescaling_marginal(data_dir):
    """fluA at branch lengths 0.01 (the reference's rescaling stress test):
    the marginal and the per-GPCSP log likelihoods against the JAX engine,
    within 1e-8."""
    jinst, inst = make_pair(data_dir, *FLUA)
    for i in (jinst, inst):
        i.get_engine().branch_lengths = np.full(
            i.dag.gpcsp_count_with_fake(), 0.01)
        i.populate_plvs()
        i.compute_likelihoods()
    jeng, eng = jinst.get_engine(), inst.get_engine()
    m = eng.get_log_marginal_likelihood()
    assert np.isfinite(m)
    assert abs(m - jeng.get_log_marginal_likelihood()) < 1e-8
    np.testing.assert_allclose(eng.get_per_gpcsp_log_likelihoods(),
                               jeng.get_per_gpcsp_log_likelihoods(), atol=1e-8)


def test_hot_start_golden(data_dir):
    """Mean of the 33 bootstrap branch lengths of one PCSP
    (gp_doctest.cpp:255-287), within 1e-12; every hot-started length equals
    the JAX engine's."""
    files = ("hotstart.fasta", "hotstart_bootstrap_sample.nwk")
    jinst, inst = make_pair(data_dir, *files)
    inst.hot_start_branch_lengths()
    jinst.hot_start_branch_lengths()
    expected = np.array([
        0.1175370000, 0.1175750000, 0.1195780000, 0.0918962000, 0.0918931000,
        0.1192590000, 0.0906988000, 0.0906972000, 0.0905154000, 0.0903663000,
        0.1245620000, 0.1244890000, 0.1245050000, 0.1245550000, 0.1245680000,
        0.1248920000, 0.1248490000, 0.1164070000, 0.1164110000, 0.1164120000,
        0.1245670000, 0.1245650000, 0.1245670000, 0.1245670000, 0.1240790000,
        0.1242540000, 0.1242160000, 0.1242560000, 0.1892030000, 0.1894900000,
        0.1895430000, 0.1896900000, 0.1905710000,
    ]).mean()
    pretty = dict(inst.pretty_indexed_branch_lengths())
    assert abs(pretty["01100|00011|00001"] - expected) < 1e-12
    np.testing.assert_array_equal(inst.get_engine().branch_lengths,
                                  jinst.get_engine().branch_lengths)


@pytest.mark.parametrize("which", ["simplest", "second_simplest"])
def test_hybrid_marginals_match_jax(data_dir, which):
    """Quartet hybrid marginals on the 7-taxon slice (tests/test_gp_hybrid.py's
    DAGs and branch lengths): every central edge's value from the batched
    requests, and the one-request form, against the JAX engine's, 1e-12
    relative."""
    files = ("7-taxon-slice-of-ds1.fasta", f"{which.replace('_', '-')}"
             "-hybrid-marginal.nwk")
    jinst, inst = make_pair(data_dir, *files)
    bl = np.random.default_rng(7 if which == "simplest" else 11).uniform(
        1e-6, 0.1, inst.dag.gpcsp_count_with_fake())
    for i in (jinst, inst):
        i.get_engine().branch_lengths = bl.copy()
        i.calculate_hybrid_marginals()
    got = inst.get_engine().hybrid_marginal_log_likelihoods
    want = jinst.get_engine().hybrid_marginal_log_likelihoods
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)

    from libsbn_tpu_torch.gp.quartet import quartet_hybrid_request_of

    eng = inst.get_engine()
    eng.hybrid_marginal_log_likelihoods[:] = -np.inf
    for parent_id, rotated, child_id, _ in (
            inst.dag.reverse_postorder_index_traversal()):
        eng.process_quartet_hybrid_request(
            quartet_hybrid_request_of(inst.dag, parent_id, rotated, child_id))
    np.testing.assert_allclose(eng.hybrid_marginal_log_likelihoods[fin],
                               want[fin], rtol=1e-12)


@pytest.mark.parametrize("files", [COMPOSITE[1], FIVE_MORE],
                         ids=["five_taxon", "five_taxon_more"])
def test_estimate_sbn_parameters_matches_jax(data_dir, files):
    """estimate_sbn_parameters after hot start: q against the JAX engine's,
    1e-10, and normalised over every sibling range."""
    jinst, inst = make_pair(data_dir, *files)
    for i in (jinst, inst):
        i.get_engine().branch_lengths = np.full(
            i.dag.gpcsp_count_with_fake(), 0.1)
        i.estimate_sbn_parameters()
    q = inst.get_engine().q
    np.testing.assert_allclose(q, jinst.get_engine().q, rtol=0, atol=1e-10)
    assert abs(q[:inst.dag.rootsplit_count()].sum() - 1.0) < 1e-12


def test_host_loop_ascent_matches_jax(data_dir):
    """estimate_branch_lengths(device_loop=False), the host loop with
    per-iteration reporting, against the JAX host loop: marginal within
    1e-9, branch lengths rtol 1e-6."""
    jinst, inst = make_pair(data_dir, *COMPOSITE[1])
    out = []
    for i in (jinst, inst):
        i.estimate_branch_lengths(1e-6, 20, quiet=False, device_loop=False)
        out.append((i.get_engine().get_log_marginal_likelihood(),
                    np.asarray(i.get_engine().branch_lengths)))
    assert abs(out[0][0] - out[1][0]) < 1e-9
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)


def test_ascent_converges_and_warns_at_cap(data_dir, capsys):
    """run_branch_ascent matches the JAX ascent on five_taxon (marginal
    1e-9, same sweep count); a fit capped at one sweep warns."""
    jinst, inst = make_pair(data_dir, *COMPOSITE[1])
    jm, jit = jinst.get_engine().run_branch_ascent(1e-8, 50)
    m, it = inst.get_engine().run_branch_ascent(1e-8, 50)
    assert (it, inst.get_engine().last_ascent_converged) == (int(jit), True)
    assert abs(m - jm) < 1e-9
    inst = make_port(data_dir, *COMPOSITE[1])
    inst.estimate_branch_lengths(1e-12, 1)
    assert not inst.get_engine().last_ascent_converged
    assert "hit max_iter" in capsys.readouterr().out


def test_dot_export_byte_golden(data_dir):
    """Byte-parity DOT export (subsplit_dag.cpp:77-119, tests/test_gp.py),
    and the file the instance writes."""
    inst = make_port(data_dir, *HELLO)
    expected = (
        "digraph g {\n"
        "node [shape=record];\n"
        "edge [colorscheme=dark23];\n"
        '4 [label="<f0>1,2|<f1>4|<f2>0"]\n'
        '0 [label="<f1>0"]\n'
        '"4":f2->"0":f1 [label="2", color=3, fontcolor=3]\n'
        '3 [label="<f0>1|<f1>3|<f2>2"]\n'
        '2 [label="<f1>2"]\n'
        '"3":f2->"2":f1 [label="4", color=3, fontcolor=3]\n'
        '1 [label="<f1>1"]\n'
        '"3":f0->"1":f1 [label="3", color=1, fontcolor=1]\n'
        '"4":f0->"3":f1 [label="1", color=1, fontcolor=1]\n'
        "}"
    )
    assert dag_to_dot(inst.dag, True) == expected
    two = make_port(data_dir, "hello.fasta", "hello_rooted_two_trees.nwk")
    out = dag_to_dot(two.dag, False)
    assert out.endswith('"6":f0->"2":f1\n}')
    assert out.count('1 [label="<f1>1"]\n') == 2


def test_tree_export_and_csv(data_dir, tmp_path):
    """Trees with GP branch lengths (tests/test_gp.py's newick golden), the
    PCSP filter, generated topologies, and the CSV and Newick files against
    the JAX instance's."""
    files = ("hello_single_nucleotide.fasta", "hello_rooted.nwk")
    inst = make_port(data_dir, *files)
    inst.get_engine().branch_lengths = np.array([0.0, 0.1, 0.2, 0.3, 0.4])
    trees = inst.currently_loaded_trees_with_gp_branch_lengths()
    out = trees.trees[0].topology.newick(
        ["%g" % b for b in trees.trees[0].branch_lengths], trees.tag_taxon_map)
    assert out == "(jupiter:0.2,(mars:0.3,saturn:0.4):0.1):0;"

    jinst, inst = make_pair(data_dir, "five_taxon.fasta",
                            "five_taxon_rooted_more.nwk")
    assert inst.generate_complete_rooted_tree_collection().tree_count() == (
        jinst.generate_complete_rooted_tree_collection().tree_count())
    for i in (jinst, inst):
        i.get_engine().branch_lengths = np.full(
            i.dag.gpcsp_count_with_fake(), 0.9)
    assert inst.currently_loaded_trees_with_a_pcsp_string_and_gp_branch_lengths(
        "000010011000010").tree_count() == 2
    for name in ("sbn_parameters_to_csv", "branch_lengths_to_csv",
                 "sbn_prior_to_csv", "export_trees", "export_all_generated_trees",
                 "subsplit_dag_to_dot"):
        for tag, i in (("jax", jinst), ("torch", inst)):
            getattr(i, name)(str(tmp_path / f"{name}.{tag}"))
        assert ((tmp_path / f"{name}.torch").read_text()
                == (tmp_path / f"{name}.jax").read_text()), name


def test_populate_refuses_non_finite(data_dir):
    """A non-finite PLV raises FloatingPointError (the reference asserts
    finiteness per operation, gp_engine.cpp:298-300)."""
    eng = make_port(data_dir, *HELLO).get_engine()
    eng.branch_lengths = np.full_like(eng.branch_lengths, np.nan)
    with pytest.raises(FloatingPointError, match="Non-finite"):
        eng.populate_plvs()


def test_routes_and_devices(data_dir):
    """use_kernels="auto" takes the level route on the CPU; True runs the
    kernels' twins there; dtype is float32 or float64; device="cuda"
    without a card raises instead of running on the CPU."""
    inst = make_port(data_dir, *HELLO)
    eng = inst.get_engine()
    assert (eng.use_kernels, eng.device.type, eng.dtype) == (
        False, "cpu", torch.float64)
    inst.make_engine(use_kernels=True, dtype=torch.float32, device="cpu")
    eng = inst.get_engine()
    assert eng.use_kernels and eng.dtype == torch.float32
    engine_kernels.reset_counters()
    inst.populate_plvs()
    assert engine_kernels.TWIN_CALLS["populate_plvs"] == 1
    assert eng.plvs["ls_p"].shape == (inst.dag.node_count(), eng.patterns)
    assert sum(engine_kernels.LAUNCHES.values()) == 0
    with pytest.raises(TypeError, match="float32 or float64"):
        inst.make_engine(dtype=torch.float16)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inst.make_engine(device="cuda")
