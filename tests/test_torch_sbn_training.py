"""SBN training and the rest of the instance surface in the port, against
libsbn_tpu and the zcrabbit/sbn goldens.

* simple average and EM (alpha 0 for 1 and 23 iterations, alpha 0.5 for
  100) against tests/golden_sbn.py (atol 1e-12; EM_05_100 at 1e-5, its
  tolerance in tests/test_sbn_training.py), and EM's parameters and score
  history against libsbn_tpu's expectation_maximization on the same
  representations (rel 1e-12);
* the probabilities of rooted and unrooted tree collections, the SBN
  parameter CSV round trip and set_sbn_parameters, split_counters,
  make_indexer_representations and string_indexer_representation_of
  against libsbn_tpu; print_status and set_rescaling.

Every port call that computes passes device="cpu". "rel r" below means
|got - want| <= r (|want| + max |want|) elementwise.
"""

import csv

import numpy as np
import pytest
import torch

import libsbn_tpu as jl
from libsbn_tpu.sbn import probability as jprob

import libsbn_tpu_torch as lt
from libsbn_tpu_torch.sbn import probability as tprob

from golden_sbn import (
    EXPECTED_EM_0_1, EXPECTED_EM_0_23, EXPECTED_EM_05_100, EXPECTED_SA,
)

torch.set_num_threads(2)


def rel_close(got, want, rel):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), np.max(
        np.abs(got - want) / scale)


@pytest.fixture(scope="module")
def pair(data_dir):
    """(libsbn_tpu instance, port instance) on DS1.100_topologies."""
    out = []
    for lib in (jl, lt):
        inst = lib.UnrootedInstance("charlie")
        inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
        inst.process_loaded_trees()
        out.append(inst)
    return tuple(out)


def test_simple_average_golden(pair):
    _, t = pair
    t.train_simple_average()
    np.testing.assert_allclose(t.calculate_sbn_probabilities(), EXPECTED_SA,
                               atol=1e-12)


@pytest.mark.parametrize("alpha, max_iter, golden, atol", [
    (0.0, 1, EXPECTED_EM_0_1, 1e-12),
    (0.0, 23, EXPECTED_EM_0_23, 1e-12),
    (0.5, 100, EXPECTED_EM_05_100, 1e-5),
])
def test_em_golden_and_libsbn_tpu(pair, alpha, max_iter, golden, atol):
    """EM on the CPU: the zcrabbit goldens, and libsbn_tpu's parameters and
    score history at rel 1e-12; the stored parameters are a writable
    float64 copy."""
    j, t = pair
    scores = t.train_expectation_maximization(alpha, max_iter, device="cpu")
    np.testing.assert_allclose(t.calculate_sbn_probabilities(), golden,
                               atol=atol)
    want = j.train_expectation_maximization(alpha, max_iter)
    assert len(scores) == len(want) == max_iter
    rel_close(scores, want, 1e-12)
    rel_close(t.sbn_parameters, j.sbn_parameters, 1e-12)
    assert t.sbn_parameters.dtype == np.float64
    assert t.sbn_parameters.flags.writeable


def test_em_function_matches_libsbn_tpu_with_epsilon(pair):
    """sbn/probability.py expectation_maximization against libsbn_tpu's on
    the same dense representations, with an early stop by score_epsilon:
    the same number of iterations, parameters and scores at rel 1e-12."""
    j, t = pair
    reps, counts = t._dense_counter()
    seg = t.sbn_support.segment_ids()
    G = t.sbn_support.gpcsp_count
    jparams, jscores = jprob.expectation_maximization(
        reps, counts, seg, G, alpha=0.3, max_iter=50, score_epsilon=1e-5)
    tparams, tscores = tprob.expectation_maximization(
        torch.as_tensor(reps), counts, torch.as_tensor(seg), G, alpha=0.3,
        max_iter=50, score_epsilon=1e-5)
    assert 1 < len(tscores) == len(jscores) < 50
    rel_close(tscores, jscores, 1e-12)
    rel_close(tparams.numpy(), np.asarray(jparams), 1e-12)


@pytest.mark.parametrize("alpha, max_iter, epsilon, golden, atol", [
    (0.0, 23, 0.0, EXPECTED_EM_0_23, 1e-12),
    (0.5, 100, 0.0, EXPECTED_EM_05_100, 1e-5),
    (0.3, 50, 1e-5, None, None),
])
def test_em_step_graph_equals_eager(pair, alpha, max_iter, epsilon, golden,
                                    atol):
    """EM with its step over a static parameter buffer (EMStepGraph, as a
    card runs it; on the CPU the same function over the same buffers)
    against the eager step: parameters and scores bit for bit; and against
    libsbn_tpu's expectation_maximization at rel 1e-12 and the goldens at
    their tolerances."""
    j, t = pair
    reps, counts = t._dense_counter()
    seg = t.sbn_support.segment_ids()
    G = t.sbn_support.gpcsp_count
    tprob.reset_counters()
    (gp, gs), (ep, es) = (
        tprob._expectation_maximization(
            torch.as_tensor(reps).long(), counts, torch.as_tensor(seg), G,
            alpha, max_iter, epsilon, False, graphed=graphed)
        for graphed in (True, False))
    assert tprob.COUNTS == {"captures": 0, "replays": 0}
    assert torch.equal(gp, ep)
    np.testing.assert_array_equal(gs, es)
    jparams, jscores = jprob.expectation_maximization(
        reps, counts, seg, G, alpha=alpha, max_iter=max_iter,
        score_epsilon=epsilon)
    assert len(gs) == len(jscores)
    rel_close(gs, jscores, 1e-12)
    rel_close(gp.numpy(), np.asarray(jparams), 1e-12)
    if golden is not None:
        t.sbn_parameters = gp.numpy().copy()
        np.testing.assert_allclose(t.calculate_sbn_probabilities(), golden,
                                   atol=atol)


def test_em_cuda_graphs_switch_keeps_the_cpu_eager(pair):
    """On the CPU train_expectation_maximization runs the eager step with
    or without cuda_graphs, and both give the same scores."""
    _, t = pair
    tprob.reset_counters()
    a = t.train_expectation_maximization(0.0, 5, device="cpu")
    b = t.train_expectation_maximization(0.0, 5, device="cpu",
                                         cuda_graphs=False)
    np.testing.assert_array_equal(a, b)
    assert tprob.COUNTS == {"captures": 0, "replays": 0}


def test_em_degenerate_support_scores_zero(data_dir):
    """One 3-taxon tree: the score is exactly 0 every iteration, and the
    monotonicity check falls back to the absolute change (no error)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "three.nwk")
        with open(path, "w") as f:
            f.write("(a:0.1,b:0.2,c:0.3);\n")
        inst = lt.UnrootedInstance("three")
        inst.read_newick_file(path)
        inst.process_loaded_trees()
        scores = inst.train_expectation_maximization(0.0, 4, device="cpu")
    np.testing.assert_array_equal(scores, np.zeros(4))


@pytest.mark.parametrize("rooted", [False, True])
def test_collection_probabilities(data_dir, rooted):
    """probability_of_{rooted,unrooted}_collection through
    calculate_sbn_probabilities, after simple average, against libsbn_tpu
    (rel 1e-12), and a tree outside the support gets probability 0."""
    if rooted:
        tree_file = f"{data_dir}/five_taxon_rooted_more.nwk"
        make = (jl.RootedInstance, lt.RootedInstance)
    else:
        tree_file = f"{data_dir}/DS1.100_topologies.nwk"
        make = (jl.UnrootedInstance, lt.UnrootedInstance)
    j, t = (m("probs") for m in make)
    for inst in (j, t):
        inst.read_newick_file(tree_file)
        inst.process_loaded_trees()
        inst.train_simple_average()
    got = t.calculate_sbn_probabilities()
    rel_close(got, j.calculate_sbn_probabilities(), 1e-12)
    assert np.all(got > 0)
    reps = t.sbn_support.dense_representations(
        [tr.topology for tr in t.tree_collection.trees])
    reps[0] = t.sbn_support.gpcsp_count  # every index out of the support
    fn = (tprob.probability_of_rooted_collection if rooted
          else tprob.probability_of_unrooted_collection)
    out = fn(torch.as_tensor(np.log(t.normalized_sbn_parameters())), reps)
    assert out[0] == 0.0
    rel_close(out[1:].numpy(), got[1:], 1e-12)


def test_sbn_parameter_csv_round_trip(pair, tmp_path):
    """sbn_parameters_to_csv writes libsbn_tpu's file; reading it back
    gives the same probabilities (atol 1e-9, as the JAX test)."""
    j, t = pair
    j.train_simple_average()
    t.train_simple_average()
    t.sbn_parameters_to_csv(str(tmp_path / "port.csv"))
    j.sbn_parameters_to_csv(str(tmp_path / "jax.csv"))
    with open(tmp_path / "port.csv") as f:
        port_rows = list(csv.reader(f))
    with open(tmp_path / "jax.csv") as f:
        jax_rows = list(csv.reader(f))
    assert [r[0] for r in port_rows] == [r[0] for r in jax_rows]
    rel_close([float(r[1]) for r in port_rows],
              [float(r[1]) for r in jax_rows], 1e-12)
    before = t.calculate_sbn_probabilities()
    t.read_sbn_parameters_from_csv(str(tmp_path / "port.csv"))
    np.testing.assert_allclose(t.calculate_sbn_probabilities(), before,
                               atol=1e-9)


def test_set_sbn_parameters(data_dir, capsys):
    """A partial map (data/test_modifying_sbn_parameters.csv): keys of the
    support it lacks become log-zero with a warning, as in libsbn_tpu; a
    negative probability raises."""
    j, t = jl.UnrootedInstance("charlie"), lt.UnrootedInstance("charlie")
    for inst in (j, t):
        inst.read_newick_file(f"{data_dir}/hello.nwk")
        inst.process_loaded_trees()
        inst.read_sbn_parameters_from_csv(
            f"{data_dir}/test_modifying_sbn_parameters.csv")
    out = capsys.readouterr().out
    assert out.count("were in the support but not specified") == 2
    np.testing.assert_array_equal(t.sbn_parameters, j.sbn_parameters)
    assert np.all(np.isfinite(t.sbn_parameters)
                  | (t.sbn_parameters < -1e300))
    key = t.pretty_indexer()[0]
    with pytest.raises(ValueError, match="Negative probability"):
        t.set_sbn_parameters({key: -0.5})


def test_split_counters_and_representations(data_dir):
    """split_counters, make_indexer_representations and
    string_indexer_representation_of equal libsbn_tpu's."""
    j, t = jl.UnrootedInstance("splits"), lt.UnrootedInstance("splits")
    for inst in (j, t):
        inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
        inst.process_loaded_trees()
    assert t.split_counters() == j.split_counters()
    assert ([np.asarray(r).tolist() for r in t.make_indexer_representations()]
            == [np.asarray(r).tolist()
                for r in j.make_indexer_representations()])
    for jt, tt in zip(j.tree_collection.trees[:3], t.tree_collection.trees[:3]):
        assert (t.string_indexer_representation_of(tt.topology)
                == j.string_indexer_representation_of(jt.topology))


def test_print_status_and_set_rescaling(data_dir, capsys):
    t = lt.UnrootedInstance("status")
    t.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    t.read_fasta_file(f"{data_dir}/DS1.fasta")
    t.process_loaded_trees()
    t.print_status()
    out = capsys.readouterr().out
    assert f"status instance: 10 trees, {t.sbn_support.gpcsp_count} GPCSPs" in out
    t.prepare_for_phylo_likelihood(lt.PhyloModelSpec(), device="cpu")
    rescaled = t.log_likelihoods()
    t.set_rescaling(False)
    assert t.rescaling is False and t.engine.rescale is False
    np.testing.assert_allclose(t.log_likelihoods(), rescaled, rtol=1e-10)
