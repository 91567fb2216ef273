"""The port's SBN layer (sbn/, the SBN part of instance/) against libsbn_tpu.

* Host arrays (support, representations, touched segments, sampled parent
  vectors) are numpy in both packages and must be identical, through the
  shared native library and through the pure-Python routes alike.
* The torch functions (normalisation, simple average, topology gradients)
  are held against the JAX package within 1e-12 (float64, the CPU).
* The tests/test_sbn_gradients.py goldens within 1e-8.

Inputs: the repo's data files; parameters and log f from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.io import native as jnative
from libsbn_tpu.sbn import gradients as jgradients
from libsbn_tpu.sbn import probability as jprobability
from libsbn_tpu.sbn import sampling as jsampling
from libsbn_tpu_torch.core.topology import Topology
from libsbn_tpu_torch.core.tree import UnrootedTree, UnrootedTreeCollection
from libsbn_tpu_torch.io import native
from libsbn_tpu_torch.sbn import gradients, probability, sampling
from libsbn_tpu_torch.utils.bitset import Bitset

torch.set_num_threads(1)

ROUTES = ["native", "python"]


def _trained(package, data_dir, trees="DS1.subsampled_10.t"):
    inst = package.UnrootedInstance("sbn")
    if trees.endswith(".t"):
        inst.read_nexus_file(f"{data_dir}/{trees}")
    else:
        inst.read_newick_file(f"{data_dir}/{trees}")
    inst.process_loaded_trees()
    inst.train_simple_average()
    return inst


def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)


@pytest.mark.parametrize("route", ROUTES)
def test_support_arrays_identical(data_dir, monkeypatch, route):
    """Segment ids, dense and PSP representations, touched segments and
    split lengths on DS1.subsampled_10.t: identical to the JAX package's."""
    if route == "python":
        _no_native(monkeypatch)
    ref = _trained(libsbn_tpu, data_dir)
    got = _trained(libsbn_tpu_torch, data_dir)
    rs, js = got.sbn_support, ref.sbn_support
    assert rs.gpcsp_count == js.gpcsp_count and rs.gpcsp_count > 0
    assert rs.rootsplit_count() == js.rootsplit_count()
    assert rs.taxon_names == js.taxon_names
    np.testing.assert_array_equal(rs.segment_ids(), js.segment_ids())
    tops = [t.topology for t in got.tree_collection.trees]
    jtops = [t.topology for t in ref.tree_collection.trees]
    reps = rs.dense_representations(tops)
    np.testing.assert_array_equal(reps, js.dense_representations(jtops))
    assert got.psp_indexer.details() == ref.psp_indexer.details()
    np.testing.assert_array_equal(
        np.asarray(got.make_psp_indexer_representations()),
        np.asarray(ref.make_psp_indexer_representations()),
    )
    n = rs.taxon_count()
    np.testing.assert_array_equal(
        gradients.touched_segments_of(rs, reps, pad_to=4 * n),
        jgradients.touched_segments_of(js, reps, pad_to=4 * n),
    )
    assert got.split_lengths() == ref.split_lengths()
    pvs = np.asarray([t.parent_id_vector() for t in tops], np.int32)
    dense = rs.dense_representations_of_parent_vectors(pvs)
    psp = got.psp_indexer.dense_representations_of_parent_vectors(pvs)
    if route == "python":
        assert dense is None and psp is None
    else:
        np.testing.assert_array_equal(dense, reps)
        np.testing.assert_array_equal(
            psp, ref.psp_indexer.dense_representations_of_parent_vectors(pvs)
        )


@pytest.mark.parametrize("route", ROUTES)
def test_sampled_parent_vectors_identical(data_dir, monkeypatch, route):
    """The same seed samples the same topologies as the JAX package: the
    native bulk sampler (parent vectors) and the Python sampler
    (topologies, through set_seed/sample_topology)."""
    if route == "python":
        _no_native(monkeypatch)
    ref = _trained(libsbn_tpu, data_dir)
    got = _trained(libsbn_tpu_torch, data_dir)
    if route == "native":
        mine = sampling.NativeSBNSampler(
            got.sbn_support, got.sbn_parameters, seed=11
        ).sample_parent_vectors(200, rooted=False)
        want = jsampling.NativeSBNSampler(
            ref.sbn_support, ref.sbn_parameters, seed=11
        ).sample_parent_vectors(200, rooted=False)
        assert mine.shape == (200, 51)
        np.testing.assert_array_equal(mine, want)
        return
    assert sampling.NativeSBNSampler(
        got.sbn_support, got.sbn_parameters
    ).sample_parent_vectors(5, rooted=False) is None
    got.set_seed(7)
    ref.set_seed(7)
    for _ in range(20):
        assert (got.sample_topology().parent_id_vector()
                == ref.sample_topology().parent_id_vector())


def test_probability_normalize_and_simple_average(data_dir):
    """simple_average and probability_normalize_in_log within 1e-12 of the
    JAX package (observed: 0 and 4.4e-16), including a segment whose
    parameters are all -inf (its logsumexp is -inf, not nan, in both)."""
    ref = _trained(libsbn_tpu, data_dir)
    got = _trained(libsbn_tpu_torch, data_dir)
    assert isinstance(got.sbn_parameters, np.ndarray)
    assert got.sbn_parameters.flags.writeable
    np.testing.assert_allclose(got.sbn_parameters, ref.sbn_parameters,
                               rtol=1e-12, atol=1e-12)
    seg = got.sbn_support.segment_ids()
    num_segments = int(seg.max()) + 1
    params = np.random.default_rng(3).normal(size=seg.size) * 4.0
    params[seg == 1] = -np.inf
    want = np.asarray(
        jprobability.probability_normalize_in_log(params, seg, num_segments)
    )
    mine = probability.probability_normalize_in_log(
        torch.as_tensor(params), torch.as_tensor(seg), num_segments
    ).numpy()
    np.testing.assert_allclose(mine, want, rtol=1e-12, atol=1e-12)
    lse = probability.segment_logsumexp(
        torch.as_tensor(params), torch.as_tensor(seg), num_segments
    ).numpy()
    assert np.isneginf(lse[1]) and np.all(np.isfinite(np.delete(lse, 1)))
    np.testing.assert_allclose(
        lse, np.asarray(jprobability.segment_logsumexp(params, seg,
                                                       num_segments)),
        rtol=1e-12,
    )


@pytest.mark.parametrize("use_vimco", [True, False])
def test_topology_gradients_match_jax(data_dir, use_vimco):
    """UnrootedInstance.topology_gradients over the ten DS1 trees with
    random parameters and log f: within 1e-12 (relative to the largest
    entry) of the JAX package's; the factors alike. Observed: 2.8e-17 of
    0.094 (VIMCO), 2.2e-11 of 8692 (naive)."""
    ref = _trained(libsbn_tpu, data_dir)
    got = _trained(libsbn_tpu_torch, data_dir)
    rng = np.random.default_rng(0)
    params = rng.normal(size=got.sbn_support.gpcsp_count)
    log_f = rng.normal(size=10) * 3.0 - 7000.0
    ref.sbn_parameters = params
    got.sbn_parameters = params.copy()
    want = ref.topology_gradients(log_f, use_vimco=use_vimco)
    mine = got.topology_gradients(log_f, use_vimco=use_vimco)
    assert mine.dtype == np.float64 and mine.shape == want.shape
    np.testing.assert_allclose(mine, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    factors = (gradients.vimco_multiplicative_factors if use_vimco
               else gradients.multiplicative_factors)
    jfactors = (jgradients.vimco_multiplicative_factors if use_vimco
                else jgradients.multiplicative_factors)
    np.testing.assert_allclose(factors(torch.as_tensor(log_f)).numpy(),
                               np.asarray(jfactors(log_f)), rtol=1e-12,
                               atol=1e-12)


def test_gradient_of_log_q_matches_jax(data_dir):
    """gradient_of_log_q of every DS1 tree within 1e-12 of the JAX
    package's (observed 1.4e-17)."""
    ref = _trained(libsbn_tpu, data_dir)
    got = _trained(libsbn_tpu_torch, data_dir)
    params = np.random.default_rng(1).normal(
        size=got.sbn_support.gpcsp_count)
    ref.sbn_parameters = params
    got.sbn_parameters = params.copy()
    for tree, jtree in zip(got.tree_collection.trees,
                           ref.tree_collection.trees):
        np.testing.assert_allclose(
            got.gradient_of_log_q(tree.topology),
            ref.gradient_of_log_q(jtree.topology), rtol=0, atol=1e-12,
        )


# -- the tests/test_sbn_gradients.py goldens ---------------------------------


@pytest.fixture()
def gradient_inst(data_dir):
    inst = libsbn_tpu_torch.UnrootedInstance("charlie")
    inst.read_nexus_file(f"{data_dir}/gradient_test.t")
    inst.process_loaded_trees()
    # tau = ((0,1),(2,3),4) with internal node labels ((0,1)5,(2,3)6,4)7.
    tau = UnrootedTree(
        Topology.of_parent_id_vector([5, 5, 6, 6, 7, 7, 7]), np.zeros(8)
    )
    inst.tree_collection = UnrootedTreeCollection(
        [tau], inst.tree_collection.tag_taxon_map
    )
    return inst


def test_golden_gradient_of_log_q_uniform(gradient_inst):
    """Uniform parameters: rootsplit entries -1/8, 0 x 6, 1/8; PCSP entries
    -1/16 x 6, 1/16 x 6, the rest 0 (within 1e-8)."""
    inst = gradient_inst
    num_rootsplits = 8
    G = inst.sbn_support.gpcsp_count
    inst.sbn_parameters = np.zeros(G)
    grad = inst.gradient_of_log_q(inst.tree_collection.trees[0].topology)
    np.testing.assert_allclose(
        np.sort(grad[:num_rootsplits]),
        np.array([-1.0 / 8] + [0.0] * 6 + [1.0 / 8]), atol=1e-8,
    )
    num_pcsp = G - num_rootsplits
    np.testing.assert_allclose(
        np.sort(grad[num_rootsplits:]),
        np.concatenate([np.full(6, -1.0 / 16), np.zeros(num_pcsp - 12),
                        np.full(6, 1.0 / 16)]),
        atol=1e-8,
    )


def test_golden_gradient_of_log_q_nonuniform(gradient_inst):
    """Two raised/lowered PCSPs: the closed-form entries within 1e-8, with
    q(tau) from the port's own normalisation."""
    inst = gradient_inst
    G = inst.sbn_support.gpcsp_count
    s_idx = inst.sbn_support.indexer[Bitset.of_string("000011111000110")]
    s_prime_idx = inst.sbn_support.indexer[Bitset.of_string("000011111000010")]
    params = np.zeros(G)
    params[s_idx] = 1.0
    params[s_prime_idx] = -1.0
    inst.sbn_parameters = params
    seg = torch.as_tensor(inst.sbn_support.segment_ids())
    normalized = probability.probability_normalize_in_log(
        torch.as_tensor(params), seg, int(seg.max()) + 1
    )
    top = inst.tree_collection.trees[0].topology
    rep = torch.as_tensor(inst.sbn_support.dense_representations([top])[0])
    q_tau = float(torch.exp(torch.logsumexp(
        probability.with_sentinel(normalized)[rep.long()].sum(-1), 0)))
    normalized = normalized.numpy()
    p_tau_rho = (1.0 / 8) * np.exp(normalized[s_idx])
    expected_s = (1.0 / q_tau) * p_tau_rho * (1 - np.exp(normalized[s_idx]))
    expected_s_prime = (
        (1.0 / q_tau) * p_tau_rho * -np.exp(normalized[s_prime_idx])
    )
    grad = inst.gradient_of_log_q(top)
    assert abs(expected_s - grad[s_idx]) < 1e-8
    assert abs(expected_s_prime - grad[s_prime_idx]) < 1e-8


def test_golden_topology_gradients_naive_and_vimco(gradient_inst):
    """The reference's VIMCO factors for log f = (-83, -75, -80, -79)
    within 1e-7, and topology_gradients equal to the factor-weighted sum of
    per-tree gradient_of_log_q within 1e-8, over four sampled trees."""
    inst = gradient_inst
    inst.sbn_parameters = np.zeros(inst.sbn_support.gpcsp_count)
    inst.set_seed(42)
    inst.sample_trees(4)
    log_f = np.array([-83.0, -75.0, -80.0, -79.0])
    vimco = gradients.vimco_multiplicative_factors(
        torch.as_tensor(log_f)).numpy()
    np.testing.assert_allclose(
        vimco, [-0.04742748, 2.59553236, -0.01779887, -0.01278592], atol=1e-7
    )
    naive = gradients.multiplicative_factors(torch.as_tensor(log_f)).numpy()
    for use_vimco, factors in [(False, naive), (True, vimco)]:
        expected = np.zeros(inst.sbn_support.gpcsp_count)
        for k, tree in enumerate(inst.tree_collection.trees):
            expected += factors[k] * inst.gradient_of_log_q(tree.topology)
        np.testing.assert_allclose(
            inst.topology_gradients(log_f, use_vimco=use_vimco), expected,
            atol=1e-8,
        )
