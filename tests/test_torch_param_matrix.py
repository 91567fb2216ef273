"""The per-tree phylo-model parameter matrix in the port, against
libsbn_tpu (the tests of tests/test_param_matrix.py, mirrored).

* the matrix, its block views, identical rows collapsing to the shared
  parameters, resizing and tree_count_option;
* per-tree rows (GTR and Weibull+4, unrooted on DS1.subsampled_10, rooted
  on fluA): log likelihoods and every gradient key against libsbn_tpu's
  per-tree (vmapped) engine at rel 1e-10, and each tree's row against the
  same call with that row as the shared parameters;
* the routes: per-tree log likelihoods keep the kernels' twins (K2, K5);
  per-tree branch gradients run the scan engine (K1 and K4 take shared
  model tensors only), as the counters show.

Every port call passes device="cpu". "rel r" below means
|got - want| <= r (|want| + max |want|) elementwise.
"""

import numpy as np
import pytest
import torch

import libsbn_tpu as jl
from libsbn_tpu.core.tree import RootedTreeCollection as JRootedCollection
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.models.phylo_model import (
    flat_from_parameters as j_flat, parameters_from_flat as j_from_flat,
)

import libsbn_tpu_torch as lt
from libsbn_tpu_torch.core.tree import RootedTreeCollection
from libsbn_tpu_torch.models.phylo_model import (
    flat_from_parameters, parameters_from_flat,
)
from libsbn_tpu_torch.ops import pruning, pruning_generic, pruning_jc, pruning_vjp

torch.set_num_threads(2)

COUNTED = (pruning, pruning_jc, pruning_generic, pruning_vjp)


def rel_close(got, want, rel, msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), (
        msg, np.max(np.abs(got - want) / scale))


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def unrooted_pair(data_dir, substitution="GTR", site="constant"):
    """(libsbn_tpu, port) instances on DS1.subsampled_10 + DS1.fasta."""
    out = []
    for lib, spec, kw in ((jl, JSpec, {}), (lt, lt.PhyloModelSpec,
                                            {"device": "cpu"})):
        inst = lib.UnrootedInstance("param matrix")
        inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
        inst.read_fasta_file(f"{data_dir}/DS1.fasta")
        inst.process_loaded_trees()
        inst.prepare_for_phylo_likelihood(spec(substitution, site, "none"),
                                          **kw)
        out.append(inst)
    return out


def perturb_rows(insts, seed=7):
    """The same distinct row per tree in each instance's matrix: Dirichlet
    frequencies and exchangeabilities (distinct rates: at the uniform
    default the GTR Q has degenerate eigenvalues), Weibull shapes in
    [0.3, 2)."""
    rng = np.random.default_rng(seed)
    B = insts[0].get_phylo_model_params().shape[0]
    keys = insts[0].get_phylo_model_param_block_map()
    draws = {}
    if "frequencies" in keys:
        draws["frequencies"] = rng.dirichlet(np.full(4, 20.0), size=B)
        draws["GTR rates"] = rng.dirichlet(np.full(6, 20.0), size=B)
    if "Weibull shape" in keys:
        draws["Weibull shape"] = rng.uniform(0.3, 2.0, (B, 1))
    for inst in insts:
        blocks = inst.get_phylo_model_param_block_map()
        for key, value in draws.items():
            blocks[key][:] = value


def test_flat_round_trip():
    spec = lt.PhyloModelSpec("GTR", "weibull+4", "strict")
    v = np.concatenate([np.full(6, 1 / 6.0), np.full(4, 0.25), [0.7], [1.3]])
    params = parameters_from_flat(spec, v)
    np.testing.assert_allclose(flat_from_parameters(spec, params), v)
    jspec = JSpec("GTR", "weibull+4", "strict")
    np.testing.assert_array_equal(
        flat_from_parameters(spec, params), j_flat(jspec, j_from_flat(jspec, v)))


def test_block_map_views_and_identical_rows(data_dir):
    """The block map's views write through to the matrix; identical rows
    stay shared parameters (stored as such); the LLs move with them, as
    libsbn_tpu's do (rel 1e-10)."""
    j, t = unrooted_pair(data_dir)
    mat = t.get_phylo_model_params()
    assert mat.shape == (10, 10) and mat.flags.writeable
    blocks = t.get_phylo_model_param_block_map()
    assert blocks["GTR rates"].shape == (10, 6)
    assert blocks["frequencies"].shape == (10, 4)
    assert blocks["entire"].shape == (10, 10)
    assert set(blocks) == set(j.get_phylo_model_param_block_map())
    baseline = t.log_likelihoods().copy()
    for inst in (j, t):
        inst.get_phylo_model_param_block_map()["frequencies"][:] = [
            0.3, 0.25, 0.2, 0.25]
    assert np.array_equal(mat[:, 6:10], np.tile([0.3, 0.25, 0.2, 0.25],
                                                (10, 1)))
    changed = t.log_likelihoods()
    assert not np.allclose(changed, baseline)
    rel_close(changed, j.log_likelihoods(), 1e-10)
    np.testing.assert_array_equal(
        t.phylo_model_params["substitution"]["frequencies"].numpy(),
        [0.3, 0.25, 0.2, 0.25])


@pytest.mark.parametrize("substitution, site", [
    ("GTR", "constant"), ("GTR", "weibull+4"), ("JC69", "weibull+4")])
def test_per_tree_rows_match_libsbn_tpu(data_dir, substitution, site):
    """Distinct rows per tree: LLs and every gradient key equal
    libsbn_tpu's per-tree engine (rel 1e-10); the LLs keep the kernels'
    twins (K5 or K2) and the branch gradients take the scan engine."""
    j, t = unrooted_pair(data_dir, substitution, site)
    perturb_rows((j, t))
    for m in COUNTED:
        m.reset_counters()
    lls = t.log_likelihoods()
    ll_twin = "ll_generic" if substitution == "GTR" else "ll_jc69"
    twins = pruning_vjp.TWIN_CALLS if substitution == "GTR" else (
        pruning_jc.TWIN_CALLS)
    assert twins[ll_twin] == 1 and pruning.CALLS["ll"] == 0
    rel_close(lls, j.log_likelihoods(), 1e-10, "log_likelihoods")
    grads = t.phylo_gradients()
    assert pruning.CALLS["ll_grad"] == 1
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 0
    assert pruning_generic.TWIN_CALLS["ll_grad_generic"] == 0
    want = j.phylo_gradients()
    assert set(grads) == set(want)
    for key in want:
        rel_close(host(grads[key]), host(want[key]), 1e-10, key)


def test_per_tree_gradients_match_loop(data_dir):
    """The batched per-tree gradients equal a loop that sets each row as
    the shared parameters (the reference's per-row SetParameters,
    fat_beagle.hpp:144), every key and tree (rel 1e-10)."""
    _, t = unrooted_pair(data_dir, "GTR", "weibull+4")
    perturb_rows((t,))
    entire = t.get_phylo_model_params().copy()
    batched = t.phylo_gradients()
    for i in range(entire.shape[0]):
        t.set_phylo_model_params_from_flat(entire[i])
        assert t.phylo_model_params_matrix is None
        shared = t.phylo_gradients()
        for key in ("log_likelihood", "branch_lengths", "substitution_model",
                    "site_model"):
            rel_close(host(batched[key])[i], host(shared[key])[i], 1e-10,
                      f"tree {i}, {key}")


def test_resize_preserves_prefix_and_tree_count_option(data_dir):
    j, t = unrooted_pair(data_dir)
    blocks = t.get_phylo_model_param_block_map()
    blocks["frequencies"][2] = [0.1, 0.2, 0.3, 0.4]
    mat = t.resize_phylo_model_params(20)
    assert mat.shape == (20, 10) and t.get_phylo_model_params() is mat
    np.testing.assert_allclose(mat[2, 6:10], [0.1, 0.2, 0.3, 0.4])
    np.testing.assert_allclose(mat[3], mat[0])
    t.prepare_for_phylo_likelihood(
        lt.PhyloModelSpec("GTR", "constant", "none"), tree_count_option=4,
        device="cpu")
    j.prepare_for_phylo_likelihood(
        JSpec("GTR", "constant", "none"), tree_count_option=4)
    np.testing.assert_array_equal(t.get_phylo_model_params(),
                                  j.get_phylo_model_params())
    with pytest.raises(ValueError, match="rows < 10 trees"):
        t.log_likelihoods()


def rooted_pair(data_dir):
    """(libsbn_tpu, port) RootedInstances on fluA (GTR, strict clock at
    0.001), the one tree duplicated so that the collection has two, with
    distinct frequencies and exchangeabilities per row."""
    out = []
    for lib, spec, coll, kw in (
            (jl, JSpec, JRootedCollection, {}),
            (lt, lt.PhyloModelSpec, RootedTreeCollection, {"device": "cpu"})):
        inst = lib.RootedInstance("rooted per-tree")
        inst.read_newick_file(f"{data_dir}/fluA.tree")
        inst.read_fasta_file(f"{data_dir}/fluA.fa")
        inst.parse_dates_from_taxon_names(True)
        inst.process_loaded_trees()
        inst.prepare_for_phylo_likelihood(spec("GTR", "constant", "strict"),
                                          **kw)
        inst.set_clock_rates(0.001)
        tree = inst.tree_collection.trees[0]
        inst.tree_collection = coll(
            [tree, tree], inst.tree_collection.tag_taxon_map,
            inst.tree_collection.tag_date_map)
        inst.resize_phylo_model_params(2)
        blocks = inst.get_phylo_model_param_block_map()
        blocks["frequencies"][0] = [0.3, 0.25, 0.2, 0.25]
        blocks["frequencies"][1] = [0.2, 0.3, 0.25, 0.25]
        blocks["GTR rates"][:] = np.random.default_rng(11).dirichlet(
            np.full(6, 20.0), size=2)
        out.append(inst)
    return out


def test_rooted_per_tree_rows(data_dir):
    """Rooted time trees with distinct rows: LL + log-det-Jacobian, the
    unrooted LLs and every gradient key against libsbn_tpu (rel 1e-10),
    and each row against the shared path (rel 1e-10)."""
    j, t = rooted_pair(data_dir)
    rel_close(t.log_likelihoods(), j.log_likelihoods(), 1e-10, "rooted LL")
    rel_close(t.unrooted_log_likelihoods(), j.unrooted_log_likelihoods(),
              1e-10, "unrooted LL")
    grads = t.phylo_gradients()
    want = j.phylo_gradients()
    for key in ("log_likelihood", "ratios_root_height", "clock_model",
                "substitution_model"):
        rel_close(host(grads[key]), host(want[key]), 1e-10, key)
    entire = t.get_phylo_model_params().copy()
    lls = t.log_likelihoods()
    for i in range(2):
        t.set_phylo_model_params_from_flat(entire[i])
        shared = t.phylo_gradients()
        for key in ("log_likelihood", "ratios_root_height", "clock_model",
                    "substitution_model"):
            rel_close(host(grads[key])[i], host(shared[key])[i], 1e-10,
                      f"tree {i}, {key}")
        rel_close(lls[i], t.log_likelihoods()[i], 1e-10, f"tree {i} LL")


def test_rooted_per_tree_jc69_takes_the_autograd_route(data_dir):
    """JC69 Weibull+4 rooted rows that differ in the shape: the gradients
    take the autograd route (K2 + K3 twins, not K1's) and equal each row's
    shared call (rel 1e-10)."""
    t = lt.RootedInstance("rooted jc")
    t.read_newick_file(f"{data_dir}/fluA.tree")
    t.read_fasta_file(f"{data_dir}/fluA.fa")
    t.parse_dates_from_taxon_names(True)
    t.prepare_for_phylo_likelihood(
        lt.PhyloModelSpec("JC69", "weibull+4", "strict"), tree_count_option=2,
        device="cpu")
    t.set_clock_rates(0.001)
    tree = t.tree_collection.trees[0]
    t.tree_collection = RootedTreeCollection(
        [tree, tree], t.tree_collection.tag_taxon_map,
        t.tree_collection.tag_date_map)
    t.get_phylo_model_param_block_map()["Weibull shape"][:, 0] = [0.3, 1.7]
    for m in COUNTED:
        m.reset_counters()
    grads = t.phylo_gradients()
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 0
    assert pruning_jc.TWIN_CALLS["ll_dea_jc69"] >= 1
    entire = t.get_phylo_model_params().copy()
    for i in range(2):
        t.set_phylo_model_params_from_flat(entire[i])
        shared = t.phylo_gradients()
        for key in ("log_likelihood", "ratios_root_height", "clock_model",
                    "site_model"):
            rel_close(host(grads[key])[i], host(shared[key])[i], 1e-10,
                      f"tree {i}, {key}")


def test_per_tree_parameters_must_lead_with_the_trees(data_dir):
    _, t = unrooted_pair(data_dir)
    params = {"substitution": {
        "rates": torch.full((3, 6), 1 / 6.0, dtype=torch.float64),
        "frequencies": torch.full((3, 4), 0.25, dtype=torch.float64)}}
    with pytest.raises(ValueError, match="lead with the 10 trees"):
        t.engine.log_likelihoods(t._batched_schedule(),
                                 t.branch_length_matrix(), params,
                                 per_tree=True)
