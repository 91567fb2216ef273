"""The port's pylibsbn binding surface against the reference's name tables.

The tables are the ones tests/test_api_names.py holds libsbn_tpu to,
extracted from the reference's Python bindings (pylibsbn.cpp) and the vip
package. They are copied here as data: this file imports neither JAX nor
that module, so it also runs where only the port is installed.

The port was built slice by slice; ``OWED`` listed the names still owed by
the ROADMAP queue 1 item that brings each, and every table had to lack
exactly its owed names. It is empty now: every table must be whole, so a
name that goes missing fails the test.
"""

import importlib

import pytest
import torch

import libsbn_tpu_torch
from libsbn_tpu_torch.gp import GPInstance

torch.set_num_threads(1)

ROOTED_TREE_NAMES = [
    "parent_id_vector", "initialize_time_tree_using_height_ratios",
    "example", "of_parent_id_vector", "branch_lengths", "height_ratios",
    "node_heights", "node_bounds", "rates",
]
PSP_INDEXER_NAMES = ["details"]
GENERIC_INSTANCE_NAMES = [
    "get_phylo_model_params", "get_phylo_model_param_block_map",
    "prepare_for_phylo_likelihood", "resize_phylo_model_params",
    "read_fasta_file", "taxon_names", "print_status", "tree_count",
    "process_loaded_trees", "train_simple_average", "sbn_parameters_to_csv",
    "read_sbn_parameters_from_csv", "calculate_sbn_probabilities",
    "log_likelihoods", "set_rescaling", "phylo_gradients",
    "read_newick_file", "read_nexus_file", "tree_collection",
]
ROOTED_INSTANCE_NAMES = [
    "unconditional_subsplit_probabilities_to_csv", "set_dates_to_be_constant",
    "parse_dates_from_taxon_names", "parse_dates_from_csv",
]
UNROOTED_INSTANCE_NAMES = [
    "train_expectation_maximization", "sample_trees",
    "make_indexer_representations", "make_psp_indexer_representations",
    "split_lengths", "split_counters", "topology_gradients", "psp_indexer",
]
GP_INSTANCE_NAMES = [
    "print_status", "print_dag", "read_newick_file", "read_nexus_file",
    "read_fasta_file", "sbn_parameters_to_csv", "sbn_prior_to_csv",
    "branch_lengths_to_csv", "export_trees", "export_all_generated_trees",
    "export_trees_with_a_pcsp", "subsplit_dag_to_dot", "make_engine",
    "hot_start_branch_lengths", "calculate_hybrid_marginals",
    "estimate_sbn_parameters", "estimate_branch_lengths",
]
MODULE_NAMES = [
    "rooted_instance", "unrooted_instance", "gp_instance",
    "PhyloModelSpecification", "ratio_gradient_of_height_gradient",
]
# The vip layer's public names, by module of the port's ``vi`` package.
VIP_SURFACE = {
    "benchmark": ["fixed"],
    "branch_models": ["BranchModel", "SplitModel", "PSPModel", "of_name"],
    "burrito": ["Burrito"],
    "cli": ["cli", "benchmark"],
    "optimizers": [
        "BaseOptimizer", "SimpleOptimizer", "BumpStepsizeOptimizer", "of_name"],
    "priors": ["log_exp_prior", "grad_log_exp_prior"],
    "sbn_model": ["SBNModel"],
    "scalar_models": [
        "ScalarModel", "LogNormalModel", "TFScalarModel", "of_name"],
    "sgd_server": ["SGD_Server"],
}

# The public names of libsbn_tpu's parallel layer and its profiling and
# CPU-baseline helpers, by module of the port (ROADMAP items 11 and 12): the
# modules keep their libsbn_tpu paths; the two dp-sharded kernel wrappers
# (libsbn_tpu/ops/pruning_pallas_jc.py:705, ops/pruning_pallas.py:417) sit
# beside the port's unsharded K1 and K4 wrappers.
PARALLEL_SURFACE = {
    "parallel.sharding": [
        "make_mesh", "particle_sharding", "pattern_sharding", "replicated",
        "shard_particle_batch", "pad_to_multiple"],
    "parallel.distributed": [
        "initialize", "global_mesh", "local_particle_count",
        "from_process_local"],
    "utils.profiling": ["device_trace", "annotate", "PhaseTimer"],
    "utils.cpu_baseline": ["eval_batch", "eval_batch_ll_pk"],
    "ops.pruning_jc": ["log_likelihood_and_branch_gradient_jc69_sharded"],
    "ops.pruning_generic": [
        "log_likelihood_and_branch_gradient_generic_sharded"],
}

# ROADMAP queue 1 item -> {table: names the port still lacks}. Items 5 (the
# instance surface and EM) and 10 (the vip layer) were the last to owe
# names; the port now has every table whole.
OWED = {}


def _unrooted(data_dir):
    inst = libsbn_tpu_torch.unrooted_instance("names")
    inst.read_newick_file(f"{data_dir}/hello.nwk")
    inst.read_fasta_file(f"{data_dir}/hello.fasta")
    inst.process_loaded_trees()
    return inst


def _rooted(data_dir):
    inst = libsbn_tpu_torch.rooted_instance("names")
    inst.read_newick_file(f"{data_dir}/fluA.tree")
    inst.read_fasta_file(f"{data_dir}/fluA.fa")
    inst.parse_dates_from_taxon_names(True)
    inst.process_loaded_trees()
    return inst


def _missing_in(package, surface):
    """The names of ``surface`` ({module: names}) that the modules under
    ``package`` lack, as "module.name"."""
    missing = []
    for module, names in surface.items():
        try:
            mod = importlib.import_module(f"{package}.{module}")
        except ModuleNotFoundError:
            mod = None
        missing += [f"{module}.{n}" for n in names if not hasattr(mod, n)]
    return missing


def _missing_vip():
    return _missing_in("libsbn_tpu_torch.vi", VIP_SURFACE)


def _missing(table, data_dir):
    """The names of ``table`` that the port lacks, in the table's order."""
    if table == "vip":
        return _missing_vip()
    if table == "parallel":
        return _missing_in("libsbn_tpu_torch", PARALLEL_SURFACE)
    obj, names = {
        "module": lambda: (libsbn_tpu_torch, MODULE_NAMES),
        "generic": lambda: (_unrooted(data_dir), GENERIC_INSTANCE_NAMES),
        "unrooted": lambda: (_unrooted(data_dir), UNROOTED_INSTANCE_NAMES),
        "rooted": lambda: (_rooted(data_dir),
                           GENERIC_INSTANCE_NAMES + ROOTED_INSTANCE_NAMES),
        "rooted_tree": lambda: (_rooted(data_dir).tree_collection.trees[0],
                                ROOTED_TREE_NAMES),
        "gp": lambda: (libsbn_tpu_torch.gp_instance(), GP_INSTANCE_NAMES),
        "psp_indexer": lambda: (_unrooted(data_dir).psp_indexer,
                                PSP_INDEXER_NAMES),
    }[table]()
    return [n for n in names if not hasattr(obj, n)]


TABLES = ["module", "generic", "unrooted", "rooted", "rooted_tree", "gp",
          "psp_indexer", "vip", "parallel"]


@pytest.mark.parametrize("table", TABLES)
def test_port_lacks_exactly_the_owed_names(table, data_dir):
    """Each table's missing names equal what OWED lists for it."""
    owed = [n for item in OWED.values() for n in item.get(table, [])]
    assert _missing(table, data_dir) == owed


def test_owed_names_belong_to_open_items():
    """No item owes a name any more: OWED is empty, and the vip surface
    covers every module of the reference's vip package, mapped to
    libsbn_tpu_torch.vi.*."""
    assert OWED == {}
    assert _missing_vip() == []
    assert set(VIP_SURFACE) == {
        "benchmark", "branch_models", "burrito", "cli", "optimizers",
        "priors", "sbn_model", "scalar_models", "sgd_server"}


def test_module_factories_are_the_classes():
    """The reference's factory names are the instance classes themselves,
    and the top level exports PSPIndexer (sbn/support.py) and
    ratio_gradient_of_height_gradient (instance/rooted.py)."""
    from libsbn_tpu_torch.instance import rooted
    from libsbn_tpu_torch.sbn.support import PSPIndexer

    assert libsbn_tpu_torch.unrooted_instance is libsbn_tpu_torch.UnrootedInstance
    assert libsbn_tpu_torch.rooted_instance is libsbn_tpu_torch.RootedInstance
    assert (libsbn_tpu_torch.ratio_gradient_of_height_gradient
            is rooted.ratio_gradient_of_height_gradient)
    assert libsbn_tpu_torch.gp_instance is GPInstance
    assert libsbn_tpu_torch.PSPIndexer is PSPIndexer
    assert {"gp_instance", "PSPIndexer", "rooted_instance", "RootedInstance",
            "ratio_gradient_of_height_gradient"} <= set(libsbn_tpu_torch.__all__)
    spec = libsbn_tpu_torch.PhyloModelSpecification(
        substitution="JC69", site="weibull+4", clock="strict")
    assert spec.site_category_count() == 4
