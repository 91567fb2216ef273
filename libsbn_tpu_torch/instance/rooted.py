"""Rooted instance (the reference's rooted_sbn_instance.{hpp,cpp}; the
counterpart of libsbn_tpu.instance.rooted): time trees with tip dates,
their likelihoods with the height-ratio Jacobian and their gradients."""

from __future__ import annotations

import csv as csv_mod

import numpy as np
import torch

from ..core.tree import RootedTree, RootedTreeCollection
from ..ops import heights as heights_ops
from ..ops import schedule as schedule_ops
from ..sbn.support import RootedSBNSupport
from ..utils.device import DEFAULT_DEVICE, compute_device
from .generic import GenericSBNInstance


class RootedInstance(GenericSBNInstance):
    support_class = RootedSBNSupport
    collection_class = RootedTreeCollection
    rooted = True

    # -- tip dates -----------------------------------------------------------
    def set_dates_to_be_constant(self, initialize_time_trees: bool):
        self.tree_collection.set_dates_to_be_constant(initialize_time_trees)

    def parse_dates_from_taxon_names(self, initialize_time_trees: bool):
        self.tree_collection.parse_dates_from_taxon_names(initialize_time_trees)

    def parse_dates_from_csv(self, path: str, initialize_time_trees: bool):
        self.tree_collection.parse_dates_from_csv(path, initialize_time_trees)

    def set_clock_rates(self, rate: float):
        """Give every branch of every tree the clock rate ``rate``."""
        for t in self.tree_collection.trees:
            t.rates = np.full(t.node_count() - 1, rate)
            t.rate_count = 1

    # -- sampling ------------------------------------------------------------
    def sample_trees(self, count: int):
        """Replace the tree collection with ``count`` rooted topologies
        sampled from the SBN (branch lengths zero, no time-tree state)."""
        self._check_support()
        node_count = 2 * self.sbn_support.taxon_count() - 1
        trees = [
            RootedTree(self.sample_topology(), np.zeros(node_count))
            for _ in range(count)
        ]
        self.tree_collection = RootedTreeCollection(
            trees, self.tree_collection.tag_taxon_map,
            self.tree_collection.tag_date_map,
        )

    # -- time-tree state -----------------------------------------------------
    def _time_tree_arrays(self):
        """(bounds (B, N), ratios (B, L-1), rates (B, N-1)) of the trees,
        float64 numpy."""
        trees = self.tree_collection.trees
        if any(
            t.node_bounds is None or t.rates is None or t.height_ratios is None
            for t in trees
        ):
            # The reference's precondition (rooted_tree.hpp:55-63
            # EnsureTipDatesHaveBeenSet).
            raise RuntimeError(
                "Attempted access of a time tree member that requires the "
                "tip dates to be set. Have you set dates for your time "
                "trees? (parse_dates_from_taxon_names / parse_dates_from_csv"
                " / set_dates_to_be_constant)"
            )
        bounds = np.stack([t.node_bounds for t in trees])
        ratios = np.stack([t.height_ratios for t in trees])
        rates = np.stack([t.rates[: t.node_count() - 1] for t in trees])
        return bounds, ratios, rates

    # -- likelihoods ---------------------------------------------------------
    def unrooted_log_likelihoods(self) -> np.ndarray:
        """(trees,) pruning log likelihoods of the trees' branch lengths,
        without rate scaling or the height Jacobian
        (RootedSBNInstance::UnrootedLogLikelihoods), on the host."""
        lls = self._get_engine().log_likelihoods(
            self._batched_schedule(), self.branch_length_matrix(),
            self.phylo_model_params,
        )
        return lls.cpu().numpy()

    def log_likelihoods(self) -> np.ndarray:
        """(trees,) LL + log-det-Jacobian of the height transform
        (fat_beagle.cpp LogLikelihood(RootedTree)), on the host."""
        bounds, ratios, rates = self._time_tree_arrays()
        lls = self._get_engine().rooted_log_likelihoods(
            self._batched_schedule(), bounds, ratios, rates,
            self.phylo_model_params,
        )
        return lls.cpu().numpy()

    def phylo_gradients(self):
        """Gradient dict (``log_likelihood`` without the Jacobian,
        ``ratios_root_height``, ``clock_model``, and ``substitution_model``
        / ``site_model`` where the model has them) of tensors on the
        engine's device."""
        bounds, ratios, rates = self._time_tree_arrays()
        strict = all(t.rate_count == 1 for t in self.tree_collection.trees)
        return self._get_engine().rooted_phylo_gradients(
            self._batched_schedule(), bounds, ratios, rates,
            self.phylo_model_params, strict_clock=strict,
        )

    # -- subsplit probabilities ----------------------------------------------
    def unconditional_subsplit_probabilities(self):
        """{subsplit: probability} through a subsplit DAG of the trees
        (rooted_sbn_instance.cpp:19-40). The DAG's GPCSPs other than the
        fake ones are laid out as the support's; the fake-subsplit edges
        get probability one."""
        if not self.tree_collection or not self.tree_collection.trees:
            raise RuntimeError(
                "Please load some trees before trying to calculate "
                "unconditional subsplit probabilities."
            )
        from ..gp.subsplit_dag import SubsplitDAG

        dag = SubsplitDAG.of_tree_collection(self.tree_collection)
        params = self.normalized_sbn_parameters()
        if params.size != dag.gpcsp_count():
            raise ValueError("GPCSP count mismatch between the SBN support "
                             "and the subsplit DAG.")
        expanded = np.ones(dag.gpcsp_count_with_fake())
        expanded[: params.size] = params
        return dag.unconditional_subsplit_probabilities(expanded)

    def unconditional_subsplit_probabilities_to_csv(self, path: str):
        """subsplit-string,probability rows (rooted_sbn_instance.cpp:36-40)."""
        with open(path, "w", newline="") as f:
            writer = csv_mod.writer(f)
            for subsplit, prob in (
                self.unconditional_subsplit_probabilities().items()
            ):
                writer.writerow([subsplit.to_string(), prob])


def ratio_gradient_of_height_gradient(tree, height_gradient, *,
                                      device=DEFAULT_DEVICE) -> np.ndarray:
    """J^T g: a gradient with respect to the internal nodes' heights
    (L-1,) as one with respect to (height ratios..., root height), for
    J = d heights / d ratios, without the log-det-Jacobian term (the
    reference's ``ratio_gradient_of_height_gradient``, pylibsbn.cpp:378,
    rooted_gradient_transforms.cpp:132-175). By autograd through
    ops/heights.py in float64 on ``device`` (the card unless the caller
    passes device="cpu"); returns numpy."""
    device = compute_device(device)
    sched = schedule_ops.schedules_of_topologies([tree.topology])
    leaf_count = sched.leaf_count

    def tensor(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)[None]

    with torch.enable_grad():
        ratios = tensor(tree.height_ratios).requires_grad_(True)
        h = heights_ops.node_heights_from_ratios(
            ratios, tensor(tree.node_bounds), leaf_count,
            tensor(sched.pre_internal_node[0], torch.int64),
            tensor(sched.pre_internal_parent[0], torch.int64),
        )
        (grad,) = torch.autograd.grad(
            h[:, leaf_count:], ratios, tensor(height_gradient))
    return grad[0].cpu().numpy()
