"""Unrooted instance (the reference's unrooted_sbn_instance.{hpp,cpp}; the
counterpart of libsbn_tpu.instance.unrooted)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.tree import UnrootedTree, UnrootedTreeCollection
from ..sbn import gradients as sbn_gradients
from ..sbn.support import UnrootedSBNSupport
from .generic import GenericSBNInstance


class UnrootedInstance(GenericSBNInstance):
    support_class = UnrootedSBNSupport
    collection_class = UnrootedTreeCollection
    rooted = False

    # -- sampling ------------------------------------------------------------
    def sample_trees(self, count: int):
        """Replace the tree collection with ``count`` topologies sampled from
        the SBN (branch lengths zero)."""
        self._check_support()
        taxon_count = self.sbn_support.taxon_count()
        if taxon_count <= 2:
            raise ValueError("Can't sample an unrooted tree with < 3 taxa.")
        edge_count = 2 * taxon_count - 2
        trees = [
            UnrootedTree(self.sample_topology(), np.zeros(edge_count))
            for _ in range(count)
        ]
        self.tree_collection = UnrootedTreeCollection(
            trees, self.tree_collection.tag_taxon_map
        )

    # -- PSP -----------------------------------------------------------------
    def make_psp_indexer_representations(self) -> List[List[List[int]]]:
        return [
            self.psp_indexer.representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def split_lengths(self):
        return self.psp_indexer.split_lengths(self.tree_collection)

    # -- likelihoods ---------------------------------------------------------
    def log_likelihoods(self) -> np.ndarray:
        """(trees,) log likelihoods of the loaded trees, on the host."""
        engine = self._get_engine()
        lls = engine.log_likelihoods(
            self._batched_schedule(), self.branch_length_matrix(),
            self.phylo_model_params,
        )
        return lls.cpu().numpy()

    def phylo_gradients(self):
        """Gradient dict (``log_likelihood``, ``branch_lengths``, and
        ``site_model`` for Weibull models) of tensors on the engine's
        device."""
        engine = self._get_engine()
        return engine.phylo_gradients(
            self._batched_schedule(), self.branch_length_matrix(),
            self.phylo_model_params,
        )

    # -- topology gradients (the VBPI hot path) ------------------------------
    def topology_gradients(self, log_f, use_vimco: bool = True) -> np.ndarray:
        """Σ_j factor_j ∇_φ log q(τ_j) over the current tree collection, on
        the host in float64."""
        self._check_support()
        seg = self.sbn_support.segment_ids()
        num_segments = int(seg.max(initial=0)) + 1
        reps = self.sbn_support.dense_representations(
            [t.topology for t in self.tree_collection.trees]
        )
        touched = sbn_gradients.touched_segments_of(self.sbn_support, reps)
        return sbn_gradients.topology_gradients(
            torch.as_tensor(np.asarray(self.sbn_parameters, np.float64)),
            torch.as_tensor(seg),
            num_segments,
            torch.as_tensor(reps),
            torch.as_tensor(touched),
            torch.as_tensor(np.asarray(log_f, np.float64)),
            use_vimco=use_vimco,
        ).numpy()

    def gradient_of_log_q(self, topology) -> np.ndarray:
        rep = self.sbn_support.dense_representations([topology])[0]
        return sbn_gradients.gradient_of_log_q(
            self.sbn_support, self.sbn_parameters, rep
        ).numpy()
