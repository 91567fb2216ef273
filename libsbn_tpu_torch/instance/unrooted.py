"""Unrooted instance (the reference's unrooted_sbn_instance.{hpp,cpp}; the
counterpart of libsbn_tpu.instance.unrooted)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.tree import UnrootedTree, UnrootedTreeCollection
from ..sbn import gradients as sbn_gradients
from ..sbn import maps
from ..sbn import probability as sbn_probability
from ..sbn.support import UnrootedSBNSupport
from ..utils.device import DEFAULT_DEVICE, compute_device
from .generic import GenericSBNInstance


class UnrootedInstance(GenericSBNInstance):
    support_class = UnrootedSBNSupport
    collection_class = UnrootedTreeCollection
    rooted = False

    # -- training ------------------------------------------------------------
    def train_expectation_maximization(
        self, alpha: float, max_iter: int, score_epsilon: float = 0.0,
        progress: bool = False, *, device=DEFAULT_DEVICE,
        cuda_graphs: bool = True,
    ) -> np.ndarray:
        """EM training of the SBN parameters (sbn_probability.cpp
        ExpectationMaximization) in float64 on ``device``: the card unless
        the caller passes device="cpu", where each iteration replays the
        step's CUDA graph unless ``cuda_graphs`` is False. Stores a writable
        float64 numpy copy of the parameters and returns the score
        history."""
        self._check_support()
        reps, counts = self._dense_counter()
        dev = compute_device(device)
        params, score_history = sbn_probability.expectation_maximization(
            torch.as_tensor(reps, device=dev),
            counts,
            torch.as_tensor(self.sbn_support.segment_ids(), device=dev),
            self.sbn_support.gpcsp_count,
            alpha=alpha, max_iter=max_iter, score_epsilon=score_epsilon,
            progress=progress, cuda_graphs=cuda_graphs,
        )
        self.sbn_parameters = params.cpu().numpy().copy()
        self._sampler = None
        return score_history

    def split_counters(self):
        """(rootsplit counter, PCSP counter) as string-keyed maps, recomputed
        from the loaded trees (unrooted_sbn_instance.cpp SplitCounters)."""
        counter = self.tree_collection.topology_counter()
        rootsplits = {
            b.to_string(): c
            for b, c in maps.unrooted_rootsplit_counter_of(counter).items()
        }
        pcsps = {
            parent.to_string(): {
                child.to_string(): c for child, c in children.items()
            }
            for parent, children in maps.unrooted_pcsp_counter_of(
                counter).items()
        }
        return rootsplits, pcsps

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
        """(trees,) log likelihoods of the loaded trees, on the host; each
        tree with its own row of the parameter matrix where rows differ."""
        engine = self._get_engine()
        params, per_tree = self._compute_params()
        lls = engine.log_likelihoods(
            self._batched_schedule(), self.branch_length_matrix(), params,
            per_tree=per_tree,
        )
        return lls.cpu().numpy()

    def phylo_gradients(self):
        """Gradient dict (``log_likelihood``, ``branch_lengths``,
        ``substitution_model`` for GTR and ``site_model`` for Weibull
        models) of tensors on the engine's device; each tree with its own
        row of the parameter matrix where rows differ."""
        engine = self._get_engine()
        params, per_tree = self._compute_params()
        return engine.phylo_gradients(
            self._batched_schedule(), self.branch_length_matrix(), params,
            per_tree=per_tree,
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
