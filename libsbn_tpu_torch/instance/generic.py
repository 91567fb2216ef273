"""Generic instance: the user-facing orchestrator.

The counterpart of libsbn_tpu.instance.generic (the reference's
GenericSBNInstance, generic_sbn_instance.hpp, and its pybind bindings):
load trees and an alignment, build the SBN support, train it by simple
average, sample topologies, and prepare the likelihood engine on the
device the caller names. ``sbn_parameters`` is a writable numpy array, as
the reference's mutable view is. EM training, the probabilities of tree
collections, CSV I/O and the per-tree parameter matrix are ROADMAP queue 1,
item 5.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..io import newick
from ..io.fasta import Alignment
from ..models.engine import PER_TREE_TODO, LikelihoodEngine
from ..models.phylo_model import (
    PhyloModelSpec, block_specification, default_parameters,
    parameters_from_flat,
)
from ..ops import schedule as schedule_ops
from ..sbn import probability as sbn_probability
from ..sbn import sampling
from ..sbn.support import PSPIndexer
from ..utils.device import DEFAULT_DEVICE

EM_TODO = "EM training is not ported yet (ROADMAP queue 1, item 5)"


class GenericSBNInstance:
    support_class = None  # set by subclasses
    collection_class = None
    rooted = True

    def __init__(self, name: str = "libsbn_tpu_torch"):
        self.name = name
        self.tree_collection = None
        self.alignment: Optional[Alignment] = None
        self.topology_counter = {}
        self.sbn_support = self.support_class()
        self.sbn_parameters = np.zeros(0)
        self.psp_indexer = PSPIndexer()
        self.engine: Optional[LikelihoodEngine] = None
        self.phylo_model_spec: Optional[PhyloModelSpec] = None
        self.phylo_model_params: Dict = {}
        self._sampler: Optional[sampling.SBNSampler] = None
        self._seed = 0

    # -- I/O ----------------------------------------------------------------
    def read_newick_file(self, path: str):
        tops, bls, ttm = newick.parse_newick_file(path)
        self._set_trees(tops, bls, ttm)

    def read_nexus_file(self, path: str):
        tops, bls, ttm = newick.parse_nexus_file(path)
        self._set_trees(tops, bls, ttm)

    def read_fasta_file(self, path: str):
        self.alignment = Alignment.read_fasta(path)

    def _set_trees(self, tops, bls, ttm):
        trees = [
            self.collection_class.tree_class(t, b) for t, b in zip(tops, bls)
        ]
        self.tree_collection = self.collection_class(trees, ttm)

    def tree_count(self) -> int:
        return self.tree_collection.tree_count() if self.tree_collection else 0

    def taxon_names(self) -> List[str]:
        return self.tree_collection.taxon_names()

    # -- SBN support & training ---------------------------------------------
    def process_loaded_trees(self):
        self._check_trees_loaded()
        self.topology_counter = self.tree_collection.topology_counter()
        self.sbn_support = self.support_class(
            self.topology_counter, self.tree_collection.taxon_names()
        )
        self.sbn_parameters = np.ones(self.sbn_support.gpcsp_count)
        self.psp_indexer = self.sbn_support.build_psp_indexer()
        self._sampler = None

    def train_simple_average(self):
        self._check_support()
        tops = list(self.topology_counter.keys())
        counts = np.asarray(
            [self.topology_counter[t] for t in tops], dtype=np.float64
        )
        reps = self.sbn_support.dense_representations(tops)
        # A writable numpy array, like the reference's mutable view
        # (pylibsbn.cpp:28-48) that vip's optimizer writes through.
        self.sbn_parameters = sbn_probability.simple_average(
            reps, counts, self.sbn_support.gpcsp_count
        ).numpy()
        self._sampler = None

    def train_expectation_maximization(self, *args, **kwargs):
        raise NotImplementedError(EM_TODO)

    def pretty_indexer(self) -> List[str]:
        return self.sbn_support.pretty_indexer()

    def normalized_sbn_parameters(self) -> np.ndarray:
        """The SBN parameters as probabilities, normalised within each
        block (rootsplits, then each parent subsplit's children)."""
        seg = self.sbn_support.segment_ids()
        num_segments = int(seg.max(initial=0)) + 1
        return torch.exp(sbn_probability.probability_normalize_in_log(
            torch.as_tensor(np.asarray(self.sbn_parameters, np.float64)),
            torch.as_tensor(seg), num_segments,
        )).numpy()

    def pretty_indexed_sbn_parameters(self):
        return list(zip(self.pretty_indexer(),
                        self.normalized_sbn_parameters()))

    # -- sampling ------------------------------------------------------------
    def set_seed(self, seed: int):
        self._seed = seed
        if self._sampler is not None:
            self._sampler.set_seed(seed)

    def _get_sampler(self) -> sampling.SBNSampler:
        if self._sampler is None:
            self._sampler = sampling.SBNSampler(
                self.sbn_support, self.sbn_parameters, self._seed
            )
        return self._sampler

    def sample_topology(self):
        self._check_support()
        return self._get_sampler().sample_topology(self.rooted)

    # -- phylogenetic likelihood ---------------------------------------------
    def prepare_for_phylo_likelihood(
        self, spec: PhyloModelSpec, thread_count: int = 1, beagle_flags=(),
        use_tip_states: bool = False, tree_count_option: Optional[int] = None,
        rescaling: bool = True, *, device=DEFAULT_DEVICE, dtype=None,
    ):
        """Create the likelihood engine. Argument order matches the reference
        binding (pylibsbn.cpp:196-199); thread_count and beagle_flags are
        accepted for that parity and ignored (one batched launch replaces
        the thread pool; there is no BEAGLE).

        device: where the engine computes; the card unless the caller
        passes device="cpu" (without a card the default raises). dtype:
        float64 unless the caller names float32."""
        self._check_trees_loaded()
        if self.alignment is None:
            raise RuntimeError("Please read a FASTA file first.")
        if tree_count_option is not None:
            raise NotImplementedError(PER_TREE_TODO)
        dtype = torch.float64 if dtype is None else dtype
        site_pattern = SitePattern(
            self.alignment, self.tree_collection.tag_taxon_map
        )
        engine = LikelihoodEngine(
            site_pattern, spec, rescale=rescaling, dtype=dtype, device=device,
            use_tip_states=use_tip_states,
        )
        self.phylo_model_spec = spec
        self.phylo_model_params = default_parameters(
            spec, dtype=torch.float64, device=device
        )
        self.engine = engine
        return engine

    def get_phylo_model_block_specification(self):
        return block_specification(self.phylo_model_spec)

    def set_phylo_model_params_from_flat(self, v):
        """Set the model parameters from a flat vector in the block
        specification's layout, as tensors on the engine's device."""
        self.phylo_model_params = parameters_from_flat(
            self.phylo_model_spec, v, dtype=torch.float64,
            device=self._get_engine().device,
        )

    def _get_engine(self) -> LikelihoodEngine:
        if self.engine is None:
            raise RuntimeError(
                "Engine not available. Call prepare_for_phylo_likelihood first."
            )
        return self.engine

    def _batched_schedule(self):
        return schedule_ops.schedules_of_topologies(
            [t.topology for t in self.tree_collection.trees]
        )

    def branch_length_matrix(self) -> np.ndarray:
        return self.tree_collection.branch_length_matrix()

    # -- checks ---------------------------------------------------------------
    def _check_trees_loaded(self):
        if self.tree_collection is None or not self.tree_collection.trees:
            raise RuntimeError("Please load some trees into your SBN instance.")

    def _check_support(self):
        if self.sbn_support.empty():
            raise RuntimeError(
                "Please call process_loaded_trees to prepare your SBN support."
            )
