"""Generic instance: the user-facing orchestrator.

The counterpart of libsbn_tpu.instance.generic (the reference's
GenericSBNInstance, generic_sbn_instance.hpp, and its pybind bindings):
load trees and an alignment, build the SBN support, train it, sample
topologies, compute the probabilities of the loaded trees, read and write
the SBN parameters as CSV, and prepare the likelihood engine on the device
the caller names. ``sbn_parameters`` is a writable float64 numpy array, as
the reference's mutable view is; assigning it hands the new array to a
sampler already built, as the reference's in-place update does. The
per-tree parameter matrix is a writable numpy array with one row per tree,
whose named column blocks are views (GetPhyloModelParams /
GetPhyloModelParamBlockMap); at compute time identical rows collapse to
the shared parameters and rows that differ become model tensors with a
leading tree axis on the engine's device (``_compute_params``).
"""

from __future__ import annotations

import csv as csv_mod
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..io import newick
from ..io.fasta import Alignment
from ..models.engine import LikelihoodEngine
from ..models.phylo_model import (
    PhyloModelSpec, block_specification, default_parameters,
    flat_from_parameters, parameters_from_flat,
)
from ..ops import schedule as schedule_ops
from ..sbn import maps
from ..sbn import probability as sbn_probability
from ..sbn import sampling
from ..sbn.support import PSPIndexer
from ..utils.device import DEFAULT_DEVICE

DOUBLE_MINIMUM = -np.finfo(np.float64).max


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
        self._sampler: Optional[sampling.SBNSampler] = None
        self.sbn_parameters = np.zeros(0)
        self.psp_indexer = PSPIndexer()
        self.engine: Optional[LikelihoodEngine] = None
        self.phylo_model_spec: Optional[PhyloModelSpec] = None
        self.phylo_model_params: Dict = {}
        self.phylo_model_params_matrix: Optional[np.ndarray] = None
        self.rescaling = True
        self._seed = 0

    @property
    def sbn_parameters(self) -> np.ndarray:
        return self._sbn_parameters

    @sbn_parameters.setter
    def sbn_parameters(self, value):
        """Store ``value``; a sampler already built draws from it from its
        next draw on, its random stream continuing (the reference's
        sampler reads the vector that training updates in place)."""
        self._sbn_parameters = value
        if self._sampler is not None:
            self._sampler.refresh_parameters(value)

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
        reps, counts = self._dense_counter()
        # A writable numpy array, like the reference's mutable view
        # (pylibsbn.cpp:28-48) that vip's optimizer writes through.
        self.sbn_parameters = sbn_probability.simple_average(
            reps, counts, self.sbn_support.gpcsp_count
        ).numpy()
        self._sampler = None

    def _dense_counter(self):
        """(reps, counts) of the distinct loaded topologies, numpy."""
        tops = list(self.topology_counter.keys())
        counts = np.asarray(
            [self.topology_counter[t] for t in tops], dtype=np.float64
        )
        return self.sbn_support.dense_representations(tops), counts

    def _segments(self):
        """(segment ids (G,) tensor, segment count) of the support."""
        seg = self.sbn_support.segment_ids()
        return torch.as_tensor(seg), int(seg.max(initial=0)) + 1

    def _normalized_log_parameters(self):
        """The SBN parameters normalised within each block, in log space,
        as a float64 CPU tensor."""
        seg, num_segments = self._segments()
        return sbn_probability.probability_normalize_in_log(
            torch.as_tensor(np.asarray(self.sbn_parameters, np.float64)),
            seg, num_segments,
        )

    def calculate_sbn_probabilities(self) -> np.ndarray:
        """(trees,) SBN probabilities of the loaded trees, on the host in
        float64 (summed over rootings for unrooted trees)."""
        self._check_support()
        reps = self.sbn_support.dense_representations(
            [t.topology for t in self.tree_collection.trees]
        )
        fn = (sbn_probability.probability_of_rooted_collection if self.rooted
              else sbn_probability.probability_of_unrooted_collection)
        return fn(self._normalized_log_parameters(), reps).numpy()

    def make_indexer_representations(self):
        return [
            self.sbn_support.indexer_representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def pretty_indexer(self) -> List[str]:
        return self.sbn_support.pretty_indexer()

    def normalized_sbn_parameters(self) -> np.ndarray:
        """The SBN parameters as probabilities, normalised within each
        block (rootsplits, then each parent subsplit's children)."""
        return torch.exp(self._normalized_log_parameters()).numpy()

    def pretty_indexed_sbn_parameters(self):
        return list(zip(self.pretty_indexer(),
                        self.normalized_sbn_parameters()))

    # -- SBN parameter CSV round trip ----------------------------------------
    def sbn_parameters_to_csv(self, path: str):
        """``pretty GPCSP,probability`` rows, sorted by key."""
        with open(path, "w", newline="") as f:
            writer = csv_mod.writer(f)
            for key, value in sorted(self.pretty_indexed_sbn_parameters()):
                writer.writerow([key, value])

    def set_sbn_parameters(self, pretty_map: Dict[str, float],
                           warn_missing=True):
        """Linear-space probabilities keyed by pretty GPCSP strings
        (generic_sbn_instance.hpp SetSBNParameters): keys of the support
        missing from the map, and zeros, become log-zero
        (DOUBLE_MINIMUM); a negative probability raises ValueError."""
        pretty = self.pretty_indexer()
        missing = 0
        out = np.empty(len(pretty))
        for i, key in enumerate(pretty):
            if key not in pretty_map:
                out[i] = DOUBLE_MINIMUM
                missing += 1
            else:
                v = pretty_map[key]
                if v > 0:
                    out[i] = np.log(v)
                elif v == 0:
                    out[i] = DOUBLE_MINIMUM
                else:
                    raise ValueError(
                        "Negative probability encountered in "
                        "set_sbn_parameters; probabilities must be in linear "
                        "space."
                    )
        if warn_missing and missing:
            print(
                f"Warning: when setting SBN parameters, {missing} were in the "
                "support but not specified; these were set to log-zero."
            )
        self.sbn_parameters = out
        self._sampler = None

    def read_sbn_parameters_from_csv(self, path: str):
        m = {}
        with open(path) as f:
            for row in csv_mod.reader(f):
                if len(row) >= 2:
                    m[row[0]] = float(row[1])
        self.set_sbn_parameters(m)

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
            spec, dtype=torch.float64, device=engine.device
        )
        self.engine = engine
        self.rescaling = rescaling
        # The parameter matrix is made when first asked for
        # (get_phylo_model_params / resize_phylo_model_params).
        self.phylo_model_params_matrix = None
        if tree_count_option is not None:
            self.resize_phylo_model_params(tree_count_option)
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
        self.phylo_model_params_matrix = None

    # -- per-tree parameter matrix (GetPhyloModelParams /
    # GetPhyloModelParamBlockMap / ResizePhyloModelParams,
    # generic_sbn_instance.hpp:221-270) --------------------------------------
    def resize_phylo_model_params(self,
                                  tree_count_option: Optional[int] = None):
        """A (count, parameter count) float64 matrix, one row per tree
        (the tree count unless ``tree_count_option`` names another), every
        row the current parameters; rows of an earlier matrix of the same
        width are kept."""
        if self.phylo_model_spec is None:
            raise RuntimeError(
                "Please call prepare_for_phylo_likelihood to make an engine "
                "before resizing the parameter matrix."
            )
        count = (tree_count_option if tree_count_option is not None
                 else self.tree_collection.tree_count())
        row = flat_from_parameters(self.phylo_model_spec,
                                   self.phylo_model_params)
        mat = np.tile(row, (count, 1))
        old = self.phylo_model_params_matrix
        if old is not None and old.shape[1] == mat.shape[1]:
            keep = min(count, old.shape[0])
            mat[:keep] = old[:keep]
        self.phylo_model_params_matrix = mat
        return mat

    def get_phylo_model_params(self) -> np.ndarray:
        if self.phylo_model_params_matrix is None:
            self.resize_phylo_model_params()
        return self.phylo_model_params_matrix

    def get_phylo_model_param_block_map(self) -> Dict[str, np.ndarray]:
        """Named writable column-block views of the parameter matrix."""
        mat = self.get_phylo_model_params()
        bs = block_specification(self.phylo_model_spec)
        return {key: mat[:, start:start + size]
                for key, (start, size) in bs.get_map().items()}

    def _compute_params(self):
        """(params, per_tree): the parameters the engine should see. With
        no matrix, or with the trees' rows all equal (then also stored as
        the shared parameters), the shared dict; otherwise one dict whose
        tensors have a leading tree axis, one row per tree (the reference
        evaluates param_matrix.row(i) for tree i, fat_beagle.hpp:144), on
        the engine's device."""
        mat = self.phylo_model_params_matrix
        if mat is None:
            return self.phylo_model_params, False
        B = self.tree_collection.tree_count()
        if mat.shape[0] < B:
            raise ValueError(
                f"Parameter matrix has {mat.shape[0]} rows < {B} trees; "
                "call resize_phylo_model_params."
            )
        device = self._get_engine().device
        if np.all(mat[:B] == mat[0]):
            self.phylo_model_params = parameters_from_flat(
                self.phylo_model_spec, mat[0], dtype=torch.float64,
                device=device,
            )
            return self.phylo_model_params, False
        rows = [parameters_from_flat(self.phylo_model_spec, mat[i],
                                     dtype=torch.float64, device=device)
                for i in range(B)]

        def stack(*leaves):
            if isinstance(leaves[0], dict):
                return {k: stack(*(d[k] for d in leaves)) for k in leaves[0]}
            return torch.stack(leaves)

        return stack(*rows), True

    def set_rescaling(self, rescaling: bool):
        """Rescale the partials (the kernels' routes) or not (the scan
        engine)."""
        if self.engine is not None:
            self.engine.rescale = rescaling
        self.rescaling = rescaling

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

    def print_status(self):
        """Summary print (generic_sbn_instance.hpp PrintStatus)."""
        print(
            f"{self.name} instance: {self.tree_count()} trees, "
            f"{self.sbn_support.gpcsp_count} GPCSPs in support"
        )

    def string_indexer_representation_of(self, topology,
                                          out_of_sample_index=None):
        rep = self.sbn_support.indexer_representation_of(
            topology, out_of_sample_index
        )
        return maps.string_indexer_representation_of(self.pretty_indexer(),
                                                     rep)

    # -- checks ---------------------------------------------------------------
    def _check_trees_loaded(self):
        if self.tree_collection is None or not self.tree_collection.trees:
            raise RuntimeError("Please load some trees into your SBN instance.")

    def _check_support(self):
        if self.sbn_support.empty():
            raise RuntimeError(
                "Please call process_loaded_trees to prepare your SBN support."
            )
