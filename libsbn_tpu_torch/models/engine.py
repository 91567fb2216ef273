"""The likelihood engine: batched likelihoods and gradients of unrooted
trees and of rooted time trees.

The counterpart of libsbn_tpu/models/engine.py. A whole tree collection
evaluates in one kernel launch per call. Routes, by model and device (a
CUDA device launches the hand-written kernels, the CPU runs their plain
PyTorch twins; float32 or float64 either way):

  * JC69, rescale=True: the matrix-free kernels of ops/pruning_jc.py: K1
    for ``branch_gradients``, K2 for ``log_likelihoods``, K2 + K3 for the
    Weibull shape gradient;
  * GTR, rescale=True: explicit transition matrices from ``expm_transition``
    and the generic kernels: K4 (ops/pruning_generic.py) for
    ``branch_gradients``, K5 for ``log_likelihoods``, one K5 + one K6 launch
    (ops/pruning_vjp.py) for all trees' substitution and site gradients;
  * rescale=False, any model: the scan engine ops/pruning.py on the
    engine's device (the JAX engine's use_pallas route ignores rescale; this
    one does not);
  * rooted time trees: heights from height ratios by the sweeps of
    ops/heights.py, then the routes above on the rate-scaled branch
    lengths. ``rooted_log_likelihoods``: K2 (JC69), K5 (GTR) or the scan
    engine. ``rooted_phylo_gradients``: JC69 with rescaling takes one K1
    launch and the hand adjoint of the heights (``_rooted_phylo_gradients_
    hand``; with the sweeps, the heights and their adjoint are two
    kernels of csrc/heights.cu around K1 on a card, their twins on the
    CPU); every other model takes autograd of the summed LL and
    log-det-Jacobian through the sweeps and K5 + K6 or the scan engine
    (``_rooted_phylo_gradients_autograd``, which also runs JC69 on K2 + K3).
    The time-tree arithmetic (heights, branch lengths, the log-det-Jacobian
    and the hand adjoint) runs in float64 whatever the working dtype; only
    the pruning takes the working dtype, from the rate-scaled branch
    lengths rounded to it, and the outputs are returned in it. A node just
    below its parent (ratio near 1) has a branch that is a small difference
    of two heights, which heights rounded to float32 move by up to 1e-4 of
    itself: on fluA under a 0.001 clock the f32 ratio gradient was then
    1.3e-5 of its largest entry off its float64 value, against 1e-7 so.

On a card (``cuda_graphs=True``, the default), with rescaling and shared
parameters, each of ``log_likelihoods``, ``branch_gradients`` and
``phylo_gradients`` (models/unrooted_graph.py) and of
``rooted_log_likelihoods`` and ``rooted_phylo_gradients`` (the hand route
for JC69, the autograd route for GTR; models/rooted_graph.py) is one
replay of a captured CUDA graph under utils/graphs.py's capture policy,
the counterpart of the JAX engine's jitted programs;
``cuda_graphs=False`` runs them eagerly, launch by launch, and per-tree
parameters and rescale=False always do. GTR's
eigensystem is solved once a call on the host, from the shared parameters,
by both routes (``_shared_eigen``), so they run the same arithmetic. The
schedule's index arrays go to the device once per schedule object, which
caches them (``_sched_dev``, the JAX engine's cache of the same name).

Gradient conventions (PhyloGradient parity, tree_gradient.hpp):
``"branch_lengths"`` is d LL / d b_e over non-root node ids 0..root_id-1,
the trifurcating layout with 2n-3 real edges; ``"substitution_model"`` is
(B, 8), each tree's gradient in stick-breaking space, the rates block (5)
then the frequencies block (3); ``"site_model"`` is the (B,) column
d LL_b / d Weibull shape; ``"ratios_root_height"`` is (B, L-1),
d (LL + log|Jacobian|) / d (height ratios, root height); ``"clock_model"``
is d LL / d clock rate, (B, 1) under a strict clock, per branch (B, N-1)
otherwise. Model gradients come from one autograd pass over per-tree copies
of the parameters, so each row is that tree's own (the JAX engine's jacrev
rows, models/engine.py:511-551). The rooted gradient dict reports the LL
without the Jacobian, as the reference's does.

Per-tree parameters (``per_tree=True``: every tensor of the parameter dict
has a leading tree axis, one row per tree, the reference's per-tree
parameter matrix, fat_beagle.hpp:144) become per-tree model tensors: Q and
freqs (B, ...) for GTR, category rates (B, K) for Weibull models.
K2/K3 and K5/K6 take them, so ``log_likelihoods``,
``rooted_log_likelihoods`` and the model gradients keep their kernels. K1
and K4 take shared model tensors only, so per-tree ``branch_gradients``
(and the branch gradients of ``phylo_gradients``) run the scan engine
ops/pruning.py with per-tree matrices, and per-tree
``rooted_phylo_gradients`` takes the autograd route; ``pruning.CALLS``
counts the scan engine's calls as the kernel modules count their launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.phylo_model import (
    PhyloModelSpec, check_spec, site_tensors, substitution_tensors,
)
from ..ops import heights as heights_ops
from ..ops import pruning, pruning_generic, pruning_jc, pruning_vjp
from ..ops import site_model as site_ops
from ..ops import substitution as subst_ops
from ..ops import transforms
from ..ops.schedule import BatchedSchedule
from ..utils.device import DEFAULT_DEVICE, compute_device
from ..utils.graphs import host_f64
from . import rooted_graph, unrooted_graph

HEIGHTS_METHODS = ("sweeps", "squaring")


class LikelihoodEngine:
    """Likelihoods and gradients for collections of unrooted trees and of
    rooted time trees over one alignment, on one device."""

    def __init__(
        self,
        site_pattern,
        spec: PhyloModelSpec,
        rescale: bool = True,
        dtype=torch.float64,
        device=DEFAULT_DEVICE,
        use_tip_states: bool = False,
        cuda_graphs: bool = True,
    ):
        """cuda_graphs: on a CUDA device, run the engine calls as captured
        CUDA graphs (models/unrooted_graph.py, models/rooted_graph.py);
        False runs them eagerly. Ignored on the CPU."""
        check_spec(spec)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        device = compute_device(device)
        self.spec = spec
        self.rescale = rescale
        self.dtype = dtype
        self.device = device
        # Tip-states mode (fat_beagle.cpp:207-256 use_tip_states): the
        # symbol codes stay resident and are expanded to partials on the
        # device at each call; the expansion is exact, so results equal the
        # dense tips'.
        self.use_tip_states = use_tip_states
        if use_tip_states:
            codes, decode = site_pattern.tip_states()
            self._tip_codes = torch.as_tensor(
                np.asarray(codes, np.int32), device=device)
            self._tip_decode = torch.as_tensor(decode, device=device).to(dtype)
            self._tips = None
        else:
            self._tips = torch.as_tensor(
                site_pattern.tip_partials(), device=device
            ).to(dtype)
        self.weights = torch.as_tensor(
            site_pattern.weights, device=device
        ).to(dtype)
        # The heights fixed point of the rooted hand route: "sweeps" (one
        # gather a sweep) or "squaring" (log-depth matrix squarings), as
        # the JAX engine's attribute of the same name.
        self.heights_method = "sweeps"
        graphed = device.type == "cuda" and cuda_graphs
        # The memory pool of the engine's captured graphs (utils/graphs.py
        # PackedPrograms), the rooted programs (``graphs``) and the unrooted
        # ones; None runs the calls eagerly.
        self.graph_pool = torch.cuda.graph_pool_handle() if graphed else None
        self.graphs = rooted_graph.RootedGraphs(self) if graphed else None
        self.unrooted_graphs = (unrooted_graph.UnrootedGraphs(self)
                                if graphed else None)

    @property
    def tips(self):
        """(L, 4, patterns) tip partials; in tip-states mode expanded from
        the codes on the device."""
        if self._tips is not None:
            return self._tips
        return self._tip_decode[self._tip_codes].transpose(1, 2).contiguous()

    # -- shared pieces ------------------------------------------------------
    @staticmethod
    def _sched_cache(sched: BatchedSchedule):
        """The dict cached ON the schedule object that holds what the engine
        derives from it, so it dies with the schedule and a new schedule
        object is never served another's. Made at the schedule's first use,
        after checking on the host what the kernels assume of it
        (pruning_jc.check_schedule): once per schedule object."""
        cache = getattr(sched, "_dev_cache", None)
        if cache is None:
            pruning_jc.check_schedule(sched.post_node, sched.post_children,
                                      sched.leaf_count, sched.root_id)
            cache = {}
            object.__setattr__(sched, "_dev_cache", cache)
        return cache

    def _sched_dev(self, sched: BatchedSchedule, name, dtype=torch.int64):
        """The device copy of the schedule's index array ``name`` in dtype,
        in _sched_cache, keyed by device and dtype."""
        cache = self._sched_cache(sched)
        key = (name, self.device, dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(
                np.asarray(getattr(sched, name)), device=self.device
            ).to(dtype)
        return cache[key]

    def _post_children(self, sched: BatchedSchedule):
        """The schedule's child table on the device, int32 (the kernels'),
        checked and cached by _sched_dev."""
        return self._sched_dev(sched, "post_children", torch.int32)

    def _bl_padded(self, branch_lengths):
        """(B, N) branch lengths in the working dtype, plus the ones-slot 0."""
        bl = torch.as_tensor(branch_lengths, device=self.device).to(self.dtype)
        return torch.nn.functional.pad(bl, (0, 1))

    def _matrix_free(self) -> bool:
        """JC69 with rescaling takes the matrix-free kernels K1-K3."""
        return self.spec.substitution == "JC69" and self.rescale

    @staticmethod
    def _check_per_tree(params, B):
        """Raise ValueError unless every tensor of per-tree ``params`` leads
        with the B trees (shared parameters are never taken as rows)."""
        for leaf in (v for d in params.values() for v in d.values()):
            shape = tuple(torch.as_tensor(leaf).shape)
            if shape[:1] != (B,):
                raise ValueError(f"per_tree parameters must lead with the {B} "
                                 f"trees, got shape {shape}")

    def _model(self, params):
        """(freqs (4,), Q (4, 4), rates (K,), props (K,)) in float64 on the
        engine's device; for per-tree parameters (leading tree axis) GTR's
        freqs and Q are (B, 4) and (B, 4, 4) and Weibull rates (B, K)."""
        freqs, Q = substitution_tensors(self.spec, params, device=self.device)
        rates, props = site_tensors(self.spec, params, device=self.device)
        return freqs, Q, rates, props

    def _node_P(self, Q, freqs, rates, bl_padded, eigen=None):
        """Node transition matrices (B, N1, K, 4, 4) in the working dtype.
        Q: (4, 4) or per tree (B, 4, 4); freqs likewise; rates: (K,) or
        (B, K); bl_padded: (B, N1); eigen: GTR's eigensystem of Q in the
        working dtype (``_shared_eigen``), solved ahead, or None.

        GTR exponentiates through ``expm_transition`` with times bl x rate
        formed in the working dtype (as the JAX engine, engine.py:112-116);
        its backward is Daleckii-Krein, defined at repeated eigenvalues.
        JC69's eigensystem is a constant."""
        dt = self.dtype
        if self.spec.substitution == "GTR":
            r = rates.to(dt)
            ts = bl_padded.to(dt)[:, :, None] * (r[:, None, :] if r.dim() == 2 else r)
            return subst_ops.expm_transition(Q.to(dt), freqs.to(dt), ts,
                                             eigen=eigen)
        _, evec, ivec, evals = subst_ops.jc69_eigen(device=self.device)
        return pruning.node_transition_matrices(
            evec.to(dt), ivec.to(dt), evals.to(dt), bl_padded.to(dt),
            rates.to(dt),
        )

    def _shared_eigen(self, params):
        """GTR's eigensystem of the shared parameters' Q, (evals (1, 4),
        V (1, 4, 4), V^-1 (1, 4, 4)) float64 on the host, as ``_node_P``
        solves it (of Q and freqs in the working dtype): one NumPy pass from
        the parameters' float64 host copies (``subst_ops.gtr_eigen_f64``).
        Every GTR call solves it ahead so (the graphs pack it into their
        buffers, the eager calls copy it to the device), and the per-tree
        copies of the model gradients share it. None for JC69 and for
        per-tree rows, whose Qs are solved where they are used."""
        if self.spec.substitution != "GTR":
            return None
        p = params["substitution"]
        rates, freqs = host_f64(p["rates"]), host_f64(p["frequencies"])
        if rates.ndim != 1 or freqs.ndim != 1:
            return None
        return subst_ops.gtr_eigen_f64(rates, freqs, self.dtype)

    def _eigen(self, params):
        """``_shared_eigen`` on the engine's device, or None."""
        eigen = self._shared_eigen(params)
        return None if eigen is None else tuple(
            x.to(self.device) for x in eigen)

    def _unrooted_graphed(self, per_tree):
        """Whether an unrooted call takes its captured graph: on a card
        with cuda_graphs, rescaling and shared parameters."""
        return (self.unrooted_graphs is not None and self.rescale
                and not per_tree)

    def _lls(self, pc, bl_padded, model, root_id, eigen=None):
        """(B,) LLs from padded branch lengths (B, N1), differentiable in
        them and in the model tensors: K2/K3 (JC69 with rescaling), K5/K6
        (GTR with rescaling), the scan engine without rescaling. eigen: as
        in _node_P."""
        freqs, Q, rates, props = model
        if self._matrix_free():
            return pruning_jc.log_likelihoods_jc69(
                pc, bl_padded, self.tips, self.weights, root_id=root_id,
                rates=rates, props=props,
            )
        dt = self.dtype
        P = self._node_P(Q, freqs, rates, bl_padded, eigen)
        if not self.rescale:
            return pruning.log_likelihoods(
                pc, P, self.tips, freqs.to(dt), props.to(dt), self.weights,
                root_id=root_id, rescale=False,
            )
        return pruning_vjp.log_likelihoods_generic(
            pc, P, self.tips, freqs.to(dt), props.to(dt), self.weights,
            root_id=root_id,
        )

    # -- unrooted likelihoods ----------------------------------------------
    def log_likelihoods(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(B,) log likelihoods; branch_lengths: (B, N). per_tree: each
        tree with its own parameter row, on the same kernels (K2, K5). On
        a card with cuda_graphs (rescaling, shared parameters) one replay
        of a captured graph."""
        if self._unrooted_graphed(per_tree):
            return self.unrooted_graphs.log_likelihoods(sched, branch_lengths,
                                                        params)
        pc = self._post_children(sched)
        if per_tree:
            self._check_per_tree(params, pc.shape[0])
        return self._lls(pc, self._bl_padded(branch_lengths),
                         self._model(params), sched.root_id,
                         self._eigen(params))

    def branch_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(lls (B,), grads (B, N-1)) — the linear-time two-pass scheme: K1
        (JC69) or K4 (GTR) with rescaling, the scan engine without. K1 and
        K4 take shared model tensors only, so per_tree (each tree with its
        own parameter row) runs the scan engine with per-tree matrices,
        counted in ``pruning.CALLS``. On a card with cuda_graphs
        (rescaling, shared parameters) one replay of a captured graph."""
        if self._unrooted_graphed(per_tree):
            return self.unrooted_graphs.branch_gradients(
                sched, branch_lengths, params)
        pc = self._post_children(sched)
        bl = self._bl_padded(branch_lengths)
        if per_tree:
            self._check_per_tree(params, pc.shape[0])
            return self._per_tree_branch_gradients(pc, bl, params,
                                                   sched.root_id)
        return self._branch_gradients(pc, bl, params, sched.root_id,
                                      self._eigen(params))

    def _per_tree_branch_gradients(self, pc, bl, params, root_id):
        """branch_gradients with a parameter row per tree: the scan engine
        with per-tree matrices."""
        dt = self.dtype
        B = pc.shape[0]
        freqs, Q, rates, props = self._model(params)
        P = self._node_P(Q, freqs, rates, bl)
        Qb = (Q if Q.dim() == 3 else Q.expand(B, 4, 4)).to(dt)
        rb = (rates if rates.dim() == 2 else rates.expand(B, -1)).to(dt)
        return pruning.log_likelihood_and_branch_gradient(
            pc, P, Qb[:, None] * rb[:, :, None, None], self.tips,
            freqs.to(dt), props.to(dt), self.weights, root_id=root_id,
            rescale=self.rescale)

    def _branch_gradients(self, pc, bl, params, root_id, eigen=None):
        """(lls, grads) of shared parameters at padded branch lengths bl
        (B, N1): K1, K4, or the scan engine without rescaling. eigen: as in
        _node_P."""
        dt = self.dtype
        freqs, Q, rates, props = self._model(params)
        if self._matrix_free():
            return pruning_jc.log_likelihood_and_branch_gradient_jc69(
                pc, bl, self.tips, self.weights, root_id=root_id,
                rates=rates.to(dt), props=props.to(dt),
            )
        P = self._node_P(Q, freqs, rates, bl, eigen)
        Qs = Q.to(dt)[None] * rates.to(dt)[:, None, None]  # r_k Q
        args = (pc, P, Qs, self.tips, freqs.to(dt), props.to(dt), self.weights)
        if not self.rescale:
            return pruning.log_likelihood_and_branch_gradient(
                *args, root_id=root_id, rescale=False)
        return pruning_generic.log_likelihood_and_branch_gradient_generic(
            *args, root_id=root_id)

    def phylo_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """Gradient dict in reference conventions (unrooted trees). On a
        card with cuda_graphs (rescaling, shared parameters) one replay of
        a captured graph: the branch gradients and the model's in one."""
        if self._unrooted_graphed(per_tree):
            return self.unrooted_graphs.phylo_gradients(sched, branch_lengths,
                                                        params)
        pc = self._post_children(sched)
        bl = self._bl_padded(branch_lengths)
        if per_tree:
            self._check_per_tree(params, pc.shape[0])
            lls, bgrads = self._per_tree_branch_gradients(pc, bl, params,
                                                          sched.root_id)
            out = {"log_likelihood": lls, "branch_lengths": bgrads}
            out.update(self._model_param_gradients(pc, sched.root_id, bl,
                                                   params))
            return out
        return self._phylo_gradients(pc, bl, params, sched.root_id,
                                     self._eigen(params))

    def _phylo_gradients(self, pc, bl, params, root_id, eigen=None):
        """phylo_gradients' dict of shared parameters at padded branch
        lengths bl: _branch_gradients, then _model_param_gradients, both on
        the eigensystem ``eigen``."""
        lls, bgrads = self._branch_gradients(pc, bl, params, root_id, eigen)
        out = {"log_likelihood": lls, "branch_lengths": bgrads}
        out.update(self._model_param_gradients(pc, root_id, bl, params,
                                               eigen))
        return out

    def _model_param_gradients(self, pc, root_id, bl_padded, params,
                               eigen=None):
        """Per-tree substitution (stick space) and site gradients, float64,
        at padded branch lengths (B, N1) (rate-scaled for time trees).

        The summed LL is differentiated with respect to per-tree copies of
        the parameters, y (B, 8) in stick space and the Weibull shape (B,),
        so each tree's Q, freqs and category rates depend on its own copy
        and each row is that tree's gradient; both blocks come from one
        forward and one backward launch (K5 + K6 for GTR, K2 + K3 for JC69
        with rescaling, the scan engine without). Per-tree parameters
        (leading tree axis) start each copy from the tree's own row. pc:
        the schedule's (B, S, 3) child table on the device. eigen: the
        shared parameters' eigensystem (``_shared_eigen``), which every
        tree's copy of Q shares, or None to solve the B copies here."""
        gtr = self.spec.substitution == "GTR"
        weibull = self.spec.site.startswith("weibull")
        if not (gtr or weibull):
            return {}
        B = pc.shape[0]
        dev = self.device
        inputs = []
        with torch.enable_grad():
            if gtr:
                p = params["substitution"]
                y0 = torch.cat([
                    transforms.stick_breaking_inverse(torch.as_tensor(
                        p["rates"], dtype=torch.float64, device=dev)),
                    transforms.stick_breaking_inverse(torch.as_tensor(
                        p["frequencies"], dtype=torch.float64, device=dev)),
                ], dim=-1)
                y = y0.detach().expand(B, 8).clone().requires_grad_(True)
                inputs.append(y)
                freqs = transforms.stick_breaking(y[:, 5:])
                Q = subst_ops.gtr_q(transforms.stick_breaking(y[:, :5]), freqs)
            else:
                freqs, Q = substitution_tensors(self.spec, params, device=dev)
            if weibull:
                shapes = torch.as_tensor(
                    params["site"]["shape"], dtype=torch.float64, device=dev
                ).detach().expand(B).clone().requires_grad_(True)
                inputs.append(shapes)
                rates, props = site_ops.weibull_rates(
                    shapes, self.spec.site_category_count(), device=dev)
            else:
                rates, props = site_tensors(self.spec, params, device=dev)
            lls = self._lls(pc, bl_padded.detach(), (freqs, Q, rates, props),
                            root_id, eigen)
            grads = torch.autograd.grad(lls.sum(), inputs)
        out = {}
        if gtr:
            out["substitution_model"] = grads[0]
        if weibull:
            out["site_model"] = grads[-1]
        return out

    # -- rooted time trees --------------------------------------------------
    def _height_iters(self, sched: BatchedSchedule) -> int:
        """The deepest internal node's depth over the batch: the number of
        sweeps the heights fixed point needs. Cached on the schedule object,
        so it dies with it and a deeper collection is never served a
        shallower count."""
        cached = getattr(sched, "_height_iters_cache", None)
        if cached is None:
            pn = np.asarray(sched.pre_internal_node)
            pp = np.asarray(sched.pre_internal_parent)
            rows = np.arange(pn.shape[0])
            depth = np.zeros((pn.shape[0], sched.node_count), np.int64)
            for j in range(pn.shape[1]):  # preorder: parents come first
                depth[rows, pn[:, j]] = depth[rows, pp[:, j]] + 1
            cached = max(1, int(depth.max(initial=0)))
            object.__setattr__(sched, "_height_iters_cache", cached)
        return cached

    @staticmethod
    def _bl_padded2(bl):
        """Rooted branch lengths (B, N-1) with the root and ones-slot zeros
        appended: (B, N + 1)."""
        return torch.nn.functional.pad(bl, (0, 2))

    def _rooted_inputs(self, sched, bounds, ratios, rates):
        """The schedule's index arrays as int32 (cached on it, _sched_dev;
        the kernels' type, the packed graphs' too) and the time-tree arrays
        on the device, the arrays in float64."""
        def upload(x):
            return torch.as_tensor(x, device=self.device).to(torch.float64)

        def ints(name):
            return self._sched_dev(sched, name, torch.int32)

        return {
            "pc": self._post_children(sched),
            "pre_node": ints("pre_internal_node"),
            "pre_parent": ints("pre_internal_parent"),
            "parent": ints("parent"),
            "bounds": upload(bounds),
            "ratios": upload(ratios),
            "rates": upload(rates),
            "n_iters": self._height_iters(sched),
            "leaf_count": sched.leaf_count,
            "root_id": sched.root_id,
        }

    def _rooted_branch_lengths(self, a, ratios, method="sweeps"):
        """(heights (B, N), branch lengths (B, N-1)) of the time trees, in
        the ratios' dtype (float64 from _rooted_inputs)."""
        h = heights_ops.node_heights_from_ratios(
            ratios, a["bounds"], a["leaf_count"], a["pre_node"],
            a["pre_parent"], n_iters=a["n_iters"], method=method)
        return h, heights_ops.branch_lengths_from_heights(h, a["parent"])

    def _rooted_parts(self, a, ratios, rates, model, eigen=None):
        """((B,) LLs in the working dtype, (B,) log-det-Jacobians and (B,
        N-1) rate-scaled branch lengths in the ratios' dtype),
        differentiable in ratios, rates and the model tensors."""
        h, bl = self._rooted_branch_lengths(a, ratios)
        bl_scaled = bl * rates
        lls = self._lls(a["pc"], self._bl_padded2(bl_scaled.to(self.dtype)),
                        model, a["root_id"], eigen)
        ldjs = heights_ops.log_det_jacobian(h, a["bounds"], a["parent"],
                                            a["leaf_count"])
        return lls, ldjs, bl_scaled

    def _rooted_graphed(self, per_tree):
        """Whether a rooted call takes its captured graph: on a card with
        cuda_graphs, rescaling and shared parameters."""
        return self.graphs is not None and self.rescale and not per_tree

    def rooted_log_likelihoods(
        self, sched: BatchedSchedule, bounds, ratios, rates, params,
        return_parts: bool = False, per_tree: bool = False,
    ):
        """(B,) LL + log-det-Jacobian of rooted time trees
        (fat_beagle.cpp:96-104), or the pair with return_parts.

        bounds: (B, N) node bounds; ratios: (B, L-1) height ratios with the
        root height last; rates: (B, N-1) per-branch clock rates. per_tree:
        each tree with its own parameter row, on the same kernels. On a
        card with cuda_graphs (rescaling, shared parameters) one replay of
        a captured graph."""
        if self._rooted_graphed(per_tree):
            lls, ldjs = self.graphs.log_likelihoods(sched, bounds, ratios,
                                                    rates, params)
        else:
            a = self._rooted_inputs(sched, bounds, ratios, rates)
            if per_tree:
                self._check_per_tree(params, a["pc"].shape[0])
            lls, ldjs = self._rooted_lls(a, params, self._eigen(params))
        if return_parts:
            return lls, ldjs
        return lls + ldjs

    def _rooted_lls(self, a, params, eigen=None):
        """((B,) LLs, (B,) log-det-Jacobians) of the inputs ``a``, in the
        working dtype."""
        lls, ldjs, _ = self._rooted_parts(a, a["ratios"], a["rates"],
                                          self._model(params), eigen)
        return lls, ldjs.to(self.dtype)

    def rooted_phylo_gradients(
        self, sched: BatchedSchedule, bounds, ratios, rates, params,
        strict_clock: bool = True, per_tree: bool = False,
    ):
        """Gradient dict of rooted time trees: ``log_likelihood`` (without
        the Jacobian), ``ratios_root_height``, ``clock_model`` and the model
        gradients. JC69 with rescaling and shared parameters takes the hand
        route (one K1 launch); every other model, and per_tree parameters
        (K1 takes shared rates only), autograd (K2 + K3, K5 + K6 or the
        scan engine). On a card with cuda_graphs, rescaling and shared
        parameters either route is one replay of a captured graph."""
        if per_tree:
            self._check_per_tree(params,
                                 np.asarray(sched.post_children).shape[0])
        if self._rooted_graphed(per_tree):
            return self.graphs.phylo_gradients(
                sched, bounds, ratios, rates, params, strict_clock,
                "hand" if self._matrix_free() else "autograd")
        if not (self._matrix_free() and not per_tree):
            return self._rooted_phylo_gradients_autograd(
                sched, bounds, ratios, rates, params, strict_clock)
        return self._rooted_phylo_gradients_hand(
            sched, bounds, ratios, rates, params, strict_clock)

    def _rounded(self, dratios, drates, strict_clock):
        """The float64 ratio and clock gradients of the torch adjoint or
        autograd, the clock's summed under a strict clock, rounded to the
        working dtype."""
        dt = self.dtype
        return dratios.to(dt), (drates.sum(-1, keepdim=True) if strict_clock
                                else drates).to(dt)

    def _rooted_gradient_dict(self, a, lls, ratio_grad, clock_grad,
                              bl_operand, params, eigen=None):
        """The gradient dict from the LLs and the ratio and clock gradients
        in the working dtype; bl_operand: the rate-scaled branch lengths
        as the pruning reads them (B, N + 1)."""
        out = {"log_likelihood": lls, "ratios_root_height": ratio_grad,
               "clock_model": clock_grad}
        # The Jacobian does not depend on the model: its gradients are the
        # LL's at the rate-scaled branch lengths.
        out.update(self._model_param_gradients(a["pc"], a["root_id"],
                                               bl_operand, params, eigen))
        return out

    def _rooted_phylo_gradients_hand(
        self, sched, bounds, ratios, rates, params, strict_clock
    ):
        """JC69 rooted gradients by the hand chain rule, eagerly (see
        _rooted_hand)."""
        return self._rooted_hand(
            self._rooted_inputs(sched, bounds, ratios, rates), params,
            strict_clock)

    def _rooted_hand(self, a, params, strict_clock):
        """The hand route on the inputs ``a``: the heights and the
        rate-scaled branch lengths, one K1 launch on those for the LL and
        its branch gradient, then the adjoint of the heights (the BEAST
        recursions of rooted_gradient_transforms.cpp:17-162) for the ratio
        and clock gradients, in float64 from the branch gradient. With
        heights_method "sweeps", the heights and their adjoint are one
        kernel each on a card and their twins on the CPU (ops/heights.py
        forward, adjoint); with "squaring", ops/heights.py's torch
        functions."""
        method = self.heights_method
        if method not in HEIGHTS_METHODS:
            raise ValueError(f"heights_method must be one of "
                             f"{HEIGHTS_METHODS}, got {method!r}")
        sweeps = method == "sweeps"
        tree = (a["ratios"], a["bounds"], a["rates"])
        if sweeps:
            h, operand = heights_ops.forward(
                *tree, a["parent"], a["leaf_count"], a["n_iters"], self.dtype)
        else:
            h, bl = self._rooted_branch_lengths(a, a["ratios"], method)
            operand = self._bl_padded2((bl * a["rates"]).to(self.dtype))
        _, _, site_rates, props = self._model(params)
        lls, g_scaled = pruning_jc.log_likelihood_and_branch_gradient_jc69(
            a["pc"], operand, self.tips, self.weights, root_id=a["root_id"],
            rates=site_rates, props=props,
        )
        if sweeps:
            grads = heights_ops.adjoint(
                g_scaled, h, *tree, a["pc"], a["parent"], a["leaf_count"],
                a["n_iters"], strict_clock)
        else:
            dratios, drates, _ = (
                heights_ops.ratio_and_rate_gradients_from_branch_gradient(
                    g_scaled.to(h.dtype), *tree, a["leaf_count"],
                    a["pre_node"], a["pre_parent"], a["parent"],
                    a["n_iters"], heights=h, method=method,
                    post_children=a["pc"],
                ))
            grads = self._rounded(dratios, drates, strict_clock)
        return self._rooted_gradient_dict(a, lls, *grads, operand, params)

    def _rooted_phylo_gradients_autograd(
        self, sched, bounds, ratios, rates, params, strict_clock
    ):
        """Rooted gradients by autograd of sum(LL + log-det-Jacobian) with
        respect to (ratios, rates), through the heights sweeps and the LL's
        backward (K5 + K6, K2 + K3 for JC69, or the scan engine); the trees
        are independent, so the sum's gradient is each tree's own. Eagerly
        (see _rooted_autograd)."""
        return self._rooted_autograd(
            self._rooted_inputs(sched, bounds, ratios, rates), params,
            strict_clock, self._eigen(params))

    def _rooted_autograd(self, a, params, strict_clock, eigen=None):
        """The autograd route on the inputs ``a``; eigen: as in _node_P,
        GTR's Q solved ahead (``_shared_eigen``), or None."""
        model = self._model(params)
        with torch.enable_grad():
            r = a["ratios"].detach().requires_grad_(True)
            k = a["rates"].detach().requires_grad_(True)
            lls, ldjs, bl_scaled = self._rooted_parts(a, r, k, model, eigen)
            dratios, drates = torch.autograd.grad((lls + ldjs).sum(), (r, k))
        return self._rooted_gradient_dict(
            a, lls.detach(), *self._rounded(dratios, drates, strict_clock),
            self._bl_padded2(bl_scaled.detach().to(self.dtype)), params,
            eigen)
