"""The likelihood engine: batched likelihoods and gradients of unrooted trees.

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
    one does not).

Gradient conventions (PhyloGradient parity, tree_gradient.hpp):
``"branch_lengths"`` is d LL / d b_e over non-root node ids 0..root_id-1,
the trifurcating layout with 2n-3 real edges; ``"substitution_model"`` is
(B, 8), each tree's gradient in stick-breaking space, the rates block (5)
then the frequencies block (3); ``"site_model"`` is the (B,) column
d LL_b / d Weibull shape. Model gradients come from one autograd pass over
per-tree copies of the parameters, so each row is that tree's own (the JAX
engine's jacrev rows, models/engine.py:511-551).

Per-tree parameter rows and rooted trees raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.phylo_model import (
    PhyloModelSpec, check_spec, site_tensors, substitution_tensors,
)
from ..ops import pruning, pruning_generic, pruning_jc, pruning_vjp
from ..ops import site_model as site_ops
from ..ops import substitution as subst_ops
from ..ops import transforms
from ..ops.schedule import BatchedSchedule
from ..utils.device import DEFAULT_DEVICE, compute_device

PER_TREE_TODO = (
    "per-tree model parameters are not ported yet (ROADMAP queue 1, item 5: "
    "the per-tree parameter matrix)"
)
ROOTED_TODO = "rooted time trees are not ported yet (ROADMAP queue 1, item 7)"


class LikelihoodEngine:
    """Likelihoods and gradients for collections of unrooted trees over one
    alignment, on one device."""

    def __init__(
        self,
        site_pattern,
        spec: PhyloModelSpec,
        rescale: bool = True,
        dtype=torch.float64,
        device=DEFAULT_DEVICE,
        use_tip_states: bool = False,
    ):
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

    @property
    def tips(self):
        """(L, 4, patterns) tip partials; in tip-states mode expanded from
        the codes on the device."""
        if self._tips is not None:
            return self._tips
        return self._tip_decode[self._tip_codes].transpose(1, 2).contiguous()

    # -- shared pieces ------------------------------------------------------
    def _post_children(self, sched: BatchedSchedule):
        """The schedule's child table on the device, after checking on the
        host what the kernels assume (pruning_jc.check_schedule)."""
        pruning_jc.check_schedule(sched.post_node, sched.post_children,
                                  sched.leaf_count, sched.root_id)
        return torch.as_tensor(
            np.asarray(sched.post_children), dtype=torch.int32,
            device=self.device,
        )

    def _bl_padded(self, branch_lengths):
        """(B, N) branch lengths in the working dtype, plus the ones-slot 0."""
        bl = torch.as_tensor(branch_lengths, device=self.device).to(self.dtype)
        return torch.nn.functional.pad(bl, (0, 1))

    def _matrix_free(self) -> bool:
        """JC69 with rescaling takes the matrix-free kernels K1-K3."""
        return self.spec.substitution == "JC69" and self.rescale

    def _model(self, params):
        """(freqs (4,), Q (4, 4), rates (K,), props (K,)) in float64 on the
        engine's device."""
        freqs, Q = substitution_tensors(self.spec, params, device=self.device)
        rates, props = site_tensors(self.spec, params, device=self.device)
        return freqs, Q, rates, props

    def _node_P(self, Q, freqs, rates, bl_padded):
        """Node transition matrices (B, N1, K, 4, 4) in the working dtype.
        Q: (4, 4) or per tree (B, 4, 4); freqs likewise; rates: (K,) or
        (B, K); bl_padded: (B, N1).

        GTR exponentiates through ``expm_transition`` with times bl x rate
        formed in the working dtype (as the JAX engine, engine.py:112-116);
        its backward is Daleckii-Krein, defined at repeated eigenvalues.
        JC69's eigensystem is a constant."""
        dt = self.dtype
        if self.spec.substitution == "GTR":
            r = rates.to(dt)
            ts = bl_padded.to(dt)[:, :, None] * (r[:, None, :] if r.dim() == 2 else r)
            return subst_ops.expm_transition(Q.to(dt), freqs.to(dt), ts)
        _, evec, ivec, evals = subst_ops.jc69_eigen(device=self.device)
        return pruning.node_transition_matrices(
            evec.to(dt), ivec.to(dt), evals.to(dt), bl_padded.to(dt),
            rates.to(dt),
        )

    def _generic_lls(self, pc, bl_padded, Q, freqs, rates, props, root_id):
        """(B,) LLs from explicit transition matrices, differentiable in Q,
        freqs, rates and props: K5/K6 with rescaling, the scan engine
        without."""
        dt = self.dtype
        P = self._node_P(Q, freqs, rates, bl_padded)
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
        """(B,) log likelihoods; branch_lengths: (B, N)."""
        if per_tree:
            raise NotImplementedError(PER_TREE_TODO)
        pc = self._post_children(sched)
        bl = self._bl_padded(branch_lengths)
        freqs, Q, rates, props = self._model(params)
        if self._matrix_free():
            return pruning_jc.log_likelihoods_jc69(
                pc, bl, self.tips, self.weights, root_id=sched.root_id,
                rates=rates.to(self.dtype), props=props.to(self.dtype),
            )
        return self._generic_lls(pc, bl, Q, freqs, rates, props, sched.root_id)

    def branch_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(lls (B,), grads (B, N-1)) — the linear-time two-pass scheme."""
        if per_tree:
            raise NotImplementedError(PER_TREE_TODO)
        dt = self.dtype
        pc = self._post_children(sched)
        bl = self._bl_padded(branch_lengths)
        freqs, Q, rates, props = self._model(params)
        if self._matrix_free():
            return pruning_jc.log_likelihood_and_branch_gradient_jc69(
                pc, bl, self.tips, self.weights, root_id=sched.root_id,
                rates=rates.to(dt), props=props.to(dt),
            )
        P = self._node_P(Q, freqs, rates, bl)
        Qs = Q.to(dt)[None] * rates.to(dt)[:, None, None]  # r_k Q
        args = (pc, P, Qs, self.tips, freqs.to(dt), props.to(dt), self.weights)
        if not self.rescale:
            return pruning.log_likelihood_and_branch_gradient(
                *args, root_id=sched.root_id, rescale=False)
        return pruning_generic.log_likelihood_and_branch_gradient_generic(
            *args, root_id=sched.root_id)

    def phylo_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """Gradient dict in reference conventions (unrooted trees)."""
        lls, bgrads = self.branch_gradients(
            sched, branch_lengths, params, per_tree=per_tree
        )
        out = {"log_likelihood": lls, "branch_lengths": bgrads}
        out.update(self._model_param_gradients(sched, branch_lengths, params))
        return out

    def _model_param_gradients(self, sched: BatchedSchedule, branch_lengths,
                               params):
        """Per-tree substitution (stick space) and site gradients, float64.

        The summed LL is differentiated with respect to per-tree copies of
        the parameters, y (B, 8) in stick space and the Weibull shape (B,),
        so each tree's Q, freqs and category rates depend on its own copy
        and each row is that tree's gradient; both blocks come from one
        forward and one backward launch (K5 + K6 for GTR, K2 + K3 for JC69
        with rescaling, the scan engine without)."""
        gtr = self.spec.substitution == "GTR"
        weibull = self.spec.site.startswith("weibull")
        if not (gtr or weibull):
            return {}
        B = np.asarray(sched.post_children).shape[0]
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
                ])
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
            pc = self._post_children(sched)
            bl = self._bl_padded(branch_lengths)
            if self._matrix_free():
                lls = pruning_jc.log_likelihoods_jc69(
                    pc, bl, self.tips, self.weights, root_id=sched.root_id,
                    rates=rates, props=props,
                )
            else:
                lls = self._generic_lls(pc, bl, Q, freqs, rates, props,
                                        sched.root_id)
            grads = torch.autograd.grad(lls.sum(), inputs)
        out = {}
        if gtr:
            out["substitution_model"] = grads[0]
        if weibull:
            out["site_model"] = grads[-1]
        return out

    def rooted_log_likelihoods(self, *args, **kwargs):
        raise NotImplementedError(ROOTED_TODO)

    def rooted_phylo_gradients(self, *args, **kwargs):
        raise NotImplementedError(ROOTED_TODO)
