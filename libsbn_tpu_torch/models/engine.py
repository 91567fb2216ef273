"""The likelihood engine: batched JC69 likelihoods and branch gradients.

The counterpart of libsbn_tpu/models/engine.py for this slice. A whole tree
collection evaluates in one kernel launch. On a CUDA device the engine
launches the hand-written kernels of ops/pruning_jc.py (K1 for
``branch_gradients``, K2 for ``log_likelihoods``, K2 + K3 for the Weibull
shape gradient) in float32 or float64; on the CPU it runs their plain
PyTorch twins. (The JAX f64 engine ran its scan engine instead; here f64 on
a card runs the f64 kernels.)

Gradient conventions (PhyloGradient parity, tree_gradient.hpp):
``"branch_lengths"`` is d LL / d b_e over non-root node ids 0..root_id-1,
the trifurcating layout with 2n-3 real edges; ``"site_model"`` is the (B,)
column d LL_b / d Weibull shape, the layout of the JAX engine's jacrev.

Paths not on this slice raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.phylo_model import GTR_TODO, PhyloModelSpec, model_tensors
from ..ops import pruning_jc
from ..ops import site_model as site_ops
from ..ops.schedule import BatchedSchedule

SCAN_ENGINE_TODO = (
    "needs the generic scan engine, not ported yet (ROADMAP queue 1, item 6: "
    "ops/pruning.py, GTR and K4-K6)"
)
PER_TREE_TODO = (
    "per-tree model parameters are not ported yet (ROADMAP queue 1, item 5: "
    "the per-tree parameter matrix)"
)
ROOTED_TODO = "rooted time trees are not ported yet (ROADMAP queue 1, item 7)"


class LikelihoodEngine:
    """JC69 likelihoods and branch gradients for collections of unrooted
    trees over one alignment, on one device."""

    def __init__(
        self,
        site_pattern,
        spec: PhyloModelSpec,
        rescale: bool = True,
        dtype=torch.float64,
        device="cpu",
        use_tip_states: bool = False,
    ):
        if spec.substitution != "JC69":
            raise NotImplementedError(GTR_TODO)
        if not rescale:
            raise NotImplementedError("rescale=False " + SCAN_ENGINE_TODO)
        if use_tip_states:
            raise NotImplementedError("use_tip_states " + SCAN_ENGINE_TODO)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {device} requested, but no CUDA device is present"
                )
            # Precision policy: no TF32 anywhere on the likelihood path.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.spec = spec
        self.dtype = dtype
        self.device = device
        self.tips = torch.as_tensor(
            site_pattern.tip_partials(), device=device
        ).to(dtype)
        self.weights = torch.as_tensor(
            site_pattern.weights, device=device
        ).to(dtype)

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

    def _rates_props(self, params):
        """Category rates and proportions, computed in f64 and cast to the
        working dtype (as the JAX engine casts its model tensors)."""
        mt = model_tensors(self.spec, params, device=self.device)
        return mt[4].to(self.dtype), mt[5].to(self.dtype)

    def log_likelihoods(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(B,) log likelihoods; branch_lengths: (B, N)."""
        if per_tree:
            raise NotImplementedError(PER_TREE_TODO)
        rates, props = self._rates_props(params)
        return pruning_jc.log_likelihoods_jc69(
            self._post_children(sched), self._bl_padded(branch_lengths),
            self.tips, self.weights, root_id=sched.root_id, rates=rates,
            props=props,
        )

    def branch_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(lls (B,), grads (B, N-1)) — the linear-time two-pass scheme."""
        if per_tree:
            raise NotImplementedError(PER_TREE_TODO)
        rates, props = self._rates_props(params)
        return pruning_jc.log_likelihood_and_branch_gradient_jc69(
            self._post_children(sched), self._bl_padded(branch_lengths),
            self.tips, self.weights, root_id=sched.root_id, rates=rates,
            props=props,
        )

    def phylo_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """Gradient dict in reference conventions (unrooted trees)."""
        lls, bgrads = self.branch_gradients(
            sched, branch_lengths, params, per_tree=per_tree
        )
        out = {"log_likelihood": lls, "branch_lengths": bgrads}
        if self.spec.site.startswith("weibull"):
            out["site_model"] = self._shape_gradient(
                sched, branch_lengths, params
            )
        return out

    def _shape_gradient(self, sched: BatchedSchedule, branch_lengths, params):
        """(B,) d LL_b / d Weibull shape in float64, from one K3 launch: the
        summed LL is differentiated with respect to a per-tree copy of the
        shape, (B,), so each tree's rates (B, K) and exp factors depend on
        its own copy and each entry is that tree's row (the JAX engine's
        per_tree trick, models/engine.py:517-521)."""
        shape = torch.as_tensor(
            params["site"]["shape"], dtype=torch.float64, device=self.device
        )
        B = np.asarray(sched.post_children).shape[0]
        shapes = shape.detach().expand(B).clone().requires_grad_(True)
        rates, props = site_ops.weibull_rates(
            shapes, self.spec.site_category_count(), device=self.device
        )
        with torch.enable_grad():
            lls = pruning_jc.log_likelihoods_jc69(
                self._post_children(sched), self._bl_padded(branch_lengths),
                self.tips, self.weights, root_id=sched.root_id, rates=rates,
                props=props,
            )
            (grad,) = torch.autograd.grad(lls.sum(), shapes)
        return grad

    def rooted_log_likelihoods(self, *args, **kwargs):
        raise NotImplementedError(ROOTED_TODO)

    def rooted_phylo_gradients(self, *args, **kwargs):
        raise NotImplementedError(ROOTED_TODO)
