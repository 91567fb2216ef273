"""The VBPI training step on a device: the counterpart of
libsbn_tpu/vi/jit_step.py, with the same names.

The host samples topologies (combinatorial) and standard normals; the rest
of a gradient step runs as tensor code on the device: reparameterized
branch lengths, the batched JC69 likelihood and linear-time branch
gradients (kernel K1, ops/pruning_jc.py), the eq:dLdPsi scalar gradients,
the VIMCO topology gradients and an Adam update. The evaluation half
(``vbpi_log_f``) takes the LL-only kernel K2. With ``rescale=False`` both
halves run the scan engine ops/pruning.py instead, on any device, as the
JAX package's step does. ``vbpi_train_step`` is a plain function of
tensors; nothing in it copies to the host or reads the device from it, and
its annealing ``beta`` and the Adam step ``count`` may be tensors on the
device. Its scatter-adds sum in a fixed order
(sbn/probability.py fixed_order_scatter_add), so a step repeats bit for bit
on a card as on the CPU.

The packed functions take the host's int32 step inputs packed by columns
into one buffer, JitVBPI's layout: ``vbpi_train_step_packed`` (one step),
``vbpi_train_steps_packed`` (K steps in order, the JAX package's lax.scan
window) and ``vbpi_log_f_packed`` (the evaluation half). What the JAX
package compiles into one XLA program per step or window, JitVBPI runs on
a card as one captured CUDA graph of ``vbpi_train_steps_packed`` per
window (vi/step_graph.py): one replay a window, K = 1 for ``step()``.

Branch models: split-lognormal (one variable per split, the benchmark
default) and PSP (three summed component variables per branch, ICLR 2019),
selected with ``branch_model=``: both run the same step with C = 1 or 3
component rows in branch_rep.

A mesh (``mesh=``, parallel/sharding.py) splits the particle axis: over
the dp devices of a local mesh through K1's sharded wrapper, and over the
ranks of a torch.distributed job with a global mesh
(parallel/distributed.py), where the step makes explicit the collectives
that XLA inserts into the JAX package's step.

JitVBPI's host work opens spans (utils/profiling.py ``annotate``, recorded
only under torch.profiler; none inside a captured step):
``libsbn.vbpi.wait_params`` (the wait for the last window's parameters),
``libsbn.vbpi.sample`` (the sampler's refresh and draws),
``libsbn.vbpi.lower`` (the topologies' lowering, cached by key), with one
``libsbn.vbpi.lower_miss`` a cache miss (``ARTIFACTS`` counts hits and
misses), ``libsbn.vbpi.pack`` (the window's host arrays) and
``libsbn.vbpi.params_copy`` (the start of the parameters' copy to the
host); vi/step_graph.py's copies and replay open utils/graphs.py's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.topology import Topology
from ..io import native
from ..ops import pruning, pruning_jc, substitution
from ..ops import schedule as schedule_ops
from ..parallel import distributed
from ..parallel.sharding import check_mesh
from ..sbn import gradients as sbn_gradients
from ..sbn import probability as sbn_probability
from ..sbn.sampling import NativeSBNSampler
from ..utils.profiling import annotate
from . import step_graph

PRIOR_RATE = 10.0

# Lookups of JitVBPI's per-topology artifact cache (_topology_artifacts):
# its hit rate without a profiler. reset_counters() sets them to 0.
ARTIFACTS = {"hits": 0, "misses": 0}


def reset_counters():
    for name in ARTIFACTS:
        ARTIFACTS[name] = 0


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor  # 0-dim int32 on the parameters' device, as optax's


class VBPIState(NamedTuple):
    q_params: torch.Tensor  # (V, 2) lognormal (mu, sigma) per variable
    sbn_params: torch.Tensor  # (G,)
    opt_state: Tuple[AdamState, AdamState]  # (q_params, sbn_params)


class VBPIStatics(NamedTuple):
    """Shape-defining configuration for one support."""

    root_id: int
    num_segments: int
    use_vimco: bool
    # PSP branch model: branch_rep carries 3 component rows per branch whose
    # lognormal parameters sum (ICLR 2019); the last q_params row is the
    # zeroed sentinel for absent components.
    psp: bool = False
    # False: the likelihoods run unrescaled through the scan engine.
    rescale: bool = True


class Adam:
    """optax.adam per parameter group, as libsbn_tpu's make_optimizer
    builds it (optax.multi_transform of one adam per group): b1 0.9, b2
    0.999, eps 1e-8 added after the square root, bias correction, one state
    per group. ``update`` descends: it returns params - lr * step. The step
    count is a 0-dim int32 tensor on the parameters' device, so an update
    reads nothing from the host."""

    def __init__(self, learning_rates, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rates = tuple(learning_rates)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return tuple(
            AdamState(torch.zeros_like(p), torch.zeros_like(p),
                      torch.zeros((), dtype=torch.int32, device=p.device))
            for p in params
        )

    def update(self, grads, opt_state, params):
        """(new params, new opt_state) for grads and params of each group,
        in optax's order of operations."""
        b1, b2 = self.b1, self.b2
        new_params, new_state = [], []
        for lr, g, st, p in zip(self.learning_rates, grads, opt_state, params):
            mu = (1 - b1) * g + b1 * st.mu
            nu = (1 - b2) * (g ** 2) + b2 * st.nu
            count = st.count + 1
            # optax's bias correction: 1 - decay ** count in float64, then
            # the division in the moment's dtype.
            c = count.to(torch.float64)
            mu_hat = mu / (1 - b1 ** c).to(mu.dtype)
            nu_hat = nu / (1 - b2 ** c).to(nu.dtype)
            step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            new_params.append(p + step * (-lr))
            new_state.append(AdamState(mu, nu, count))
        return tuple(new_params), tuple(new_state)


def make_optimizer(scalar_lr=1e-3, sbn_lr=1e-3):
    return Adam((scalar_lr, sbn_lr))


def init_state(q_params, sbn_params, optimizer) -> VBPIState:
    return VBPIState(q_params, sbn_params,
                     optimizer.init((q_params, sbn_params)))


def state_from_numpy(q_params, sbn_params, adam, *, device, dtype):
    """The JAX package's VBPIState, as numpy, to this package's: q_params
    (V, 2), sbn_params (G,), and adam = ((mu, nu, count) of the q_params
    group, (mu, nu, count) of the sbn_params group), the optax Adam states
    that libsbn_tpu's make_optimizer keeps."""

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    opt_state = tuple(
        AdamState(t(mu), t(nu), torch.tensor(int(count), dtype=torch.int32,
                                             device=device))
        for mu, nu, count in adam)
    return VBPIState(t(q_params), t(sbn_params), opt_state)


def _branch_lengths(q_params, branch_rep, eps):
    """Reparameterized branch lengths theta = exp(mu + sigma * eps), with
    (mu, sigma) summed over each branch's C component variables (for the
    split model C = 1; for PSP the zeroed sentinel row absorbs absent
    components). Returns (mu, sigma, theta), each (P, B)."""
    mu = q_params[branch_rep, 0].sum(dim=1)
    sigma = q_params[branch_rep, 1].sum(dim=1)
    return mu, sigma, torch.exp(mu + sigma * eps)


def _log_f_terms(sbn_params, segment_ids, num_segments, reps, mu, sigma,
                 theta):
    """log prior - log q_sbn - log q_branch per particle, (P,)."""
    n_branches = theta.shape[1]
    log_prior = (n_branches * math.log(PRIOR_RATE)
                 - PRIOR_RATE * torch.sum(theta, dim=1))
    normalized = sbn_probability.probability_normalize_in_log(
        sbn_params, segment_ids, num_segments
    )
    log_rho = torch.sum(sbn_probability.with_sentinel(normalized)[reps], -1)
    log_q_sbn = torch.logsumexp(log_rho, -1)
    log_theta = torch.log(theta)
    log_q_branch = torch.sum(
        -log_theta - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi)
        - (log_theta - mu) ** 2 / (2.0 * sigma ** 2),
        dim=1,
    )
    return log_prior - log_q_sbn - log_q_branch


@functools.lru_cache(maxsize=None)
def _jc69_constants(dtype, device):
    """(freqs, evec, ivec, evals, Q (1, 4, 4), ones (1,)) of JC69, made once
    per dtype and device: built from host lists, they could not be made
    inside a CUDA graph capture."""
    freqs, evec, ivec, evals = substitution.jc69_eigen(dtype=dtype,
                                                       device=device)
    return (freqs, evec, ivec, evals,
            substitution.jc69_q(dtype=dtype, device=device)[None],
            torch.ones(1, dtype=dtype, device=device))


def _scan_inputs(theta):
    """The scan engine's JC69 inputs for branch lengths theta (P, B):
    per-tree transition matrices (P, B + 2, 1, 4, 4) over the padded
    lengths, the rate matrix (1, 4, 4), freqs and props."""
    freqs, evec, ivec, evals, Q, ones = _jc69_constants(theta.dtype,
                                                        theta.device)
    P = pruning.node_transition_matrices(
        evec, ivec, evals, torch.nn.functional.pad(theta, (0, 2)), ones)
    return P, Q, freqs, ones


def vbpi_train_step(
    state: VBPIState,
    statics: VBPIStatics,
    optimizer: Adam,
    # Per-step host-sampled inputs, on the device:
    post_children,  # (P, S, 3) int32, contiguous
    branch_rep,  # (P, C, B) int64 variable indices per branch
    reps,  # (P, E, R) int64 unrooted indexer representations
    touched,  # (P, E, Sm) int64 touched segments
    eps,  # (P, B) standard normals
    beta,  # annealing scalar: a float or a 0-dim tensor on the device
    # Constant model data:
    tips,  # (L, 4, patterns)
    weights,  # (patterns,)
    segment_ids,  # (G,) int64
    mesh=None,
):
    """One full VBPI gradient step. Returns (new_state, metrics).

    mesh: None for one device. A Mesh splits the particles over its dp
    devices through K1's sharded wrapper (the unrescaled scan engine runs
    on the first device). A distributed mesh (distributed.global_mesh)
    holds this rank's particles: the step gathers every rank's LLs and
    log f, which the VIMCO baselines and the metrics need, and all-reduces
    the scalar and SBN gradient sums, so every rank takes the same update:
    the psums that XLA inserts into the JAX package's step."""
    q_params, sbn_params, opt_state = state
    P_count, C, B = branch_rep.shape

    # 1. Reparameterized branch lengths.
    mu, sigma, theta = _branch_lengths(q_params, branch_rep, eps)

    # 2. Batched pruning: likelihoods + linear-time branch gradients (K1,
    # or the unrescaled scan engine).
    if statics.rescale:
        bl_padded = torch.nn.functional.pad(theta, (0, 2))  # root + ones slots
        args = (post_children, bl_padded, tips, weights)
        if mesh is None:
            lls, bgrads = pruning_jc.log_likelihood_and_branch_gradient_jc69(
                *args, root_id=statics.root_id)
        else:
            lls, bgrads = (
                pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
                    mesh, *args, root_id=statics.root_id))
    else:
        P, Qs, freqs, props = _scan_inputs(theta)
        lls, bgrads = pruning.log_likelihood_and_branch_gradient(
            post_children, P, Qs, tips, freqs, props, weights,
            root_id=statics.root_id, rescale=False,
        )

    # 3. Scalar lognormal gradient, eq:dLdPsi: each branch's per-occurrence
    # contribution scatters onto all C of its component variables.
    dlogp = bgrads - PRIOR_RATE  # + d log prior / d theta
    g0 = dlogp * theta - (-1.0)
    g1 = dlogp * theta * eps - (-eps - 1.0 / sigma)
    V = q_params.shape[0]
    g01 = torch.stack([g0, g1], dim=-1)[:, None]  # (P, 1, B, 2)
    scalar_grad = sbn_probability.fixed_order_scatter_add(
        q_params.new_zeros((V, 2)), branch_rep.reshape(-1),
        g01.expand(P_count, C, B, 2).reshape(-1, 2))
    if statics.psp:
        scalar_grad[V - 1] = 0.0  # the sentinel row stays zero

    # 4. log f = beta*loglike + log prior - log q_sbn - log q_branch.
    log_f = beta * lls + _log_f_terms(
        sbn_params, segment_ids, statics.num_segments, reps, mu, sigma, theta
    )

    # Across ranks: every particle's LL and log f, in rank order.
    rows = None
    if mesh is not None and mesh.distributed:
        both = distributed.gather_rows(torch.stack([lls, log_f], dim=1), mesh)
        lls, log_f = both[:, 0], both[:, 1]
        rows = slice(mesh.rank * P_count, (mesh.rank + 1) * P_count)

    # 5. VIMCO topology gradient (over this rank's particles).
    sbn_grad = sbn_gradients.topology_gradients(
        sbn_params, segment_ids, statics.num_segments, reps, touched, log_f,
        use_vimco=statics.use_vimco, rows=rows,
    )
    if rows is not None:
        flat = distributed.all_reduce_sum(
            torch.cat([scalar_grad.reshape(-1), sbn_grad]), mesh)
        scalar_grad = flat[:2 * V].reshape(V, 2)
        sbn_grad = flat[2 * V:]

    # 6. Ascent step (Adam descends, so negate).
    (q_params, sbn_params), opt_state = optimizer.update(
        (-scalar_grad, -sbn_grad), opt_state, (q_params, sbn_params)
    )
    metrics = {"mean_ll": torch.mean(lls), "elbo_like": torch.mean(log_f)}
    return VBPIState(q_params, sbn_params, opt_state), metrics


def vbpi_log_f(state: VBPIState, statics: VBPIStatics, post_children,
               branch_rep, reps, eps, tips, weights, segment_ids):
    """Per-particle log f = loglike + log prior - log q_sbn - log q_branch
    at beta = 1, with NO parameter update (K2 for the LLs, or the unrescaled
    scan engine): the evaluation half of vbpi_train_step, for ELBO and
    importance-sampled marginal estimates (vip burrito.py:127-183)."""
    q_params, sbn_params, _ = state
    mu, sigma, theta = _branch_lengths(q_params, branch_rep, eps)
    if statics.rescale:
        lls = pruning_jc.log_likelihoods_jc69(
            post_children, torch.nn.functional.pad(theta, (0, 2)), tips,
            weights, root_id=statics.root_id,
        )
    else:
        P, _, freqs, props = _scan_inputs(theta)
        lls = pruning.log_likelihoods(
            post_children, P, tips, freqs, props, weights,
            root_id=statics.root_id, rescale=False,
        )
    return lls + _log_f_terms(sbn_params, segment_ids, statics.num_segments,
                              reps, mu, sigma, theta)


def pack_ints(ints):
    """The host's int32 step inputs (post_children, branch_rep, reps,
    touched), each with the same leading axes ((P,) or (K, P)), packed by
    columns into one int32 array (*lead, W); returns it and the arrays'
    per-particle shapes, which ``unpack_ints`` takes."""
    lead = ints[0].shape[:-2]
    n = int(np.prod(lead))
    shapes = tuple(tuple(a.shape[len(lead):]) for a in ints)
    packed = np.concatenate(
        [np.ascontiguousarray(a, dtype=np.int32).reshape(n, -1)
         for a in ints], axis=1,
    )
    return packed.reshape(lead + (packed.shape[1],)), shapes


def unpack_ints(packed, shapes):
    """The step's int inputs from a packed (..., W) int32 tensor, as
    vbpi_train_step takes them: post_children int32 (contiguous, as K1 takes
    it), branch_rep, reps and touched int64."""
    lead = tuple(packed.shape[:-1])
    out, offset = [], 0
    for shp in shapes:
        width = math.prod(shp)
        out.append(packed[..., offset:offset + width].reshape(lead + shp))
        offset += width
    if offset != packed.shape[-1]:
        raise ValueError(f"packed width {packed.shape[-1]} != {offset}, the "
                         f"width of shapes {shapes}")
    return (out[0].contiguous(),) + tuple(a.long() for a in out[1:])


def vbpi_train_step_packed(state, statics, optimizer, packed, eps, beta,
                           shapes, tips, weights, segment_ids, mesh=None):
    """vbpi_train_step with its int32 inputs packed into ONE (P, W) buffer
    (``pack_ints``; shapes: their per-particle shapes), unpacked as views on
    the device. Returns (new_state, metrics)."""
    return vbpi_train_step(
        state, statics, optimizer, *unpack_ints(packed, shapes), eps, beta,
        tips, weights, segment_ids, mesh=mesh)


def vbpi_train_steps_packed(state, statics, optimizer, packed_k, eps_k, betas,
                            shapes, tips, weights, segment_ids, mesh=None):
    """K training steps in order, as the JAX package's lax.scan over steps:
    step k reads packed_k[k] (P, W), eps_k[k] (P, B) and betas[k] (betas:
    (K,), a tensor or a sequence of floats) and starts from the state the
    step before it left. Returns (state, metrics stacked to (K,)). On a card
    JitVBPI captures this function in one CUDA graph per window length, so
    that a window is one dispatch."""
    per_step = []
    for k in range(packed_k.shape[0]):
        state, metrics = vbpi_train_step_packed(
            state, statics, optimizer, packed_k[k], eps_k[k], betas[k],
            shapes, tips, weights, segment_ids, mesh=mesh)
        per_step.append(metrics)
    return state, {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]}


def vbpi_log_f_packed(state, statics, packed, eps, shapes, tips, weights,
                      segment_ids):
    """vbpi_log_f (log f per particle at beta = 1, no update) from the
    packed int32 inputs of vbpi_train_step_packed."""
    post_children, branch_rep, reps, _ = unpack_ints(packed, shapes)
    return vbpi_log_f(state, statics, post_children, branch_rep, reps, eps,
                      tips, weights, segment_ids)


class JitVBPI:
    """Host driver around vbpi_train_step for an UnrootedInstance with a
    split-lognormal or PSP branch model.

    device: where the step runs; the engine's device unless the caller names
    another. mesh: a parallel.sharding.Mesh, in place of ``device``; the
    step's state lives on its first device. A local mesh splits each
    step's particles over its dp devices. A global mesh
    (parallel.distributed.global_mesh, from every rank) makes
    particle_count the global batch: each rank samples its
    particle_count / world_size particles and the step combines the ranks'
    sums, so the replicated parameters stay bit-identical across ranks.
    dtype: float64 unless the caller names float32. Host randomness is
    numpy's default_rng(seed + 7919 * rank), as in the JAX package, so both
    sample the same topologies and normals for a seed.

    Routes, chosen by configuration: on a CUDA device with no mesh (and
    ``cuda_graphs`` left True) every window of steps is one replay of a
    captured CUDA graph of vbpi_train_steps_packed (vi/step_graph.py; K = 1
    for step() and step_overlapped(), K for step_many(K)), the counterpart
    of the JAX package's one dispatch, for K1 and for the unrescaled scan
    engine alike. The state then lives in the graphs' static buffers:
    ``state`` returns them, and assigning it copies into them. A capture
    or replay error raises. On the CPU, on a mesh, or with
    ``cuda_graphs=False``, the steps run eagerly."""

    def __init__(self, inst, particle_count: int, mesh=None, use_vimco=True,
                 scalar_lr=1e-3, sbn_lr=1e-3, dtype=torch.float64, seed=0,
                 rescale=True, branch_model: str = "split", device=None,
                 cuda_graphs=True):
        if mesh is not None:
            check_mesh(mesh)
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: the "
                                 "mesh's first device holds the state")
            device = mesh.first_device
        if branch_model not in ("split", "psp"):
            raise ValueError(f"branch_model must be split or psp, got "
                             f"{branch_model!r}")
        engine = inst.engine
        if engine is None:
            raise RuntimeError("Call prepare_for_phylo_likelihood first.")
        if engine.spec.substitution != "JC69" or engine.spec.site != "constant":
            raise ValueError("the VBPI step is JC69 with constant rates")
        device = engine.device if device is None else torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested, but no CUDA device is present"
            )
        self.inst = inst
        self.particle_count = particle_count
        self.mesh = mesh
        self.local_particle_count = (
            particle_count if mesh is None
            else distributed.local_particle_count(mesh, particle_count))
        self.device = device
        self.dtype = dtype
        # Decorrelated per-rank sampling streams, as in the JAX package.
        rank = 0 if mesh is None else mesh.rank
        self.rng = np.random.default_rng(seed + 7919 * rank)
        self._artifact_cache = {}
        self._pending_sample = None
        # The state's version, bumped by every update and assignment, and
        # the (version, host buffer, event) of its sbn_params' copy.
        self._version = 0
        self._params_copy = (None, None, None)
        self._state = None
        self.graphs = None
        # The topology sampler of the last batch: "native" (the C++ bulk
        # sampler) or "python" (sbn/sampling.py SBNSampler).
        self.last_sampler = None
        # The host samples (ints, eps) of the last step(), this rank's.
        self.last_batch = None

        segment_ids = inst.sbn_support.segment_ids()
        self.segment_ids = torch.as_tensor(segment_ids, dtype=torch.long,
                                           device=device)
        num_segments = int(segment_ids.max(initial=0)) + 1
        self.tips = engine.tips.to(device=device, dtype=dtype)
        self.weights = engine.weights.to(device=device, dtype=dtype)

        self.branch_model = branch_model
        details = inst.psp_indexer.details()
        if branch_model == "split":
            V = details["after_rootsplits_index"]
            q0 = np.full((V, 2), [-2.0, 0.5])
        else:
            # PSP: one variable per rootsplit/down/up component plus the
            # zeroed sentinel row (branch_models.py PSPModel).
            V = details["first_empty_index"] + 1
            q0 = np.full((V, 2), [-2.0 / 3.0, 0.5 / 3.0])
            q0[-1] = 0.0
        self.optimizer = make_optimizer(scalar_lr, sbn_lr)
        self.state = init_state(
            self._tensor(q0), self._tensor(inst.sbn_parameters),
            self.optimizer,
        )
        self.statics = VBPIStatics(
            root_id=2 * inst.sbn_support.taxon_count() - 3,
            num_segments=num_segments,
            use_vimco=use_vimco,
            psp=(branch_model == "psp"),
            rescale=rescale,
        )
        if device.type == "cuda" and mesh is None and cuda_graphs:
            self.graphs = step_graph.StepGraphs(
                self._state, self._run_window_eagerly, device)

    @property
    def state(self) -> VBPIState:
        """The training state; on the graph route the captured graphs'
        static buffers, updated in place by each window."""
        return self._state

    @state.setter
    def state(self, value):
        dev = value.q_params.device
        value = VBPIState(value.q_params, value.sbn_params, tuple(
            AdamState(st.mu, st.nu, torch.as_tensor(st.count, dtype=torch.int32,
                                                    device=dev))
            for st in value.opt_state))
        if self.graphs is None:
            self._state = value
        else:
            self.graphs.assign(value)
        self._version += 1

    def _tensor(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)

    def mode_match(self, split_modes):
        """Mode-matched lognormal initialization from per-split branch-length
        modes (scalar_model.py:95-101 / branch_model.py PSPModel.mode_match),
        e.g. the last MCMC sample's split lengths (benchmark.py:61). Resets
        the optimizer state."""
        split_modes = np.asarray(split_modes)
        q = np.zeros(tuple(self.state.q_params.shape))
        log_modes = np.log(np.clip(split_modes, 1e-6, None))
        biclipped = np.log(np.clip(split_modes, 1e-6, 1 - 1e-6))
        n_split = split_modes.size
        if self.branch_model == "split" and n_split != q.shape[0]:
            raise ValueError(f"{n_split} split modes for {q.shape[0]} splits")
        q[:n_split, 1] = -0.1 * biclipped
        q[:n_split, 0] = np.square(q[:n_split, 1]) + log_modes
        if self.branch_model == "psp":
            q[-1] = 0.0  # sentinel row
        self.state = init_state(self._tensor(q), self.state.sbn_params,
                                self.optimizer)

    # -- host side: sampling and lowering -----------------------------------
    def _topology_artifacts(self, key, top=None):
        """Per-topology host arrays, cached: sampled topologies repeat
        heavily once the SBN concentrates, so the lowering (schedule row,
        indexer representations, touched segments) is paid once per
        distinct topology. Returns (post_children (S, 3), branch_rep (C, B),
        rep (E, R), touched (E, Sm)), all int32.

        ``key`` is either the Topology itself (Python-sampler path) or the
        tuple of its canonical parent-id vector. On the tuple path with the
        native core available, the whole miss is C++-side (schedule builder
        + indexer representations) and never constructs a Python Topology;
        branch_rep falls out as rep[:, 0] (the PSP rootsplit row equals the
        split-index column by construction, psp_indexer.cpp:31-48)."""
        cached = self._artifact_cache.get(key)
        if cached is not None:
            ARTIFACTS["hits"] += 1
            return cached
        ARTIFACTS["misses"] += 1
        with annotate("libsbn.vbpi.lower_miss"):
            artifacts = self._lower_topology(key, top)
        self._artifact_cache[key] = artifacts
        return artifacts

    def _lower_topology(self, key, top):
        """_topology_artifacts' miss: the lowering of one topology."""
        support = self.inst.sbn_support
        psp = self.statics.psp
        rep = None
        L = support.taxon_count()
        root_id = self.statics.root_id
        if top is None and not isinstance(key, Topology):
            pv = np.asarray(key, dtype=np.int32)
            reps = support.dense_representations_of_parent_vectors(pv[None])
            sched_dict = native.build_schedules(pv[None], L)
            branch_rep = None
            if reps is not None and sched_dict is not None:
                if psp:
                    # Native PSP rows (lsbn_psp_representations).
                    prep = self.inst.psp_indexer.\
                        dense_representations_of_parent_vectors(pv[None])
                    if prep is not None:
                        branch_rep = np.ascontiguousarray(prep[0])
                else:
                    branch_rep = np.ascontiguousarray(reps[0][None, :, 0])
            if branch_rep is not None:
                rep = reps[0]
                post_node = sched_dict["post_node"][0]
                post_children = sched_dict["post_children"][0]
        if rep is None:
            if top is None:
                top = key if isinstance(key, Topology) else (
                    Topology.of_parent_id_vector(list(key))
                )
            sched = schedule_ops.schedule_of_topology(top)
            post_node, post_children = sched.post_node, sched.post_children
            psp_rep = np.asarray(
                self.inst.psp_indexer.representation_of(top), dtype=np.int32,
            )  # (3, B)
            branch_rep = psp_rep if psp else psp_rep[:1]
            rep = support.dense_representations([top])[0]
        pruning_jc.check_schedule(post_node, post_children, L, root_id)
        touched = sbn_gradients.touched_segments_of(
            support, rep[None], pad_to=4 * L
        )[0]
        return (np.asarray(post_children, np.int32), branch_rep, rep,
                touched)

    def _get_native_sampler(self):
        if not hasattr(self, "_native_sampler"):
            self._native_sampler = NativeSBNSampler(
                self.inst.sbn_support, self.inst.sbn_parameters,
                seed=int(self.rng.integers(2**31)),
            )
        return self._native_sampler

    def _sample_artifacts(self, sbn_params_np, count):
        """Sample ``count`` topologies from a host-side SBN parameter vector
        and lower them: a list of per-topology artifact tuples."""
        # Refresh the sampler. Prefer the native bulk sampler: it emits
        # canonical parent-id vectors that key the artifact cache directly.
        with annotate("libsbn.vbpi.sample"):
            self.inst.sbn_parameters = np.array(sbn_params_np)
            native_sampler = self._get_native_sampler()
            native_sampler.refresh_parameters(self.inst.sbn_parameters)
            pvs = native_sampler.sample_parent_vectors(count, rooted=False)
            if pvs is not None:
                self.last_sampler = "native"
            else:
                # The reference's host algorithm, when the native library
                # is unavailable (not a device fallback); its draws do not
                # depend on the lowering, so they are all made first.
                self.last_sampler = "python"
                self.inst._sampler = None
                sampler = self.inst._get_sampler()
                tops = [sampler.sample_topology(rooted=False)
                        for _ in range(count)]
        with annotate("libsbn.vbpi.lower"):
            keys = tops if pvs is None else (tuple(map(int, row))
                                             for row in pvs)
            return [self._topology_artifacts(key) for key in keys]

    def _host_sample_from(self, sbn_params_np, count=None):
        """Sample topologies from an explicit host-side SBN parameter vector
        and lower them to step inputs: (ints, eps) with ints the four int32
        arrays (post_children, branch_rep, reps, touched) stacked over
        particles and eps (P, B) standard normals."""
        count = self.local_particle_count if count is None else count
        artifacts = self._sample_artifacts(sbn_params_np, count)
        ints = tuple(np.stack(column) for column in zip(*artifacts))
        eps = self.rng.standard_normal((count, ints[1].shape[-1]))
        return ints, eps

    def _host_sample(self, count=None):
        """Sample from the CURRENT parameters (waits for them)."""
        return self._host_sample_from(self._host_params(), count)

    def _start_params_copy(self):
        """Start the device-to-host copy of the current sbn_params: into
        pinned memory without blocking on a card, so a later step's sampler
        finds it there; after a graph's replay, in order on the same stream.
        One copy per version of the state."""
        with annotate("libsbn.vbpi.params_copy"):
            p = self.state.sbn_params
            if p.device.type == "cuda":
                buf = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                buf.copy_(p, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(p.device))
            else:
                buf, event = p.clone(), None
        self._params_copy = (self._version, buf, event)

    def _current_params_copy(self):
        """(version, host buffer, event) of the current sbn_params' one
        copy: the one the step that made them started, or a new one."""
        if self._params_copy[0] != self._version:
            self._start_params_copy()
        return self._params_copy

    @staticmethod
    def _wait(params_copy) -> np.ndarray:
        _, buf, event = params_copy
        if event is not None:
            with annotate("libsbn.vbpi.wait_params"):
                event.synchronize()
        return buf.numpy()

    def _host_params(self) -> np.ndarray:
        """The current sbn_params on the host."""
        return self._wait(self._current_params_copy())

    def _put_packed(self, ints, eps):
        """One host-to-device copy of the int32 arrays packed into a (P, W)
        buffer, one of eps: (packed, eps, shapes)."""
        packed, shapes = pack_ints(ints)
        eps = np.asarray(eps, _numpy_dtype(self.dtype))
        return (torch.from_numpy(packed).to(self.device),
                torch.from_numpy(eps).to(self.device), shapes)

    def _device_put(self, ints, eps):
        """The step's inputs on the device, as vbpi_train_step takes them:
        (post_children int32, branch_rep, reps, touched int64, eps), views
        of the packed buffer."""
        packed, eps, shapes = self._put_packed(ints, eps)
        return unpack_ints(packed, shapes) + (eps,)

    # -- steps -----------------------------------------------------------------
    def _check_single_process(self, what):
        if self.mesh is not None and self.mesh.distributed:
            raise RuntimeError(f"{what} is single-process; a distributed "
                               "mesh takes step()")

    def _run_window_eagerly(self, state, packed_k, eps_k, betas, shapes):
        return vbpi_train_steps_packed(
            state, self.statics, self.optimizer, packed_k, eps_k, betas,
            shapes, self.tips, self.weights, self.segment_ids, mesh=self.mesh)

    def _window(self, ints_k, eps_k, betas):
        """Steps over a window of K host samples: ints_k the four int32
        arrays (K, P, ...), eps_k (K, P, B), betas (K,). The packed ints go
        to the device in one copy, eps and betas in one more; then one
        replay of the window's graph on the graph route, else
        vbpi_train_steps_packed eagerly. Returns metrics stacked to (K,)."""
        with annotate("libsbn.vbpi.pack"):
            packed, shapes = pack_ints(ints_k)
            floats = np.concatenate([np.ravel(eps_k), np.ravel(betas)]
                                    ).astype(_numpy_dtype(self.dtype))
        if self.graphs is not None:
            metrics = self.graphs.run(packed, floats, shapes, eps_k.shape)
        else:
            packed = torch.from_numpy(packed).to(self.device)
            floats = torch.from_numpy(floats).to(self.device)
            n = eps_k.size
            self._state, metrics = self._run_window_eagerly(
                self._state, packed, floats[:n].view(eps_k.shape),
                floats[n:], shapes)
        self._version += 1
        self._start_params_copy()
        return metrics

    def _one_step(self, ints, eps, beta):
        metrics = self._window(tuple(a[None] for a in ints), eps[None], [beta])
        return {name: value[0] for name, value in metrics.items()}

    def step(self, beta: float = 1.0):
        """One gradient step: sample from the current parameters, then
        step (a window of one). Returns the metrics as 0-dim tensors on the
        device."""
        self._pending_sample = None  # see step_many: bound overlap staleness
        ints, eps = self._host_sample()
        self.last_batch = (ints, eps)
        return self._one_step(ints, eps, beta)

    def step_many(self, n_steps: int, beta=1.0):
        """n_steps gradient steps in ONE dispatch on the graph route (one
        replay of the window's graph), whose topologies are all sampled up
        front from the SBN as of the call (up to n_steps - 1 updates stale,
        as the JAX package's window is); branch sampling and every update
        use live parameters. beta may be a scalar or a (n_steps,)
        annealing schedule. Returns metrics stacked over steps, (n_steps,)
        tensors. Single-process."""
        self._check_single_process("step_many")
        # A batch pre-sampled by step_overlapped would be arbitrarily stale
        # by the time a later step_overlapped call consumed it; drop it so
        # staleness stays bounded at one dispatch.
        self._pending_sample = None
        K, P = int(n_steps), self.particle_count
        artifacts = self._sample_artifacts(self._host_params(), K * P)
        with annotate("libsbn.vbpi.pack"):
            ints = tuple(np.stack(column).reshape((K, P) + column[0].shape)
                         for column in zip(*artifacts))
            eps_k = self.rng.standard_normal((K, P, ints[1].shape[-1]))
            betas = np.broadcast_to(np.asarray(beta, dtype=np.float64), (K,))
        return self._window(ints, eps_k, betas)

    def step_overlapped(self, beta: float = 1.0):
        """One gradient step with host sampling overlapped against the
        in-flight device step (double buffering): batch t+1 is lowered on
        the host while the device runs step t, from the parameters before
        step t (one dispatch of staleness). The first call primes the
        pipeline synchronously, so it equals step() for the same seed.
        Single-process."""
        self._check_single_process("step_overlapped")
        if self._pending_sample is None:
            self._pending_sample = self._host_sample()  # pipeline fill
        ints, eps = self._pending_sample
        prev = self._current_params_copy()  # of the state before this step
        metrics = self._one_step(ints, eps, beta)
        # The previous step has finished by now (the device runs in order);
        # its parameters' copy was started when it was dispatched.
        self._pending_sample = self._host_sample_from(self._wait(prev))
        return metrics

    # -- evaluation ------------------------------------------------------------
    def log_f_values(self, particle_count: int) -> np.ndarray:
        """(particle_count,) per-particle log f at the current parameters
        (no update), on the host. Under a distributed mesh particle_count
        is global: each rank evaluates its share and every rank returns all
        of them, in rank order."""
        count = (particle_count if self.mesh is None
                 else distributed.local_particle_count(self.mesh,
                                                       particle_count))
        ints, eps = self._host_sample(count=count)
        packed, eps, shapes = self._put_packed(ints, eps)
        with torch.no_grad():
            logf = vbpi_log_f_packed(
                self.state, self.statics, packed, eps, shapes, self.tips,
                self.weights, self.segment_ids,
            )
            if self.mesh is not None:
                logf = distributed.gather_rows(logf, self.mesh)
        return logf.cpu().numpy()

    def estimate_elbo(self, particle_count: int) -> float:
        """Naive Monte Carlo ELBO (Burrito.estimate_elbo analog)."""
        return float(self.log_f_values(particle_count).mean())

    def marginal_likelihood_estimate(self, particle_count: int) -> float:
        """Importance-sampling marginal log likelihood: logsumexp(log f)
        - log n (Burrito.marginal_likelihood_estimate analog)."""
        logf = torch.from_numpy(self.log_f_values(particle_count))
        return float(torch.logsumexp(logf, 0)) - math.log(len(logf))


def _numpy_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64
