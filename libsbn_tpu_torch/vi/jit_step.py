"""The VBPI training step on a device: the counterpart of
libsbn_tpu/vi/jit_step.py, with the same names.

The host samples topologies (combinatorial) and standard normals; the rest
of a gradient step runs as tensor code on the device: reparameterized
branch lengths, the batched JC69 likelihood and linear-time branch
gradients (kernel K1, ops/pruning_jc.py), the eq:dLdPsi scalar gradients,
the VIMCO topology gradients and an Adam update. The evaluation half
(``vbpi_log_f``) takes the LL-only kernel K2. PyTorch runs eagerly, so
``vbpi_train_step`` is a plain function of tensors; nothing in it copies to
the host. On a CUDA device ``index_add_`` sums in no fixed order, so two
runs of a step agree to rounding, not bit for bit.

Branch models: split-lognormal (one variable per split, the benchmark
default) and PSP (three summed component variables per branch, ICLR 2019),
selected with ``branch_model=``: both run the same step with C = 1 or 3
component rows in branch_rep.

Not on this slice: a device mesh (``mesh=``, ROADMAP queue 1, item 11) and
``rescale=False`` (a route through the scan engine, item 4).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.topology import Topology
from ..io import native
from ..ops import pruning_jc
from ..ops import schedule as schedule_ops
from ..sbn import gradients as sbn_gradients
from ..sbn import probability as sbn_probability
from ..sbn.sampling import NativeSBNSampler

PRIOR_RATE = 10.0
MESH_TODO = (
    "mesh= is not ported yet (ROADMAP queue 1, item 11: torch.distributed)"
)
RESCALE_TODO = (
    "rescale=False is not ported for the VBPI step yet (ROADMAP queue 1, "
    "item 4: the step must route through the scan engine ops/pruning.py)"
)


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


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


class Adam:
    """optax.adam per parameter group, as libsbn_tpu's make_optimizer
    builds it (optax.multi_transform of one adam per group): b1 0.9, b2
    0.999, eps 1e-8 added after the square root, bias correction, one state
    per group. ``update`` descends: it returns params - lr * step."""

    def __init__(self, learning_rates, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rates = tuple(learning_rates)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return tuple(
            AdamState(torch.zeros_like(p), torch.zeros_like(p), 0)
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
            mu_hat = mu / (1 - b1 ** count)
            nu_hat = nu / (1 - b2 ** count)
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

    opt_state = tuple(AdamState(t(mu), t(nu), int(count))
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
    beta,  # annealing scalar
    # Constant model data:
    tips,  # (L, 4, patterns)
    weights,  # (patterns,)
    segment_ids,  # (G,) int64
):
    """One full VBPI gradient step. Returns (new_state, metrics)."""
    q_params, sbn_params, opt_state = state
    P_count, C, B = branch_rep.shape

    # 1. Reparameterized branch lengths.
    mu, sigma, theta = _branch_lengths(q_params, branch_rep, eps)

    # 2. Batched pruning: likelihoods + linear-time branch gradients (K1).
    bl_padded = torch.nn.functional.pad(theta, (0, 2))  # root + ones slots
    lls, bgrads = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        post_children, bl_padded, tips, weights, root_id=statics.root_id,
    )

    # 3. Scalar lognormal gradient, eq:dLdPsi: each branch's per-occurrence
    # contribution scatters onto all C of its component variables.
    dlogp = bgrads - PRIOR_RATE  # + d log prior / d theta
    g0 = dlogp * theta - (-1.0)
    g1 = dlogp * theta * eps - (-eps - 1.0 / sigma)
    V = q_params.shape[0]
    occ = branch_rep.reshape(-1)
    scalar_grad = torch.stack([
        q_params.new_zeros((V,)).index_add_(
            0, occ, g[:, None, :].expand(P_count, C, B).reshape(-1))
        for g in (g0, g1)
    ], dim=1)
    if statics.psp:
        scalar_grad[V - 1] = 0.0  # the sentinel row stays zero

    # 4. log f = beta*loglike + log prior - log q_sbn - log q_branch.
    log_f = beta * lls + _log_f_terms(
        sbn_params, segment_ids, statics.num_segments, reps, mu, sigma, theta
    )

    # 5. VIMCO topology gradient.
    sbn_grad = sbn_gradients.topology_gradients(
        sbn_params, segment_ids, statics.num_segments, reps, touched, log_f,
        use_vimco=statics.use_vimco,
    )

    # 6. Ascent step (Adam descends, so negate).
    (q_params, sbn_params), opt_state = optimizer.update(
        (-scalar_grad, -sbn_grad), opt_state, (q_params, sbn_params)
    )
    metrics = {"mean_ll": torch.mean(lls), "elbo_like": torch.mean(log_f)}
    return VBPIState(q_params, sbn_params, opt_state), metrics


def vbpi_log_f(state: VBPIState, statics: VBPIStatics, post_children,
               branch_rep, reps, eps, tips, weights, segment_ids):
    """Per-particle log f = loglike + log prior - log q_sbn - log q_branch
    at beta = 1, with NO parameter update (K2 for the LLs): the evaluation
    half of vbpi_train_step, for ELBO and importance-sampled marginal
    estimates (vip burrito.py:127-183)."""
    q_params, sbn_params, _ = state
    mu, sigma, theta = _branch_lengths(q_params, branch_rep, eps)
    lls = pruning_jc.log_likelihoods_jc69(
        post_children, torch.nn.functional.pad(theta, (0, 2)), tips, weights,
        root_id=statics.root_id,
    )
    return lls + _log_f_terms(sbn_params, segment_ids, statics.num_segments,
                              reps, mu, sigma, theta)


class JitVBPI:
    """Host driver around vbpi_train_step for an UnrootedInstance with a
    split-lognormal or PSP branch model, on one device.

    device: where the step runs; the engine's device unless the caller names
    another. dtype: float64 unless the caller names float32. Host randomness
    is numpy's default_rng(seed + 7919 * rank) with rank 0, as in the JAX
    package, so both sample the same topologies and normals for a seed."""

    def __init__(self, inst, particle_count: int, mesh=None, use_vimco=True,
                 scalar_lr=1e-3, sbn_lr=1e-3, dtype=torch.float64, seed=0,
                 rescale=True, branch_model: str = "split", device=None):
        if mesh is not None:
            raise NotImplementedError(MESH_TODO)
        if not rescale:
            raise NotImplementedError(RESCALE_TODO)
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
        self.device = device
        self.dtype = dtype
        # seed + 7919 * rank in the JAX package; one process here, rank 0.
        self.rng = np.random.default_rng(seed)
        self._artifact_cache = {}
        self._pending_sample = None
        self._params_copy = (None, None, None)
        # The topology sampler of the last batch: "native" (the C++ bulk
        # sampler) or "python" (sbn/sampling.py SBNSampler).
        self.last_sampler = None

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
        )

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
            return cached
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
        artifacts = (np.asarray(post_children, np.int32), branch_rep, rep,
                     touched)
        self._artifact_cache[key] = artifacts
        return artifacts

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
        self.inst.sbn_parameters = np.array(sbn_params_np)
        native_sampler = self._get_native_sampler()
        native_sampler.refresh_parameters(self.inst.sbn_parameters)
        pvs = native_sampler.sample_parent_vectors(count, rooted=False)
        if pvs is not None:
            self.last_sampler = "native"
            return [self._topology_artifacts(tuple(map(int, row)))
                    for row in pvs]
        # The reference's host algorithm, when the native library is
        # unavailable (not a device fallback).
        self.last_sampler = "python"
        self.inst._sampler = None
        sampler = self.inst._get_sampler()
        return [self._topology_artifacts(sampler.sample_topology(rooted=False))
                for _ in range(count)]

    def _host_sample_from(self, sbn_params_np, count=None):
        """Sample topologies from an explicit host-side SBN parameter vector
        and lower them to step inputs: (ints, eps) with ints the four int32
        arrays (post_children, branch_rep, reps, touched) stacked over
        particles and eps (P, B) standard normals."""
        count = self.particle_count if count is None else count
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
        finds it there. One copy per state."""
        p = self.state.sbn_params
        if p.device.type == "cuda":
            buf = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            buf.copy_(p, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(p.device))
        else:
            buf, event = p.clone(), None
        self._params_copy = (p, buf, event)

    def _current_params_copy(self):
        """(source, host buffer, event) of the current sbn_params' one copy:
        the one the step that made them started, or a new one."""
        if self._params_copy[0] is not self.state.sbn_params:
            self._start_params_copy()
        return self._params_copy

    @staticmethod
    def _wait(params_copy) -> np.ndarray:
        _, buf, event = params_copy
        if event is not None:
            event.synchronize()
        return buf.numpy()

    def _host_params(self) -> np.ndarray:
        """The current sbn_params on the host."""
        return self._wait(self._current_params_copy())

    def _device_put(self, ints, eps):
        """One host-to-device copy of the int32 arrays packed into a (P, W)
        buffer, one of eps; then the step's views on the device:
        (post_children int32, branch_rep, reps, touched int64, eps)."""
        lead = ints[0].shape[:-2]  # (P,) or (K, P)
        n = int(np.prod(lead))
        shapes = [a.shape[len(lead):] for a in ints]
        packed = np.concatenate(
            [np.ascontiguousarray(a, dtype=np.int32).reshape(n, -1)
             for a in ints], axis=1,
        )
        packed = torch.from_numpy(packed).to(self.device)
        eps = torch.as_tensor(eps.astype(_numpy_dtype(self.dtype))).to(
            self.device)
        out, offset = [], 0
        for shp in shapes:
            width = int(np.prod(shp))
            out.append(packed[:, offset:offset + width].reshape(lead + shp))
            offset += width
        post_children = out[0].contiguous()
        return (post_children,) + tuple(a.long() for a in out[1:]) + (eps,)

    # -- steps -----------------------------------------------------------------
    def _dispatch(self, inputs, beta):
        post_children, branch_rep, reps, touched, eps = inputs
        self.state, metrics = vbpi_train_step(
            self.state, self.statics, self.optimizer, post_children,
            branch_rep, reps, touched, eps, beta, self.tips, self.weights,
            self.segment_ids,
        )
        self._start_params_copy()
        return metrics

    def step(self, beta: float = 1.0):
        """One gradient step: sample from the current parameters, then
        step. Returns the metrics as 0-dim tensors on the device."""
        self._pending_sample = None  # see step_many: bound overlap staleness
        ints, eps = self._host_sample()
        return self._dispatch(self._device_put(ints, eps), beta)

    def step_many(self, n_steps: int, beta=1.0):
        """n_steps gradient steps whose topologies are all sampled up front
        from the SBN as of the call (up to n_steps - 1 updates stale, as the
        JAX package's one-dispatch window is); branch sampling and every
        update use live parameters. beta may be a scalar or a (n_steps,)
        annealing schedule. Returns metrics stacked over steps, (n_steps,)
        tensors."""
        # A batch pre-sampled by step_overlapped would be arbitrarily stale
        # by the time a later step_overlapped call consumed it; drop it so
        # staleness stays bounded at one dispatch.
        self._pending_sample = None
        K, P = int(n_steps), self.particle_count
        artifacts = self._sample_artifacts(self._host_params(), K * P)
        ints = tuple(np.stack(column).reshape((K, P) + column[0].shape)
                     for column in zip(*artifacts))
        eps_k = self.rng.standard_normal((K, P, ints[1].shape[-1]))
        betas = np.broadcast_to(np.asarray(beta, dtype=np.float64), (K,))
        inputs = self._device_put(ints, eps_k)
        metrics = [self._dispatch(tuple(a[k] for a in inputs), float(betas[k]))
                   for k in range(K)]
        return {name: torch.stack([m[name] for m in metrics])
                for name in metrics[0]}

    def step_overlapped(self, beta: float = 1.0):
        """One gradient step with host sampling overlapped against the
        in-flight device step (double buffering): batch t+1 is lowered on
        the host while the device runs step t, from the parameters before
        step t (one dispatch of staleness). The first call primes the
        pipeline synchronously, so it equals step() for the same seed."""
        if self._pending_sample is None:
            self._pending_sample = self._host_sample()  # pipeline fill
        ints, eps = self._pending_sample
        prev = self._current_params_copy()  # of the state before this step
        metrics = self._dispatch(self._device_put(ints, eps), beta)
        # The previous step has finished by now (the device runs in order);
        # its parameters' copy was started when it was dispatched.
        self._pending_sample = self._host_sample_from(self._wait(prev))
        return metrics

    # -- evaluation ------------------------------------------------------------
    def log_f_values(self, particle_count: int) -> np.ndarray:
        """(particle_count,) per-particle log f at the current parameters
        (no update), on the host."""
        ints, eps = self._host_sample(count=particle_count)
        post_children, branch_rep, reps, _, eps = self._device_put(ints, eps)
        with torch.no_grad():
            logf = vbpi_log_f(
                self.state, self.statics, post_children, branch_rep, reps,
                eps, self.tips, self.weights, self.segment_ids,
            )
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
