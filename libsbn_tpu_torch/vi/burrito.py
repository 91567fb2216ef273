"""The Burrito: the VBPI training loop (reference: vip/burrito.py; the
counterpart of libsbn_tpu.vi.burrito).

Terminology follows the reference: "particles" are the sampled (topology,
branch lengths) pairs; `px_` prefixes arrays whose first axis ranges over
particles.

Data flow per gradient step:
  1. sample particle_count topologies from the SBN (host, the instance's
     numpy sampler);
  2. lower them to one batched schedule; branch representations are dense
     int arrays;
  3. sample branch lengths via the reparameterized scalar model (host, its
     numpy Generator);
  4. ONE engine call on the engine's device returns all log likelihoods
     and branch gradients (K1 for JC69, K4 for GTR; replacing the
     reference's FatBeagle thread pool);
  5. scalar/SBN gradients assembled via the eq:dLdPsi scatter and the VIMCO
     topology gradients (host);
  6. Adam step on both parameter groups (host, vi/optimizers.py).
Each ELBO or marginal-likelihood estimate is one ``engine.log_likelihoods``
(K2 for JC69, K5 for GTR). The host draws in libsbn_tpu's order, so a seed
gives its topologies and branch lengths. The sampler sees every SBN update
(the instance hands it each new parameter array); libsbn_tpu's keeps the
parameters it was built with, so the two trajectories agree once its
sampler is refreshed after each update too.
"""

from __future__ import annotations

import numpy as np
from scipy.special import logsumexp

from ..instance import UnrootedInstance
from ..models.phylo_model import PhyloModelSpec
from ..utils.device import DEFAULT_DEVICE
from . import branch_models, optimizers


class Burrito:
    def __init__(
        self,
        *,
        mcmc_nexus_path: str,
        burn_in_fraction: float,
        fasta_path: str,
        phylo_model_specification: PhyloModelSpec,
        branch_model_name: str,
        scalar_model_name: str,
        optimizer_name: str,
        particle_count: int,
        thread_count: int = 1,
        use_vimco: bool = True,
        seed: int = 0,
        device=DEFAULT_DEVICE,
        dtype=None,
    ):
        """device: where the likelihood engine computes, the card unless
        the caller passes device="cpu"; dtype: float64 unless the caller
        names float32 (both passed to prepare_for_phylo_likelihood)."""
        self.particle_count = particle_count
        self.use_vimco = use_vimco
        self.inst = UnrootedInstance("burrito")

        # Read the MCMC run to get the topology support.
        self.inst.read_nexus_file(mcmc_nexus_path)
        burn_in_count = int(burn_in_fraction * self.inst.tree_count())
        self.inst.tree_collection.erase(0, burn_in_count)
        self.inst.process_loaded_trees()
        self.inst.set_seed(seed)

        # Set up the likelihood engine.
        self.inst.read_fasta_file(fasta_path)
        self.inst.prepare_for_phylo_likelihood(
            phylo_model_specification, thread_count, device=device,
            dtype=dtype,
        )
        rng = np.random.default_rng(seed)
        self.branch_model = branch_models.of_name(
            branch_model_name, scalar_model_name, self.inst, rng
        )
        self.opt = optimizers.of_name(
            optimizer_name, self.inst, self.branch_model.scalar_model,
            self.estimate_elbo,
        )
        self.elbo_trace = []
        # The schedule and (B, N + 1) branch-length matrix of the last
        # engine call, for a caller that replays that call.
        self.last_schedule = self.last_branch_lengths = None

    @property
    def scalar_model(self):
        return self.branch_model.scalar_model

    def sample_topologies(self, count: int):
        """Sample topologies into the instance (branch lengths overwritten
        by the scalar model sample)."""
        self.inst.sample_trees(count)

    def _engine_arrays(self, px_theta_sample):
        """Pack sampled branch lengths into the (B, N) engine matrix: the
        root slot gets 0."""
        P, branches = px_theta_sample.shape
        bl = np.zeros((P, branches + 1))
        bl[:, :branches] = px_theta_sample
        return bl

    def gradient_step(self, beta_t: float = 1.0):
        self.sample_topologies(self.particle_count)
        px_branch_representation = self.branch_model.px_branch_representation()
        (
            px_theta_sample,
            dg_dpsi,
            dlog_qg_dpsi,
        ) = self.branch_model.sample_and_gradients(px_branch_representation)
        # One batched engine call: likelihoods + branch gradients.
        sched = self.last_schedule = self.inst._batched_schedule()
        bl = self.last_branch_lengths = self._engine_arrays(px_theta_sample)
        engine = self.inst._get_engine()
        lls, branch_grads = engine.branch_gradients(
            sched, bl, self.inst.phylo_model_params
        )
        lls = lls.cpu().numpy()
        branch_grads = branch_grads.cpu().numpy()
        # Write sampled branch lengths into the instance trees so that
        # calculate_sbn_probabilities / representations see them.
        for i, tree in enumerate(self.inst.tree_collection.trees):
            tree.branch_lengths[:-1] = px_theta_sample[i]

        scalar_grad = self.branch_model.scalar_grad(
            px_theta_sample,
            branch_grads,
            px_branch_representation,
            dg_dpsi,
            dlog_qg_dpsi,
        )
        px_phylo_log_like = beta_t * lls
        px_log_f = self.px_log_f(
            px_phylo_log_like, px_theta_sample, px_branch_representation
        )
        sbn_grad = self.inst.topology_gradients(px_log_f, self.use_vimco)
        self.opt.gradient_step(
            {"scalar_params": scalar_grad, "sbn_params": sbn_grad}
        )

    def gradient_steps(self, step_count: int, progress: bool = False):
        betas = np.maximum(
            np.arange(1, step_count + 1, dtype=np.float64) / step_count, 0.001
        )
        for step in range(step_count):
            self.gradient_step(betas[step])
            self.elbo_trace.append(self.estimate_elbo(self.particle_count))
            if progress:
                # The reference renders a click progress bar here
                # (burrito.py:122); one status line per step.
                print(
                    f"VBPI [{step + 1}/{step_count}] "
                    f"elbo {self.elbo_trace[-1]:.4f} beta {betas[step]:.3f}",
                    flush=True,
                )

    def _sample_and_likelihoods(self, particle_count: int):
        self.sample_topologies(particle_count)
        px_branch_representation = self.branch_model.px_branch_representation()
        px_theta_sample = self.branch_model.sample(px_branch_representation)
        for i, tree in enumerate(self.inst.tree_collection.trees):
            tree.branch_lengths[:-1] = px_theta_sample[i]
        sched = self.last_schedule = self.inst._batched_schedule()
        bl = self.last_branch_lengths = self._engine_arrays(px_theta_sample)
        engine = self.inst._get_engine()
        lls = engine.log_likelihoods(
            sched, bl, self.inst.phylo_model_params,
        ).cpu().numpy()
        return lls, px_theta_sample, px_branch_representation

    def estimate_elbo(self, particle_count: int) -> float:
        """Naive Monte Carlo ELBO estimate (burrito.py:127-153)."""
        lls, theta, rep = self._sample_and_likelihoods(particle_count)
        px_log_prior = self.branch_model.log_prior(theta)
        elbo_total = (
            np.sum(lls + px_log_prior)
            - np.sum(np.log(self.inst.calculate_sbn_probabilities()))
            - self.branch_model.log_prob(theta, rep)
        )
        return elbo_total / self.inst.tree_count()

    def px_log_f(self, px_phylo_log_like, px_theta_sample, px_branch_representation):
        px_log_prior = self.branch_model.log_prior(px_theta_sample)
        px_log_sbn_prob = np.log(self.inst.calculate_sbn_probabilities())
        px_branch_log_prob = self.branch_model.particle_log_probs(
            px_theta_sample, px_branch_representation
        )
        return (
            px_phylo_log_like + px_log_prior - px_log_sbn_prob - px_branch_log_prob
        )

    def marginal_likelihood_estimate(self, particle_count: int) -> float:
        """Importance-sampling marginal likelihood (burrito.py:168-183)."""
        lls, theta, rep = self._sample_and_likelihoods(particle_count)
        px_log_f = self.px_log_f(lls, theta, rep)
        return logsumexp(px_log_f) - np.log(particle_count)
