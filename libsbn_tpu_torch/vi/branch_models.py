"""Branch-length variational models (reference: vip/branch_model.py).

A copy of libsbn_tpu.vi.branch_models: numpy on the host, drawing from the
scalar model's numpy Generator in the same order, so that a seed gives the
JAX package's branch lengths.

SplitModel: one log-normal per split (rep = PSP rootsplit row).
PSPModel: log-normal parameters summed across the rootsplit/down/up PSP
components of each branch (ICLR 2019), with a zeroed sentinel row so pendant
branches need no special-casing.
"""

from __future__ import annotations


import numpy as np

from . import priors, scalar_models


class BranchModel:
    def __init__(self, scalar_model_name: str, inst, rng=None):
        self.inst = inst
        self.scalar_model = scalar_models.of_name(
            scalar_model_name, variable_count=self._compute_variable_count(inst),
            rng=rng,
        )
        self.log_prior = priors.log_exp_prior
        self.grad_log_prior = priors.grad_log_exp_prior

    def make_raw_representation(self):
        return self.inst.make_psp_indexer_representations()

    @staticmethod
    def _compute_variable_count(inst):
        raise NotImplementedError


class SplitModel(BranchModel):
    """Branch modeling parameterized by splits."""

    @staticmethod
    def _compute_variable_count(inst):
        return inst.psp_indexer.details()["after_rootsplits_index"]

    def px_branch_representation(self):
        """(P, branches) split index of each branch of each sampled tree."""
        return np.asarray(
            [rep[0] for rep in self.make_raw_representation()], dtype=np.int64
        )

    def mode_match(self, split_modes):
        self.scalar_model.mode_match(split_modes)

    def sample(self, px_branch_representation):
        return self.scalar_model.sample(px_branch_representation)

    def sample_all(self, particle_count):
        return self.scalar_model.sample_all(particle_count)

    def particle_log_probs(self, px_theta_sample, px_branch_representation):
        """(P,) log q of each particle's branch lengths, one vectorized call
        (the reference iterates particles through a generator)."""
        per_branch = self.scalar_model.elementwise_log_prob(
            np.asarray(px_theta_sample), np.asarray(px_branch_representation)
        )
        return per_branch.sum(axis=-1)

    def log_prob_generator(self, px_theta_sample, px_branch_representation):
        yield from self.particle_log_probs(
            px_theta_sample, px_branch_representation
        )

    def log_prob(self, px_theta_sample, px_branch_representation):
        return float(
            self.particle_log_probs(
                px_theta_sample, px_branch_representation
            ).sum()
        )

    def sample_and_gradients(self, px_branch_representation):
        return self.scalar_model.sample_and_gradients(px_branch_representation)

    def scalar_grad(
        self, theta_sample, branch_gradients, px_branch_to_split, dg_dpsi,
        dlog_qg_dpsi,
    ):
        """eq:dLdPsi scatter-accumulation (branch_model.py:104-133).

        branch_gradients: (P, branches) d loglike / d branch length."""
        dlogp_dtheta = np.asarray(branch_gradients) + self.grad_log_prior(theta_sample)
        grad = np.zeros(
            (self.scalar_model.variable_count, self.scalar_model.param_count)
        )
        # eq:dLdPsi — per (particle, branch) occurrence:
        # grad[var] += dlogp[p,b] * dg_dpsi[p,var] - dlog_qg_dpsi[p,var].
        for particle_idx, branch_to_split in enumerate(px_branch_to_split):
            np.add.at(
                grad,
                branch_to_split,
                dlogp_dtheta[particle_idx, :, None]
                * dg_dpsi[particle_idx, branch_to_split, :]
                - dlog_qg_dpsi[particle_idx, branch_to_split, :],
            )
        return grad


class PSPModel(BranchModel):
    """Primary Subsplit Pair branch model (branch_model.py:137-299)."""

    def __init__(self, scalar_model_name: str, inst, rng=None):
        if scalar_model_name != "lognormal":
            raise ValueError("PSP only works with LogNormal.")
        super().__init__(scalar_model_name, inst, rng)
        details = inst.psp_indexer.details()
        assert details["rootsplit_position"] == 0
        assert details["subsplit_down_position"] == 1
        assert details["subsplit_up_position"] == 2
        self.after_rootsplits_index = details["after_rootsplits_index"]
        self.q_params = self.scalar_model.q_params
        self.q_params[-1, :] = 0.0  # sentinel row

    @staticmethod
    def _compute_variable_count(inst):
        return inst.psp_indexer.details()["first_empty_index"] + 1

    def px_branch_representation(self):
        """(P, 3, branches): rootsplit/down/up PSP indices per branch."""
        return np.asarray(self.make_raw_representation(), dtype=np.int64)

    def mode_match(self, split_modes):
        split_modes = np.asarray(split_modes)
        assert split_modes.size == self.after_rootsplits_index
        self.q_params[:, :] = 0.0
        log_modes = np.log(np.clip(split_modes, 1e-6, None))
        biclipped = np.log(np.clip(split_modes, 1e-6, 1 - 1e-6))
        split_q = self.q_params[: self.after_rootsplits_index, :]
        split_q[:, 1] = -0.1 * biclipped
        split_q[:, 0] = np.square(split_q[:, 1]) + log_modes

    def _make_lognormal_params(self, branch_representation):
        """(3, branches) rep -> (branches, 2) summed lognormal params."""
        return self.q_params[branch_representation].sum(axis=0)

    def sample(self, px_branch_representation):
        px = np.asarray(px_branch_representation)
        out = np.empty((px.shape[0], px.shape[2]))
        for i, rep in enumerate(px):
            p = self._make_lognormal_params(rep)
            out[i] = self.scalar_model.rng.lognormal(p[:, 0], p[:, 1])
        return out

    def sample_all(self, particle_count):
        """Split-marginal stand-in (branch_model.py sample_all note)."""
        p = self.q_params[: self.after_rootsplits_index]
        return self.scalar_model.rng.lognormal(
            p[:, 0], p[:, 1], (particle_count, self.after_rootsplits_index)
        )

    def particle_log_probs(self, px_theta_sample, px_branch_representation):
        """(P,) log q per particle: each branch is lognormal with (mu, sigma)
        summed over its three PSP components, evaluated in one vectorized
        call over the whole (P, B) sample."""
        px = np.asarray(px_branch_representation)  # (P, 3, B)
        summed = self.q_params[px].sum(axis=-3)  # (P, B, 2)
        per_branch = scalar_models.LogNormalModel.elementwise_general_log_prob(
            np.asarray(px_theta_sample), summed[..., 0], summed[..., 1]
        )
        return per_branch.sum(axis=-1)

    def log_prob_one(self, theta, branch_representation):
        return float(
            self.particle_log_probs(
                np.asarray(theta)[None], np.asarray(branch_representation)[None]
            )[0]
        )

    def log_prob_generator(self, px_theta_sample, px_branch_representation):
        yield from self.particle_log_probs(
            px_theta_sample, px_branch_representation
        )

    def log_prob(self, px_theta_sample, px_branch_representation):
        return float(
            self.particle_log_probs(
                px_theta_sample, px_branch_representation
            ).sum()
        )

    def sample_and_gradients(self, px_branch_representation):
        """As in LogNormalModel but each branch's (mu, sigma) is the sum over
        its three PSP components; gradients scatter to all components
        (branch_model.py:232-266)."""
        px = np.asarray(px_branch_representation)
        P, _, B = px.shape
        V = self.scalar_model.variable_count
        sample = np.empty((P, B))
        dg_dpsi = np.zeros((P, V, 2))
        dlog_qg_dpsi = np.zeros((P, V, 2))
        dlog_qg_dpsi[:, :, 0] = -1.0  # eq:dlogqgdPsi
        for i, rep in enumerate(px):
            p = self._make_lognormal_params(rep)
            mu, sigma = p[:, 0], p[:, 1]
            sample[i] = self.scalar_model.rng.lognormal(mu, sigma)
            epsilon = (np.log(sample[i]) - mu) / sigma
            # Each PSP component inherits the branch's lognormal derivatives
            # (assignment, matching branch_model.py:254-266; only the zeroed
            # sentinel index repeats within a row).
            for which_variables in rep:
                dg_dpsi[i, which_variables, 0] = sample[i]
                dg_dpsi[i, which_variables, 1] = sample[i] * epsilon
                dlog_qg_dpsi[i, which_variables, 1] = -epsilon - 1.0 / sigma
        return sample, dg_dpsi, dlog_qg_dpsi

    def scalar_grad(
        self, theta_sample, branch_gradients, px_branch_representation, dg_dpsi,
        dlog_qg_dpsi,
    ):
        dlogp_dtheta = np.asarray(branch_gradients) + self.grad_log_prior(theta_sample)
        V = self.scalar_model.variable_count
        grad = np.zeros((V, self.scalar_model.param_count))
        # eq:dLdPsi over (particle, PSP component, branch) occurrences.
        for i, rep in enumerate(px_branch_representation):
            for which_variables in rep:
                np.add.at(
                    grad,
                    which_variables,
                    dlogp_dtheta[i, :, None] * dg_dpsi[i, which_variables, :]
                    - dlog_qg_dpsi[i, which_variables, :],
                )
        grad[-1, :] = 0.0  # sentinel stays zero
        return grad


def of_name(name: str, scalar_model_name: str, inst, rng=None) -> BranchModel:
    choices = {"split": SplitModel, "psp": PSPModel}
    if name not in choices:
        raise ValueError(f"Branch model {name} not known.")
    return choices[name](scalar_model_name, inst, rng)
