"""Scalar variational models (reference: vip/scalar_model.py; the
counterpart of libsbn_tpu.vi.scalar_models).

The reference hand-derives reparameterization gradients (eq:gLogNorm,
eq:dgdPsi, eq:dlogqgdPsi) for a log-normal q and wraps TFP distributions for
the rest. Here, as in libsbn_tpu, the log-normal model is numpy with the
analytic gradients and the model's numpy Generator, so that a seed gives
the JAX package's samples; the rest (``ADScalarModel`` and its subclasses)
take their reparameterization gradients from torch autograd on the host,
drawing from a ``torch.Generator`` seeded from the model's numpy rng where
the JAX package splits ``jax.random`` keys.

Gradient conventions returned by sample_and_gradients (matching the
reference so BranchModel.scalar_grad composes identically):
  * sample: (P, B) sampled branch lengths;
  * dg_dpsi: (P, V, 2) gradient of the reparameterization g wrt (mu, sigma);
  * dlog_qg_dpsi: (P, V, 2) TOTAL derivative of log q(g(eps, psi); psi).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class ScalarModel:
    def __init__(self, initial_params: np.ndarray, variable_count: int):
        initial_params = np.asarray(initial_params, dtype=np.float64)
        assert initial_params.ndim == 1
        self.q_params = np.full((variable_count, len(initial_params)), initial_params)

    @property
    def variable_count(self) -> int:
        return self.q_params.shape[0]

    @property
    def param_count(self) -> int:
        return self.q_params.shape[1]

    def suggested_step_size(self):
        """1% of the mean parameter magnitude, per parameter column."""
        return 0.01 * np.mean(np.abs(self.q_params), axis=0)

    def elementwise_log_prob(self, values, which_variables):
        """log q(value_i) per entry; shapes broadcast ((P,B) or (B,))."""
        raise NotImplementedError


class LogNormalModel(ScalarModel):
    """Log-normal q with analytic reparameterization gradients."""

    def __init__(self, variable_count: int, rng=None):
        super().__init__(np.array([-2.0, 0.5]), variable_count)
        self.name = "LogNormal"
        self.rng = rng or np.random.default_rng(0)

    def mu(self, which_variables=None):
        if which_variables is None:
            return self.q_params[:, 0]
        return self.q_params[which_variables, 0]

    def sigma(self, which_variables=None):
        if which_variables is None:
            return self.q_params[:, 1]
        return self.q_params[which_variables, 1]

    def mode_match(self, modes):
        """Initialize so the lognormal modes match (scalar_model.py:95-101)."""
        _lognormal_mode_match(self.q_params, modes)

    def sample_all(self, particle_count: int):
        return self.rng.lognormal(
            self.mu(), self.sigma(), (particle_count, self.variable_count)
        )

    def sample(self, px_which_variables):
        px_which_variables = np.asarray(px_which_variables)
        mu = self.q_params[px_which_variables, 0]
        sigma = self.q_params[px_which_variables, 1]
        return self.rng.lognormal(mu, sigma)

    def sample_and_gradients(self, px_which_variables, prebaked_sample=None):
        """(sample, dg_dpsi, dlog_qg_dpsi); see module docstring."""
        px_which_variables = np.asarray(px_which_variables)
        particle_count, width = px_which_variables.shape
        mu = self.q_params[px_which_variables, 0]  # (P, B)
        sigma = self.q_params[px_which_variables, 1]
        if prebaked_sample is None:
            sample = self.rng.lognormal(mu, sigma)
        else:
            sample = np.broadcast_to(prebaked_sample, (particle_count, width)).copy()
        dg_dpsi = np.zeros((particle_count, self.variable_count, 2))
        dlog_qg_dpsi = np.zeros((particle_count, self.variable_count, 2))
        dlog_qg_dpsi[:, :, 0] = -1.0  # eq:dlogqgdPsi
        epsilon = (np.log(sample) - mu) / sigma  # eq:gLogNorm
        rows = np.arange(particle_count)[:, None]
        # eq:dgdPsi — note: assumes each variable appears at most once per
        # particle (true for split/PSP representations).
        dg_dpsi[rows, px_which_variables, 0] = sample
        dg_dpsi[rows, px_which_variables, 1] = sample * epsilon
        dlog_qg_dpsi[rows, px_which_variables, 1] = -epsilon - 1.0 / sigma
        return sample, dg_dpsi, dlog_qg_dpsi

    @staticmethod
    def elementwise_general_log_prob(values, mu, sigma):
        """Lognormal log density per entry: a normal logpdf on z = log(x)
        plus the |dz/dx| = 1/x change-of-variables term."""
        z = np.log(np.asarray(values))
        standardized = (z - mu) / sigma
        normal_logpdf = (
            -0.5 * standardized**2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)
        )
        return normal_logpdf - z

    @staticmethod
    def general_log_prob(values, mu, sigma):
        return np.sum(
            LogNormalModel.elementwise_general_log_prob(values, mu, sigma)
        )

    def elementwise_log_prob(self, values, which_variables):
        which = np.asarray(which_variables)
        return LogNormalModel.elementwise_general_log_prob(
            values, self.q_params[which, 0], self.q_params[which, 1]
        )

    def log_prob(self, values, which_variables):
        values = np.asarray(values)
        assert values.size == np.asarray(which_variables).size
        return float(np.sum(self.elementwise_log_prob(values, which_variables)))


class ADScalarModel(ScalarModel):
    """Scalar models whose reparameterization gradients come from torch
    autograd, in float64 on the host (the reference's TFP GradientTape
    wrappers, scalar_model.py TFScalarModel). Subclasses define the sampler
    and the log density on tensors; sample_and_gradients differentiates
    them at one draw.

    dg_dpsi and dlog_qg_dpsi follow the reference's conventions: per
    (particle, variable, param), with dlog_qg the TOTAL derivative of
    log q(g(eps, psi); psi)."""

    initial_params: np.ndarray = None
    name = "AD"

    def __init__(self, variable_count: int, rng=None):
        super().__init__(self.initial_params, variable_count)
        self.rng = rng or np.random.default_rng(0)
        # One draw of the numpy rng seeds the torch stream, as the JAX
        # package draws its PRNG key's seed.
        self._gen = torch.Generator().manual_seed(
            int(self.rng.integers(0, 2**31)))

    # Subclass API: _sample(psi) -> theta, drawing from self._gen,
    # elementwise in the rows of psi (..., params); _log_prob(theta, psi)
    # -> elementwise log density.
    def _sample(self, psi):
        raise NotImplementedError

    def _log_prob(self, theta, psi):
        raise NotImplementedError

    def mode_match(self, modes):
        raise NotImplementedError

    @staticmethod
    def _psi(q):
        return torch.as_tensor(np.ascontiguousarray(q), dtype=torch.float64)

    def sample(self, px_which_variables):
        px = np.asarray(px_which_variables)
        with torch.no_grad():
            return self._sample(self._psi(self.q_params[px])).numpy()

    def sample_all(self, particle_count: int):
        psi = np.broadcast_to(
            self.q_params, (particle_count,) + self.q_params.shape)
        with torch.no_grad():
            return self._sample(self._psi(psi)).numpy()

    def elementwise_log_prob(self, values, which_variables):
        psi = self._psi(self.q_params[np.asarray(which_variables)])
        with torch.no_grad():
            return self._log_prob(
                torch.as_tensor(np.asarray(values), dtype=torch.float64),
                psi).numpy()

    def log_prob(self, values, which_variables):
        return float(np.sum(self.elementwise_log_prob(values, which_variables)))

    def sample_and_gradients(self, px_which_variables):
        px = np.asarray(px_which_variables)
        particle_count, _ = px.shape
        with torch.enable_grad():
            psi = self._psi(self.q_params[px]).requires_grad_(True)
            theta = self._sample(psi)
            # Each theta_i depends only on its own psi row (elementwise
            # samplers), so d sum(theta) / d psi is the whole Jacobian.
            (dg,) = torch.autograd.grad(theta.sum(), psi, retain_graph=True)
            (dlogq,) = torch.autograd.grad(
                self._log_prob(theta, psi).sum(), psi)
        k = self.param_count
        dg_dpsi = np.zeros((particle_count, self.variable_count, k))
        dlog_qg_dpsi = np.zeros((particle_count, self.variable_count, k))
        rows = np.arange(particle_count)[:, None]
        dg_dpsi[rows, px, :] = dg.numpy()
        dlog_qg_dpsi[rows, px, :] = dlogq.numpy()
        return theta.detach().numpy(), dg_dpsi, dlog_qg_dpsi


def _lognormal_mode_match(q_params, modes):
    """Log-normal (mu, sigma) whose modes match ``modes``
    (scalar_model.py:95-101)."""
    modes = np.asarray(modes)
    log_modes = np.log(np.clip(modes, 1e-6, None))
    biclipped = np.log(np.clip(modes, 1e-6, 1 - 1e-6))
    q_params[:, 1] = -0.1 * biclipped
    q_params[:, 0] = np.square(q_params[:, 1]) + log_modes


class ADLogNormalModel(ADScalarModel):
    """Log-normal by autograd (cross-checks the hand-coded LogNormalModel)."""

    initial_params = np.array([-2.0, 0.5])
    name = "TFLogNormal"

    def _sample(self, psi):
        eps = torch.randn(psi.shape[:-1], generator=self._gen,
                          dtype=torch.float64)
        return torch.exp(psi[..., 0] + psi[..., 1] * eps)

    def _log_prob(self, theta, psi):
        mu, sigma = psi[..., 0], psi[..., 1]
        lt = torch.log(theta)
        return (
            -lt - torch.log(sigma) - 0.5 * math.log(2 * math.pi)
            - (lt - mu) ** 2 / (2 * sigma**2)
        )

    def mode_match(self, modes):
        _lognormal_mode_match(self.q_params, modes)


class GammaModel(ADScalarModel):
    """Gamma(concentration=e^a, rate=e^b) with the implicit
    reparameterization gradient of ``torch._standard_gamma`` (the draw
    ``torch.distributions.Gamma.rsample`` makes, here from the model's
    generator; scalar_model.py gamma_factory)."""

    initial_params = np.array([1.3, 3.0])
    name = "TFGamma"

    def _sample(self, psi):
        conc = torch.exp(psi[..., 0])
        rate = torch.exp(psi[..., 1])
        return torch._standard_gamma(conc, generator=self._gen) / rate

    def _log_prob(self, theta, psi):
        conc = torch.exp(psi[..., 0])
        rate = torch.exp(psi[..., 1])
        return (
            conc * torch.log(rate) - torch.lgamma(conc)
            + (conc - 1) * torch.log(theta) - rate * theta
        )

    def mode_match(self, modes):
        modes = np.asarray(modes)
        biclipped = np.log(np.clip(modes, 1e-6, 1 - 1e-6))
        self.q_params[:, 1] = np.log(-60.0 * biclipped)
        self.q_params[:, 0] = np.log(1 + modes * self.q_params[:, 1])


class TruncatedLogNormalModel(ADScalarModel):
    """exp-shifted truncated normal (scalar_model.py
    truncated_lognormal_factory): theta = exp(z) - exp(low) with
    z ~ TruncatedNormal(loc, scale, low, 999); the inverse-CDF
    reparameterization (``torch.special.ndtri`` of a uniform between the
    bounds' ``ndtr``) keeps it differentiable."""

    initial_params = np.array([-1.0, 0.5, 0.1])
    name = "TFTruncatedLogNormal"
    HIGH = 999.0

    def _sample(self, psi):
        loc, scale, low = psi[..., 0], psi[..., 1], psi[..., 2]
        u = 1e-7 + (1 - 2e-7) * torch.rand(
            psi.shape[:-1], generator=self._gen, dtype=torch.float64)
        a = torch.special.ndtr((low - loc) / scale)
        b = torch.special.ndtr((self.HIGH - loc) / scale)
        z = loc + scale * torch.special.ndtri(a + u * (b - a))
        return torch.exp(z) - torch.exp(low)

    def _log_prob(self, theta, psi):
        loc, scale, low = psi[..., 0], psi[..., 1], psi[..., 2]
        x = theta + torch.exp(low)  # invert the shift
        z = torch.log(x)
        a = torch.special.ndtr((low - loc) / scale)
        b = torch.special.ndtr((self.HIGH - loc) / scale)
        normal_logpdf = (-0.5 * ((z - loc) / scale) ** 2 - torch.log(scale)
                         - 0.5 * math.log(2 * math.pi))
        # TruncatedNormal density in z, plus |dz/dtheta| = 1/x.
        return normal_logpdf - torch.log(b - a) - torch.log(x)

    def mode_match(self, modes):
        _lognormal_mode_match(self.q_params, modes)
        self.q_params[:, 2] = -5.0


# Reference-exact class name (vip/scalar_model.py:262): the TFP-backed
# GradientTape models are replaced by torch autograd with the same
# distributions; of_name accepts the reference's "tf_*" choice strings.
TFScalarModel = ADScalarModel


def of_name(name: str, variable_count: int, rng=None) -> ScalarModel:
    choices = {
        "lognormal": LogNormalModel,
        "tf_lognormal": ADLogNormalModel,
        "tf_gamma": GammaModel,
        "tf_truncated_lognormal": TruncatedLogNormalModel,
    }
    if name not in choices:
        raise ValueError(f"Scalar model {name} not known.")
    return choices[name](variable_count, rng)
