"""Branch-length prior: iid Exponential(10) across branches.

A copy of libsbn_tpu.vi.priors (the reference's vip/priors.py: two
functions, the same call signatures), numpy on the host, re-expressed as an elementwise log-density reduced over the branch axis so
the per-branch terms are reusable (e.g. for per-branch diagnostics).
"""

from __future__ import annotations

import numpy as np

DEFAULT_RATE = 10.0


def _elementwise_log_density(theta, rate: float):
    """log p(theta_i) for theta_i ~ Exponential(rate), elementwise."""
    return np.log(rate) - rate * np.asarray(theta)


def log_exp_prior(px_theta_sample, rate: float = DEFAULT_RATE):
    """Total log density of a (particles, branches) sample -> (particles,)."""
    theta = np.asarray(px_theta_sample)
    if theta.ndim != 2:
        raise ValueError("expected (particles, branches), got shape "
                         f"{theta.shape}")
    return _elementwise_log_density(theta, rate).sum(axis=-1)


def grad_log_exp_prior(px_theta_sample, rate: float = DEFAULT_RATE):
    """d log p / d theta — constant for the exponential, broadcastable."""
    return -rate
