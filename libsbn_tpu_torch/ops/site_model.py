"""Site rate-variation models (constant, discretized Weibull).

The reference's src/site_model.cpp, as in libsbn_tpu.ops.site_model: the
Weibull median discretization with scale fixed to 1 and rates normalized to
mean 1. Plain tensor functions of the shape parameter.
"""

from __future__ import annotations

import torch


def constant_rates(*, dtype=torch.float64, device="cpu"):
    """One category of rate 1 and proportion 1: (rates (1,), props (1,))."""
    one = torch.ones((1,), dtype=dtype, device=device)
    return one, one.clone()


def weibull_rates(shape, category_count: int, *, dtype=torch.float64,
                  device="cpu"):
    """Discretized Weibull category rates and proportions.

    rate_i ∝ (-log(1 - (2i+1)/(2K)))^(1/shape), normalized to mean 1;
    proportions are uniform (site_model.cpp UpdateRates). A shape tensor
    with leading dims (e.g. one shape per tree, (B,)) gives rates with the
    same leading dims, (..., K); the proportions stay (K,)."""
    shape = torch.as_tensor(shape, dtype=dtype, device=device)
    i = torch.arange(category_count, dtype=dtype, device=device)
    quantile = (2.0 * i + 1.0) / (2.0 * category_count)
    raw = torch.pow(-torch.log1p(-quantile), 1.0 / shape[..., None])
    rates = raw / torch.mean(raw, dim=-1, keepdim=True)
    props = torch.full(
        (category_count,), 1.0 / category_count, dtype=dtype, device=device
    )
    return rates, props


def weibull_rate_gradient(shape, category_count: int, *, dtype=torch.float64,
                          device="cpu"):
    """Analytic d rates / d shape (K,), as site_model.cpp computes it, for
    parity tests (the engine's gradients come from autograd of
    weibull_rates)."""
    shape = torch.as_tensor(shape, dtype=dtype, device=device)
    i = torch.arange(category_count, dtype=dtype, device=device)
    quantile = (2.0 * i + 1.0) / (2.0 * category_count)
    base = -torch.log1p(-quantile)
    raw = torch.pow(base, 1.0 / shape)
    draw = -raw * torch.log(base) / (shape * shape)
    mean = torch.mean(raw)
    dmean = torch.mean(draw)
    return (draw * mean - raw * dmean) / (mean * mean)
