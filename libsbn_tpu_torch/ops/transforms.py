"""Constrained-parameter transforms (libsbn_tpu.ops.transforms).

The stick-breaking simplex transform in the Stan convention, as the
reference's src/stick_breaking_transform.cpp (checked there against
PyTorch's StickBreakingTransform). It expresses GTR exchangeabilities and
stationary frequencies in unconstrained space, where the engine reports
their gradients. Every function is batched over leading axes: y (..., K-1),
x (..., K).
"""

from __future__ import annotations

import torch


def _softplus(x):
    """log(1 + e^x) without torch's linear cut-over above x = 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _offsets(n, like):
    """log(n - k) for k = 0..n-1."""
    k = torch.arange(n, dtype=like.dtype, device=like.device)
    return torch.log(n - k)


def stick_breaking(y):
    """Unconstrained y (..., K-1) -> simplex x (..., K)."""
    z = torch.sigmoid(y - _offsets(y.shape[-1], y))
    # x_k = z_k prod_{j<k} (1 - z_j); the remainder goes to the last entry.
    # The running product is written out, a multiply an entry in cumprod's
    # order: cumprod's backward reads the device from the host (it asks
    # whether an input is zero), which a captured CUDA graph cannot do.
    one_minus = 1.0 - z
    stick = [torch.ones_like(z[..., :1])]
    for k in range(z.shape[-1]):
        stick.append(stick[-1] * one_minus[..., k:k + 1])
    stick = torch.cat(stick, dim=-1)
    return torch.cat([z * stick[..., :-1], stick[..., -1:]], dim=-1)


def _remaining(x):
    """1 - sum_{j<k} x_j for k = 0..K-2."""
    head = torch.cumsum(x[..., :-1], dim=-1)
    return 1.0 - torch.cat([torch.zeros_like(x[..., :1]), head], dim=-1)[..., :-1]


def stick_breaking_inverse(x):
    """Simplex x (..., K) -> unconstrained y (..., K-1)."""
    z = x[..., :-1] / _remaining(x)
    return torch.log(z / (1.0 - z)) + _offsets(x.shape[-1] - 1, x)


def stick_breaking_log_abs_det_jacobian(x, y):
    """log |det dx/dy| (stick_breaking_transform.cpp:46-59), (...,)."""
    adj = y - _offsets(y.shape[-1], y)
    return torch.sum(
        torch.log(_remaining(x)) - _softplus(-adj) - _softplus(adj), dim=-1
    )
