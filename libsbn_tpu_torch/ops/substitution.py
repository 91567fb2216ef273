"""Substitution models as tensors: JC69 and GTR (the reference's
src/substitution_model.{hpp,cpp}; libsbn_tpu.ops.substitution).

A model provides its stationary frequencies and its rate matrix Q,
normalised to unit expected substitution rate; transition matrices are
P(t) = expm(Q t). JC69's eigensystem and Q are constants. GTR's Q is built
from six exchangeabilities and four frequencies (``gtr_q``), batched over
leading axes; ``expm_transition`` exponentiates it with a Daleckii-Krein
backward that stays defined at repeated eigenvalues.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_GTR_RATES = np.full(6, 1.0 / 6.0)
DEFAULT_FREQS = np.full(4, 0.25)


def jc69_eigen(*, dtype=torch.float64, device="cpu"):
    """Hardcoded JC69 eigendecomposition (substitution_model.hpp:59-74):
    (freqs, eigenvectors, inverse eigenvectors, eigenvalues)."""

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    freqs = torch.full((4,), 0.25, dtype=dtype, device=device)
    evec = t(
        [
            [1.0, 2.0, 0.0, 0.5],
            [1.0, -2.0, 0.5, 0.0],
            [1.0, 2.0, 0.0, -0.5],
            [1.0, -2.0, -0.5, 0.0],
        ]
    )
    ivec = t(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.125, -0.125, 0.125, -0.125],
            [0.0, 1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0, 0.0],
        ]
    )
    evals = t([0.0, -4.0 / 3.0, -4.0 / 3.0, -4.0 / 3.0])
    return freqs, evec, ivec, evals


def jc69_q(*, dtype=torch.float64, device="cpu"):
    """The unit-rate JC69 rate matrix: 1/3 off the diagonal, -1 on it."""
    q = torch.full((4, 4), 1.0 / 3.0, dtype=dtype, device=device)
    return q - torch.eye(4, dtype=dtype, device=device) * (4.0 / 3.0)


def gtr_q(rates, freqs):
    """The unit-rate GTR rate matrix (substitution_model.cpp UpdateQMatrix).
    rates: (..., 6) upper-triangle exchangeabilities (AC, AG, AT, CG, CT,
    GT); freqs: (..., 4) stationary frequencies. Returns (..., 4, 4);
    differentiable in both."""
    iu = torch.triu_indices(4, 4, 1, device=rates.device)
    S = rates.new_zeros(rates.shape[:-1] + (4, 4))
    S[..., iu[0], iu[1]] = rates
    S = S + S.transpose(-1, -2)
    Q = S * freqs[..., None, :]
    rowsum = torch.sum(Q, dim=-1)
    Q = Q - torch.diag_embed(rowsum)
    total_rate = torch.sum(rowsum * freqs, dim=-1)
    return Q / total_rate[..., None, None]


def _eigen_of_q(Q, freqs):
    """(evals, V, V^-1) of reversible Qs (..., 4, 4) via the symmetrized
    form; freqs (..., 4) enter only as a similarity transform."""
    sqrt_f = torch.sqrt(freqs)
    S = sqrt_f[..., :, None] * Q / sqrt_f[..., None, :]
    S = 0.5 * (S + S.transpose(-1, -2))
    lam, U = torch.linalg.eigh(S)
    return lam, U / sqrt_f[..., :, None], U.transpose(-1, -2) * sqrt_f[..., None, :]


def gtr_eigen(rates, freqs):
    """GTR eigendecomposition via the symmetrized matrix: (freqs,
    eigenvectors, inverse eigenvectors, eigenvalues), the reference's
    convention (substitution_model.cpp Update). Autograd through it is
    undefined at repeated eigenvalues; the engine differentiates through
    ``expm_transition`` instead."""
    lam, evec, ivec = _eigen_of_q(gtr_q(rates, freqs), freqs)
    return freqs, evec, ivec, lam


def transition_matrices(evec, ivec, evals, edge_lengths):
    """P(t) = V diag(e^{Λ t}) V^-1 batched over edge_lengths (...,),
    returning (..., 4, 4). The exponential runs in f64 whatever the working
    dtype (BASELINE.md precision policy)."""
    t = torch.as_tensor(edge_lengths)
    expo = torch.exp(
        t.to(torch.float64)[..., None] * evals.to(torch.float64)
    ).to(t.dtype)
    return torch.einsum("ij,...j,jk->...ik", evec, expo, ivec)


def q_from_eigen(evec, ivec, evals):
    return torch.einsum("ij,j,jk->ik", evec, evals, ivec)


def _eigen_f64_host(Q, freqs):
    """The eigensystem of Q (nQ, 4, 4) in f64, solved on a CPU copy (one
    LAPACK call; on a card, eigh of a few 4x4s would launch a solver and
    synchronise anyway), returned on Q's device."""
    lam, V, Vi = _eigen_of_q(
        Q.detach().to("cpu", torch.float64),
        freqs.detach().to("cpu", torch.float64),
    )
    return lam.to(Q.device), V.to(Q.device), Vi.to(Q.device)


def _phi(lam, ts):
    """Daleckii-Krein divided differences (nQ, nT, 4, 4):
    Phi_ij = (e^{t li} - e^{t lj}) / (li - lj), Phi_ii = t e^{t li}, in the
    cancellation-stable form t e^{t (li + lj)/2} sinhc(t (li - lj)/2)."""
    mean = 0.5 * (lam[:, :, None] + lam[:, None, :])  # (nQ, 4, 4)
    diff = 0.5 * (lam[:, :, None] - lam[:, None, :])
    t = ts[:, :, None, None]
    a = t * mean[:, None]
    d = t * diff[:, None]
    small = torch.abs(d) < 1e-6
    d_safe = torch.where(small, torch.ones_like(d), d)
    sinhc = torch.where(small, 1.0 + d * d / 6.0, torch.sinh(d_safe) / d_safe)
    return t * torch.exp(a) * sinhc


class _ExpmTransition(torch.autograd.Function):
    """P = expm(Q t) for Qs (nQ, 4, 4) and times (nQ, nT): (nQ, nT, 4, 4).
    Forward and backward in f64 on an eigensystem that autograd never sees.
    The backward is the transpose of the JAX package's Daleckii-Krein JVP
    (libsbn_tpu/ops/substitution.py:147-178): with W = V^T G V^-T,
        Q̄ = V^-T [sum_t W ∘ Phi] V^T,   t̄ = sum_m λ_m e^{λ_m t} W_mm,
    and no cotangent for freqs (they only symmetrize the eigenproblem)."""

    @staticmethod
    def forward(ctx, Q, freqs, ts):
        lam, V, Vi = _eigen_f64_host(Q, freqs)
        t64 = ts.to(torch.float64)
        expo = torch.exp(t64[..., None] * lam[:, None, :])  # (nQ, nT, 4)
        ctx.save_for_backward(lam, V, Vi, t64, expo)
        ctx.dtypes = (Q.dtype, ts.dtype)
        P = torch.einsum("qij,qtj,qjk->qtik", V, expo, Vi)
        return P.to(torch.promote_types(Q.dtype, ts.dtype))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        lam, V, Vi, t64, expo = ctx.saved_tensors
        q_dtype, t_dtype = ctx.dtypes
        W = torch.einsum("qji,qtjk,qlk->qtil", V, G.to(torch.float64), Vi)
        dQ = dts = None
        if ctx.needs_input_grad[0]:
            H = torch.sum(W * _phi(lam, t64), dim=1)  # (nQ, 4, 4)
            dQ = torch.einsum("qji,qjk,qlk->qil", Vi, H, V).to(q_dtype)
        if ctx.needs_input_grad[2]:
            diag = torch.diagonal(W, dim1=-2, dim2=-1)  # (nQ, nT, 4)
            dts = torch.sum(lam[:, None, :] * expo * diag, dim=-1).to(t_dtype)
        return dQ, None, dts


def expm_transition(Q, freqs, ts):
    """P(t) = expm(Q t), differentiable in Q and ts, and defined (with its
    gradient) at repeated eigenvalues, e.g. the uniform-rates GTR point.

    Q: (*batch, 4, 4) reversible rate matrices; freqs: (*batch, 4), their
    stationary frequencies (used only to symmetrize the eigenproblem: P is a
    function of Q alone, so freqs get no gradient here; differentiate
    through ``gtr_q`` for that); ts: (*batch, ...) times, whose leading
    dims are Q's batch dims. Returns ts.shape + (4, 4) in the promoted dtype
    of Q and ts."""
    batch = Q.shape[:-2]
    if ts.shape[: len(batch)] != batch:
        raise ValueError(
            f"times {tuple(ts.shape)} must lead with Q's batch dims "
            f"{tuple(batch)}"
        )
    nQ = int(np.prod(batch, dtype=np.int64))
    P = _ExpmTransition.apply(
        Q.reshape(nQ, 4, 4), freqs.expand(batch + (4,)).reshape(nQ, 4),
        ts.reshape(nQ, -1),
    )
    return P.reshape(ts.shape + (4, 4))
