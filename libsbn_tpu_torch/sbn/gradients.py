"""Topology gradients: ∇_φ log q(τ) and VIMCO multiplicative factors.

The counterpart of libsbn_tpu.sbn.gradients (the reference's
unrooted_sbn_instance.cpp GradientOfLogQ/TopologyGradients and
generic_sbn_instance.hpp CalculateVIMCOMultiplicativeFactors).

Dense formulation (eq:gradLogQ): for unrooted topology τ with rootings ρ,

  ∇ log q(τ)[i] = (1/q) Σ_ρ P_ρ ( 1[i ∈ rep_ρ] − p̄_i · 1[seg(i) touched by ρ] )

which decomposes into two scatter-adds: rooting probabilities onto the rep
indices (term 1) and onto the touched normalization segments (term 2). The
factors and gradients are plain tensor functions on the device of their
inputs. The scatter-adds sum in a fixed order
(probability.fixed_order_scatter_add), so a gradient repeats bit for bit
on a card too, where ``index_add_``'s atomics would add in no fixed order.

Host-side prep (``touched_segments_of``, numpy, as in the JAX package)
computes, per rooting, which parameter blocks (segments) appear in
eq:gradLogQ's sum over subsplits s|t in the rooted tree — the rootsplit
block plus each present parent subsplit's child block, in both orientations
(GetSubsplitRanges).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .probability import (
    fixed_order_scatter_add, probability_normalize_in_log, with_sentinel,
)
from .support import SBNSupport


def multiplicative_factors(log_f):
    """Naive multi-sample ELBO factors (CalculateMultiplicativeFactors)."""
    k = log_f.shape[0]
    log_F = torch.logsumexp(log_f, 0)
    hat_L = log_F - math.log(float(k))
    tilde_w = torch.exp(log_f - log_F)
    return hat_L - tilde_w


def vimco_multiplicative_factors(log_f):
    """VIMCO factors with geometric-mean baseline
    (CalculateVIMCOMultiplicativeFactors)."""
    k = log_f.shape[0]
    log_gm = (torch.sum(log_f) - log_f) / (k - 1.0)
    # Row j: log_f with entry j replaced by its geometric-mean baseline.
    eye = torch.eye(k, dtype=torch.bool, device=log_f.device)
    mat = torch.where(eye, log_gm[:, None], log_f.expand(k, k))
    per_sample_signal = torch.logsumexp(mat, 1) - math.log(float(k))
    return multiplicative_factors(log_f) - per_sample_signal


def _touched_tables(support: SBNSupport):
    """Per-index touched-segment lookup tables, cached on the support.

    A rep entry touches a fixed set of segments determined by the index
    alone: the rootsplit index s touches the segments of the ordered parents
    (root + ~root, ~root + root); a PCSP index touches the segments of its
    child subsplit in both orientations (GetSubsplitRanges). Absent parents
    map to the dummy segment id (= num_segments)."""
    cached = getattr(support, "_touched_tables_cache", None)
    if cached is not None:
        return cached
    seg_of_parent = {
        parent: s for s, parent in enumerate(support.parent_to_range, start=1)
    }
    num_segments = len(seg_of_parent) + 1
    rs_count = support.rootsplit_count()
    root_tab = np.full((rs_count, 2), num_segments, dtype=np.int32)
    for s, root in enumerate(support.rootsplits):
        for k, parent in enumerate((root + ~root, (~root) + root)):
            root_tab[s, k] = seg_of_parent.get(parent, num_segments)
    child_tab = np.full((support.gpcsp_count, 2), num_segments, dtype=np.int32)
    for idx, child in support.index_to_child.items():
        for k, parent in enumerate((child, child.rotate_subsplit())):
            child_tab[idx, k] = seg_of_parent.get(parent, num_segments)
    cached = (num_segments, root_tab, child_tab)
    object.__setattr__(support, "_touched_tables_cache", cached)
    return cached


def touched_segments_of(
    support: SBNSupport, reps: np.ndarray, pad_to: int | None = None
) -> np.ndarray:
    """Per rooting, segment ids touched by eq:gradLogQ (host-side).

    reps: (..., E, R) int32 dense unrooted representations.
    Returns (..., E, Smax) int32 padded with the dummy segment id S
    (= num_segments). Vectorized as gathers into precomputed per-index
    tables (_touched_tables); out-of-support rootings yield all-dummy rows."""
    num_segments, root_tab, child_tab = _touched_tables(support)
    sentinel = support.gpcsp_count

    flat = reps.reshape(-1, reps.shape[-1])
    R = flat.shape[1]
    valid = ~(flat >= sentinel).any(axis=1)
    safe = np.where(valid[:, None], flat, 0)
    cols = np.concatenate(
        [
            np.zeros((flat.shape[0], 1), dtype=np.int32),  # rootsplit segment
            root_tab[safe[:, 0]],
            child_tab[safe[:, 1:]].reshape(flat.shape[0], 2 * (R - 1)),
        ],
        axis=1,
    )
    cols = np.where(valid[:, None], cols, num_segments)
    width = pad_to if pad_to is not None else cols.shape[1]
    if width < cols.shape[1]:
        used = int((cols != num_segments).sum(axis=1).max(initial=0))
        if used > width:
            raise ValueError(f"pad_to = {width} < {used} touched segments")
        # Compact non-dummy entries left before truncating.
        order = np.argsort(cols == num_segments, axis=1, kind="stable")
        cols = np.take_along_axis(cols, order, axis=1)[:, :width]
    out = np.full((flat.shape[0], width), num_segments, dtype=np.int32)
    out[:, : cols.shape[1]] = cols
    return out.reshape(reps.shape[:-1] + (width,))


def _sums_at(size, index, w, pad):
    """(size,) sums of the per-rooting weights w at index (w.shape + (n,)),
    each slot's terms in a fixed order (fixed_order_scatter_add). The
    entries at ``pad`` (padding, whose sum nothing reads) each go to a slot
    of their own past ``size``: gathered in one slot they would be one long
    run of adds, which the sorted scatter makes serial on a card."""
    index = index.reshape(-1)
    spare = torch.arange(size, size + index.numel(), device=index.device)
    index = torch.where(index == pad, spare, index)
    src = w[..., None].expand(w.shape + (index.numel() // w.numel(),))
    return fixed_order_scatter_add(
        w.new_zeros((size + index.numel(),)), index, src.reshape(-1))[:size]


def _weighted_scatters(params, normalized, reps, touched, w, segment_ids,
                       num_segments):
    """term1 - term2 of eq:gradLogQ for per-rooting weights w (reps.shape[:-1])."""
    G = params.shape[0]
    term1 = _sums_at(G, reps, w, G)
    touched_weight = _sums_at(num_segments, touched, w, num_segments)
    term2 = torch.exp(normalized) * touched_weight[segment_ids]
    return term1 - term2


def topology_gradients(
    sbn_parameters,
    segment_ids,
    num_segments: int,
    reps,
    touched,
    log_f,
    use_vimco: bool = True,
    rows=None,
):
    """Σ_j factor_j ∇_φ log q(τ_j) over particles (TopologyGradients).

    sbn_parameters: (G,) unnormalized log params; segment_ids: (G,);
    reps: (T, E, R) integer; touched: (T, E, Sm) integer (dummy segment =
    num_segments); log_f: (T,). All on one device. Returns (G,).
    rows: a slice of log_f's particles that reps and touched hold (by
    default all of them): the factors, which need every particle's log f,
    are taken over log_f and the sum over the rows' particles alone, so
    that a rank of a distributed step gives its share of the sum."""
    segment_ids = segment_ids.long()
    reps = reps.long()
    normalized = probability_normalize_in_log(
        sbn_parameters, segment_ids, num_segments
    )
    log_rho = torch.sum(with_sentinel(normalized)[reps], -1)  # (T, E)
    log_q = torch.logsumexp(log_rho, -1)  # (T,)
    factors = (
        vimco_multiplicative_factors(log_f)
        if use_vimco
        else multiplicative_factors(log_f)
    )
    if rows is not None:
        factors = factors[rows]
    # Weight per rooting: factor_j * P_ρ / q_j.
    w = factors[:, None] * torch.exp(log_rho - log_q[:, None])  # (T, E)
    return _weighted_scatters(sbn_parameters, normalized, reps,
                              touched.long(), w, segment_ids, num_segments)


def gradient_of_log_q(support: SBNSupport, sbn_parameters, rep: np.ndarray):
    """Single-topology ∇_φ log q(τ) (GradientOfLogQ), on the host in
    float64. rep: (E, R) dense representation of the topology."""
    segment_ids = support.segment_ids()
    num_segments = int(segment_ids.max(initial=0)) + 1
    touched = torch.as_tensor(touched_segments_of(support, rep[None])[0]).long()
    params = torch.as_tensor(np.asarray(sbn_parameters, dtype=np.float64))
    segment_ids = torch.as_tensor(segment_ids).long()
    reps = torch.as_tensor(rep).long()
    normalized = probability_normalize_in_log(params, segment_ids, num_segments)
    log_rho = torch.sum(with_sentinel(normalized)[reps], -1)
    w = torch.exp(log_rho - torch.logsumexp(log_rho, 0))
    return _weighted_scatters(params, normalized, reps, touched, w,
                              segment_ids, num_segments)
