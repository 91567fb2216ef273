"""SBN probability: normalisation, simple-average and EM training, and the
probabilities of tree collections, in torch.

The counterpart of libsbn_tpu.sbn.probability (the reference's
src/sbn_probability.cpp, NeurIPS 2018 Algorithm 1). Indexer representations
are dense integer tensors (T topologies, E rootings, R indices per
rooting); the parameter vector gets an extra slot at index G holding -inf
(``with_sentinel``), so out-of-support indices (sentinel G) contribute zero
probability with no branching. Plain tensor functions on whatever device
their inputs are on; EM runs in float64, one iteration a handful of
gathers, segment logsumexps and one scatter, each sum in a fixed order (a
run on a card repeats bit for bit), and reads one
pair of numbers back to the host per iteration (the score, for the
monotonicity assertion, and the underflow count).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

NEG_INF = float("-inf")


def with_sentinel(params, sentinel_value=NEG_INF):
    """Append the out-of-support slot: (G,) -> (G+1,)."""
    return torch.cat([params, params.new_full((1,), sentinel_value)])


def segment_logsumexp(values, segment_ids, num_segments: int):
    """Per-segment logsumexp via scatter-max + scatter-add.

    values: (G,); segment_ids: (G,) integer. Returns (num_segments,)."""
    segment_ids = segment_ids.long()
    seg_max = values.new_full((num_segments,), NEG_INF).scatter_reduce(
        0, segment_ids, values, "amax", include_self=False
    )
    # Guard fully -inf segments.
    safe_max = torch.where(torch.isfinite(seg_max), seg_max,
                           torch.zeros_like(seg_max))
    shifted = torch.exp(values - safe_max[segment_ids])
    seg_sum = fixed_order_scatter_add(values.new_zeros((num_segments,)),
                                      segment_ids, shifted)
    return safe_max + torch.log(seg_sum)


def fixed_order_scatter_add(out, index, src):
    """out[index[i]] += src[i], each slot's terms added in one fixed order:
    on the CPU in the order of ``src`` (as index_add_ does), on a card in
    the order of a stable sort of ``index`` (index_put_'s accumulate path),
    so that a run repeats bit for bit there; index_add_ on a card adds with
    atomics in no fixed order."""
    return out.index_put_((index,), src, accumulate=True)


def probability_normalize_in_log(params, segment_ids, num_segments: int):
    """Normalize each block to log-probabilities
    (ProbabilityNormalizeParamsInLog)."""
    logz = segment_logsumexp(params, segment_ids, num_segments)
    return params - logz[segment_ids.long()]


def log_counts_of_representations(reps, counts, gpcsp_count: int):
    """log of the scatter-added topology counts (SetLogCounts analog), in
    float64.

    reps: (T, ..., R) integer with sentinel G allowed; counts: (T,)."""
    reps = torch.as_tensor(reps).long()
    counts = torch.as_tensor(counts, dtype=torch.float64, device=reps.device)
    flat = reps.reshape(reps.shape[0], -1)
    acc = counts.new_zeros((gpcsp_count + 1,)).index_add_(
        0, flat.reshape(-1), counts[:, None].expand(flat.shape).reshape(-1)
    )
    return torch.log(acc[:gpcsp_count])


def simple_average(reps, counts, gpcsp_count: int):
    """SA estimator: sbn_parameters = log counts (SimpleAverage).

    Note the reference does NOT normalize here; evaluation normalizes on the
    fly."""
    return log_counts_of_representations(reps, counts, gpcsp_count)


def _em_step(params, reps, counts, log_m_tilde_alpha, m_tilde_pos,
             segment_ids, num_segments: int, alpha_positive: bool):
    """One EM iteration from normalized log-probabilities ``params`` (G,).

    reps: (T, E, R) int64; counts: (T,). Returns (new params (G,), score
    (), underflowed ()): the score is the marginal log likelihood of the
    training trees (plus the regularization term when alpha > 0);
    underflowed counts the in-support rootings whose E-step weight
    underflowed to exactly 0, so that their M-step contribution is dropped
    (the reference clamps them to DOUBLE_MINIMUM and reports the
    floating-point exception, sbn_probability.cpp:278-281)."""
    G = segment_ids.shape[0]
    ext = with_sentinel(params)
    logq = ext[reps].sum(dim=-1)  # (T, E): log q of each rooting
    logp = torch.logsumexp(logq, dim=-1)  # (T,)
    score = torch.sum(counts * logp)
    w = torch.exp(logq - logp[:, None]) * counts[:, None]  # (T, E)
    # M-step: scatter the weights onto every index of every rooted rep.
    m_bar = fixed_order_scatter_add(
        params.new_zeros((G + 1,)), reps.reshape(-1),
        w[:, :, None].expand(reps.shape).reshape(-1))[:G]
    new = torch.log(m_bar)
    if alpha_positive:
        new = torch.logaddexp(new, log_m_tilde_alpha)
    new = probability_normalize_in_log(new, segment_ids, num_segments)
    if alpha_positive:
        score = score + torch.sum(m_tilde_pos * new)
    underflowed = torch.sum(torch.isfinite(logq) & (w <= 0.0))
    return new, score, underflowed


def expectation_maximization(
    reps, counts, segment_ids, gpcsp_count: int, alpha: float = 0.0,
    max_iter: int = 100, score_epsilon: float = 0.0, progress: bool = False,
):
    """EM training (ExpectationMaximization), on the device of ``reps``.
    Returns (params (G,) float64 tensor, score history as float64 numpy).

    reps: (T, E, R) dense unrooted representations; counts: (T,) topology
    counts; segment_ids: (G,). Monotonicity of the score is asserted each
    iteration as in the reference, on the relative change, or on the
    absolute change where the previous score is exactly 0 (a degenerate
    support such as one 3-taxon tree); the loop stops early once the change
    is below ``score_epsilon``. A non-finite score warns."""
    reps = torch.as_tensor(reps).long()
    dev = reps.device
    counts = torch.as_tensor(counts, dtype=torch.float64, device=dev)
    segment_ids = torch.as_tensor(segment_ids, device=dev).long()
    num_segments = int(segment_ids.max()) + 1
    edge_count = reps.shape[1]

    log_m_tilde = log_counts_of_representations(reps, counts, gpcsp_count)
    log_m_tilde = log_m_tilde - np.log(float(edge_count))
    params = probability_normalize_in_log(log_m_tilde, segment_ids,
                                          num_segments)
    alpha_positive = alpha > 0.0
    if alpha_positive:
        log_m_tilde_alpha = log_m_tilde + np.log(alpha)
        m_tilde_pos = torch.exp(log_m_tilde_alpha)
    else:
        log_m_tilde_alpha = m_tilde_pos = None

    score_history = []
    max_underflowed = 0
    underflow_iters = 0
    for em_idx in range(max_iter):
        params, score, underflowed = _em_step(
            params, reps, counts, log_m_tilde_alpha, m_tilde_pos,
            segment_ids, num_segments, alpha_positive,
        )
        # One read back to the host per iteration.
        score, underflowed = torch.stack(
            [score, underflowed.to(torch.float64)]).tolist()
        underflowed = int(underflowed)
        if underflowed:
            underflow_iters += 1
            max_underflowed = max(max_underflowed, underflowed)
        if progress:
            # The reference renders a ProgressBar over max_iter
            # (sbn_probability.cpp:256); one status line per iteration.
            print(f"EM [{em_idx + 1}/{max_iter}] score {score:.10f}",
                  flush=True)
        if not np.isfinite(score):
            warnings.warn(
                f"EM iteration {em_idx}: non-finite score {score} "
                "(ReportFloatingPointEnvironmentExceptions analog)",
                RuntimeWarning, stacklevel=2,
            )
        score_history.append(score)
        if em_idx > 0:
            prev = score_history[-2]
            scaled = (score - prev) / abs(prev) if prev != 0.0 else score - prev
            if not scaled > -1e-10:
                raise AssertionError("EM score function decreased.")
            if abs(scaled) < score_epsilon:
                break
    if underflow_iters:
        warnings.warn(
            f"EM: up to {max_underflowed} in-support rooting weights "
            f"underflowed to 0 (affected {underflow_iters} of "
            f"{len(score_history)} iterations); their M-step contributions "
            "were dropped (reference clamps these to DOUBLE_MINIMUM and "
            "reports the FE exception, sbn_probability.cpp:278-281)",
            RuntimeWarning, stacklevel=2,
        )
    return params, np.asarray(score_history)


# -- probability evaluation --------------------------------------------------
def probability_of_rooted_collection(params_normalized, reps):
    """reps: (T, R) rooted representations -> (T,) probabilities; trees out
    of the support get 0 (ProbabilityOfSingle via the -inf sentinel)."""
    ext = with_sentinel(params_normalized)
    reps = torch.as_tensor(reps, device=ext.device).long()
    return torch.exp(ext[reps].sum(dim=-1))


def probability_of_unrooted_collection(params_normalized, reps):
    """reps: (T, E, R) unrooted representations -> (T,) probabilities
    summed over the rootings."""
    ext = with_sentinel(params_normalized)
    reps = torch.as_tensor(reps, device=ext.device).long()
    return torch.exp(torch.logsumexp(ext[reps].sum(dim=-1), dim=-1))
