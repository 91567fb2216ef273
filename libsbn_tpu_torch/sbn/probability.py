"""SBN probability: normalisation and simple-average training, in torch.

The counterpart of libsbn_tpu.sbn.probability (the reference's
src/sbn_probability.cpp). Indexer representations are dense integer tensors
(T topologies, E rootings, R indices per rooting); the parameter vector
gets an extra slot at index G holding -inf (``with_sentinel``), so
out-of-support indices (sentinel G) contribute zero probability with no
branching. Plain tensor functions on whatever device their inputs are on.

EM training and the probabilities of tree collections are ROADMAP queue 1,
item 5.
"""

from __future__ import annotations

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
    seg_sum = values.new_zeros((num_segments,)).index_add_(0, segment_ids,
                                                          shifted)
    return safe_max + torch.log(seg_sum)


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
