"""What the per-layer readers share: a kernel's share of its roofline."""

from portbench import work


def roofline_pct(ctx, patterns, job, model=None):
    """The least time of ``job`` on the call's shapes (work.py), over the
    traced device time a call of the kernels whose names hold one of
    ``patterns``, in percent; None when no such kernel ran."""
    tr = ctx["trace"]
    seconds = tr.device_s(patterns) / len(tr.calls)
    if seconds <= 0:
        return None
    shape = ctx["work"]["shape"]
    if model is not None and shape.model != model:
        return None
    return 100.0 * work.least_seconds(shape, job) / seconds
