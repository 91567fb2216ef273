"""The whole step's share of the card's peak: the pruning operations a
step's particles require (log-likelihoods and branch gradients, work.py)
over the untraced window's host-clock time a step, at the peak of the
configuration's type."""

from portbench import work


def read(ctx):
    s, shape = ctx["stats"], ctx["work"]["shape"]
    ops = work.ops(shape, "ll_bgrad") * s["attempted"]
    return 100.0 * ops / s["window_s"] / work.PEAK_FLOPS[shape.dtype]
