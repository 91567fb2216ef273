"""The whole rooted call's share of the card's peak: the operations the
window's calls required (log-likelihoods and branch gradients on the
rooted shape, work.py with work_rooted.RootedShape) over the untraced
window's host-clock time, at the peak of the configuration's type."""

from portbench import work


def read(ctx):
    s, shape = ctx["stats"], ctx["work"]["shape"]
    ops = work.ops(shape, ctx["work"]["call_job"]) * s["attempted"]
    return 100.0 * ops / s["window_s"] / work.PEAK_FLOPS[shape.dtype]
