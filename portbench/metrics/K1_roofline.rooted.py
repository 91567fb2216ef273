"""K1, the JC69 likelihood-and-branch-gradient kernel (on-chip and slab
routes, named as K1_roofline names them), on rooted trees: against the
least time of a call's log-likelihoods and branch gradients counted on the
rooted shape (work_rooted.RootedShape)."""

from portbench.metrics._common import roofline_pct
from portbench.metrics.K1_roofline import KERNELS


def read(ctx):
    return roofline_pct(ctx, KERNELS, "ll_bgrad", "JC69")
