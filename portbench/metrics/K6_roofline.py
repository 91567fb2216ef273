"""K6, the generic kernel of d LL / d P (on-chip and slab routes), against
the least time of a call's d LL / d P for every edge and category."""

from portbench.metrics._common import roofline_pct

KERNELS = ("generic_dp_kernel", "generic_dp_slab_kernel")


def read(ctx):
    return roofline_pct(ctx, KERNELS, "dp", "GTR")
