"""K5, the generic likelihood kernel (on-chip and slab routes), against the
least time of a call's log-likelihoods."""

from portbench.metrics._common import roofline_pct

KERNELS = ("generic_ll_kernel", "generic_ll_slab_kernel")


def read(ctx):
    return roofline_pct(ctx, KERNELS, "ll", "GTR")
