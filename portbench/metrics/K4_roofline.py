"""K4, the generic likelihood-and-branch-gradient kernel (on-chip and slab
routes), against the least time of a call's log-likelihoods and branch
gradients."""

from portbench.metrics._common import roofline_pct

KERNELS = ("generic_ll_grad_kernel", "generic_ll_grad_slab_kernel")


def read(ctx):
    return roofline_pct(ctx, KERNELS, "ll_bgrad", "GTR")
