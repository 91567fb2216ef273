"""K1, the JC69 likelihood-and-branch-gradient kernel (on-chip and slab
routes), against the least time of a call's log-likelihoods and branch
gradients."""

from portbench.metrics._common import roofline_pct

KERNELS = ("jc69_ll_grad_kernel", "jc69_ll_grad_slab_kernel")


def read(ctx):
    return roofline_pct(ctx, KERNELS, "ll_bgrad", "JC69")
