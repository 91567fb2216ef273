"""The device's busy time a rooted call outside K1: the union of device
intervals over the traced calls less K1's kernel time (its kernels named
as K1_roofline names them), over the calls. What is left is the heights
layer's work on the device (the sweeps from ratios to heights, their
adjoint, the log-det-Jacobian's terms) and the call's copies."""

from portbench.metrics.K1_roofline import KERNELS


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * (tr.busy_s - tr.device_s(KERNELS)) / len(tr.calls)
