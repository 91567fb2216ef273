"""The engine's host time a call: each traced call's span (from the call
to its outputs ready) less the device's busy time inside it, averaged."""


def read(ctx):
    return 1e3 * ctx["trace"].host_s_per_call()
