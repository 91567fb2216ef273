"""Device operations a call (kernels, copies and memsets, those a CUDA
graph replays included), from the trace of the traced calls."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.in_window()) / len(tr.calls)
