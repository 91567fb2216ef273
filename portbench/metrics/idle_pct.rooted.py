"""The device's idle share of the traced window: 1 - the union of its
busy intervals over the window, from the first call's start to the last
call's outputs."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
