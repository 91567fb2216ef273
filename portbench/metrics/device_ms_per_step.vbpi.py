"""The device's busy time a VBPI step: the union of device intervals over
the traced step_many calls, over the steps they ran."""


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr.busy_s / (len(tr.calls) * ctx["work"]["steps_per_call"])
