"""The heights sweeps a rooted call runs, forward and adjoint: the
program's counter ``libsbn_tpu_torch.ops.heights.SWEEPS`` over the traced
calls, as drivers/rooted.py read it around them, over the calls. None
where the program has no such counter."""


def read(ctx):
    sweeps = ctx["work"].get("height_sweeps")
    if sweeps is None:
        return None
    return sweeps / len(ctx["trace"].calls)
