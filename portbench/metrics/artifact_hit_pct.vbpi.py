"""The share of the run's topology lowerings that VBPI found in its cache:
the program's counter ``libsbn_tpu_torch.vi.jit_step.ARTIFACTS`` (hits and
misses since the process started, set-up included). None where the
program has no such counter."""

import sys


def read(ctx):
    mod = sys.modules.get("libsbn_tpu_torch.vi.jit_step")
    counts = getattr(mod, "ARTIFACTS", None)
    if not counts:
        return None
    lowered = counts["hits"] + counts["misses"]
    return 100.0 * counts["hits"] / lowered if lowered else None
