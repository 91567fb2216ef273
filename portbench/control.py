"""The readings that the limits of ``correct`` are set from, for one cell:
the program's numbers over many seeds and the control's over a few, in one
process (one set-up).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 2

For each seed: the seed's traffic, a short window at the cell's own load,
and the check of the calls it keeps against the float64 reference (the
program's reading); for a control seed also the control in the program's
place on the same length sets: the reference in the precision below the
configuration's (reference/likelihood.py, ``control=True``). With
``--faults``, each fault planted in the program and read on
``--fault-seeds`` (the training cell's faults set its upper readings
too). One JSON line a seed; a summary line last with each number's
largest program reading and smallest control and fault readings. Needs a
card, as run.py does.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(cell_name, seeds, control_seeds, seconds, device="cuda",
             overrides=None, faults=(), fault_seeds=()):
    """(per-seed rows, summary) for the cell; see the module's doc. Each
    of ``faults`` (drivers' fault names) is planted in the program and read
    on ``fault_seeds``, one set-up a fault."""
    import torch

    from portbench import harness

    cell = harness.Cell(cell_name)
    traffic = dict(cell.traffic, **(overrides or {}))
    rows = []
    for fault in (None,) + tuple(faults):
        drv = cell.driver().Driver(cell.config, traffic, torch.device(device),
                                   fault)
        todo = (sorted(set(seeds) | set(control_seeds)) if fault is None
                else fault_seeds)
        for seed in todo:
            drv.prepare(seed)
            drv.window(seconds)
            drv.collect()
            row = {"seed": seed, "fault": fault, "program": drv.check()}
            if fault is None and seed in control_seeds:
                row["control"] = drv.control()
            rows.append(row)
            print(json.dumps(row), flush=True)
        drv.release()
    faulty = [r for r in rows if r["fault"] is not None]
    rows = [r for r in rows if r["fault"] is None]
    prog = [r["program"] for r in rows if r["seed"] in seeds]
    ctrl = [r["control"] for r in rows if "control" in r]
    summary = {k: {"program_max": max(p[k] for p in prog),
                   "control_min": (min(c[k] for c in ctrl) if ctrl else None),
                   "limit": cell.limits.get(k)} for k in prog[0]}
    for fault in faults:
        for k in summary:
            summary[k][fault + "_min"] = min(
                r["program"][k] for r in faulty if r["fault"] == fault)
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="",
                    help="faults to plant, read on --fault-seeds")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    _, summary = readings(args.workload, ints(args.seeds),
                          ints(args.control_seeds), args.seconds,
                          faults=[f for f in args.faults.split(",") if f],
                          fault_seeds=ints(args.fault_seeds))
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
