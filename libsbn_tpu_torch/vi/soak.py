"""End-to-end DS1 VBPI training soak: the counterpart of the JAX package's
tools/soak_vbpi.py, with the same protocol and assertion.

The protocol: JitVBPI on DS1 (DS1.subsampled_10.t after process_loaded_trees
and train_simple_average, DS1.fasta, JC69), 10 particles, VIMCO,
split-lognormal, float32, seed 0, 20,000 steps as step_many(20) windows,
beta annealed as min(1, (steps so far + 1) / 2000) per window. Then
ELBO(100) and the importance-weighted marginal likelihood estimate over
1,000 particles: both finite and, at 20,000 steps or more, the marginal
above -6790. That bound is the JAX tool's, set from its record on a TPU.
The JAX package itself, run by this protocol on the CPU, ends at ELBO(100)
-7067.93 and IW marginal(1000) -7035.76 and fails it too; this module
lands within 0.12 nats of both on an H100 (PERF.md), and chip_smoke.py
holds it to them.

    python -m libsbn_tpu_torch.vi.soak [n_steps] [--device cpu]

Runs on the card unless given ``--device cpu`` (on a card, each window is
one CUDA graph replay: JitVBPI's graph route). Prints the steps, seconds
and ms per step (host clock, the device synchronised at the end), the two
estimates and, on a card, its nvidia-smi name and power limit; exits
non-zero if the check fails.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import torch

from .. import PhyloModelSpec, UnrootedInstance
from ..utils.device import DEFAULT_DEVICE, compute_device
from .jit_step import JitVBPI

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")
PARTICLES = 10
WINDOW = 20
ANNEAL_STEPS = 2000
ELBO_PARTICLES = 100
MARGINAL_PARTICLES = 1000
# The JAX package's assertion (tools/soak_vbpi.py), at 20,000 steps.
MARGINAL_FLOOR = -6790.0
CHECKED_STEPS = 20000


def instance(device=DEFAULT_DEVICE, dtype=torch.float32, data_dir=DATA):
    """The soak's DS1 instance, on ``device`` (the card by default)."""
    inst = UnrootedInstance("soak")
    inst.read_nexus_file(os.path.join(data_dir, "DS1.subsampled_10.t"))
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(os.path.join(data_dir, "DS1.fasta"))
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict"), device=device,
        dtype=dtype)
    return inst


def run(n_steps=CHECKED_STEPS, device=DEFAULT_DEVICE, dtype=torch.float32,
        seed=0, data_dir=DATA):
    """Train by the protocol and estimate; returns a dict of the steps,
    seconds, ms per step, ELBO, marginal and route ("graph" or "eager")."""
    device = compute_device(device)
    jv = JitVBPI(instance(device, dtype, data_dir), particle_count=PARTICLES,
                 seed=seed, dtype=dtype)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    steps = 0
    while steps < n_steps:
        jv.step_many(WINDOW, beta=min(1.0, (steps + 1) / ANNEAL_STEPS))
        steps += WINDOW
    sync()
    seconds = time.perf_counter() - t0
    return {
        "steps": steps, "seconds": seconds,
        "ms_per_step": seconds / steps * 1e3,
        "elbo": jv.estimate_elbo(ELBO_PARTICLES),
        "marginal": jv.marginal_likelihood_estimate(MARGINAL_PARTICLES),
        "route": "eager" if jv.graphs is None else "graph",
    }


def check(result):
    """Raise AssertionError unless both estimates are finite and, after
    CHECKED_STEPS steps or more, the marginal is above MARGINAL_FLOOR."""
    if not (math.isfinite(result["elbo"]) and math.isfinite(result["marginal"])):
        raise AssertionError(f"soak estimates are not finite: {result}")
    if result["steps"] >= CHECKED_STEPS and result["marginal"] <= MARGINAL_FLOOR:
        raise AssertionError(
            f"IW marginal({MARGINAL_PARTICLES}) {result['marginal']} <= "
            f"{MARGINAL_FLOOR} after {result['steps']} steps")


def card_name():
    """nvidia-smi's name and power limit of the card(s)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_steps", nargs="?", type=int, default=CHECKED_STEPS)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cpu, or a CUDA device (default: the card)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    result = run(args.n_steps, device=args.device, seed=args.seed)
    print(f"soak: {result['steps']} steps in {result['seconds']:.1f} s "
          f"({result['ms_per_step']:.3f} ms/step, {result['route']} route)")
    print(f"ELBO({ELBO_PARTICLES})={result['elbo']:.2f}  IW marginal"
          f"({MARGINAL_PARTICLES})={result['marginal']:.2f}")
    if compute_device(args.device).type == "cuda":
        print(card_name())
    check(result)
    print("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
