"""K1 against the native CPU baseline at scale: the counterpart of the JAX
package's tools/scale_compare.py, with the same workload and gate.

The workload: LL + linear-time branch gradient of a batch of copies of one
random unrooted tree (joins drawn from ``default_rng(0)``), one-hot random
tips and branch lengths from U(0.01, 0.3), by K1 in float32 through
``ops/pruning_jc.py`` against ``utils/cpu_baseline.eval_batch`` in float64
on all cores. The native side runs float64 because its unscaled float32
path underflows beyond about 100 taxa; K1 rescales per level and stays
float32. The JAX tool's gate is kept as it is: max |g_k1 - g_native| /
(|g_native| + 1) < 1e-4 over the node_count - 1 edges.

K1 also runs in float64 at every point. It rescales as the float32 kernel
does; the native path does not, so native float64 underflows once a site's
likelihood falls below the smallest double (each one-hot random site
contributes about 4^-taxa). Where the native LLs are finite, K1 float64 is
held to native float64 at rel 1e-9 (max |a - b| / max |b|, LLs and
gradients each); everywhere, float32 K1 must give finite LLs and gradients,
and its gate value against K1 float64 is printed, which separates a fault
of the kernel from float32 rounding.

``--sweep`` runs 27 and 200 taxa, the largest taxon count whose float32
K = 1 tree fits K1's on-chip plan (``pruning_jc.onchip_plan``: 433), one
more (the slab route) and 1,000 taxa. Each point prints the route K1 took
(read from the launch counters), K1's evals/s at both dtypes, native
float64's, their ratio, the gate values and the device MB a call added.

    python -m libsbn_tpu_torch.utils.scale_compare [taxa] [patterns] [batch]
        [--sweep] [--device cpu]

Defaults 200 taxa x 1,024 patterns x 64 trees. Runs on the card unless
given ``--device cpu`` (the kernels' plain twins). Times are
``profiling.timed_evals_per_sec``'s (best of 3 windows for K1, one window
of at least 8 calls for the native baseline), each line with the card's
nvidia-smi name and power limit. Exits non-zero if a gate fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.topology import Topology
from ..ops import pruning_jc, schedule
from . import cpu_baseline
from .device import DEFAULT_DEVICE, compute_device
from .profiling import timed_evals_per_sec

# The JAX tool's gradient gate (float32 K1 against native float64), and
# K1 float64 against native float64.
GATE = 1e-4
F64_REL = 1e-9
SWEEP_TAXA = (27, 200)  # then the plan's edge, one past it, and 1,000
SWEEP_LARGEST = 1000


def random_tree(taxa, rng):
    """The JAX tool's tree: sequential Topology.join2 of two leaves or
    subtrees drawn from ``rng`` until three remain, joined at the root;
    polished."""
    nodes = [Topology.leaf(i) for i in range(taxa)]
    while len(nodes) > 3:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False), reverse=True)
        a, b = nodes.pop(i), nodes.pop(j)
        nodes.append(Topology.join2(a, b))
    top = Topology.join(nodes)
    top.polish()
    return top


def make_inputs(taxa, patterns, batch):
    """The JAX tool's inputs, drawn from one ``default_rng(0)`` in its
    order (the tree, the lengths, the tip states): a dict of the schedule
    ``sched``, ``pc`` (B, S, 3) int32, ``bl`` (B, N + 1) float64 with the
    root and ones slots 0, one-hot ``tips`` (L, 4, P) and ``w`` (P,)
    float32, and ``up`` (up_node, up_parent, up_sibs tiled to B)."""
    rng = np.random.default_rng(0)
    sch = schedule.schedule_of_topology(random_tree(taxa, rng))

    def tile(a):
        return np.tile(a[None], (batch,) + (1,) * a.ndim)

    bl = rng.uniform(0.01, 0.3, (batch, sch.node_count + 1))
    bl[:, sch.root_id] = 0.0
    bl[:, -1] = 0.0
    states = rng.integers(0, 4, (taxa, patterns))
    tips = np.zeros((taxa, 4, patterns), np.float32)
    tips[np.arange(taxa)[:, None], states, np.arange(patterns)[None, :]] = 1.0
    return {
        "sched": sch,
        "pc": tile(np.asarray(sch.post_children)).astype(np.int32),
        "bl": bl, "tips": tips, "w": np.ones(patterns, np.float32),
        "up": tuple(tile(np.asarray(a)) for a in (sch.up_node, sch.up_parent,
                                                   sch.up_sibs)),
    }


def onchip_limit():
    """The largest taxon count whose unrooted tree (taxa - 2 combine steps)
    fits K1's on-chip plan at float32, one category."""
    def fits(taxa):
        return pruning_jc.onchip_plan(torch.float32, 1, taxa - 2,
                                      taxa) is not None

    taxa = 3
    while fits(taxa + 1):
        taxa += 1
    return taxa


def sweep_points():
    """--sweep's taxon counts: 27, 200, the float32 plan's edge, one past
    it, and 1,000."""
    edge = onchip_limit()
    return SWEEP_TAXA + (edge, edge + 1, SWEEP_LARGEST)


def gate_value(grad, ref, edges):
    """The JAX tool's gate: max |grad - ref| / (|ref| + 1) over the first
    ``edges`` columns (nan where ref is not finite)."""
    g = np.asarray(grad, np.float64)[:, :edges]
    r = np.asarray(ref, np.float64)[:, :edges]
    with np.errstate(invalid="ignore"):
        return float(np.max(np.abs(g - r) / (np.abs(r) + 1.0)))


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def k1_call(inp, dtype, device):
    """A function that runs K1 (on the CPU its twin) at ``dtype`` on
    ``device`` over inputs uploaded once: () -> (lls (B,), grads
    (B, root_id))."""
    root_id = inp["sched"].root_id
    pc = torch.as_tensor(inp["pc"], device=device)
    bl = torch.as_tensor(inp["bl"]).to(device=device, dtype=dtype)
    tips = torch.as_tensor(inp["tips"]).to(device=device, dtype=dtype)
    w = torch.as_tensor(inp["w"]).to(device=device, dtype=dtype)
    return lambda: pruning_jc.log_likelihood_and_branch_gradient_jc69(
        pc, bl, tips, w, root_id=root_id)


def native_call(inp):
    """A function that runs the native baseline in float64 on all cores:
    () -> (lls (B,), grads (B, N))."""
    tips, w = inp["tips"].astype(np.float64), inp["w"].astype(np.float64)
    return lambda: cpu_baseline.eval_batch(
        inp["pc"], *inp["up"], inp["bl"], tips, w, inp["sched"].leaf_count,
        threads=0, dtype_bits=64)


def first_call(fn, device):
    """(fn's outputs as float64 numpy, the route K1 took, the device MB
    the call added at its peak, None on the CPU)."""
    before = dict(pruning_jc.LAUNCHES)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    mb = None
    if cuda:
        torch.cuda.synchronize(device)
        mb = (torch.cuda.max_memory_allocated(device) - base) / 2**20
    ran = {k for k, v in pruning_jc.LAUNCHES.items() if v != before[k]}
    route = ("slab" if "ll_grad_jc69_slab" in ran
             else "on-chip" if "ll_grad_jc69" in ran else "twin")
    return [x.detach().to("cpu", torch.float64).numpy() for x in out], route, mb


def run(taxa=200, patterns=1024, batch=64, device=DEFAULT_DEVICE,
        target_s=2.0):
    """One point: K1 at float32 and float64 and the native float64 baseline
    on make_inputs(taxa, patterns, batch). Returns a dict of the
    inputs (``inputs``), each side's ``ll``/``grad`` (float64 numpy:
    ``f32``, ``f64``, ``native``), K1's ``route`` and ``mb`` by dtype,
    the gate values ``gate_native`` (float32 K1 against native),
    ``gate_f64`` (float32 K1 against K1 float64) and ``rel_native`` (K1
    float64 against native, LLs and gradients; None where the native LLs
    are not finite), ``native_finite``, ``f32_finite`` and
    ``evals_per_s`` by side (timing windows of about ``target_s``)."""
    device = compute_device(device)
    inp = make_inputs(taxa, patterns, batch)
    edges = inp["sched"].node_count - 1
    calls = {"f32": k1_call(inp, torch.float32, device),
             "f64": k1_call(inp, torch.float64, device),
             "native": native_call(inp)}
    out = {"taxa": taxa, "patterns": patterns, "batch": batch,
           "inputs": inp, "route": {}, "mb": {}}
    for side in ("f32", "f64"):
        (ll, grad), out["route"][side], out["mb"][side] = first_call(
            calls[side], device)
        out[side] = {"ll": ll, "grad": grad}
    ll, grad = calls["native"]()
    out["native"] = {"ll": ll, "grad": grad}
    out["native_finite"] = bool(np.all(np.isfinite(ll)))
    out["f32_finite"] = bool(np.all(np.isfinite(out["f32"]["ll"]))
                             and np.all(np.isfinite(out["f32"]["grad"])))
    out["gate_native"] = gate_value(out["f32"]["grad"], grad, edges)
    out["gate_f64"] = gate_value(out["f32"]["grad"], out["f64"]["grad"],
                                 edges)
    out["rel_native"] = None
    if out["native_finite"]:
        out["rel_native"] = (rel_err(out["f64"]["ll"], ll),
                             rel_err(out["f64"]["grad"], grad[:, :edges]))
    out["evals_per_s"] = {
        side: timed_evals_per_sec(calls[side], batch, target_s=target_s)
        for side in ("f32", "f64")}
    out["evals_per_s"]["native"] = timed_evals_per_sec(
        calls["native"], batch, windows=1, target_s=target_s)
    return out


def check(result, gated=True):
    """Raise AssertionError unless float32 K1's LLs and gradients are
    finite, K1 float64 agrees with native float64 at F64_REL where the
    native LLs are finite, and (``gated``: the default point) the JAX
    tool's gate holds."""
    where = f"{result['taxa']} taxa x {result['patterns']} patterns"
    if not result["f32_finite"]:
        raise AssertionError(f"{where}: float32 K1 gave non-finite values")
    rel = result["rel_native"]
    if rel is not None and max(rel) >= F64_REL:
        raise AssertionError(f"{where}: K1 float64 against native float64 "
                             f"at rel {rel}, over {F64_REL}")
    if gated and not result["gate_native"] < GATE:
        raise AssertionError(f"{where}: gradient parity broke at scale: "
                             f"{result['gate_native']}")


def describe(result, where):
    """The point's lines: routes, rates, gates and MB."""
    r = result
    head = (f"{r['taxa']} taxa x {r['patterns']} patterns (B={r['batch']}): "
            f"K1 route f32 {r['route']['f32']}, f64 {r['route']['f64']}")
    if r["mb"]["f32"] is not None:
        head += (f"; a call added {r['mb']['f32']:.1f} MB (f32), "
                 f"{r['mb']['f64']:.1f} MB (f64)")
    rel = ("native LLs not finite (underflow): not compared"
           if r["rel_native"] is None
           else f"LLs {r['rel_native'][0]:.1e}, gradients "
                f"{r['rel_native'][1]:.1e}")
    lines = [head,
             f"  gate, f32 K1 vs native f64: {r['gate_native']:.1e}; f32 K1 "
             f"vs f64 K1: {r['gate_f64']:.1e}; f64 K1 vs native f64: {rel}"]
    e = r["evals_per_s"]
    lines.append(
        f"  K1 f32 {e['f32']:,.0f} evals/s, K1 f64 {e['f64']:,.0f} "
        f"evals/s, native f64 {e['native']:,.0f} evals/s -> "
        f"{e['f32'] / e['native']:.1f}x (f32), "
        f"{e['f64'] / e['native']:.1f}x (f64) [{where}]")
    return lines


def main(argv=None):
    from ..vi.soak import card_name

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("taxa", nargs="?", type=int, default=200)
    parser.add_argument("patterns", nargs="?", type=int, default=1024)
    parser.add_argument("batch", nargs="?", type=int, default=64)
    parser.add_argument("--sweep", action="store_true",
                        help="run the sweep's taxon counts at these "
                             "patterns and batch")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)
    device = compute_device(args.device)
    where = card_name() if device.type == "cuda" else "cpu, the kernels' twins"
    points = sweep_points() if args.sweep else (args.taxa,)
    failed = []
    for taxa in points:
        result = run(taxa, args.patterns, args.batch, device)
        for line in describe(result, where):
            print(line)
        try:
            check(result, gated=taxa == args.taxa)
        except AssertionError as err:
            print(f"FAIL {err}")
            failed.append(taxa)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
