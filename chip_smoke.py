#!/usr/bin/env python3
"""On-card smoke test of libsbn_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA card is required (there is no CPU fallback); prints its
     name and `nvidia-smi` power limit;
  2. build: builds the CUDA kernels from libsbn_tpu_torch/csrc at first use;
  3. kernel vs twin: K1 (LL + branch gradient), K2 (LL) and K3 (d ll / d
     exp factors, d ll / d props) against their plain PyTorch twins on the
     card, on DS1.subsampled_10 tiled to 512 trees with perturbed branch
     lengths, float32 and float64, one rate category and Weibull+4;
  4. likelihood path: the port's UnrootedInstance on the card (JC69, DS1
     and hello) against the pybeagle/physher golden numbers, and the DS1
     Weibull+4 phylo_gradients (branch gradients against the physher
     goldens, the shape gradient against the card's own f64 finite
     difference), with the launch counters showing that K1, K2 and K3 ran
     and no twin did;
  5. VBPI path: the JAX bench's config 5 (DS1, process_loaded_trees,
     train_simple_average, JC69, split-lognormal, VIMCO, 10 particles) as
     JitVBPI(float32) on the card: a few step()s, one step_many(16) and
     estimate_elbo(512), with finite metrics, K1 and K2 launched and no
     twin called; then one float64 step on the card against the same step
     on the CPU;
  6. timing: K1, K2 and K3 against their twins at B = 512, float32, with
     CUDA events; the VBPI step in ms per step (host clock, synchronised).
The last lines are the {"kernels": [...]} report, the card's `nvidia-smi`
name and power limit, and {"ok": true, "device": {...}}. Imports nothing of
JAX.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data")
sys.path.insert(0, REPO)

import libsbn_tpu_torch as lt  # noqa: E402
from libsbn_tpu_torch.core.site_pattern import SitePattern  # noqa: E402
from libsbn_tpu_torch.io import newick  # noqa: E402
from libsbn_tpu_torch.io.fasta import Alignment  # noqa: E402
from libsbn_tpu_torch.ops import _kernels, pruning_jc, schedule  # noqa: E402
from libsbn_tpu_torch.ops.site_model import weibull_rates  # noqa: E402
from libsbn_tpu_torch.vi import JitVBPI  # noqa: E402

# Golden numbers (the reference's unrooted_sbn_instance.hpp tests, as
# pinned by the JAX package's tests/test_likelihood.py).
PYBEAGLE_LIKELIHOODS = np.array([
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
])
PHYSHER_GRADIENTS = np.array([
    -904.18956, -607.70500, -562.36274, -553.63315, -542.26058, -539.64210,
    -463.36511, -445.32555, -414.27197, -412.84218, -399.15359, -342.68038,
    -306.23644, -277.05392, -258.73681, -175.07391, -171.59627, -168.57646,
    -150.57623, -145.38176, -115.15798, -94.86412, -83.02880, -80.09165,
    -69.00574, -51.93337, 0.00000, 0.00000, 16.17497, 20.47784,
    58.06984, 131.18998, 137.10799, 225.73617, 233.92172, 253.49785,
    255.52967, 259.90378, 394.00504, 394.96619, 396.98933, 429.83873,
    450.71566, 462.75827, 471.57364, 472.83161, 514.59289, 650.72575,
    888.87834, 913.96566, 927.14730, 959.10746, 2296.55028,
])
PHYSHER_WEIBULL_LIKELIHOODS = np.array([
    -9456.1201098061, -6624.4110704332, -6623.4474776131, -6617.25658038029,
    -6627.5385571548, -6621.6155048722, -6622.3314942713, -6618.7695717585,
    -6616.3837517370, -6623.8295828648,
])
# d LL / d b of edge 0 of each tree, Weibull+4 at shape 0.1.
PHYSHER_WEIBULL_GRADIENTS_BL0 = np.array([
    -126.890527, 157.251275, 138.202510, -180.311856, 417.562897, -796.450894,
    -173.744375, -70.693513, 699.190754, -723.034349,
])
HELLO_LL = -84.852358

# Parity gates against the goldens (BASELINE.md precision policy):
# (rtol, atol) for LLs and for gradient entries.
GOLDEN_TOL = {
    torch.float64: {"ll": (0.0, 1.1e-4), "grad": (0.0, 1e-4),
                    "hello": (0.0, 1e-6), "shape": (1e-6, 1e-4)},
    torch.float32: {"ll": (1e-5, 0.5), "grad": (2e-2, 0.5),
                    "hello": (1e-5, 0.5), "shape": (2e-2, 0.5)},
}
# One f64 VBPI step on the card against the same step on the CPU, (rtol,
# atol): the two differ in summation order only (the kernel's tile sums;
# index_add_ sums with atomics in no fixed order on the card). The metrics
# precede the update. The parameters pass through Adam, whose step
# lr g / (|g| + eps) turns a summation-order difference of ~1e-14 in a
# gradient entry near zero into lr / eps = 1e5 times as much: atol 1e-8.
STEP_TOL = {"metrics": (1e-9, 1e-10), "params": (1e-9, 1e-8)}
# Kernel vs twin on the same card and dtype, tighter than the gates above:
# the two differ only in summation order (warp/tile sums vs torch.sum) and
# in nvcc's fused multiply-adds.
TWIN_TOL = {
    torch.float64: {"ll": (1e-12, 1e-9), "grad": (1e-9, 1e-8)},
    torch.float32: {"ll": (2e-6, 0.05), "grad": (1e-3, 0.05)},
}
B = 512  # trees per launch (the JAX bench's headline batch)
DEV = "cuda"
KERNELS = [
    {"name": "jc69_ll_grad (K1)", "key": "ll_grad_jc69",
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:214"},
    {"name": "jc69_ll (K2)", "key": "ll_jc69",
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:431"},
    {"name": "jc69_dea (K3)", "key": "ll_dea_jc69",
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:447"},
]
PARTICLES = 10  # the JAX bench's config 5
SOURCE = "libsbn_tpu_torch/csrc/pruning_jc.cu"


def close(name, got, want, tol):
    """Assert |got - want| <= atol + rtol |want| elementwise; return the
    max abs error."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} / non-finite values")
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    err = float(np.max(np.abs(got - want)))
    print(f"  ok  {name}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {name}, count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    _kernels.load()
    info = _kernels.build_info
    print(f"[2] build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info['seconds']:.1f} s) -> {info['path']}")
    # One line per kernel instance: registers and spills from ptxas -v.
    pattern = r"Function properties for \S*?(jc69_\w+_kernel)I([fd])Li(\d+)E"
    name = None
    for line in info["log"].splitlines():
        m = re.search(pattern, line)
        if m:
            dt = "float" if m.group(2) == "f" else "double"
            name = f"{m.group(1)}<{dt}, K={m.group(3)}>"
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"  ptxas {name}: {regs} registers; {spills}")
            name = None


def load_ds1(dtype):
    """DS1.subsampled_10 tiled to B trees, branch lengths perturbed by
    U(0.8, 1.2) from default_rng(0) (the JAX bench recipe)."""
    tops, bls, ttm = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    sched = schedule.schedules_of_topologies(tops)
    reps = B // len(tops) + 1
    pc = np.tile(sched.post_children, (reps, 1, 1))[:B]
    bl_p = np.pad(np.stack(bls), ((0, 0), (0, 1))).astype(np.float32)
    bl_p = np.tile(bl_p, (reps, 1))[:B]
    rng = np.random.default_rng(0)
    bl_p = (bl_p * rng.uniform(0.8, 1.2, bl_p.shape)).astype(np.float32)
    return {
        "pc": torch.as_tensor(pc, dtype=torch.int32, device=DEV),
        "bl": torch.as_tensor(bl_p, device=DEV),
        "tips": torch.as_tensor(sp.tip_partials(), device=DEV).to(dtype),
        "w": torch.as_tensor(sp.weights, device=DEV).to(dtype),
        "root_id": sched.root_id,
    }


def kernel_inputs(d, dtype, site):
    if site == "constant":
        rates = torch.ones(1, dtype=torch.float64, device=DEV)
        props = rates.clone()
    else:
        rates, props = weibull_rates(0.1, 4, device=DEV)
    rates, props = rates.to(dtype), props.to(dtype)
    ea = pruning_jc.exp_factors(d["bl"], rates, dtype)
    return ea, rates, props


def phase_kernel_vs_twin():
    print(f"[3] kernel vs twin on the card, DS1 x {B} trees")
    errs = {}
    for dtype in (torch.float32, torch.float64):
        d = load_ds1(dtype)
        tol = TWIN_TOL[dtype]
        for site in ("constant", "weibull+4"):
            ea, rates, props = kernel_inputs(d, dtype, site)
            args = (d["pc"], ea, rates, props, d["tips"], d["w"])
            k_ll, k_g = pruning_jc.ll_grad_jc69_cuda(*args, root_id=d["root_id"])
            t_ll, t_g = pruning_jc.ll_grad_jc69_plain(*args, root_id=d["root_id"])
            args2 = (d["pc"], ea, props, d["tips"], d["w"])
            k2 = pruning_jc.ll_jc69_cuda(*args2, root_id=d["root_id"])
            t2 = pruning_jc.ll_jc69_plain(*args2, root_id=d["root_id"])
            k_dea, k_dp = pruning_jc.ll_dea_jc69_cuda(*args2,
                                                      root_id=d["root_id"])
            t_dea, t_dp = pruning_jc.ll_dea_jc69_plain(*args2,
                                                       root_id=d["root_id"])
            torch.cuda.synchronize()
            r = d["root_id"]
            tag = f"{str(dtype)[6:]} {site}"
            e1 = max(
                close(f"K1 LL {tag}", k_ll.cpu(), t_ll.cpu(), tol["ll"]),
                close(f"K1 grad {tag}", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
                      tol["grad"]),
            )
            e2 = close(f"K2 LL {tag}", k2.cpu(), t2.cpu(), tol["ll"])
            if k_dea[:, r:].any():
                raise AssertionError("K3: root or ones-slot rows not zero")
            e3 = max(
                close(f"K3 dea {tag}", k_dea.cpu(), t_dea.cpu(), tol["grad"]),
                close(f"K3 dprops {tag}", k_dp.cpu(), t_dp.cpu(),
                      tol["grad"]),
            )
            del k_dea, t_dea
            if dtype == torch.float32 and site == "constant":
                # the timed case
                errs = {"ll_grad_jc69": e1, "ll_jc69": e2, "ll_dea_jc69": e3}
    return errs


def instance(tree_file, fasta, spec, dtype):
    inst = lt.UnrootedInstance()
    if tree_file.endswith(".t"):
        inst.read_nexus_file(f"{DATA}/{tree_file}")
    else:
        inst.read_newick_file(f"{DATA}/{tree_file}")
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.prepare_for_phylo_likelihood(spec, device=DEV, dtype=dtype)
    return inst


def launch_counts(path, needed):
    """Read the counters after a path's run; fail unless every kernel in
    ``needed`` launched and no twin ran."""
    torch.cuda.synchronize()
    launches = dict(pruning_jc.LAUNCHES)
    twins = dict(pruning_jc.TWIN_CALLS)
    print(f"  {path}: kernel launches {launches}, twin calls {twins}")
    if min(launches[k] for k in needed) < 1 or max(twins.values()) != 0:
        raise AssertionError(f"the {path} did not run (only) its kernels")
    return launches


def phase_main_path():
    """The user's likelihood entry points on the card; returns the launch
    counts."""
    print("[4] likelihood path: UnrootedInstance on cuda vs goldens")
    shape_fd = shape_finite_difference()
    pruning_jc.reset_counters()
    for dtype in (torch.float64, torch.float32):
        tol = GOLDEN_TOL[dtype]
        tag = str(dtype)[6:]
        jc = lt.PhyloModelSpec("JC69", "constant", "strict")
        inst = instance("DS1.subsampled_10.t", "DS1.fasta", jc, dtype)
        close(f"DS1 LLs vs pybeagle, {tag}", inst.log_likelihoods(),
              PYBEAGLE_LIKELIHOODS, tol["ll"])
        grads = inst.phylo_gradients()
        g = grads["branch_lengths"]
        if g.device.type != torch.device(DEV).type or g.shape != (10, 51):
            raise AssertionError(f"gradients on {g.device}, shape {g.shape}")
        close(f"DS1 LLs of phylo_gradients, {tag}",
              grads["log_likelihood"].cpu(), PYBEAGLE_LIKELIHOODS, tol["ll"])
        mine = np.sort(np.concatenate([g[-1].cpu().numpy(), [0.0, 0.0]]))
        close(f"DS1 last-tree gradient vs physher, {tag}", mine,
              PHYSHER_GRADIENTS, tol["grad"])
        wb = lt.PhyloModelSpec("JC69", "weibull+4", "strict")
        inst = instance("DS1.subsampled_10.t", "DS1.fasta", wb, dtype)
        inst.phylo_model_params["site"]["shape"] = torch.tensor(
            0.1, dtype=torch.float64, device=DEV)
        close(f"DS1 Weibull+4 LLs vs physher, {tag}", inst.log_likelihoods(),
              PHYSHER_WEIBULL_LIKELIHOODS, tol["ll"])
        grads = inst.phylo_gradients()
        shape_grad = grads["site_model"]
        if (shape_grad.device.type != torch.device(DEV).type
                or shape_grad.shape != (10,)):
            raise AssertionError(f"shape gradient on {shape_grad.device}, "
                                 f"shape {tuple(shape_grad.shape)}")
        close(f"DS1 Weibull+4 edge-0 gradients vs physher, {tag}",
              grads["branch_lengths"][:, 0].cpu(),
              PHYSHER_WEIBULL_GRADIENTS_BL0, tol["grad"])
        close(f"DS1 Weibull+4 shape gradient vs f64 finite difference, {tag}",
              shape_grad.cpu(), shape_fd, tol["shape"])
        inst = instance("hello.nwk", "hello.fasta", jc, dtype)
        close(f"hello LL, {tag}", inst.log_likelihoods(), [HELLO_LL],
              tol["hello"])
    return launch_counts("likelihood path",
                         ["ll_grad_jc69", "ll_jc69", "ll_dea_jc69"])


def shape_finite_difference(h=1e-5):
    """(10,) d LL / d Weibull shape at 0.1 on DS1 by central differences of
    the f64 LLs on the card (K2)."""
    wb = lt.PhyloModelSpec("JC69", "weibull+4", "strict")
    inst = instance("DS1.subsampled_10.t", "DS1.fasta", wb, torch.float64)

    def lls(shape):
        inst.phylo_model_params["site"]["shape"] = torch.tensor(
            shape, dtype=torch.float64, device=DEV)
        return inst.log_likelihoods()

    return (lls(0.1 + h) - lls(0.1 - h)) / (2 * h)


def bench_instance(device, dtype):
    """The JAX bench's config 5 instance (bench.py:546-556)."""
    inst = lt.UnrootedInstance("bench")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        lt.PhyloModelSpec("JC69", "constant", "strict"), device=device,
        dtype=dtype)
    return inst


def phase_vbpi():
    """JitVBPI on the card at the bench's configuration, then one f64 step
    on the card against the CPU's; returns the launch counts of the
    float32 run."""
    print(f"[5] VBPI path: JitVBPI(float32) on cuda, DS1, {PARTICLES} "
          "particles, VIMCO, split-lognormal")
    inst = bench_instance(DEV, torch.float32)
    pruning_jc.reset_counters()
    jv = JitVBPI(inst, particle_count=PARTICLES, seed=0, dtype=torch.float32)
    metrics = [jv.step() for _ in range(4)]
    window = jv.step_many(16)
    elbo = jv.estimate_elbo(512)
    launches = launch_counts("VBPI path", ["ll_grad_jc69", "ll_jc69"])
    values = np.array([[float(m["mean_ll"]), float(m["elbo_like"])]
                       for m in metrics])
    w_ll = window["mean_ll"].cpu().numpy()
    w_elbo = window["elbo_like"].cpu().numpy()
    if not (np.all(np.isfinite(values)) and np.all(np.isfinite(w_ll))
            and np.all(np.isfinite(w_elbo)) and np.isfinite(elbo)):
        raise AssertionError("VBPI metrics are not finite")
    if (w_ll.shape != (16,)
            or jv.state.q_params.device.type != torch.device(DEV).type):
        raise AssertionError("step_many returned the wrong shape or device")
    print(f"  sampler: {jv.last_sampler}; step() mean_ll "
          f"{values[:, 0].round(3).tolist()}, elbo_like "
          f"{values[:, 1].round(3).tolist()}")
    print(f"  step_many(16): mean_ll {w_ll[0]:.3f} .. {w_ll[-1]:.3f}, "
          f"elbo_like {w_elbo[0]:.3f} .. {w_elbo[-1]:.3f}; "
          f"estimate_elbo(512) {elbo:.3f}")

    # One f64 step on the card against the same step on the CPU (same
    # seed, so the same host samples).
    cpu = JitVBPI(bench_instance("cpu", torch.float64),
                  particle_count=PARTICLES, seed=0, device="cpu")
    card = JitVBPI(bench_instance(DEV, torch.float64),
                   particle_count=PARTICLES, seed=0)
    want, got = cpu.step(), card.step()
    for name in ("mean_ll", "elbo_like"):
        close(f"f64 step card vs CPU, {name}", float(got[name]),
              float(want[name]), STEP_TOL["metrics"])
    for name in ("q_params", "sbn_params"):
        close(f"f64 step card vs CPU, {name}",
              getattr(card.state, name).cpu(), getattr(cpu.state, name),
              STEP_TOL["params"])
    return launches


def time_ms(fn, reps=7, inner=10):
    """Median over reps of the mean per-call time of `inner` calls, by CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_timing(smi):
    print(f"[6] timing at B = {B}, float32, one category, DS1 ({smi})")
    d = load_ds1(torch.float32)
    ea, rates, props = kernel_inputs(d, torch.float32, "constant")
    r = d["root_id"]
    a1 = (d["pc"], ea, rates, props, d["tips"], d["w"])
    a2 = (d["pc"], ea, props, d["tips"], d["w"])
    calls = {
        "ll_grad_jc69": (lambda: pruning_jc.ll_grad_jc69_cuda(*a1, root_id=r),
                         lambda: pruning_jc.ll_grad_jc69_plain(*a1, root_id=r)),
        "ll_jc69": (lambda: pruning_jc.ll_jc69_cuda(*a2, root_id=r),
                    lambda: pruning_jc.ll_jc69_plain(*a2, root_id=r)),
        "ll_dea_jc69": (lambda: pruning_jc.ll_dea_jc69_cuda(*a2, root_id=r),
                        lambda: pruning_jc.ll_dea_jc69_plain(*a2, root_id=r)),
    }
    out = {}
    for key, (kern, plain) in calls.items():
        torch.cuda.reset_peak_memory_stats()
        # Turns: plain, kernel, kernel, plain; each side keeps its better.
        p1, k1, k2, p2 = (time_ms(f) for f in (plain, kern, kern, plain))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[key] = (ms, plain_ms)
        print(f"  {key}: kernel {k1:.4f} / {k2:.4f} ms, twin {p1:.4f} / "
              f"{p2:.4f} ms; {B / ms * 1e3:.0f} vs {B / plain_ms * 1e3:.0f} "
              f"evals/s; peak {peak:.2f} GiB")

    # The differentiable LL: K2 forward + K3 backward through autograd.
    bl = d["bl"].detach().clone().requires_grad_(True)

    def ll_and_grad():
        ll = pruning_jc.log_likelihoods_jc69(d["pc"], bl, d["tips"], d["w"],
                                             root_id=r)
        return torch.autograd.grad(ll.sum(), bl)

    print(f"  log_likelihoods_jc69 + autograd (K2 + K3): "
          f"{time_ms(ll_and_grad, reps=5, inner=5):.4f} ms")
    return out


def time_vbpi(smi, steps=20):
    """ms per VBPI step at the bench's configuration (host clock around
    synchronised runs, after a warm-up)."""
    print(f"  VBPI at P = {PARTICLES}, float32, DS1 ({smi}):")
    jv = JitVBPI(bench_instance(DEV, torch.float32),
                 particle_count=PARTICLES, seed=0, dtype=torch.float32)
    runs = {
        "step()": lambda: [jv.step() for _ in range(steps)],
        "step_overlapped()": lambda: [jv.step_overlapped()
                                      for _ in range(steps)],
        "step_many(16)": lambda: [jv.step_many(16)
                                  for _ in range(steps // 16 + 1)],
    }
    out = {}
    for name, run in runs.items():
        run()  # warm-up (and the topology cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(run())
        torch.cuda.synchronize()
        per = 16 if name == "step_many(16)" else 1
        out[name] = (time.perf_counter() - t0) * 1e3 / (n * per)
        print(f"    {name}: {out[name]:.3f} ms per step")
    return out


def main():
    name, smi = phase_device()
    phase_build()
    errs = phase_kernel_vs_twin()
    runs = [phase_main_path(), phase_vbpi()]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    times = phase_timing(smi)
    time_vbpi(smi)
    report = [
        {"name": k["name"], "route": "cuda", "source": SOURCE,
         "replaces": k["replaces"], "launches": launches[k["key"]],
         "max_abs_err": errs[k["key"]], "ms": times[k["key"]][0],
         "plain_ms": times[k["key"]][1]}
        for k in KERNELS
    ]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
