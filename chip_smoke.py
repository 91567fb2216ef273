#!/usr/bin/env python3
"""On-card smoke test of libsbn_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA card is required (there is no CPU fallback); prints its
     name and `nvidia-smi` power limit;
  2. build: builds the CUDA kernels from libsbn_tpu_torch/csrc (one nvcc
     per source, in parallel) and prints each instance's registers and
     spills;
  3. kernel vs twin: K1 (LL + branch gradient), K2 (LL) and K3 (d ll / d
     exp factors, d ll / d props) against their plain PyTorch twins on the
     card, on DS1.subsampled_10 tiled to 512 trees with perturbed branch
     lengths, float32 and float64, one rate category and Weibull+4; then K4
     (generic LL + branch gradient), K5 (generic LL) and K6 (d ll / dP,
     d ll / d freqs, d ll / d props) against theirs on DS1.100_topologies
     tiled to 256 trees, GTR + constant and GTR + Weibull+4, float32 and
     float64;
  4. likelihood path: the port's UnrootedInstance on the card (JC69, DS1
     and hello) against the pybeagle/physher golden numbers, and the DS1
     Weibull+4 phylo_gradients (branch gradients against the physher
     goldens, the shape gradient against the card's own f64 finite
     difference), with the launch counters showing that K1, K2 and K3 ran
     and no twin did;
  4b. GTR path: UnrootedInstance on the card, GTR + Weibull+4 on
     DS1.100_topologies, float64 and float32, against values pinned from
     libsbn_tpu's f64 scan engine; in f64 the kernel route against the
     port's own scan engine on the card and the substitution gradient at
     the uniform-rates default against a central finite difference; the
     counters show K4, K5 and K6 launched and no twin called;
  5. VBPI path: the JAX bench's config 5 (DS1, process_loaded_trees,
     train_simple_average, JC69, split-lognormal, VIMCO, 10 particles) as
     JitVBPI(float32) on the card: a few step()s, one step_many(16) and
     estimate_elbo(512), with finite metrics, K1 and K2 launched and no
     twin called; then one float64 step on the card against the same step
     on the CPU;
  6. timing: K1, K2 and K3 against their twins at B = 512, float32, with
     CUDA events; the VBPI step in ms per step (host clock, synchronised);
     K4, K5 and K6 against their twins at the JAX bench's config 2 (GTR +
     Weibull+4 at shape 0.5, B = 256, float32), the K5 + K6 autograd pass
     and engine.phylo_gradients from host arrays, with peak device memory.
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
from libsbn_tpu_torch.models.engine import LikelihoodEngine  # noqa: E402
from libsbn_tpu_torch.models.phylo_model import default_parameters  # noqa: E402
from libsbn_tpu_torch.ops import (  # noqa: E402
    _kernels, pruning, pruning_generic, pruning_jc, pruning_vjp, schedule,
)
from libsbn_tpu_torch.ops import substitution, transforms  # noqa: E402
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
# GTR + Weibull+4 on DS1.100_topologies at GTR_PARAMS, from libsbn_tpu's f64
# scan engine on the CPU (tests/test_torch_generic.py holds these to it):
# the 100 LLs, d LL / d b of edge 0, and for the first 10 trees the
# stick-space substitution gradients and d LL / d shape.
GTR_RATES = [0.1, 0.2, 0.15, 0.25, 0.2, 0.1]
GTR_FREQS = [0.3, 0.25, 0.2, 0.25]
GTR_SHAPE = 0.7
GTR_LIKELIHOODS = np.array([
    -12063.247826462177, -12063.247826462177, -12065.064513915742,
    -12066.546341549118, -12064.958601409962, -12065.064513915742,
    -12062.879578895094, -12062.284346448128, -12062.284346448128,
    -12060.47329032368, -12066.77519836391, -12062.284346448128,
    -12065.064513915742, -12076.870100388702, -12085.596890937984,
    -12080.92295259792, -12083.87257062936, -12060.47329032368,
    -12066.77519836391, -12063.247826462177, -12067.147599348833,
    -12065.064513915742, -12079.1032081323, -12062.284346448128,
    -12062.628902482365, -12063.247826462177, -12066.77519836391,
    -12060.47329032368, -12087.909802356662, -12078.607620585313,
    -12080.822526732103, -12084.464948586728, -12068.253503456332,
    -12063.247826462177, -12069.409200239426, -12066.77519836391,
    -12064.710907940189, -12063.247826462177, -12062.284346448128,
    -12066.902479326693, -12069.518578088015, -12065.934907221339,
    -12076.422682685921, -12065.064513915742, -12063.247826462177,
    -12064.521368624752, -12063.247826462177, -12071.220025238868,
    -12065.064513915742, -12065.064513915742, -12064.958601409962,
    -12064.958601409962, -12060.47329032368, -12078.186574734047,
    -12062.879578895094, -12063.247826462177, -12072.600103865445,
    -12061.196581895885, -12066.332824568493, -12065.064513915742,
    -12065.45512492349, -12065.064513915742, -12063.247826462177,
    -12065.064513915742, -12063.247826462177, -12067.936598736895,
    -12063.247826462177, -12064.958601409962, -12066.77519836391,
    -12073.94734520236, -12065.064513915742, -12063.247826462177,
    -12066.77519836391, -12063.247826462177, -12070.48361661324,
    -12060.47329032368, -12062.284346448128, -12063.247826462177,
    -12065.064513915742, -12067.750930021426, -12068.379229876662,
    -12066.035034149578, -12069.141211463775, -12072.344945426476,
    -12060.47329032368, -12065.064513915742, -12072.79874688384,
    -12063.247826462177, -12065.064513915742, -12069.518578088011,
    -12064.719173025587, -12061.196581895882, -12065.064513915742,
    -12063.247826462177, -12066.332824568493, -12062.628902482365,
    -12063.247826462177, -12063.247826462177, -12080.92295259792,
    -12083.33480917808,
])
GTR_GRADIENTS_BL0 = np.array([
    -61.43698942053795, -61.43698942053795, -61.42712196900927,
    -61.58774150418649, -61.68168873221416, -61.42712196900927,
    -61.50038687407986, -61.52313959799515, -61.52313959799515,
    -61.52669684551009, -61.67216012223884, -61.52313959799515,
    -61.42712196900927, -61.446847770590466, -61.275701747263845,
    -61.21170474051353, -61.204171743211006, -61.52669684551009,
    -61.67216012223884, -61.43698942053795, -61.67145528794126,
    -61.42712196900927, -61.222448969056316, -61.52313959799515,
    -61.45029766125027, -61.43698942053795, -61.67216012223884,
    -61.52669684551009, -61.99210816751229, -61.467566160141715,
    -61.3645395873349, -61.368161176063815, -61.4246422545573,
    -61.43698942053795, -61.61665922527933, -61.67216012223884,
    -61.77032323016345, -61.43698942053795, -61.52313959799515,
    -61.584958181638356, -61.34825866520155, -61.301758368540085,
    -61.445611733827505, -61.42712196900927, -61.43698942053795,
    -61.44602383502673, -61.43698942053795, -61.622673433974754,
    -61.42712196900927, -61.42712196900927, -61.681688732214155,
    -61.681688732214155, -61.52669684551009, -61.44287335398941,
    -61.50038687407986, -61.43698942053795, -61.63227064169885,
    -61.488112950128475, -61.159680562110935, -61.42712196900927,
    -61.66477390328993, -61.42712196900927, -61.43698942053795,
    -61.42712196900927, -61.43698942053795, -61.660327979154374,
    -61.43698942053795, -61.681688732214155, -61.67216012223884,
    -62.26050266021612, -61.42712196900927, -61.43698942053795,
    -61.67216012223884, -61.43698942053795, -61.42499948511995,
    -61.52669684551009, -61.52313959799515, -61.43698942053795,
    -61.42712196900927, -61.35148722775864, -61.655415775109795,
    -61.67059313314969, -61.59601079178756, -61.63080263093031,
    -61.52669684551009, -61.42712196900927, -61.48113183320125,
    -61.43698942053795, -61.42712196900927, -61.34825866520155,
    -61.48948765311322, -61.488112950128475, -61.42712196900927,
    -61.43698942053795, -61.159680562110935, -61.45029766125027,
    -61.43698942053795, -61.43698942053795, -61.21170474051353,
    -61.1921811112531,
])
GTR_SUBSTITUTION_GRADIENTS = np.array([
    [37.37450626752085, -75.29788860620711, 69.43935430704154,
     -125.7528023286616, 74.61405128401657, -553.0478160564726,
     -97.9475700563386, 287.58209606673495],
    [37.37450626752085, -75.29788860620711, 69.43935430704154,
     -125.7528023286616, 74.61405128401657, -553.0478160564726,
     -97.9475700563386, 287.58209606673495],
    [36.19053504157635, -75.77642534559747, 69.3917718697112,
     -126.21328012676449, 74.25887093435685, -555.4452829645165,
     -98.71550003953224, 287.6570451307733],
    [37.37553809344446, -74.62381175902885, 68.98119333187559,
     -124.39863067267069, 74.77202193696141, -550.8187309622937,
     -99.48189646531735, 288.6725205826812],
    [37.50285436018544, -75.48631578635693, 69.39816740647056,
     -124.77092598172769, 74.70581835735612, -552.1752795202394,
     -96.3066940826561, 287.0355248543127],
    [36.19053504157635, -75.77642534559747, 69.3917718697112,
     -126.21328012676449, 74.25887093435685, -555.4452829645165,
     -98.71550003953224, 287.6570451307733],
    [35.73709796468088, -74.72118667228663, 69.81694511865842,
     -124.13110282415816, 73.48403387350074, -553.9754879368842,
     -99.76516080838827, 287.7282756985213],
    [36.288204904886285, -75.17717936023098, 69.43753103746555,
     -124.78090473404248, 73.87803795442832, -554.4604885663691,
     -99.83955206208118, 287.7635385101621],
    [36.288204904886285, -75.17717936023098, 69.43753103746555,
     -124.78090473404248, 73.87803795442832, -554.4604885663691,
     -99.83955206208118, 287.7635385101621],
    [37.47201893821999, -74.72357634865382, 69.4826702236545,
     -124.33979148182523, 74.23418838950244, -552.0436445465191,
     -99.08970426161964, 287.6930988009878],
])
GTR_SITE_GRADIENTS = np.array([
    -19055.840498591067, -19055.840498591067, -19067.658784565938,
    -19041.12216153288, -19055.251518859117, -19067.658784565938,
    -19062.94895152681, -19061.01239077452, -19061.01239077452,
    -19048.819934253996,
])

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
B_GTR = 256  # the JAX bench's config 2 (DS1.100_topologies tiled)
BENCH_SHAPE = 0.5  # config 2's Weibull shape
DEV = "cuda"
JC_SOURCE = "libsbn_tpu_torch/csrc/pruning_jc.cu"
GENERIC_SOURCE = "libsbn_tpu_torch/csrc/pruning_generic.cu"
KERNELS = [
    {"name": "jc69_ll_grad (K1)", "key": "ll_grad_jc69", "source": JC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:214"},
    {"name": "jc69_ll (K2)", "key": "ll_jc69", "source": JC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:431"},
    {"name": "jc69_dea (K3)", "key": "ll_dea_jc69", "source": JC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas_jc.py:447"},
    {"name": "generic_ll_grad (K4)", "key": "ll_grad_generic",
     "source": GENERIC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas.py:55"},
    {"name": "generic_ll (K5)", "key": "ll_generic", "source": GENERIC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas_vjp.py:38"},
    {"name": "generic_dp (K6)", "key": "ll_dp_generic",
     "source": GENERIC_SOURCE,
     "replaces": "libsbn_tpu/ops/pruning_pallas_vjp.py:111"},
]
# The modules whose wrappers count kernel launches and twin calls.
COUNTED = (pruning_jc, pruning_generic, pruning_vjp)
PARTICLES = 10  # the JAX bench's config 5


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
    _kernels.build()  # one nvcc per source, in parallel
    for source in _kernels.SOURCES:
        _kernels.load(source)
    print(f"[2] build: {time.perf_counter() - t0:.1f} s")
    # One line per kernel instance: registers and spills from ptxas -v.
    pattern = (r"Function properties for \S*?((?:jc69|generic)_"
               r"(?:ll_grad|ll|dea|dp)_kernel)I([fd])Li(\d+)E")
    for source, info in _kernels.build_info.items():
        print(f"  {source}: nvcc {info['seconds']:.1f} s -> {info['path']}")
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


def load_ds1_100(dtype):
    """DS1.100_topologies tiled to B_GTR trees, unperturbed (the JAX bench's
    config 2 recipe): the schedule, branch lengths and alignment as the
    kernels and the engine take them."""
    tops, bls, ttm = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    reps = B_GTR // len(tops) + 1
    sched = schedule.schedules_of_topologies((tops * reps)[:B_GTR])
    bl = np.tile(np.stack(bls), (reps, 1))[:B_GTR]
    return {
        "sp": sp, "sched": sched, "bl_host": bl.astype(np.float32),
        "pc": torch.as_tensor(sched.post_children, dtype=torch.int32,
                              device=DEV),
        "bl": torch.as_tensor(np.pad(bl, ((0, 0), (0, 1))), device=DEV),
        "tips": torch.as_tensor(sp.tip_partials(), device=DEV).to(dtype),
        "w": torch.as_tensor(sp.weights, device=DEV).to(dtype),
        "root_id": sched.root_id,
    }


def generic_inputs(d, dtype, site, rates6=GTR_RATES, freqs=GTR_FREQS,
                   shape=GTR_SHAPE):
    """(P (B, N1, K, 4, 4), Q_scaled (K, 4, 4), freqs (4,), props (K,)) in
    ``dtype`` on the card, built as the engine builds them."""
    f64 = dict(dtype=torch.float64, device=DEV)
    freqs = torch.tensor(freqs, **f64)
    Q = substitution.gtr_q(torch.tensor(rates6, **f64), freqs)
    if site == "constant":
        rates = props = torch.ones(1, **f64)
    else:
        rates, props = weibull_rates(shape, 4, device=DEV)
    with torch.no_grad():
        ts = d["bl"].to(dtype)[:, :, None] * rates.to(dtype)
        P = substitution.expm_transition(Q.to(dtype), freqs.to(dtype), ts)
    Qs = Q.to(dtype)[None] * rates.to(dtype)[:, None, None]
    return P.contiguous(), Qs.contiguous(), freqs.to(dtype), props.to(dtype)


def phase_generic_vs_twin():
    print(f"[3] kernel vs twin on the card, DS1.100_topologies x {B_GTR} "
          "trees, GTR")
    errs = {}
    for dtype in (torch.float32, torch.float64):
        d = load_ds1_100(dtype)
        tol = TWIN_TOL[dtype]
        r = d["root_id"]
        for site in ("constant", "weibull+4"):
            P, Qs, freqs, props = generic_inputs(d, dtype, site)
            args = (d["pc"], P, Qs, d["tips"], freqs, props, d["w"])
            k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
            t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
            args2 = (d["pc"], P, d["tips"], freqs, props, d["w"])
            k5 = pruning_vjp.ll_generic_cuda(*args2, root_id=r)
            t5 = pruning_vjp.ll_generic_plain(*args2, root_id=r)
            k6 = pruning_vjp.ll_dp_generic_cuda(*args2, root_id=r)
            t6 = pruning_vjp.ll_dp_generic_plain(*args2, root_id=r)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} GTR {site}"
            e4 = max(
                close(f"K4 LL {tag}", k_ll.cpu(), t_ll.cpu(), tol["ll"]),
                close(f"K4 grad {tag}", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
                      tol["grad"]),
            )
            e5 = close(f"K5 LL {tag}", k5.cpu(), t5.cpu(), tol["ll"])
            if k6[0][:, r:].any():
                raise AssertionError("K6: root or ones-slot rows not zero")
            e6 = max(
                close(f"K6 {name} {tag}", k.cpu(), t.cpu(), tol["grad"])
                for name, k, t in zip(("dP", "dfreqs", "dprops"), k6, t6)
            )
            del k6, t6
            if dtype == torch.float32 and site == "weibull+4":
                # the timed case's model
                errs = {"ll_grad_generic": e4, "ll_generic": e5,
                        "ll_dp_generic": e6}
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


def reset_counters():
    for module in COUNTED:
        module.reset_counters()


def launch_counts(path, needed):
    """Read every module's counters after a path's run; fail unless every
    kernel in ``needed`` launched and no twin ran."""
    torch.cuda.synchronize()
    launches = {k: v for m in COUNTED for k, v in m.LAUNCHES.items()}
    twins = {k: v for m in COUNTED for k, v in m.TWIN_CALLS.items()}
    print(f"  {path}: kernel launches {launches}, twin calls {twins}")
    if min(launches[k] for k in needed) < 1 or max(twins.values()) != 0:
        raise AssertionError(f"the {path} did not run (only) its kernels")
    return launches


def phase_main_path():
    """The user's likelihood entry points on the card; returns the launch
    counts."""
    print("[4] likelihood path: UnrootedInstance on cuda vs goldens")
    shape_fd = shape_finite_difference()
    reset_counters()
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


def gtr_instance(dtype, params=True):
    """UnrootedInstance on the card: GTR + Weibull+4 over
    DS1.100_topologies, at GTR_PARAMS (or the defaults)."""
    spec = lt.PhyloModelSpec("GTR", "weibull+4", "strict")
    inst = instance("DS1.100_topologies.nwk", "DS1.fasta", spec, dtype)
    if params:
        f64 = dict(dtype=torch.float64, device=DEV)
        inst.phylo_model_params["substitution"] = {
            "rates": torch.tensor(GTR_RATES, **f64),
            "frequencies": torch.tensor(GTR_FREQS, **f64),
        }
        inst.phylo_model_params["site"]["shape"] = torch.tensor(GTR_SHAPE, **f64)
    return inst


def phase_gtr_path():
    """The GTR likelihood path through UnrootedInstance on the card against
    the pinned libsbn_tpu values; returns the launch counts."""
    print("[4b] GTR path: UnrootedInstance on cuda, GTR + Weibull+4, "
          "DS1.100_topologies, vs libsbn_tpu's f64 scan engine")
    reset_counters()
    for dtype in (torch.float64, torch.float32):
        tol = GOLDEN_TOL[dtype]
        tag = str(dtype)[6:]
        inst = gtr_instance(dtype)
        close(f"GTR LLs, {tag}", inst.log_likelihoods(), GTR_LIKELIHOODS,
              tol["ll"])
        grads = inst.phylo_gradients()
        shapes = {k: tuple(v.shape) for k, v in grads.items()}
        want = {"log_likelihood": (100,), "branch_lengths": (100, 51),
                "substitution_model": (100, 8), "site_model": (100,)}
        if shapes != want or any(v.device.type != torch.device(DEV).type
                                 for v in grads.values()):
            raise AssertionError(f"phylo_gradients: {shapes}")
        close(f"GTR LLs of phylo_gradients, {tag}",
              grads["log_likelihood"].cpu(), GTR_LIKELIHOODS, tol["ll"])
        close(f"GTR edge-0 gradients, {tag}",
              grads["branch_lengths"][:, 0].cpu(), GTR_GRADIENTS_BL0,
              tol["grad"])
        close(f"GTR substitution gradients (10 trees), {tag}",
              grads["substitution_model"][:10].cpu(),
              GTR_SUBSTITUTION_GRADIENTS, tol["grad"])
        close(f"GTR shape gradients (10 trees), {tag}",
              grads["site_model"][:10].cpu(), GTR_SITE_GRADIENTS, tol["grad"])
    launches = launch_counts(
        "GTR path", ["ll_grad_generic", "ll_generic", "ll_dp_generic"])
    gtr_scan_engine_check()
    gtr_uniform_rates_check()
    return launches


def gtr_scan_engine_check(rel=1e-10):
    """f64 on the card: K4, K5 and K6 (through autograd) against the port's
    own scan engine (ops/pruning.py, rescale=True) on the same P."""
    d = load_ds1_100(torch.float64)
    r = d["root_id"]
    P, Qs, freqs, props = generic_inputs(d, torch.float64, "weibull+4")
    args = (d["pc"], P, Qs, d["tips"], freqs, props, d["w"])
    k_ll, k_g = pruning_generic.log_likelihood_and_branch_gradient_generic(
        *args, root_id=r)
    s_ll, s_g = pruning.log_likelihood_and_branch_gradient(*args, root_id=r)
    Pk = P.clone().requires_grad_(True)
    ll5 = pruning_vjp.log_likelihoods_generic(
        d["pc"], Pk, d["tips"], freqs, props, d["w"], root_id=r)
    (dP_k,) = torch.autograd.grad(ll5.sum(), Pk)
    Ps = P.clone().requires_grad_(True)
    lls = pruning.log_likelihoods(d["pc"], Ps, d["tips"], freqs, props,
                                  d["w"], root_id=r)
    (dP_s,) = torch.autograd.grad(lls.sum(), Ps)
    for name, got, want in (("K4 LL", k_ll, s_ll), ("K4 grad", k_g, s_g),
                            ("K5 LL", ll5, lls), ("K6 dP", dP_k, dP_s)):
        scale = float(want.detach().abs().max())
        close(f"{name} vs the scan engine on the card, f64", got.detach().cpu(),
              want.detach().cpu(), (0.0, rel * scale))


def gtr_uniform_rates_check(eps=1e-6):
    """f64 on the card: the substitution gradient at the uniform-rates
    default (repeated eigenvalues) against a central finite difference in
    stick space, within 1e-4 max(1, |fd|) (tests/test_models.py:118)."""
    inst = gtr_instance(torch.float64, params=False)
    got = inst.phylo_gradients()["substitution_model"].cpu().numpy()
    sub = inst.phylo_model_params["substitution"]
    y0 = torch.cat([transforms.stick_breaking_inverse(sub["rates"]),
                    transforms.stick_breaking_inverse(sub["frequencies"])])

    def lls(y):
        inst.phylo_model_params["substitution"] = {
            "rates": transforms.stick_breaking(y[:5]),
            "frequencies": transforms.stick_breaking(y[5:]),
        }
        return inst.log_likelihoods()

    fd = np.empty_like(got)
    for j in range(8):
        step = torch.zeros(8, dtype=torch.float64, device=DEV)
        step[j] = eps
        fd[:, j] = (lls(y0 + step) - lls(y0 - step)) / (2 * eps)
    err = np.abs(got - fd) / np.maximum(1.0, np.abs(fd))
    if not (np.all(np.isfinite(got)) and err.max() < 1e-4):
        raise AssertionError(f"uniform-rates gradient vs fd: {err.max():.3e}")
    print(f"  ok  uniform-rates substitution gradient vs central difference, "
          f"f64: max |g - fd| / max(1, |fd|) {err.max():.3e} (< 1e-4)")


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
    reset_counters()
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


def time_pairs(calls, n_trees, plain_reps=(7, 10)):
    """{key: (kernel ms, twin ms)} for {key: (kernel call, twin call)}, in
    turns plain, kernel, kernel, plain; each side keeps its better."""
    out = {}
    for key, (kern, plain) in calls.items():
        torch.cuda.reset_peak_memory_stats()
        p1 = time_ms(plain, *plain_reps)
        k1, k2 = time_ms(kern), time_ms(kern)
        p2 = time_ms(plain, *plain_reps)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[key] = (ms, plain_ms)
        print(f"  {key}: kernel {k1:.4f} / {k2:.4f} ms, twin {p1:.4f} / "
              f"{p2:.4f} ms; {n_trees / ms * 1e3:.0f} vs "
              f"{n_trees / plain_ms * 1e3:.0f} evals/s; peak {peak:.2f} GiB")
    return out


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
    out = time_pairs(calls, B)
    # The differentiable LL: K2 forward + K3 backward through autograd.
    bl = d["bl"].detach().clone().requires_grad_(True)

    def ll_and_grad():
        ll = pruning_jc.log_likelihoods_jc69(d["pc"], bl, d["tips"], d["w"],
                                             root_id=r)
        return torch.autograd.grad(ll.sum(), bl)

    print(f"  log_likelihoods_jc69 + autograd (K2 + K3): "
          f"{time_ms(ll_and_grad, reps=5, inner=5):.4f} ms")
    return out


def phase_generic_timing(smi, calls=10):
    """K4, K5 and K6 against their twins, the K5 + K6 autograd pass and the
    engine's phylo_gradients from host arrays, at the JAX bench's config 2:
    GTR (default parameters) + Weibull+4 at shape 0.5, DS1.100_topologies
    tiled to B_GTR trees, float32."""
    print(f"  config 2: GTR + Weibull+4 (shape {BENCH_SHAPE}), "
          f"DS1.100_topologies x {B_GTR}, float32 ({smi})")
    dt = torch.float32
    d = load_ds1_100(dt)
    r = d["root_id"]
    uniform = substitution.DEFAULT_GTR_RATES.tolist()
    P, Qs, freqs, props = generic_inputs(
        d, dt, "weibull+4", rates6=uniform,
        freqs=substitution.DEFAULT_FREQS.tolist(), shape=BENCH_SHAPE)
    a4 = (d["pc"], P, Qs, d["tips"], freqs, props, d["w"])
    a5 = (d["pc"], P, d["tips"], freqs, props, d["w"])
    calls4 = {
        "ll_grad_generic": (
            lambda: pruning_generic.ll_grad_generic_cuda(*a4, root_id=r),
            lambda: pruning_generic.ll_grad_generic_plain(*a4, root_id=r)),
        "ll_generic": (lambda: pruning_vjp.ll_generic_cuda(*a5, root_id=r),
                       lambda: pruning_vjp.ll_generic_plain(*a5, root_id=r)),
        "ll_dp_generic": (
            lambda: pruning_vjp.ll_dp_generic_cuda(*a5, root_id=r),
            lambda: pruning_vjp.ll_dp_generic_plain(*a5, root_id=r)),
    }
    out = time_pairs(calls4, B_GTR, plain_reps=(3, 3))

    Pg = P.detach().clone().requires_grad_(True)

    def ll_and_grad():
        ll = pruning_vjp.log_likelihoods_generic(
            d["pc"], Pg, d["tips"], freqs, props, d["w"], root_id=r)
        return torch.autograd.grad(ll.sum(), Pg)

    print(f"  log_likelihoods_generic + autograd (K5 + K6): "
          f"{time_ms(ll_and_grad, reps=5, inner=5):.4f} ms")

    spec = lt.PhyloModelSpec("GTR", "weibull+4", "strict")
    engine = LikelihoodEngine(d["sp"], spec, dtype=dt, device=DEV)
    params = default_parameters(spec, device=DEV)
    params["site"]["shape"] = torch.tensor(BENCH_SHAPE, dtype=torch.float64,
                                           device=DEV)
    for name, fn in (("log_likelihoods", engine.log_likelihoods),
                     ("phylo_gradients", engine.phylo_gradients)):
        for _ in range(2):
            fn(d["sched"], d["bl_host"], params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn(d["sched"], d["bl_host"], params)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  engine.{name} from host arrays: median "
              f"{statistics.median(times):.3f} ms (min {min(times):.3f}, "
              f"{calls} calls, host clock, synchronised); peak {peak:.2f} GiB")
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
    errs.update(phase_generic_vs_twin())
    runs = [phase_main_path(), phase_gtr_path(), phase_vbpi()]
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    times = phase_timing(smi)
    time_vbpi(smi)
    times.update(phase_generic_timing(smi))
    report = [
        {"name": k["name"], "route": "cuda", "source": k["source"],
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
