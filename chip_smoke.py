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
     spills, and the static SASS mix of the on-chip and slab designs;
  3. kernel vs twin: K1 (LL + branch gradient), K2 (LL) and K3 (d ll / d
     exp factors, d ll / d props) against their plain PyTorch twins on the
     card, on DS1.subsampled_10 tiled to 512 trees with perturbed branch
     lengths, float32 and float64, K = 1, 4 and 8 rate categories (all
     three on chip); K1, K2 and K3 on a synthetic 256-taxon tree from a
     numpy seed at float64 K = 8 (beyond shared memory: the slab route) and
     float32 K = 1 (on chip, 32 patterns a tile); then K4
     (generic LL + branch gradient), K5 (generic LL) and K6 (d ll / dP,
     d ll / d freqs, d ll / d props) against theirs on DS1.100_topologies
     tiled to 256 trees, GTR + constant and GTR + Weibull+4, float32 and
     float64 (all three on chip), and K4, K5 and K6 on the 256-taxon tree
     at float32 Weibull+4 and float64 constant (their slab routes); each
     call's route is read from the launch counters;
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
     CUDA events, each beside its bound and its share of the bound; K1, K2
     and K3 at K = 1 and at Weibull+4 beside their slab route (the first
     design) on the same inputs, in turns, with the device memory one call
     adds (fails at 50 MB) and the on-chip design's shared-memory traffic;
     engine.branch_gradients and engine.log_likelihoods from host arrays;
     the VBPI step in ms per step (host clock, synchronised);
     K4, K5 and K6 against their twins at the JAX bench's config 2 (GTR +
     Weibull+4 at shape 0.5, B = 256, float32), K4 and K5 on chip beside
     their slab routes in turns with the memory one call adds (fails at
     50 MB), K6 the same (fails at 128 MB), the K5 + K6 autograd pass and
     engine.log_likelihoods and engine.phylo_gradients from host arrays,
     with peak device memory, device time per call (torch.profiler) and
     the device's idle share of the host-clock median;
  7. GP kernels vs twins: K7 (the PLV population, on chip) and K8 (the
     golden-section branch sweep, a block per edge over staged rows, and
     its slab route, the first design) against their plain PyTorch twins
     on the card, on hello and fluA, float32 and float64; K7 on a synthetic
     600-taxon rooted tree from a numpy seed, float32 and float64 (beyond
     its plan: the slab route), and K8 on seeded rows beyond its plan;
  8. GP path: GPInstance.make_engine(device="cuda"): on the kernel route
     (K7 + K8) in f64 the hello marginal and gradient goldens and the fluA
     fit run_branch_ascent(1e-6, 100) against libsbn_tpu's pinned optimum;
     the same fit on the level route on the card (the f64 oracle); the f32
     kernel route's fit within 1e-2 of the optimum; the counters show K7 and
     K8 launched and no twin called;
  9. GP timing: K7 and K8 against their twins per launch on fluA, float32,
     and K7 and K8 each beside its slab route in turns, each with its share
     of the bound and the SM clock (nvidia-smi) before and after; the JAX
     bench's GP config (fluA, f32,
     run_branch_ascent(1e-2, 10) from the same starting lengths each run)
     on both routes, in ms per ascent, with device time per ascent and the
     device's idle share as in phase 6;
  10. rooted time trees: RootedInstance on the card, fluA (dates from the
     taxon names, strict clock at 0.001), float64, against the physher and
     phylotorch goldens (JC69 LL, log-det-Jacobian and the 68 ratio and
     root-height gradients; Weibull+4 at shape 0.1, LL and shape gradient;
     GTR, LL and the 8 substitution gradients) and the clock gradient
     against the card's own f64 central difference, with the counters
     showing K1 (the hand route), K2, K3, K5 and K6 launched and no twin
     called, on a run that ends with the JAX bench's flua_rooted_gradients
     (fluA tiled to 256, ratios perturbed by U(0.95, 1.05) from
     default_rng(0), JC69, float32): the hand route (K1) against the
     autograd route (K2 + K3) and against the f64 hand route; after the
     counters are read, every kernel of the path against its twin on the
     path's own inputs: K1, K2 and K3 on the f64 instance (on chip), on the
     f64 Weibull+4 instance (the slab route) and on the batch at f32 and
     f64, K5 and K6 on the f64 GTR instance; then, after phase 9's
     timings, K1 timed beside its twin on the f32 batch with its bound,
     and rooted_phylo_gradients (both routes) and rooted_log_likelihoods
     from host arrays with device time, idle share, peak memory and
     gradient evaluations per second;
  11. the vip path (after [10], before the timing phases): after reference
     runs on the CPU (device="cpu", the kernels' twins), with the counters
     at 0: (a) EM on DS1.100_topologies on the card, (0, 23) and (0.5,
     100), against the zcrabbit goldens of tests/golden_sbn.py and the CPU
     reference, and run twice, equal bit for bit; (b) GTR + Weibull+4 rows per tree on DS1.subsampled_10,
     float64, log_likelihoods (K5) and phylo_gradients (the scan engine for
     the branch gradients, K5 + K6 for the model's) against the CPU at rel
     1e-10, each call's route read from the counters; (c) the Burrito
     (DS1.subsampled_10.t burn-in 0.1, DS1.fasta, lognormal, the simple
     optimizer, 10 particles, seed 0, float64): JC69 split for 5 steps (K1
     and K2), GTR + Weibull+4 split for 2 (K4 and K5), JC69 psp for 2,
     each ELBO trace against the CPU reference at rel 1e-9; (d)
     vi.benchmark.fixed on DS1 (20 steps, 10 particles, the final ELBO over
     10,000 particles: one K2 launch at B = 10,000) with its gradient time
     and final ELBO; (f) the
     vip-torch command (benchmark --step-count 2 --particle-count 4) on a
     hello directory (on DS1 its own 10,000-particle ELBO would add 43 s of
     host work); the counters show K1, K2, K4 and K5 launched and no twin
     called; then (e) K1-K3 at the inputs of one more JC69 Burrito step
     (B = 10), K4-K6 at one more GTR step's, K2 on the first 1,000 rows
     of a 10,000-particle ELBO estimate's batch (the Burrito keeps its last
     engine call's schedule and branch lengths) against their twins at
     TWIN_TOL, and the timings: that B = 10,000 engine.log_likelihoods
     call with its device time and the memory it adds, K2 at B = 10,000
     beside its twin in chunks of 1,000 and its bound, a gradient step and
     a 10-particle ELBO estimate with device time and idle share.
The last lines are the {"kernels": [...]} report (each kernel's launches
on its paths, its error against its twin, its time, its twin's, and its
bound: the larger of its operations at the peak of their type (float64's
for a float64 launch, float32's otherwise) and its inputs and outputs at
the HBM rate; K1 has two entries, the first counting the
unrooted and vip paths, the second the rooted batch and path; K2 has two,
the first counting every path but the vip path, the second the vip path's
launches with the B = 10,000 launch's time and bound), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}.
Imports nothing of JAX.
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
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection  # noqa: E402
from libsbn_tpu_torch.gp import GPInstance, engine_kernels  # noqa: E402
from libsbn_tpu_torch.gp.engine import _jc69_transition  # noqa: E402
from libsbn_tpu_torch.io import newick  # noqa: E402
from libsbn_tpu_torch.io.fasta import Alignment  # noqa: E402
from libsbn_tpu_torch.models.engine import LikelihoodEngine  # noqa: E402
from libsbn_tpu_torch.models.phylo_model import default_parameters  # noqa: E402
from libsbn_tpu_torch.ops import (  # noqa: E402
    _kernels, pruning, pruning_generic, pruning_jc, pruning_vjp, schedule,
)
from libsbn_tpu_torch.ops import substitution, transforms  # noqa: E402
from libsbn_tpu_torch.ops.site_model import weibull_rates  # noqa: E402
from libsbn_tpu_torch.vi import Burrito, JitVBPI, benchmark, cli  # noqa: E402

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
KS = (1, 4, 8)  # rate categories of K1-K3 against their twins
BIG_TAXA = 256  # the synthetic tree beyond shared memory
GP_BIG_TAXA = 600  # the synthetic rooted tree beyond K7's plan (1,199 nodes)
# One H100 SXM (NVIDIA's data sheet): float32 and float64 outside the tensor
# cores, HBM3, and the SMs' shared memory (132 SMs x 128 B per cycle at
# 1.755 GHz).
PEAK_F32 = 67e12  # operations / s
PEAK_F64 = 34e12  # operations / s
HBM_RATE = 3.35e12  # bytes / s
SMEM_RATE = 132 * 128 * 1.755e9  # bytes / s
B_GTR = 256  # the JAX bench's config 2 (DS1.100_topologies tiled)
BENCH_SHAPE = 0.5  # config 2's Weibull shape
DEV = "cuda"
JC_SOURCE = "libsbn_tpu_torch/csrc/pruning_jc.cu"
GENERIC_SOURCE = "libsbn_tpu_torch/csrc/pruning_generic.cu"
GP_SOURCE = "libsbn_tpu_torch/csrc/gp_engine.cu"
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
    {"name": "gp_populate (K7)", "key": "populate_plvs", "source": GP_SOURCE,
     "replaces": "libsbn_tpu/gp/engine_pallas.py:104"},
    {"name": "gp_golden_sweep (K8)", "key": "golden_sweep",
     "source": GP_SOURCE, "replaces": "libsbn_tpu/gp/engine_pallas.py:361"},
]
# The modules whose wrappers count kernel launches and twin calls.
COUNTED = (pruning_jc, pruning_generic, pruning_vjp, engine_kernels)
PARTICLES = 10  # the JAX bench's config 5
# Generalized pruning: the reference's goldens (gp_doctest.cpp, as
# tests/test_gp.py pins them) and the fluA optimum of run_branch_ascent(1e-6,
# 100) in f64 (libsbn_tpu: -4337.885058592374 on its level route and
# -4337.885058592593 on its Pallas route, both in 12 sweeps;
# tests/test_torch_gp_kernels.py holds the port's CPU routes to it).
GP_HELLO = -84.77961943
GP_HELLO_BL = [0.0, 0.22, 0.113, 0.15, 0.1]
GP_GRADIENT = (-4.806671945, -0.6109379521)
GP_FLUA = -4337.885058592
GP_FLUA_TOL = {torch.float64: 1e-7, torch.float32: 1e-2}
# K7 against its twin, (rtol, atol) of the PLVs and of the log-scales;
# K8 against its twin, the largest objective gap over |f| + sum(w) and the
# largest log-branch-length gap on edges that are not flat
# (engine_kernels.sweep_disagreement).
# Rooted time trees on fluA at a strict clock of 0.001: the physher and
# phylotorch goldens (the reference's rooted_sbn_instance.hpp tests, as the
# JAX package's tests/test_rooted_likelihood.py pins them), and their
# tolerances there, (rtol, atol).
CLOCK_RATE = 0.001
ROOTED_LL = -4777.616349
ROOTED_LDJ = -9.25135166
ROOTED_RATIO_GRADIENTS = np.array([
    -0.593654, 6.441290, 11.202945, 5.173924, -0.904631, 2.731402, 3.157131,
    7.082914, 10.305417, 13.988206, 20.709336, 48.897993, 99.164949, 130.205747,
    17.314019, 21.033290, -1.336335, 12.259822, 22.887291, 27.176564, 47.487426,
    3.637276, 12.955169, 15.315953, 83.254605, -3.806996, 105.385095, 4.874023,
    22.754466, 6.036534, 25.651478, 29.535185, 29.598789, 1.817247, 10.598685,
    76.259248, 56.481423, 10.679778, 6.587179, 3.330556, -4.622247, 33.417304,
    63.415767, 188.809515, 23.540875, 17.421076, 1.222568, 22.372012, 34.239511,
    3.486115, 4.098873, 13.200954, 19.726890, 96.808738, 4.240029, 7.414585,
    48.871694, 3.488516, 82.969065, 9.009334, 8.032474, 3.981016, 6.543650,
    53.702423, 37.835952, 2.840831, 7.517186, 19.936861,
])
ROOTED_WEIBULL_LL = -4618.2062529058  # shape 0.1
ROOTED_WEIBULL_SHAPE_GRADIENT = -5.231329
ROOTED_GTR_RATES = [0.05, 0.1, 0.15, 0.20, 0.25, 0.25]
ROOTED_GTR_FREQS = [0.1, 0.2, 0.3, 0.4]
ROOTED_GTR_LL = -5221.438941335706
ROOTED_GTR_GRADIENTS = np.array([
    49.06451538, 151.83105912, 26.40235659, -8.25135661,
    75.29759338, 352.56545247, 90.07046995, 30.12301652,
])
ROOTED_TOL = {"ll": (0.0, 1e-4), "grad": (0.0, 1e-4), "gtr": (0.0, 1e-3),
              "shape": (0.0, 1e-3), "clock": (1e-3, 0.0)}
# The hand route against the autograd route in f32 (the JAX package's
# tests/test_pallas.py:496-499).
ROUTES_F32_TOL = (1e-3, 0.1)
B_ROOTED = 256  # the JAX bench's flua_rooted_gradients
GP_TWIN_TOL = {
    torch.float64: {"plv": (1e-12, 1e-300), "ls": (1e-12, 1e-12),
                    "obj": 1e-12, "lb": 1e-6},
    torch.float32: {"plv": (1e-5, 1e-6), "ls": (1e-5, 1e-4),
                    "obj": 1e-5, "lb": None},
}


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
               r"(?:ll_grad|ll|dea|dp)(?:_slab)?_kernel|"
               r"gp_(?:populate|golden_sweep)(?:_slab)?_kernel)I([fd])(?:Li(\d+)E)?")
    for source, info in _kernels.build_info.items():
        print(f"  {source}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        name = None
        for line in info["log"].splitlines():
            m = re.search(pattern, line)
            if m:
                dt = "float" if m.group(2) == "f" else "double"
                k = f", K={m.group(3)}" if m.group(3) else ""
                name = f"{m.group(1)}<{dt}{k}>"
            elif name and "spill stores" in line:
                spills = line.strip()
            elif name and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"  ptxas {name}: {regs} registers; {spills}")
                name = None
    sass_mix("pruning_jc")
    sass_mix("pruning_generic", ("generic_dp_kernelIfLi4E", "generic_dp_slab_kernelIfLi4E",
                                 "generic_ll_grad_kernelIfLi4E",
                                 "generic_ll_grad_slab_kernelIfLi4E",
                                 "generic_ll_kernelIfLi4E", "generic_ll_slab_kernelIfLi4E"))
    sass_mix("gp_engine", ("gp_populate_kernelIfE", "gp_populate_slab_kernelIfE",
                           "gp_golden_sweep_kernelIfE", "gp_golden_sweep_slab_kernelIfE"))


def sass_mix(source, kernels=("jc69_ll_grad_kernelIfLi1E", "jc69_dea_kernelIfLi1E",
                              "jc69_ll_kernelIfLi1E", "jc69_ll_slab_kernelIfLi1E")):
    """The static SASS instruction mix of some kernel instances of a built
    source (cuobjdump from the CUDA toolkit): floating point, integer and
    address, memory, and control instructions; "not measured" when the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("  SASS mix: not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", _kernels.build_info[source]["path"]],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    classes = {"float": ("FADD", "FMUL", "FFMA", "MUFU", "FSETP", "FSEL",
                         "FMNMX", "DADD", "DMUL", "DFMA", "DSETP"),
               "memory": ("LDS", "STS", "LDG", "STG", "LDC", "LDL", "STL"),
               "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT",
                           "SHFL", "BAR", "WARPSYNC")}
    for name in kernels:
        counts, on = {"float": 0, "memory": 0, "control": 0, "integer": 0}, False
        for line in sass.splitlines():
            if "Function :" in line:
                on = name in line
            elif on and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                op = re.sub(r"^\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?", "",
                            line).split()[0].split(".")[0]
                kind = next((k for k, ops in classes.items() if op in ops),
                            "integer")
                counts[kind] += 1
        print(f"  SASS mix of {name}: {sum(counts.values())} instructions, "
              f"{counts}")


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


def kernel_inputs(d, dtype, K, shape=0.1):
    """(ea, rates, props) in ``dtype`` on the card: one rate category, or K
    Weibull categories at ``shape``."""
    if K == 1:
        rates = torch.ones(1, dtype=torch.float64, device=DEV)
        props = rates.clone()
    else:
        rates, props = weibull_rates(shape, K, device=DEV)
    rates, props = rates.to(dtype), props.to(dtype)
    ea = pruning_jc.exp_factors(d["bl"], rates, dtype)
    return ea, rates, props


def jc69_vs_twins(d, dtype, K, tag):
    """K1, K2 and K3 against their twins on d's inputs, at TWIN_TOL; checks
    that each took the route of its shared-memory plan (on chip, or the
    slab route) and returns {key: max abs error}."""
    tol = TWIN_TOL[dtype]
    r = d["root_id"]
    L, S = d["tips"].shape[0], d["pc"].shape[1]
    route = "onchip" if pruning_jc.onchip_plan(dtype, K, S, L) else "slab"
    if (pruning_jc.onchip_plan(dtype, K, S, L, "ll") is None) != (route == "slab"):
        raise AssertionError(f"K2's plan and K1's disagree at {dtype} K = {K}")
    ea, rates, props = kernel_inputs(d, dtype, K)
    args = (d["pc"], ea, rates, props, d["tips"], d["w"])
    args2 = (d["pc"], ea, props, d["tips"], d["w"])
    pruning_jc.reset_counters()
    k_ll, k_g = pruning_jc.ll_grad_jc69_cuda(*args, root_id=r)
    k_dea, k_dp = pruning_jc.ll_dea_jc69_cuda(*args2, root_id=r)
    torch.cuda.synchronize()
    sfx = "_slab" if route == "slab" else ""
    took = (pruning_jc.LAUNCHES[f"ll_grad_jc69{sfx}"],
            pruning_jc.LAUNCHES[f"ll_dea_jc69{sfx}"])
    if took != (1, 1):
        raise AssertionError(f"K1/K3 {tag}: not on the {route} route "
                             f"({pruning_jc.LAUNCHES})")
    print(f"  K1/K3 {tag}: {route} route")
    t_ll, t_g = pruning_jc.ll_grad_jc69_plain(*args, root_id=r)
    errs = {"ll_grad_jc69": max(
        close(f"K1 LL {tag}", k_ll.cpu(), t_ll.cpu(), tol["ll"]),
        close(f"K1 grad {tag}", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
              tol["grad"]))}
    del t_g
    pruning_jc.reset_counters()
    k2 = pruning_jc.ll_jc69_cuda(*args2, root_id=r)
    torch.cuda.synchronize()
    if pruning_jc.LAUNCHES[f"ll_jc69{sfx}"] != 1:
        raise AssertionError(f"K2 {tag}: not on the {route} route "
                             f"({pruning_jc.LAUNCHES})")
    t2 = pruning_jc.ll_jc69_plain(*args2, root_id=r)
    errs["ll_jc69"] = close(f"K2 LL {tag}, {route} route", k2.cpu(), t2.cpu(),
                            tol["ll"])
    if k_dea[:, r:].any():
        raise AssertionError("K3: root or ones-slot rows not zero")
    t_dea, t_dp = pruning_jc.ll_dea_jc69_plain(*args2, root_id=r)
    errs["ll_dea_jc69"] = max(
        close(f"K3 dea {tag}", k_dea.cpu(), t_dea.cpu(), tol["grad"]),
        close(f"K3 dprops {tag}", k_dp.cpu(), t_dp.cpu(), tol["grad"]))
    return errs


def phase_kernel_vs_twin():
    print(f"[3] kernel vs twin on the card, DS1 x {B} trees, K = {KS}")
    errs = {}
    for dtype in (torch.float32, torch.float64):
        d = load_ds1(dtype)
        for K in KS:
            tag = f"{str(dtype)[6:]} K={K}"
            e = jc69_vs_twins(d, dtype, K, tag)
            torch.cuda.empty_cache()
            if dtype == torch.float32 and K == 1:
                errs = e  # the timed case
    for dtype, K in ((torch.float64, 8), (torch.float32, 1)):
        d = synthetic_tree(dtype)
        if dtype == torch.float64 and pruning_jc.onchip_plan(
                dtype, K, d["pc"].shape[1], BIG_TAXA) is not None:
            raise AssertionError("the 256-taxon tree fits on chip at f64 "
                                 "K = 8: nothing exercises the slab route")
        tag = (f"{str(dtype)[6:]} K={K}, {BIG_TAXA} taxa x {d['pc'].shape[0]} "
               f"trees, {d['tips'].shape[2]} patterns")
        jc69_vs_twins(d, dtype, K, tag)
    return errs


def synthetic_tree(dtype, trees=8, patterns=300, seed=0):
    """BIG_TAXA-taxon unrooted trees, joins drawn from default_rng(seed), in
    the schedules' postorder-linear form, with random tip partials (most
    one-hot), pattern weights and branch lengths."""
    rng = np.random.default_rng(seed)
    L = BIG_TAXA
    S = L - 2
    ones = L + S  # N1 - 1
    pcs = []
    for _ in range(trees):
        pool, nxt, pc = list(range(L)), L, []
        while len(pool) > 3:
            i, j = sorted(rng.choice(len(pool), 2, replace=False))
            a, b = pool[i], pool[j]
            pool.pop(j)
            pool.pop(i)
            pc.append([a, b, ones])
            pool.append(nxt)
            nxt += 1
        pcs.append(pc + [pool])
    soft = rng.dirichlet(np.ones(4), size=(L, patterns)).transpose(0, 2, 1)
    hard = (soft == soft.max(axis=1, keepdims=True)).astype(np.float64)
    tips = np.where(rng.uniform(size=soft.shape) < 0.8, hard, soft)
    bl = np.pad(rng.uniform(0.01, 0.2, (trees, L + S - 1)), ((0, 0), (0, 2)))
    return {
        "pc": torch.as_tensor(np.array(pcs), dtype=torch.int32, device=DEV),
        "bl": torch.as_tensor(bl, device=DEV),
        "tips": torch.as_tensor(tips, device=DEV).to(dtype).contiguous(),
        "w": torch.as_tensor(rng.integers(1, 5, patterns), device=DEV).to(dtype),
        "root_id": L + S - 1,
    }


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
            pruning_generic.reset_counters()
            k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
            torch.cuda.synchronize()
            if pruning_generic.LAUNCHES["ll_grad_generic"] != 1:
                raise AssertionError(f"K4 {str(dtype)[6:]} GTR {site}: not on chip "
                                     f"({pruning_generic.LAUNCHES})")
            if k_g[:, r:].any():
                raise AssertionError("K4: root or ones-slot rows not zero")
            t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
            tag = f"{str(dtype)[6:]} GTR {site}"
            e4 = max(
                close(f"K4 LL {tag}", k_ll.cpu(), t_ll.cpu(), tol["ll"]),
                close(f"K4 grad {tag}", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
                      tol["grad"]),
            )
            e5, e6 = k5_k6_vs_twins(d, dtype, (P, freqs, props), tag)
            if dtype == torch.float32 and site == "weibull+4":
                # the timed case's model
                errs = {"ll_grad_generic": e4, "ll_generic": e5,
                        "ll_dp_generic": e6}
    k6_slab_vs_twin()
    k4_slab_vs_twin()
    k5_slab_vs_twin()
    return errs


def k5_k6_vs_twins(d, dtype, model, tag):
    """K5 and K6 on chip against their twins on d's inputs and ``model`` =
    (P, freqs, props) from generic_inputs, at TWIN_TOL; returns their max
    abs errors."""
    tol = TWIN_TOL[dtype]
    r = d["root_id"]
    P, freqs, props = model
    args = (d["pc"], P, d["tips"], freqs, props, d["w"])
    pruning_vjp.reset_counters()
    k5 = pruning_vjp.ll_generic_cuda(*args, root_id=r)
    torch.cuda.synchronize()
    if pruning_vjp.LAUNCHES["ll_generic"] != 1:
        raise AssertionError(f"K5 {tag}: not on chip ({pruning_vjp.LAUNCHES})")
    t5 = pruning_vjp.ll_generic_plain(*args, root_id=r)
    pruning_vjp.reset_counters()
    k6 = pruning_vjp.ll_dp_generic_cuda(*args, root_id=r)
    torch.cuda.synchronize()
    if pruning_vjp.LAUNCHES["ll_dp_generic"] != 1:
        raise AssertionError(f"K6 {tag}: not on chip ({pruning_vjp.LAUNCHES})")
    t6 = pruning_vjp.ll_dp_generic_plain(*args, root_id=r)
    W = pruning_vjp.ll_onchip_plan(dtype, props.shape[0], d["pc"].shape[1],
                                   d["tips"].shape[0])[0]
    e5 = close(f"K5 LL {tag}, on chip, {W} warps a block", k5.cpu(),
               t5.cpu(), tol["ll"])
    if k6[0][:, r:].any():
        raise AssertionError("K6: root or ones-slot rows not zero")
    e6 = max(
        close(f"K6 {name} {tag}", k.cpu(), t.cpu(), tol["grad"])
        for name, k, t in zip(("dP", "dfreqs", "dprops"), k6, t6)
    )
    return e5, e6


def k5_slab_vs_twin():
    """K5 on the 256-taxon tree, GTR + Weibull+4 at float32 and GTR +
    constant at float64, shapes its on-chip plan refuses: the slab route,
    against the twin at TWIN_TOL."""
    for dtype, site in ((torch.float32, "weibull+4"), (torch.float64, "constant")):
        d = synthetic_tree(dtype)
        r = d["root_id"]
        P, _, freqs, props = generic_inputs(d, dtype, site)
        L, S, K = BIG_TAXA, d["pc"].shape[1], props.shape[0]
        if pruning_vjp.ll_onchip_plan(dtype, K, S, L) is not None:
            raise AssertionError(f"K5 fits on chip at {BIG_TAXA} taxa, {dtype} "
                                 f"K = {K}: nothing exercises its slab route")
        args = (d["pc"], P, d["tips"], freqs, props, d["w"])
        pruning_vjp.reset_counters()
        k5 = pruning_vjp.ll_generic_cuda(*args, root_id=r)
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} GTR {site}, {BIG_TAXA} taxa"
        if pruning_vjp.LAUNCHES != {"ll_generic": 0, "ll_generic_slab": 1,
                                    "ll_dp_generic": 0, "ll_dp_generic_slab": 0}:
            raise AssertionError(f"K5 {tag}: not on the slab route "
                                 f"({pruning_vjp.LAUNCHES})")
        t5 = pruning_vjp.ll_generic_plain(*args, root_id=r)
        close(f"K5 LL {tag}, slab route", k5.cpu(), t5.cpu(), TWIN_TOL[dtype]["ll"])


def k4_slab_vs_twin():
    """K4 on the 256-taxon tree, GTR + Weibull+4 at float32 and GTR +
    constant at float64, shapes its on-chip plan refuses: the slab route,
    against the twin at TWIN_TOL."""
    for dtype, site in ((torch.float32, "weibull+4"), (torch.float64, "constant")):
        d = synthetic_tree(dtype)
        r = d["root_id"]
        P, Qs, freqs, props = generic_inputs(d, dtype, site)
        L, S, K = BIG_TAXA, d["pc"].shape[1], props.shape[0]
        if pruning_generic.ll_grad_onchip_plan(dtype, K, S, L) is not None:
            raise AssertionError(f"K4 fits on chip at {BIG_TAXA} taxa, {dtype} "
                                 f"K = {K}: nothing exercises its slab route")
        args = (d["pc"], P, Qs, d["tips"], freqs, props, d["w"])
        pruning_generic.reset_counters()
        k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} GTR {site}, {BIG_TAXA} taxa"
        if pruning_generic.LAUNCHES != {"ll_grad_generic": 0,
                                        "ll_grad_generic_slab": 1}:
            raise AssertionError(f"K4 {tag}: not on the slab route "
                                 f"({pruning_generic.LAUNCHES})")
        t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
        close(f"K4 LL {tag}, slab route", k_ll.cpu(), t_ll.cpu(),
              TWIN_TOL[dtype]["ll"])
        close(f"K4 grad {tag}, slab route", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
              TWIN_TOL[dtype]["grad"])


def k6_slab_vs_twin():
    """K6 on the 256-taxon tree, GTR + Weibull+4 at float32 and GTR +
    constant at float64, shapes its on-chip plan refuses: the slab route,
    against the twin at TWIN_TOL."""
    for dtype, site in ((torch.float32, "weibull+4"), (torch.float64, "constant")):
        d = synthetic_tree(dtype)
        r = d["root_id"]
        P, _, freqs, props = generic_inputs(d, dtype, site)
        L, S, K = BIG_TAXA, d["pc"].shape[1], props.shape[0]
        if pruning_vjp.dp_onchip_plan(dtype, K, S, L) is not None:
            raise AssertionError(f"K6 fits on chip at {BIG_TAXA} taxa, {dtype} "
                                 f"K = {K}: nothing exercises its slab route")
        args = (d["pc"], P, d["tips"], freqs, props, d["w"])
        pruning_vjp.reset_counters()
        k6 = pruning_vjp.ll_dp_generic_cuda(*args, root_id=r)
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} GTR {site}, {BIG_TAXA} taxa"
        if pruning_vjp.LAUNCHES != {"ll_generic": 0, "ll_generic_slab": 0,
                                    "ll_dp_generic": 0, "ll_dp_generic_slab": 1}:
            raise AssertionError(f"K6 {tag}: not on the slab route "
                                 f"({pruning_vjp.LAUNCHES})")
        t6 = pruning_vjp.ll_dp_generic_plain(*args, root_id=r)
        for name, k, t in zip(("dP", "dfreqs", "dprops"), k6, t6):
            close(f"K6 {name} {tag}, slab route", k.cpu(), t.cpu(),
                  TWIN_TOL[dtype]["grad"])


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


def launch_counts(path, needed, avoided=()):
    """Read every module's counters after a path's run; fail unless every
    kernel in ``needed`` launched, none in ``avoided`` (slab routes) did
    and no twin ran."""
    torch.cuda.synchronize()
    launches = {k: v for m in COUNTED for k, v in m.LAUNCHES.items()}
    twins = {k: v for m in COUNTED for k, v in m.TWIN_CALLS.items()}
    print(f"  {path}: kernel launches {launches}, twin calls {twins}")
    if (min(launches[k] for k in needed) < 1 or max(twins.values()) != 0
            or any(launches[k] for k in avoided)):
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
        "GTR path", ["ll_grad_generic", "ll_generic", "ll_dp_generic"],
        ["ll_grad_generic_slab", "ll_generic_slab", "ll_dp_generic_slab"])
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


def host_and_device(fn, calls):
    """(line, peak GiB) for an entry point called from the host: the median
    and least host-clock ms of ``calls`` synchronised calls after two
    warm-ups, with the peak device memory over them; then, over ``calls``
    more under torch.profiler, the device ms per call summed over the
    device's kernels and copies, and their number per call. The device's
    idle share is 1 - device ms / the unprofiled median, since the profiler
    slows the host; "not measured" when the profiler records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total if hasattr(e, "self_device_time_total")
             else e.self_cuda_time_total for e in kernels)
    count = sum(e.count for e in kernels) / calls
    dev_ms = us / 1e3 / calls
    device = (f"device time {dev_ms:.3f} ms per call in {count:.0f} kernels "
              f"and copies, the device idle {1 - dev_ms / med:.1%} of the "
              "median" if us > 0 else "device time not measured")
    return (f"median {med:.3f} ms (min {min(times):.3f}, {calls} calls, host "
            f"clock, synchronised); {device} (torch.profiler, {calls} more "
            "calls)"), peak


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


def tensors(*items):
    """The tensors in items, nested in tuples, lists and dicts."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            yield from tensors(*x.values())
        elif isinstance(x, (tuple, list)):
            yield from tensors(*x)


def nbytes(*items):
    """Bytes of the tensors in items, each counted once."""
    return sum(x.numel() * x.element_size() for x in tensors(*items))


def bound(ops, inputs, outputs):
    """(ms, "operations" or "bytes"): the least time of the work on this
    card, the larger of its operations at the peak of the type it computes
    in (float64's when an output is float64, else float32's) and its inputs
    read once and outputs written once at the HBM rate."""
    f64 = any(x.dtype == torch.float64 for x in tensors(outputs))
    t_ops = ops / (PEAK_F64 if f64 else PEAK_F32) * 1e3
    t_bytes = nbytes(inputs, outputs) / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def jc69_ops(kind, B, L, S, K, P):
    """Operations of K2 ("ll"), K1 ("ll_grad") or K3 ("dea") on these
    shapes, counted from csrc/pruning_jc.cu: one per add, multiply,
    divide, log or compare, and one add per value of a cross-pattern sum."""
    scaled = sum(1 for s in range(S) if s % 2 or s == S - 1)
    forward = (L * (3 + 11 * K) + S * 22 * K + scaled * (6 * K + 3)
               + 2 * K + 4)
    if kind == "ll":
        return B * P * forward
    edges, inner = L + S - 1, S - 1  # real edges; internal kids (U stored)
    step = 11 * K + (3 * K if K > 1 else 0) + 16 * K + 1
    per_edge = 18 * K + 3 if kind == "ll_grad" else 29 * K + 1
    upper = S * step + edges * per_edge + inner * 4 * K
    return B * P * (forward + upper)


def generic_ops(kind, B, L, S, K, P):
    """Operations of K5 ("ll"), K4 ("ll_grad") or K6 ("dp") on these
    shapes, counted from csrc/pruning_generic.cu as jc69_ops counts: each
    4x4 apply 28, each max-rescale 8K + 2, each edge's upper partial,
    denominator, Q E or dP contraction and U rescale."""
    forward = L * 28 * K + S * (44 * K + 2) + 12 * K + 4
    if kind == "ll":
        return B * P * forward
    edges, inner = L + S - 1, S - 1
    per_edge = 52 * K + 3 if kind == "ll_grad" else 52 * K + 2
    upper = S * 28 * K + edges * per_edge + inner * 8 * K
    if kind == "dp":
        upper += 17 * K + 4  # d ll / d freqs and d ll / d props at the root
    return B * P * (forward + upper)


def populate_ops(streams, S):
    """Operations of K7 over S patterns, counted from csrc/gp_engine.cu:
    each stream step's 4x4 apply (28), q scale (4) and max-aligned
    accumulate (17), each finishing step's product, max and normalisation
    (14), each root seed (4)."""
    rw = streams.rootward.cpu().numpy()
    lw = streams.leafward.cpu().numpy()
    finish = int(rw[:, 3].sum() + lw[:, 3].sum())
    return S * (49 * (len(rw) + len(lw)) + 14 * finish
                + 4 * len(streams.roots))


def sweep_ops(E, S):
    """Operations of K8: per edge 2 GOLDEN_ITERS + 3 objective evaluations,
    each 5 per pattern (multiply, add, log, weight, sum)."""
    return E * (2 * engine_kernels.GOLDEN_ITERS + 3) * S * 5


def onchip_smem_ms(pc, L, K, P, itemsize, upper=True):
    """The on-chip K1/K3's (upper) or K2's (not upper) shared-memory
    traffic on this schedule, at the card's aggregate shared-memory rate:
    per pattern, each forward step's three child rows read (4K values for
    an internal node; a leaf's tip comes from device memory, the ones slot
    is a constant) and its row written, and each upper step's U read, three
    kid rows read, and for every internal kid its three children's rows
    read and its U written. Returns (GB, ms)."""
    pc = pc.cpu().numpy()
    S = pc.shape[1]
    ones = L + S

    def row(c):
        return 4 * K if L <= c < ones else 0

    values = 0
    for tree in pc:
        for s, kids in enumerate(tree):
            last = s == S - 1
            values += sum(row(c) for c in kids) + (0 if last else 4 * K)
            if not upper:
                continue
            values += sum(row(c) for c in kids) + (0 if last else 4 * K)
            for c in kids:
                if L <= c < ones:
                    values += sum(row(g) for g in tree[c - L]) + 4 * K
    gb = values * P * itemsize / 1e9
    return gb, gb * 1e9 / SMEM_RATE * 1e3


def call_memory(fn):
    """Device memory one call adds: the peak during it less what was
    allocated before it, in MB."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def phase_timing(smi):
    """K1, K2 and K3 against their twins at B = 512, f32, K = 1; each on
    chip against its slab route (the first design) on the same inputs at
    K = 1 and Weibull+4, in turns; bounds, shares of bound, device memory
    per call; the K2 + K3 autograd pass, engine.branch_gradients and
    engine.log_likelihoods. Returns ({key: (ms, twin ms)}, {key: (bound ms,
    bound_by)}) at K = 1."""
    print(f"[6] timing at B = {B}, float32, DS1 ({smi})")
    d = load_ds1(torch.float32)
    r = d["root_id"]
    L, _, P = d["tips"].shape
    S = d["pc"].shape[1]
    lib = _kernels.load("pruning_jc")
    out, bounds = {}, {}
    for K in (1, 4):
        ea, rates, props = kernel_inputs(d, torch.float32, K)
        a1 = (d["pc"], ea, rates, props, d["tips"], d["w"])
        a2 = (d["pc"], ea, props, d["tips"], d["w"])
        dims = (B, L, S, r + 2, K, P)
        kern = {
            "ll_grad_jc69": lambda: pruning_jc.ll_grad_jc69_cuda(*a1, root_id=r),
            "ll_jc69": lambda: pruning_jc.ll_jc69_cuda(*a2, root_id=r),
            "ll_dea_jc69": lambda: pruning_jc.ll_dea_jc69_cuda(*a2, root_id=r),
        }
        if K == 1:
            plain = {
                "ll_grad_jc69": lambda: pruning_jc.ll_grad_jc69_plain(*a1, root_id=r),
                "ll_jc69": lambda: pruning_jc.ll_jc69_plain(*a2, root_id=r),
                "ll_dea_jc69": lambda: pruning_jc.ll_dea_jc69_plain(*a2, root_id=r),
            }
            out = time_pairs({k: (kern[k], plain[k]) for k in kern}, B)
        slab = {
            "ll_grad_jc69": lambda: pruning_jc._ll_grad_jc69_slab(lib, dims, *a1),
            "ll_jc69": lambda: pruning_jc._ll_jc69_slab(lib, dims, *a2),
            "ll_dea_jc69": lambda: pruning_jc._ll_dea_jc69_slab(lib, dims, *a2),
        }
        site = "one category" if K == 1 else f"Weibull+{K}"
        for key, ops_kind, inputs in (("ll_grad_jc69", "ll_grad", a1),
                                      ("ll_jc69", "ll", a2),
                                      ("ll_dea_jc69", "dea", a2)):
            smem_gb, smem_ms = onchip_smem_ms(d["pc"], L, K, P, 4,
                                              upper=key != "ll_jc69")
            b_ms, b_by = bound(jc69_ops(ops_kind, B, L, S, K, P), inputs,
                               kern[key]())
            if K == 1:
                bounds[key] = (b_ms, b_by)
            s1, k1, k2, s2 = (time_ms(slab[key]), time_ms(kern[key]),
                              time_ms(kern[key]), time_ms(slab[key]))
            ms, slab_ms = min(k1, k2), min(s1, s2)
            mem, slab_mem = call_memory(kern[key]), call_memory(slab[key])
            if mem >= 50:
                raise AssertionError(f"{key}, {site}: one on-chip call adds "
                                     f"{mem:.1f} MB (>= 50 MB)")
            print(f"  {key}, {site}: on chip {k1:.4f} / {k2:.4f} ms, slab "
                  f"route (first design) {s1:.4f} / {s2:.4f} ms, "
                  f"{slab_ms / ms:.2f}x; bound {b_ms:.4f} ms ({b_by}), on "
                  f"chip {b_ms / ms:.1%} of it; shared-memory traffic "
                  f"{smem_gb:.2f} GB, {smem_ms:.4f} ms at "
                  f"{SMEM_RATE / 1e12:.1f} TB/s, {smem_ms / ms:.1%} of it; "
                  f"one call adds {mem:.2f} MB on chip, {slab_mem:.1f} MB "
                  f"slab")
    # The differentiable LL: K2 forward + K3 backward through autograd.
    bl = d["bl"].detach().clone().requires_grad_(True)

    def ll_and_grad():
        ll = pruning_jc.log_likelihoods_jc69(d["pc"], bl, d["tips"], d["w"],
                                             root_id=r)
        return torch.autograd.grad(ll.sum(), bl)

    print(f"  log_likelihoods_jc69 + autograd (K2 + K3): "
          f"{time_ms(ll_and_grad, reps=5, inner=5):.4f} ms")
    engine_calls(smi)
    return out, bounds


def engine_calls(smi, calls=10):
    """engine.branch_gradients (K1) and engine.log_likelihoods (K2) from
    host arrays on the headline workload: DS1.subsampled_10 tiled to B
    trees, perturbed lengths, f32."""
    tops, bls, ttm = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    reps = B // len(tops) + 1
    sched = schedule.schedules_of_topologies((tops * reps)[:B])
    bl = np.tile(np.stack(bls), (reps, 1))[:B]
    bl = bl * np.random.default_rng(0).uniform(0.8, 1.2, bl.shape)
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    engine = LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV)
    params = default_parameters(spec, device=DEV)
    for name, fn in (("branch_gradients", engine.branch_gradients),
                     ("log_likelihoods", engine.log_likelihoods)):
        for _ in range(3):
            fn(sched, bl, params)
        torch.cuda.synchronize()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn(sched, bl, params)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"  engine.{name} from host arrays, B = {B}: median "
              f"{statistics.median(times):.3f} ms (min {min(times):.3f}, "
              f"{calls} calls, host clock, synchronised; {smi})")


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
    L, _, npat = d["tips"].shape
    S, K = d["pc"].shape[1], props.shape[0]
    bounds = {}
    for key, kind, inputs in (("ll_grad_generic", "ll_grad", a4),
                              ("ll_generic", "ll", a5),
                              ("ll_dp_generic", "dp", a5)):
        bounds[key] = bound(generic_ops(kind, B_GTR, L, S, K, npat), inputs,
                            calls4[key][0]())
        print(f"  {key}: bound {bounds[key][0]:.4f} ms ({bounds[key][1]}), "
              f"{bounds[key][0] / out[key][0]:.1%} of it")
    k4_onchip_vs_slab(d, a4, bounds["ll_grad_generic"][0])
    k5_onchip_vs_slab(d, a5, bounds["ll_generic"][0])
    k6_onchip_vs_slab(d, a5, bounds["ll_dp_generic"][0])

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
        line, peak = host_and_device(
            lambda fn=fn: fn(d["sched"], d["bl_host"], params), calls)
        print(f"  engine.{name} from host arrays: {line}; peak {peak:.2f} GiB")
    return out, bounds


def onchip_vs_slab(key, kern, slab, b_ms, limit_mb, what):
    """A kernel on chip against its slab route (the first design) on the
    same inputs, in turns slab, chip, chip, slab, with the device memory
    one call adds; fails if an on-chip call adds ``limit_mb`` or more."""
    s1, k1, k2, s2 = time_ms(slab), time_ms(kern), time_ms(kern), time_ms(slab)
    ms, slab_ms = min(k1, k2), min(s1, s2)
    mem, slab_mem = call_memory(kern), call_memory(slab)
    if mem >= limit_mb:
        raise AssertionError(f"{key}: one on-chip call adds {mem:.1f} MB "
                             f"(>= {limit_mb} MB)")
    print(f"  {key}, {what}: on chip {k1:.4f} / {k2:.4f} ms, slab route "
          f"(first design) {s1:.4f} / {s2:.4f} ms, {slab_ms / ms:.2f}x; bound "
          f"{b_ms:.5f} ms, on chip {b_ms / ms:.2%} of it, slab "
          f"{b_ms / slab_ms:.2%}; one call adds {mem:.2f} MB on chip, "
          f"{slab_mem:.2f} MB slab")


def k4_onchip_vs_slab(d, a4, b_ms):
    """K4 on chip against its slab route on config 2's inputs a4."""
    r = d["root_id"]
    pc, P, Qs, tips, freqs, props, w = a4
    K = props.shape[0]
    dims = (pc.shape[0], tips.shape[0], pc.shape[1], r + 2, K, tips.shape[2])
    lib = pruning_generic.load_checked(K)
    onchip_vs_slab(
        "ll_grad_generic",
        lambda: pruning_generic.ll_grad_generic_cuda(*a4, root_id=r),
        lambda: pruning_generic._ll_grad_generic_slab(lib, dims, *a4),
        b_ms, 50, f"Weibull+{K}")


def k5_onchip_vs_slab(d, a5, b_ms):
    """K5 on chip against its slab route (the first design) on config 2's
    inputs a5; fails if an on-chip call adds 50 MB or more."""
    r = d["root_id"]
    pc, P, tips, freqs, props, w = a5
    L, S, K = tips.shape[0], pc.shape[1], props.shape[0]
    dims = (pc.shape[0], L, S, r + 2, K, tips.shape[2])
    lib = pruning_vjp.load_checked(K)
    W = pruning_vjp.ll_onchip_plan(P.dtype, K, S, L)[0]
    onchip_vs_slab(
        "ll_generic",
        lambda: pruning_vjp.ll_generic_cuda(*a5, root_id=r),
        lambda: pruning_vjp._ll_generic_slab(lib, dims, *a5, 0, 0),
        b_ms, 50, f"Weibull+{K}, {W} warps a block")
    # Warps a block sharing one staged copy of the tree's matrices.
    itemsize = P.element_size()
    by_warps = {n: (lambda n=n: pruning_vjp._ll_generic_onchip(
        lib, dims, *a5, 0, 0, (n, pruning_vjp.ll_onchip_bytes(itemsize, K, S, L, n))))
        for n in (1, 2, 4, 8)}
    print("  ll_generic on chip by warps a block (blocks a tree, warps an SM): "
          + warps_in_turns(by_warps, lambda n: (
              pruning_vjp.ll_chunks(tips.shape[2], K, n),
              pruning_vjp.sm_warps(n, pruning_vjp.ll_onchip_bytes(itemsize, K, S, L, n)))))


def warps_in_turns(runs, note):
    """Time {warps: call} in turns, most warps first, then back; returns a
    line of each count's better time and ``note(count)``."""
    order = sorted(runs, reverse=True)
    first = {n: time_ms(runs[n]) for n in order}
    second = {n: time_ms(runs[n]) for n in reversed(order)}
    return "; ".join(f"{n}: {min(first[n], second[n]):.4f} ms {note(n)}"
                     for n in order)


def k6_onchip_vs_slab(d, a5, b_ms):
    """K6 on chip against its slab route (the first design) on config 2's
    inputs a5, in turns slab, chip, chip, slab, with the device memory one
    call adds; fails if an on-chip call adds 128 MB or more."""
    r = d["root_id"]
    pc, P, tips, freqs, props, w = a5
    L, S, K = tips.shape[0], pc.shape[1], props.shape[0]
    dims = (pc.shape[0], L, S, r + 2, K, tips.shape[2])
    lib = pruning_vjp.load_checked(K)
    onchip_vs_slab(
        "ll_dp_generic",
        lambda: pruning_vjp.ll_dp_generic_cuda(*a5, root_id=r),
        lambda: pruning_vjp._ll_dp_generic_slab(
            lib, dims, pc, P, tips, (freqs, 0), (props, 0), w),
        b_ms, 128, f"Weibull+{K}")


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


def gp_instance(fasta, newick_file, dtype, use_kernels="auto"):
    """GPInstance on the card; "auto" is the kernel route there."""
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{newick_file}")
    inst.make_engine(dtype=dtype, device=DEV, use_kernels=use_kernels)
    return inst


def gp_kernel_inputs(eng, seed=0):
    """K7's inputs on the card at seeded U(0.01, 0.3) branch lengths and
    the uniform prior: (streams, q, P, tips, bl)."""
    bl = np.random.default_rng(seed).uniform(0.01, 0.3, eng.branch_lengths.size)
    blt = eng._tensor(bl)
    return (eng._edge_streams(), eng._tensor(eng.q),
            _jc69_transition(blt).contiguous(), eng._tips, blt)


def phase_gp_vs_twin():
    """K7 and K8 against their twins on the card, hello and fluA, float32
    and float64; returns the errors of the timed case (fluA, float32): K7's
    largest PLV error and K8's largest objective gap in nats."""
    print("[7] GP kernels vs twins on the card, hello and fluA")
    errs = {}
    for fasta, nwk in (("hello.fasta", "hello_rooted.nwk"),
                       ("fluA.fa", "fluA.tree")):
        for dtype in (torch.float32, torch.float64):
            tag = f"{fasta.split('.')[0]} {str(dtype)[6:]}"
            eng = gp_instance(fasta, nwk, dtype).get_engine()
            streams, q, P, tips, bl = gp_kernel_inputs(eng)
            got, e7 = k7_vs_twin(streams, q, P, tips, dtype, tag, "populate_plvs")
            A, B = engine_kernels.sweep_stats(got, eng._pa, eng._ch, eng._rot)
            A, B = A.contiguous(), B.contiguous()
            cur = torch.log(bl[eng._g]).contiguous()
            e8 = k8_vs_twin(A, B, eng._w, cur, dtype, tag)
            if fasta == "fluA.fa" and dtype == torch.float32:
                errs = {"populate_plvs": e7, "golden_sweep": e8}
    for dtype in (torch.float32, torch.float64):
        eng = synthetic_gp_engine(dtype)
        streams, q, P, tips, _ = gp_kernel_inputs(eng)
        k7_vs_twin(streams, q, P, tips, dtype,
                   f"{GP_BIG_TAXA} taxa {str(dtype)[6:]}, slab route",
                   "populate_plvs_slab")
    k8_beyond_the_plan()
    return errs


def k8_vs_twin(A, B, w, cur, dtype, tag):
    """K8's main design (a block per edge over staged rows) and its slab
    route (the first design) against the twin by sweep_disagreement at
    GP_TWIN_TOL, each route read from the counters, the main design twice
    with the same bits; returns the main design's largest objective gap in
    nats."""
    want = engine_kernels.golden_sweep_twin(A, B, w, cur)
    gaps = {}
    for route, call, n in (
            ("golden_sweep", lambda: engine_kernels.golden_sweep_cuda(A, B, w, cur), 2),
            ("golden_sweep_slab",
             lambda: engine_kernels._golden_sweep_launch(A, B, w, cur, None), 1)):
        engine_kernels.reset_counters()
        runs = [call() for _ in range(n)]
        torch.cuda.synchronize()
        if (engine_kernels.LAUNCHES[route] != n
                or sum(engine_kernels.LAUNCHES.values()) != n):
            raise AssertionError(f"K8 {tag}: not on the {route} route "
                                 f"({engine_kernels.LAUNCHES})")
        got = runs[0]
        if not all(torch.equal(got, x) for x in runs[1:]):
            raise AssertionError(f"K8 {tag}: two launches differ")
        gaps[route] = sweep_vs_twin(A, B, w, got, want, dtype,
                                    f"K8 {tag} ({route}"
                                    + (", bit-identical twice)" if n > 1 else ")"))
    return gaps["golden_sweep"]


def sweep_vs_twin(A, B, w, got, want, dtype, tag):
    """Fail unless sweep_disagreement holds ``got`` to ``want`` at
    GP_TWIN_TOL; returns the largest objective gap in nats."""
    tol = GP_TWIN_TOL[dtype]
    obj_gap, lb_gap, gap = engine_kernels.sweep_disagreement(A, B, w, got, want)
    ok = obj_gap <= tol["obj"] and (tol["lb"] is None or lb_gap <= tol["lb"])
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: objective gap {obj_gap:.3e}, "
                             f"log-length gap {lb_gap:.3e}")
    print(f"  ok  {tag}: objective gap {gap:.3e} nats, {obj_gap:.3e} of "
          f"|f| + sum(w) (<= {tol['obj']}); log-length gap on edges that are "
          f"not flat {lb_gap:.3e} (<= {tol['lb']})")
    return gap


def k8_beyond_the_plan(edges=4, seed=0):
    """K8 on seeded rows (A, B > 0) one pattern longer than its plan holds,
    float32 and float64: the slab route, against the twin."""
    rng = np.random.default_rng(seed)
    for dtype in (torch.float32, torch.float64):
        S = next(n for n in range(8_000, 40_000)
                 if engine_kernels.golden_sweep_plan(dtype, n) is None)
        A, B = (torch.as_tensor(rng.uniform(0.01, 1.0, (edges, S)), device=DEV)
                .to(dtype) for _ in range(2))
        w = torch.as_tensor(rng.integers(1, 5, S), device=DEV).to(dtype)
        cur = torch.as_tensor(np.log(rng.uniform(0.01, 0.3, edges)),
                              device=DEV).to(dtype)
        engine_kernels.reset_counters()
        got = engine_kernels.golden_sweep_cuda(A, B, w, cur)
        torch.cuda.synchronize()
        if engine_kernels.LAUNCHES["golden_sweep_slab"] != 1:
            raise AssertionError(f"K8 at {S} patterns: not on the slab route "
                                 f"({engine_kernels.LAUNCHES})")
        sweep_vs_twin(A, B, w, got, engine_kernels.golden_sweep_twin(A, B, w, cur),
                      dtype, f"K8 {edges} seeded edges x {S} patterns "
                      f"{str(dtype)[6:]} (golden_sweep_slab)")


def k7_vs_twin(streams, q, P, tips, dtype, tag, route):
    """K7 against its twin at GP_TWIN_TOL, failing unless it took ``route``
    (the counter it bumps: "populate_plvs" on chip or "populate_plvs_slab");
    returns the kernel's PLV dict and its largest PLV error."""
    tol = GP_TWIN_TOL[dtype]
    engine_kernels.reset_counters()
    got = engine_kernels.populate_plvs_cuda(streams, q, P, tips)
    torch.cuda.synchronize()
    if engine_kernels.LAUNCHES[route] != 1 or sum(engine_kernels.LAUNCHES.values()) != 1:
        raise AssertionError(f"K7 {tag}: not on the {route} route "
                             f"({engine_kernels.LAUNCHES})")
    want = engine_kernels.populate_plvs_twin(streams, q, P, tips)
    errs = {}
    for k in engine_kernels.PLV_KEYS:
        kind = "ls" if k.startswith("ls_") else "plv"
        a, b = got[k].double().cpu().numpy(), want[k].double().cpu().numpy()
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            raise AssertionError(f"K7 {k} {tag}: shape / non-finite")
        np.testing.assert_allclose(a, b, *tol[kind], err_msg=f"K7 {k} {tag}")
        errs[kind] = max(errs.get(kind, 0.0), float(np.max(np.abs(a - b))))
    print(f"  ok  K7 {tag} ({route}), 12 arrays: max abs err {errs['plv']:.3e} "
          f"on the PLVs (rtol, atol {tol['plv']}), {errs['ls']:.3e} on the "
          f"log-scales ({tol['ls']})")
    return got, errs["plv"]


def synthetic_gp_engine(dtype, taxa=GP_BIG_TAXA, sites=200, seed=0):
    """A GP engine on the card over one rooted tree of ``taxa`` leaves
    (random joins and branch lengths from default_rng(seed)) and a random
    alignment of ``sites`` columns: 2 taxa - 1 DAG nodes, beyond K7's
    on-chip plan at 600 taxa in float32 and float64."""
    rng = np.random.default_rng(seed)
    pool = [f"t{i}" for i in range(taxa)]
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        a, b = pool.pop(j), pool.pop(i)
        la, lb = rng.uniform(0.01, 0.2, 2)
        pool.append(f"({b}:{la:.4f},{a}:{lb:.4f})")
    tops, bls, ttm = newick.parse_newick_string(pool[0] + ";")
    inst = GPInstance()
    inst.alignment = Alignment({f"t{i}": "".join(row) for i, row in enumerate(
        rng.choice(list("ACGT"), size=(taxa, sites)))})
    inst.tree_collection = RootedTreeCollection(
        [RootedTree(t, bl) for t, bl in zip(tops, bls)], ttm)
    inst.make_engine(dtype=dtype, device=DEV)
    eng = inst.get_engine()
    st = eng._edge_streams()
    if engine_kernels.populate_onchip_plan(
            dtype, st.node_count, eng.dag.gpcsp_count_with_fake(),
            st.rootward.shape[0], st.leafward.shape[0], st.roots.shape[0]) is not None:
        raise AssertionError(f"K7 fits on chip at {taxa} taxa, {dtype}: "
                             "nothing exercises its slab route")
    return eng


def gp_fit(dtype, use_kernels, tol=1e-6, max_iter=100):
    inst = gp_instance("fluA.fa", "fluA.tree", dtype, use_kernels)
    eng = inst.get_engine()
    t0 = time.perf_counter()
    marginal, sweeps = eng.run_branch_ascent(tol, max_iter)
    seconds = time.perf_counter() - t0
    route = "kernel" if use_kernels else "level"
    if not eng.last_ascent_converged:
        raise AssertionError(f"fluA {route} route did not converge")
    close(f"fluA fit run_branch_ascent({tol}, {max_iter}), {route} route, "
          f"{str(dtype)[6:]} ({sweeps} sweeps, {seconds:.2f} s)", marginal,
          GP_FLUA, (0.0, GP_FLUA_TOL[dtype]))
    return marginal


def phase_gp_path():
    """GPInstance on the card: the goldens and the fluA fit on the kernel
    route, f64 and f32, and the level route's f64 fit as the on-card
    oracle; returns the launch counts of the kernel-route runs."""
    print("[8] GP path: GPInstance.make_engine(device='cuda') vs the "
          "reference's goldens and libsbn_tpu's fluA optimum")
    reset_counters()
    inst = gp_instance("hello.fasta", "hello_rooted.nwk", torch.float64)
    eng = inst.get_engine()
    if not eng.use_kernels or eng.device.type != torch.device(DEV).type:
        raise AssertionError("make_engine(device='cuda') is not on the "
                             "kernel route")
    eng.branch_lengths = np.array(GP_HELLO_BL)
    inst.populate_plvs()
    inst.compute_likelihoods()
    close("GP hello per-GPCSP LLs, kernel route, f64",
          eng.get_per_gpcsp_log_likelihoods(), np.full(5, GP_HELLO),
          (0.0, 1e-6))
    close("GP hello marginal, kernel route, f64",
          eng.get_log_marginal_likelihood(), GP_HELLO, (0.0, 1e-6))
    inst = gp_instance("hello_single_nucleotide.fasta", "hello_rooted.nwk",
                       torch.float64)
    inst.get_engine().branch_lengths = np.array(GP_HELLO_BL)
    inst.populate_plvs()
    close("GP gradient golden (LL, dLL/db), kernel route, f64",
          inst.get_engine().log_likelihood_and_derivative(
              inst.dag.node_count() - 1, 0), GP_GRADIENT, (0.0, 1e-6))
    gp_fit(torch.float64, use_kernels=True)
    gp_fit(torch.float32, use_kernels=True)
    launches = launch_counts("GP path", ["populate_plvs", "golden_sweep"],
                             ["populate_plvs_slab", "golden_sweep_slab"])
    gp_fit(torch.float64, use_kernels=False)
    return launches


def sm_clock():
    """The card's SM clock now, as nvidia-smi reads it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_gp_timing(smi, runs=5):
    """K7 and K8 against their twins per launch (CUDA events) on fluA,
    float32; then the JAX bench's GP config on both routes."""
    print(f"[9] GP timing: fluA, float32 ({smi})")
    eng = gp_instance("fluA.fa", "fluA.tree", torch.float32).get_engine()
    streams, q, P, tips, bl = gp_kernel_inputs(eng)
    plvs = engine_kernels.populate_plvs_cuda(streams, q, P, tips)
    A, B = engine_kernels.sweep_stats(plvs, eng._pa, eng._ch, eng._rot)
    A, B = A.contiguous(), B.contiguous()
    cur = torch.log(bl[eng._g]).contiguous()
    calls = {
        "populate_plvs": (
            lambda: engine_kernels.populate_plvs_cuda(streams, q, P, tips),
            lambda: engine_kernels.populate_plvs_twin(streams, q, P, tips)),
        "golden_sweep": (
            lambda: engine_kernels.golden_sweep_cuda(A, B, eng._w, cur),
            lambda: engine_kernels.golden_sweep_twin(A, B, eng._w, cur)),
    }
    print(f"  SM clock before the K7 / K8 timings: {sm_clock()}")
    out = time_pairs(calls, 1, plain_reps=(3, 2))
    bounds = {
        "populate_plvs": bound(populate_ops(streams, tips.shape[2]),
                               (streams, q, P, tips), calls["populate_plvs"][0]()),
        "golden_sweep": bound(sweep_ops(*A.shape), (A, B, eng._w, cur),
                              calls["golden_sweep"][0]()),
    }
    for key, (b_ms, b_by) in bounds.items():
        print(f"  {key}: bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / out[key][0]:.2%} of it")
    for key, slab, what in (
            ("populate_plvs",
             lambda: engine_kernels._populate_plvs_launch(streams, q, P, tips, None),
             f"fluA, {tips.shape[2]} patterns"),
            ("golden_sweep",
             lambda: engine_kernels._golden_sweep_launch(A, B, eng._w, cur, None),
             f"fluA, {A.shape[0]} edges x {A.shape[1]} patterns")):
        print(f"  SM clock before {key}: {sm_clock()}")
        onchip_vs_slab(key, calls[key][0], slab, bounds[key][0], 50, what)
        print(f"  SM clock after {key}: {sm_clock()}")
    for use_kernels in (True, False):
        eng = gp_instance("fluA.fa", "fluA.tree", torch.float32,
                          use_kernels).get_engine()
        bl0 = eng.branch_lengths.copy()

        def ascent(eng=eng, bl0=bl0):
            eng.branch_lengths = bl0.copy()
            return eng.run_branch_ascent(1e-2, 10)

        line, _ = host_and_device(ascent, runs)
        marginal, sweeps = ascent()
        route = "kernel route (K7 + K8)" if use_kernels else "level route"
        print(f"  run_branch_ascent(1e-2, 10), {route}, per ascent: {line}; "
              f"{sweeps} sweeps, marginal {marginal:.6f}")
    return out, bounds


def rooted_instance(spec, dtype):
    """RootedInstance on the card: fluA, dates from the taxon names, every
    branch at CLOCK_RATE."""
    inst = lt.RootedInstance("fluA")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.parse_dates_from_taxon_names(True)
    inst.set_clock_rates(CLOCK_RATE)
    inst.prepare_for_phylo_likelihood(spec, device=DEV, dtype=dtype)
    return inst


def rooted_args(inst):
    """The engine's arguments for an instance's trees: (sched, bounds,
    ratios, rates, params), the arrays on the host."""
    return (inst._batched_schedule(), *inst._time_tree_arrays(),
            inst.phylo_model_params)


def rooted_kernel_inputs(eng, sched, bounds, ratios, rates):
    """The pruning kernels' inputs on a rooted path, as jc69_vs_twins and
    generic_inputs take them: the rate-scaled branch lengths with the root
    and ones slots, in the engine's dtype (no kernel launches)."""
    a = eng._rooted_inputs(sched, bounds, ratios, rates)
    _, bl = eng._rooted_branch_lengths(a, a["ratios"])
    return {"pc": a["pc"], "bl": eng._bl_padded2(bl * a["rates"]),
            "tips": eng.tips, "w": eng.weights, "root_id": a["root_id"]}


def rooted_kernels_vs_twins(jc_cases, gtr_d):
    """Every kernel launch of the rooted path against its twin at the
    path's shapes, at TWIN_TOL: K1, K2 and K3 on each (d, dtype, K, tag) of
    ``jc_cases`` (on chip, or the slab route where the plan says so), K5
    and K6 on the GTR instance's inputs. Returns the errors of the f32
    B_ROOTED batch."""
    errs = None
    for d, dtype, K, tag in jc_cases:
        e = jc69_vs_twins(d, dtype, K, tag)
        if dtype == torch.float32:
            errs = e  # the timed case
    model = generic_inputs(gtr_d, torch.float64, "constant",
                           ROOTED_GTR_RATES, ROOTED_GTR_FREQS)
    k5_k6_vs_twins(gtr_d, torch.float64, (model[0], *model[2:]),
                   "rooted fluA, float64 GTR")
    return errs


def clock_finite_difference(eps=1e-7):
    """d LL / d clock rate on fluA by a central difference of the f64 LLs
    on the card (K2)."""
    inst = rooted_instance(lt.PhyloModelSpec("JC69", "constant", "strict"),
                           torch.float64)
    sched, bounds, ratios, rates, params = rooted_args(inst)
    eng = inst.engine

    def ll(r):
        return float(eng.rooted_log_likelihoods(sched, bounds, ratios, r,
                                                params, True)[0][0])

    return (ll(rates + eps) - ll(rates - eps)) / (2 * eps)


def phase_rooted_path():
    """The rooted time-tree entry points on the card against the goldens, in
    f64, then every kernel of the path against its twin on the path's
    inputs; returns (the launch counts, the f32 batch's twin errors)."""
    print("[10] rooted time trees: RootedInstance on cuda, fluA, float64, "
          "vs the physher and phylotorch goldens")
    clock_fd = clock_finite_difference()
    reset_counters()
    f64, tol = torch.float64, ROOTED_TOL
    inst = rooted_instance(lt.PhyloModelSpec("JC69", "constant", "strict"), f64)
    jc_cases = [(rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4]), f64, 1,
                 "rooted fluA, float64 K=1")]
    lls, ldjs = inst.engine.rooted_log_likelihoods(*rooted_args(inst), True)
    close("fluA rooted LL vs physher", lls.cpu(), [ROOTED_LL], tol["ll"])
    close("fluA log-det-Jacobian vs physher", ldjs.cpu(), [ROOTED_LDJ],
          tol["ll"])
    close("fluA log_likelihoods() = LL + ldj", inst.log_likelihoods(),
          [ROOTED_LL + ROOTED_LDJ], tol["ll"])
    g = inst.phylo_gradients()
    r = g["ratios_root_height"]
    if r.device.type != torch.device(DEV).type or r.shape != (1, 68):
        raise AssertionError(f"ratio gradients on {r.device}, shape {r.shape}")
    close("fluA LL of phylo_gradients vs physher", g["log_likelihood"].cpu(),
          [ROOTED_LL], tol["ll"])
    close("fluA ratio and root-height gradients vs physher", r[0].cpu(),
          ROOTED_RATIO_GRADIENTS, tol["grad"])
    close("fluA clock gradient vs f64 central difference",
          g["clock_model"][0].cpu(), [clock_fd], tol["clock"])
    inst = rooted_instance(lt.PhyloModelSpec("JC69", "weibull+4", "strict"),
                           f64)
    inst.phylo_model_params["site"]["shape"] = torch.tensor(
        0.1, dtype=f64, device=DEV)
    jc_cases.append((rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4]),
                     f64, 4, "rooted fluA, float64 Weibull+4 at shape 0.1"))
    lls, ldjs = inst.engine.rooted_log_likelihoods(*rooted_args(inst), True)
    close("fluA Weibull+4 LL vs physher", lls.cpu(), [ROOTED_WEIBULL_LL],
          tol["ll"])
    close("fluA Weibull+4 shape gradient vs physher",
          inst.phylo_gradients()["site_model"].cpu(),
          [ROOTED_WEIBULL_SHAPE_GRADIENT], tol["shape"])
    inst = rooted_instance(lt.PhyloModelSpec("GTR", "constant", "strict"), f64)
    inst.phylo_model_params["substitution"] = {
        "rates": torch.tensor(ROOTED_GTR_RATES, dtype=f64, device=DEV),
        "frequencies": torch.tensor(ROOTED_GTR_FREQS, dtype=f64, device=DEV),
    }
    gtr_d = rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4])
    lls, ldjs = inst.engine.rooted_log_likelihoods(*rooted_args(inst), True)
    close("fluA GTR LL vs phylotorch", lls.cpu(), [ROOTED_GTR_LL], tol["gtr"])
    close("fluA GTR log-det-Jacobian", ldjs.cpu(), [ROOTED_LDJ], tol["ll"])
    g = inst.phylo_gradients()
    close("fluA GTR LL of phylo_gradients vs phylotorch",
          g["log_likelihood"].cpu(), [ROOTED_GTR_LL], tol["gtr"])
    close("fluA GTR substitution gradients vs phylotorch",
          g["substitution_model"][0].cpu(), ROOTED_GTR_GRADIENTS, tol["gtr"])
    jc_cases += rooted_routes_f32()
    launches = launch_counts("rooted path", ["ll_grad_jc69", "ll_jc69",
                                             "ll_dea_jc69", "ll_generic",
                                             "ll_dp_generic"])
    return launches, rooted_kernels_vs_twins(jc_cases, gtr_d)


def rooted_routes_f32():
    """flua_rooted_gradients at float32 on the card: the hand route (K1)
    against the autograd route (K2 + K3) and against the f64 hand route.
    Returns the kernels' inputs of both engines as jc69_vs_twins cases."""
    print(f"  flua_rooted_gradients: fluA x {B_ROOTED}, JC69, float32")
    sp, sched, bounds, ratios, rates = rooted_batch()
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    args = (sched, bounds, ratios, rates, default_parameters(spec, device=DEV))
    eng = LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV)
    hand = eng.rooted_phylo_gradients(*args)
    auto = eng._rooted_phylo_gradients_autograd(*args, True)
    ref_eng = LikelihoodEngine(sp, spec, dtype=torch.float64, device=DEV)
    ref = ref_eng.rooted_phylo_gradients(*args)
    for key in ("log_likelihood", "ratios_root_height", "clock_model"):
        close(f"f32 hand route vs autograd route (K2 + K3), {key}",
              hand[key].cpu(), auto[key].cpu(), ROUTES_F32_TOL)
        gate = GOLDEN_TOL[torch.float32]["ll" if key == "log_likelihood"
                                         else "grad"]
        close(f"f32 hand route vs f64 hand route, {key}", hand[key].cpu(),
              ref[key].cpu(), gate)
    return [(rooted_kernel_inputs(e, *args[:4]), e.dtype, 1,
             f"rooted fluA x {B_ROOTED}, {str(e.dtype)[6:]} K=1")
            for e in (eng, ref_eng)]


def rooted_batch():
    """The JAX bench's flua_rooted_gradients inputs: fluA tiled to B_ROOTED
    trees, ratios perturbed by U(0.95, 1.05) from default_rng(0) and
    clipped to [1e-4, 1 - 1e-4], every branch at CLOCK_RATE: (site
    patterns, sched, bounds, ratios, rates), the arrays on the host."""
    tops, bls, ttm = newick.parse_newick_file(f"{DATA}/fluA.tree")
    coll = RootedTreeCollection([RootedTree(t, b) for t, b in zip(tops, bls)],
                                ttm)
    coll.parse_dates_from_taxon_names(True)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/fluA.fa"), ttm)
    tree = coll.trees[0]
    sched = schedule.schedules_of_topologies([tree.topology] * B_ROOTED)
    bounds = np.tile(tree.node_bounds, (B_ROOTED, 1))
    ratios = np.tile(tree.height_ratios, (B_ROOTED, 1))
    rates = np.full((B_ROOTED, tree.node_count() - 1), CLOCK_RATE)
    rng = np.random.default_rng(0)
    ratios[:, :-1] = np.clip(
        ratios[:, :-1] * rng.uniform(0.95, 1.05, ratios[:, :-1].shape),
        1e-4, 1 - 1e-4)
    return sp, sched, bounds, ratios, rates


def phase_rooted_timing(smi, calls=10):
    """flua_rooted_gradients at float32: K1 timed beside its twin on the
    rooted batch (phase 10 held the two to each other), with its bound; the
    entry points from host arrays. Returns ((ms, twin ms), (bound ms,
    bound_by)) of K1 on this batch."""
    print(f"  flua_rooted_gradients timing: fluA x {B_ROOTED}, JC69, float32 "
          f"({smi})")
    sp, sched, bounds, ratios, rates = rooted_batch()
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    args = (sched, bounds, ratios, rates, default_parameters(spec, device=DEV))
    eng = LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV)
    # K1 on the rooted batch's rate-scaled branch lengths.
    d = rooted_kernel_inputs(eng, *args[:4])
    ea, one, _ = kernel_inputs(d, torch.float32, 1)
    a1 = (d["pc"], ea, one, one, d["tips"], d["w"])
    r = d["root_id"]
    k_out = pruning_jc.ll_grad_jc69_cuda(*a1, root_id=r)
    key = "ll_grad_jc69 (rooted fluA)"
    times = time_pairs({key: (
        lambda: pruning_jc.ll_grad_jc69_cuda(*a1, root_id=r),
        lambda: pruning_jc.ll_grad_jc69_plain(*a1, root_id=r))}, B_ROOTED,
        plain_reps=(5, 5))[key]
    L, _, P = eng.tips.shape
    b = bound(jc69_ops("ll_grad", B_ROOTED, L, d["pc"].shape[1], 1, P), a1,
              k_out)
    print(f"  K1, rooted fluA batch: bound {b[0]:.5f} ms ({b[1]}), "
          f"{b[0] / times[0]:.2%} of it")
    entries = (
        ("rooted_phylo_gradients (hand route: K1 + the heights adjoint)",
         lambda: eng.rooted_phylo_gradients(*args)),
        ("_rooted_phylo_gradients_autograd (K2 + K3 through the sweeps)",
         lambda: eng._rooted_phylo_gradients_autograd(*args, True)),
        ("rooted_log_likelihoods (K2)",
         lambda: eng.rooted_log_likelihoods(*args)),
    )
    for what, fn in entries:
        reset_counters()
        fn()
        torch.cuda.synchronize()
        per_call = {k: v for m in COUNTED for k, v in m.LAUNCHES.items() if v}
        line, peak = host_and_device(fn, calls)
        med = float(re.search(r"median ([\d.]+) ms", line).group(1))
        print(f"  {what}, B = {B_ROOTED} from host arrays: {line}; peak "
              f"{peak:.3f} GiB; {B_ROOTED / med * 1e3:.0f} evals/s; kernel "
              f"launches per call {per_call}")
    return times, b


# The vip path of [11]: the Burrito at the JAX bench's config 5 size (DS1,
# 10 particles) in float64, and vi.benchmark.fixed's defaults.
VIP_STEPS = 5
VIP_FIXED_STEPS = 20
FINAL_ELBO_PARTICLES = 10_000  # fixed's default final_elbo_particle_count
K2_TWIN_ROWS = 1_000  # the twin's share of the B = 10,000 batch
# The Burrito's ELBO traces on the card against the CPU's (same seed, same
# host draws): rel 1e-9, the parity gate of the CPU tests against
# libsbn_tpu; per-tree GTR rows on the card against the CPU: rel 1e-10. EM
# on the card against the CPU: the trees' probabilities at the goldens'
# atol 1e-12 and the scores at rtol 1e-12 ((rtol, atol) for close); the log
# parameters at rel 1e-12 (rel_close, the measure that holds the port to
# libsbn_tpu on the CPU): the card sums each slot in another fixed order
# than the CPU, and EM(0, 23) carries that rounding along directions the
# trees do not determine.
VIP_TRACE_REL = 1e-9
PER_TREE_REL = 1e-10
EM_CARD_TOL = {"probs": (0.0, 1e-12), "scores": (1e-12, 0.0),
               "params": 1e-12}


def sbn_goldens():
    """The zcrabbit EM goldens of tests/golden_sbn.py, a file of plain
    lists, read as data."""
    import ast

    with open(os.path.join(REPO, "tests", "golden_sbn.py")) as f:
        tree = ast.parse(f.read())
    return {node.targets[0].id: np.array(ast.literal_eval(node.value))
            for node in tree.body if isinstance(node, ast.Assign)}


def rel_close(name, got, want, rel):
    """Assert |got - want| <= rel (|want| + max |want|) elementwise (the CPU
    tests' "rel" against libsbn_tpu); return the max abs error."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} / non-finite values")
    scale = np.abs(want) + np.max(np.abs(want))
    worst = float(np.max(np.abs(got - want) / scale))
    if worst > rel:
        raise AssertionError(f"{name}: {worst:.3e} of the scale > rel {rel}")
    err = float(np.max(np.abs(got - want)))
    print(f"  ok  {name}: max abs err {err:.3e}, {worst:.3e} of the scale "
          f"(rel {rel})")
    return err


def vip_counts():
    """Every kernel's launches and twin's calls, and the scan engine's
    calls (``scan_ll``, ``scan_ll_grad``), as one dict."""
    out = {k: v for m in COUNTED for k, v in m.LAUNCHES.items()}
    out.update({f"twin_{k}": v for m in COUNTED
                for k, v in m.TWIN_CALLS.items()})
    out.update({f"scan_{k}": v for k, v in pruning.CALLS.items()})
    return out


def counted_call(what, fn, want):
    """fn() with the counts it adds checked: exactly ``want`` (a dict of
    counts) beyond what it left at zero. Returns fn's result."""
    before = vip_counts()
    out = fn()
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in vip_counts().items()
             if v != before[k]}
    print(f"  {what}: adds {added}")
    if added != want:
        raise AssertionError(f"{what}: the calls took {added}, not {want}")
    return out


def vip_burrito(device, spec=("JC69", "constant", "strict"),
                branch_model="split"):
    """The Burrito of [11]: DS1.subsampled_10.t (burn in 0.1) with
    DS1.fasta, split or psp / lognormal, the simple optimizer, 10
    particles, seed 0, float64, on ``device``."""
    return Burrito(
        mcmc_nexus_path=f"{DATA}/DS1.subsampled_10.t", burn_in_fraction=0.1,
        fasta_path=f"{DATA}/DS1.fasta",
        phylo_model_specification=lt.PhyloModelSpec(*spec),
        branch_model_name=branch_model, scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=PARTICLES, seed=0,
        device=device, dtype=torch.float64)


VIP_RUNS = (  # (tag, model, branch model, steps)
    ("JC69 split", ("JC69", "constant", "strict"), "split", VIP_STEPS),
    ("GTR + Weibull+4 split", ("GTR", "weibull+4", "strict"), "split", 2),
    ("JC69 psp", ("JC69", "constant", "strict"), "psp", 2),
)


def em_runs(device):
    """EM(0, 23) and EM(0.5, 100) on DS1.100_topologies on ``device``:
    {(alpha, iterations): (scores, parameters, probabilities, seconds)}."""
    inst = lt.UnrootedInstance("charlie")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    out = {}
    for alpha, iters in ((0.0, 23), (0.5, 100)):
        t0 = time.perf_counter()
        scores = inst.train_expectation_maximization(alpha, iters,
                                                     device=device)
        seconds = time.perf_counter() - t0
        out[(alpha, iters)] = (scores, inst.sbn_parameters.copy(),
                               inst.calculate_sbn_probabilities(), seconds)
    return out


def per_tree_instance(device):
    """DS1.subsampled_10 with DS1.fasta, GTR + Weibull+4, float64, with a
    parameter matrix whose rows differ (frequencies, exchangeabilities and
    shapes from default_rng(7))."""
    inst = lt.UnrootedInstance("per tree")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        lt.PhyloModelSpec("GTR", "weibull+4", "strict"), device=device,
        dtype=torch.float64)
    blocks = inst.get_phylo_model_param_block_map()
    rng = np.random.default_rng(7)
    blocks["frequencies"][:] = rng.dirichlet(np.full(4, 20.0), size=10)
    blocks["GTR rates"][:] = rng.dirichlet(np.full(6, 20.0), size=10)
    blocks["Weibull shape"][:, 0] = rng.uniform(0.3, 2.0, 10)
    return inst


def vip_fixed_dir(tmp, name, trees):
    """A directory ``name`` holding ``name``_out.t (a copy of data/trees)
    and ``name``.fasta, as vi.benchmark.fixed reads them."""
    import shutil

    d = os.path.join(tmp, name)
    os.mkdir(d)
    shutil.copy(f"{DATA}/{trees}", os.path.join(d, f"{name}_out.t"))
    shutil.copy(f"{DATA}/{name}.fasta", os.path.join(d, f"{name}.fasta"))
    return d


def burrito_kernel_inputs(burro):
    """The pruning kernels' inputs of the Burrito's last engine call: the d
    dict of jc69_vs_twins, the engine, and its model tensors (freqs, Q,
    rates, props)."""
    eng = burro.inst._get_engine()
    sched = burro.last_schedule
    d = {"pc": eng._post_children(sched),
         "bl": eng._bl_padded(burro.last_branch_lengths), "tips": eng.tips,
         "w": eng.weights, "root_id": sched.root_id}
    return d, eng, eng._model(burro.inst.phylo_model_params)


def phase_vip(smi):
    """[11] The vip path on the card: EM, per-tree GTR rows, the Burrito,
    vi.benchmark.fixed and the vip-torch command; then every kernel of the
    path against its twin on the path's own inputs, and its timings.
    Returns (launch counts of the card path, {key: max abs error}, the
    B = 10,000 K2 entry's numbers)."""
    import tempfile

    print("[11] vip path: EM, per-tree rows, the Burrito and "
          "vi.benchmark.fixed on cuda")
    t_phase = time.perf_counter()
    goldens = sbn_goldens()
    # Reference runs on the CPU (the kernels' twins), before the path's
    # counters are set to 0.
    print("  reference runs on the CPU (device=\"cpu\")")
    em_cpu = em_runs("cpu")
    pt_cpu = per_tree_instance("cpu")
    pt_cpu_ll, pt_cpu_g = pt_cpu.log_likelihoods(), pt_cpu.phylo_gradients()
    traces_cpu = {}
    for tag, spec, bm, steps in VIP_RUNS:
        burro = vip_burrito("cpu", spec, bm)
        burro.gradient_steps(steps)
        traces_cpu[tag] = burro.elbo_trace

    reset_counters()
    pruning.reset_counters()
    # (a) EM on the card, twice: every sum in a fixed order, so the second
    # run repeats the first bit for bit.
    em_card = em_runs(DEV)
    em_again = em_runs(DEV)
    for (alpha, iters), key, atol in (((0.0, 23), "EXPECTED_EM_0_23", 1e-12),
                                      ((0.5, 100), "EXPECTED_EM_05_100",
                                       1e-5)):
        scores, params, probs, seconds = em_card[(alpha, iters)]
        print(f"  EM({alpha}, {iters}) on the card: {seconds:.3f} s")
        close(f"EM({alpha}, {iters}) on the card vs zcrabbit", probs,
              goldens[key], (0.0, atol))
        for got, want in zip(em_again[(alpha, iters)][:3], (scores, params,
                                                            probs)):
            if not np.array_equal(got, want):
                raise AssertionError(f"EM({alpha}, {iters}): a second run on "
                                     "the card differs from the first")
        print(f"  ok  EM({alpha}, {iters}): a second run on the card equal "
              "bit for bit")
        cpu_scores, cpu_params, cpu_probs, _ = em_cpu[(alpha, iters)]
        close(f"EM({alpha}, {iters}) probabilities, card vs CPU reference",
              probs, cpu_probs, EM_CARD_TOL["probs"])
        close(f"EM({alpha}, {iters}) scores, card vs CPU reference", scores,
              cpu_scores, EM_CARD_TOL["scores"])
        rel_close(f"EM({alpha}, {iters}) log parameters, card vs CPU "
                  "reference", params, cpu_params, EM_CARD_TOL["params"])
    # (b) Per-tree GTR rows on the card: the LLs keep K5, the branch
    # gradients take the scan engine, the model gradients K5 + K6.
    pt = per_tree_instance(DEV)
    ll = counted_call("per-tree log_likelihoods", pt.log_likelihoods,
                      {"ll_generic": 1})
    g = counted_call("per-tree phylo_gradients", pt.phylo_gradients,
                     {"scan_ll_grad": 1, "ll_generic": 1, "ll_dp_generic": 1})
    rel_close("per-tree LLs, card vs CPU reference", ll, pt_cpu_ll,
              PER_TREE_REL)
    for key in pt_cpu_g:
        rel_close(f"per-tree {key}, card vs CPU reference", g[key].cpu(),
                  pt_cpu_g[key], PER_TREE_REL)
    # (c) The Burrito on the card.
    burros = {}
    for tag, spec, bm, steps in VIP_RUNS:
        jc = spec[0] == "JC69"
        want = ({"ll_grad_jc69": steps, "ll_jc69": steps} if jc
                else {"ll_grad_generic": steps, "ll_generic": steps})
        burro = burros[tag] = vip_burrito(DEV, spec, bm)
        counted_call(f"Burrito {tag}, {steps} gradient_steps",
                     lambda: burro.gradient_steps(steps), want)
        rel_close(f"Burrito {tag} ELBO trace, card vs CPU reference",
                  burro.elbo_trace, traces_cpu[tag], VIP_TRACE_REL)
    # (d) vi.benchmark.fixed on DS1 with its default final ELBO (one K2
    # launch at B = 10,000), then (f) the command line on hello: the
    # command's final ELBO is over 10,000 particles too, which on DS1 is
    # 43 s of host work (sampling and lowering topologies in Python; the
    # second card run of this phase), so the command runs on hello's 4
    # taxa.
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = vip_fixed_dir(tmp, "DS1", "DS1.subsampled_10.t")
        t0 = time.perf_counter()
        details, _, fitting = counted_call(
            f"fixed(DS1), {VIP_FIXED_STEPS} steps and a {FINAL_ELBO_PARTICLES}"
            "-particle final ELBO",
            lambda: benchmark.fixed(
                data_dir, branch_model_name="split",
                scalar_model_name="lognormal", optimizer_name="simple",
                step_count=VIP_FIXED_STEPS, particle_count=PARTICLES),
            {"ll_grad_jc69": VIP_FIXED_STEPS,
             "ll_jc69": VIP_FIXED_STEPS + 1})
        fixed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = cli.main(["benchmark", "--step-count", "2", "--particle-count",
                       "4", vip_fixed_dir(tmp, "hello", "hello_out.t")])
        cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"vip-torch benchmark returned {rc}")
    if not np.isfinite(details["final_elbo"]):
        raise AssertionError(f"fixed's final ELBO is {details['final_elbo']}")
    print(f"  fixed(DS1, step_count={VIP_FIXED_STEPS}, particle_count="
          f"{PARTICLES}): {fixed_s:.1f} s; gradient_time "
          f"{details['gradient_time']:.4f} s, "
          f"{details['gradient_time'] / VIP_FIXED_STEPS * 1e3:.3f} ms per "
          f"gradient step (host clock, its ELBO estimate included); final "
          f"ELBO over {FINAL_ELBO_PARTICLES} particles "
          f"{details['final_elbo']:.4f}; vb_sample "
          f"{fitting['vb_sample'].shape}")
    print(f"  vip-torch benchmark --step-count 2 --particle-count 4 (hello):"
          f" rc {rc}, {cli_s:.1f} s")
    launches = launch_counts("vip path", ["ll_grad_jc69", "ll_jc69",
                                          "ll_grad_generic", "ll_generic"])

    # (e) Every kernel of the path against its twin on the path's inputs:
    # one more gradient step of each Burrito gives its step's inputs, and a
    # 10,000-particle ELBO estimate, as fixed's last call, the B = 10,000
    # batch.
    errs = {}
    jc_burro = burros["JC69 split"]
    jc_burro.gradient_step()
    d, _, _ = burrito_kernel_inputs(jc_burro)
    errs.update(jc69_vs_twins(d, torch.float64, 1,
                              f"vip step B = {PARTICLES}, float64"))
    burros["GTR + Weibull+4 split"].gradient_step()
    d, eng, (freqs, Q, rates, props) = burrito_kernel_inputs(
        burros["GTR + Weibull+4 split"])
    dt = torch.float64
    P = eng._node_P(Q, freqs, rates, d["bl"]).contiguous()
    Qs = (Q.to(dt)[None] * rates.to(dt)[:, None, None]).contiguous()
    args = (d["pc"], P, Qs, d["tips"], freqs.to(dt), props.to(dt), d["w"])
    r = d["root_id"]
    k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
    t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
    tag = f"vip GTR + Weibull+4 step B = {PARTICLES}, float64"
    errs["ll_grad_generic"] = max(
        close(f"K4 LL {tag}", k_ll.cpu(), t_ll.cpu(), TWIN_TOL[dt]["ll"]),
        close(f"K4 grad {tag}", k_g[:, :r].cpu(), t_g[:, :r].cpu(),
              TWIN_TOL[dt]["grad"]))
    errs["ll_generic"], _ = k5_k6_vs_twins(
        d, dt, (P, freqs.to(dt), props.to(dt)), tag)
    t0 = time.perf_counter()
    jc_burro.estimate_elbo(FINAL_ELBO_PARTICLES)
    elbo10k_s = time.perf_counter() - t0
    d, eng, _ = burrito_kernel_inputs(jc_burro)
    b10k, r = d["pc"].shape[0], d["root_id"]
    ea, _, one = kernel_inputs(d, dt, 1)
    a2 = (d["pc"], ea, one, d["tips"], d["w"])
    n = K2_TWIN_ROWS
    rows = (d["pc"][:n].contiguous(), ea[:n].contiguous(), one, d["tips"],
            d["w"])
    full = pruning_jc.ll_jc69_cuda(*a2, root_id=r)
    part = pruning_jc.ll_jc69_cuda(*rows, root_id=r)
    if not torch.isfinite(full).all():
        raise AssertionError(f"K2 at B = {b10k}: non-finite LLs")
    errs["ll_jc69"] = close(
        f"K2 on the first {n} rows of the B = {b10k} batch vs twin",
        part.cpu(), pruning_jc.ll_jc69_plain(*rows, root_id=r).cpu(),
        TWIN_TOL[dt]["ll"])
    close(f"K2 at B = {b10k}: its first {n} rows vs the B = {n} launch",
          full[:n].cpu(), part.cpu(), TWIN_TOL[dt]["ll"])

    # Timings: the B = 10,000 engine.log_likelihoods call on the estimate's
    # own schedule and branch lengths; K2 at B = 10,000 against the twin
    # over the same rows in chunks of K2_TWIN_ROWS; a gradient step and an
    # ELBO estimate from the host with device time and idle share.
    def call10k():
        return eng.log_likelihoods(jc_burro.last_schedule,
                                   jc_burro.last_branch_lengths,
                                   jc_burro.inst.phylo_model_params)

    line, peak = host_and_device(call10k, 3)
    mb10k = call_memory(call10k)
    print(f"  estimate_elbo({b10k}) on DS1: {elbo10k_s:.1f} s (host clock); "
          f"its engine.log_likelihoods call, B = {b10k}, float64 ({smi}): "
          f"{line}; adds {mb10k:.2f} MB, peak {peak:.3f} GiB")
    chunks = [tuple(x[i:i + n].contiguous() if j in (0, 1) else x
                    for j, x in enumerate(a2)) for i in range(0, b10k, n)]
    k2_ms = min(time_ms(lambda: pruning_jc.ll_jc69_cuda(*a2, root_id=r)),
                time_ms(lambda: pruning_jc.ll_jc69_cuda(*a2, root_id=r)))
    plain_ms = time_ms(lambda: [pruning_jc.ll_jc69_plain(*c, root_id=r)
                                for c in chunks], reps=2, inner=1)
    L, _, Pn = d["tips"].shape
    k2_bound = bound(jc69_ops("ll", b10k, L, d["pc"].shape[1], 1, Pn), a2,
                     full)
    k2_mem = call_memory(lambda: pruning_jc.ll_jc69_cuda(*a2, root_id=r))
    print(f"  K2 at B = {b10k}, float64 ({smi}): {k2_ms:.4f} ms (CUDA "
          f"events), twin in {b10k // n} chunks of {n} {plain_ms:.2f} ms; "
          f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]}, float64 peak), "
          f"{k2_bound[0] / k2_ms:.2%} of it; one launch adds {k2_mem:.2f} MB")
    burro = vip_burrito(DEV)
    for what, fn in (("Burrito.gradient_step", burro.gradient_step),
                     (f"Burrito.estimate_elbo({PARTICLES})",
                      lambda: burro.estimate_elbo(PARTICLES))):
        line, peak = host_and_device(fn, 10)
        print(f"  {what}, DS1, {PARTICLES} particles, float64 ({smi}): "
              f"{line}; peak {peak:.3f} GiB")
    print(f"[11] took {time.perf_counter() - t_phase:.1f} s")
    return launches, errs, (k2_ms, plain_ms, k2_bound)


def main():
    name, smi = phase_device()
    phase_build()
    errs = phase_kernel_vs_twin()
    errs.update(phase_generic_vs_twin())
    errs.update(phase_gp_vs_twin())
    runs = [phase_main_path(), phase_gtr_path(), phase_vbpi(), phase_gp_path()]
    rooted_launches, rooted_errs = phase_rooted_path()
    vip_launches, vip_errs, vip_k2 = phase_vip(smi)
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    # K1's rooted launches stand in its second entry below and K2's vip
    # launches in its second; every other kernel's entry counts every path.
    for k, n in rooted_launches.items():
        if k != "ll_grad_jc69":
            launches[k] += n
    for k, n in vip_launches.items():
        if k != "ll_jc69":
            launches[k] += n
    times, bounds = phase_timing(smi)
    time_vbpi(smi)
    for phase in (phase_generic_timing, phase_gp_timing):
        t, b = phase(smi)
        times.update(t)
        bounds.update(b)
    rooted_times, rooted_bound = phase_rooted_timing(smi)
    # No single PyTorch call computes any of these functions (each is a
    # pruning recursion or a golden-section search): library_ms is null.
    report = [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[k["key"]],
         "max_abs_err": errs[k["key"]], "ms": times[k["key"]][0],
         "plain_ms": times[k["key"]][1], "bound_ms": bounds[k["key"]][0],
         "bound_by": bounds[k["key"]][1], "library_ms": None}
        for k in KERNELS
    ]
    # K1's second case: the rooted batch of phase 10, with the launches of
    # the rooted path alone.
    report.insert(1, {
        "name": "jc69_ll_grad (K1), rooted fluA B = 256", "route": "cuda",
        "source": JC_SOURCE, "replaces": KERNELS[0]["replaces"],
        "launches": rooted_launches["ll_grad_jc69"],
        "max_abs_err": rooted_errs["ll_grad_jc69"],
        "ms": rooted_times[0], "plain_ms": rooted_times[1],
        "bound_ms": rooted_bound[0], "bound_by": rooted_bound[1],
        "library_ms": None})
    # K2's second case: the B = 10,000 launch of vi.benchmark.fixed's final
    # ELBO, with the launches of the vip path alone; its twin time is the
    # twin over the same rows in chunks of K2_TWIN_ROWS, its error the
    # first chunk's.
    report.insert(3, {
        "name": f"jc69_ll (K2), vip final ELBO B = {FINAL_ELBO_PARTICLES} "
                "f64", "route": "cuda", "source": JC_SOURCE,
        "replaces": KERNELS[1]["replaces"],
        "launches": vip_launches["ll_jc69"],
        "max_abs_err": vip_errs["ll_jc69"], "ms": vip_k2[0],
        "plain_ms": vip_k2[1], "bound_ms": vip_k2[2][0],
        "bound_by": vip_k2[2][1], "library_ms": None})
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
