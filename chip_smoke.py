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
     and no twin did; each call is made twice, a key's first call (run
     eagerly) and its second (a capture of its graph and one replay:
     models/unrooted_graph.py, the engine's default on a card), both held
     to the goldens, and the graph counters show one capture and one
     replay a key; the goldens' constants come from the parity tier
     (libsbn_tpu_torch/utils/parity.py);
  4b. GTR path: UnrootedInstance on the card, GTR + Weibull+4 on
     DS1.100_topologies, float64 and float32, against values pinned from
     libsbn_tpu's f64 scan engine; in f64 the kernel route against the
     port's own scan engine on the card and the substitution gradient at
     the uniform-rates default against a central finite difference; the
     counters show K4, K5 and K6 launched and no twin called, and each
     golden call made twice, eagerly and by one replay of its captured
     graph;
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
     engine.branch_gradients and engine.log_likelihoods from host arrays,
     eagerly (cuda_graphs=False, as recorded before the graphs) and by the
     graph route;
     K4, K5 and K6 against their twins at the JAX bench's config 2 (GTR +
     Weibull+4 at shape 0.5, B = 256, float32), K4 and K5 on chip beside
     their slab routes in turns with the memory one call adds (fails at
     50 MB), K6 the same (fails at 128 MB), the K5 + K6 autograd pass and
     engine.log_likelihoods and engine.phylo_gradients from host arrays
     by both routes, with peak device memory, device time per call (torch.profiler) and
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
     kernel route's fit within 1e-2 of the optimum; the streamed ascent
     run_branch_ascent_streamed(1e-6, 100, 100) (fluA's 238 patterns in
     three chunks, the last padded at weight 0, K7 a chunk, Newton on the
     host, the chunk programs by their CUDA graphs) in f64
     with A and B in host RAM and in an np.memmap, within 1e-7 of the
     optimum and of the level route's fit, and in f32 within 1e-2; the
     counters show K7 and K8 launched and no twin called; then K7 against
     its twin on the last chunk's own inputs (S = 100), f64 and f32;
  9. GP timing: K7 and K8 against their twins per launch on fluA, float32,
     and K7 and K8 each beside its slab route in turns, each with its share
     of the bound and the SM clock (nvidia-smi) before and after; the JAX
     bench's GP config (fluA, f32,
     run_branch_ascent(1e-2, 10) from the same starting lengths each run)
     on both routes, in ms per ascent, with device time per ascent and the
     device's idle share as in phase 6, and the streamed ascent
     run_branch_ascent_streamed(1e-2, 10, 100) the same way, by its chunk
     programs' graphs and eagerly;
  10. rooted time trees: RootedInstance on the card, fluA (dates from the
     taxon names, strict clock at 0.001), float64, against the physher and
     phylotorch goldens (JC69 LL, log-det-Jacobian and the 68 ratio and
     root-height gradients; Weibull+4 at shape 0.1, LL and shape gradient;
     GTR, LL and the 8 substitution gradients) and the clock gradient
     against the card's own f64 central difference, each golden's call
     made twice, eagerly and by one replay of its captured graph (the hand
     route, the LLs, GTR's autograd route; the Weibull+4 keys run K1-K3's
     slab routes at f64 and stay eager), with
     the counters showing K1 and the heights kernels H1 and H2 (the hand
     route), K2, K3, K5 and K6 launched
     and no twin called, on a run that ends with the JAX bench's flua_rooted_gradients
     (fluA tiled to 256, ratios perturbed by U(0.95, 1.05) from
     default_rng(0), JC69, float32): the hand route (K1) against the
     autograd route (K2 + K3) and against the f64 hand route; after the
     counters are read, every kernel of the path against its twin on the
     path's own inputs: K1, K2 and K3 on the f64 instance (on chip), on the
     f64 Weibull+4 instance (the slab route) and on the batch at f32 and
     f64, K5 and K6 on the f64 GTR instance; H1 and H2 (csrc/heights.cu)
     on the batch's inputs at f32 and f64 against their twins bit for bit,
     each launched once a call with the counters at 0; then, after phase
     9's timings, K1, H1 and H2 timed beside their twins on the f32 batch
     with their bounds,
     and rooted_phylo_gradients (both routes) and rooted_log_likelihoods
     from host arrays with device time, idle share, peak memory and
     gradient evaluations per second;
  11. the vip path (after [10], before the timing phases): after reference
     runs on the CPU (device="cpu", the kernels' twins), with the counters
     at 0: (a) EM on DS1.100_topologies on the card (the step's CUDA
     graph), (0, 23) and (0.5, 100), against the zcrabbit goldens of tests/golden_sbn.py and the CPU
     reference, and run twice, equal bit for bit; (b) GTR + Weibull+4
     rows per tree on DS1.subsampled_10, float64, log_likelihoods (K5)
     and phylo_gradients (the scan engine for the branch gradients, K5 +
     K6 for the model's) against the CPU at rel
     1e-10, each call's route read from the counters; (c) the Burrito
     (DS1.subsampled_10.t burn-in 0.1, DS1.fasta, lognormal, the simple
     optimizer, 10 particles, seed 0, float64): JC69 split for 5 steps (K1
     and K2), GTR + Weibull+4 split for 2 (K4 and K5), JC69 psp for 2,
     each ELBO trace against the CPU reference at rel 1e-9; (d)
     vi.benchmark.fixed on DS1 (20 steps, 10 particles, the final ELBO over
     10,000 particles: a key of its own at B = 10,000, called once, so
     run eagerly: one K2 launch; every graph's warm-up adds one launch of
     its kernels to a path's counts) with its gradient time
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
  12. forest mode (after [11]): DS1.100_topologies under R = 8
     split-keyed length sets (U(0.8, 1.2) from default_rng(0) times the
     per-split mean lengths, the JAX bench's forest_shared_ds1_100): the
     f64 forest against the per-tree engine on the card (one K1 launch of
     R T trees, before the path's counters are set to 0) at rel 1e-9; the
     f32 forest with bf16 gathers against f64 within the bench's gate on the
     first set (every set's error printed); the f64 split gradient against
     the per-tree gradients summed onto splits, twice, equal bit for bit;
     20 f32 Adam steps of forest_branch_ascent rising; every surface (the
     LLs, the LLs with per-tree gradients and bf16 gathers, the split
     gradient) at f32, and at f64 on DS1.100, eagerly twice and by its
     graph (libsbn_tpu_torch/ops/forest_graph.py: the first call eager, the
     second a capture and replay, the third a replay, then a replay with
     new lengths), each equal to the eager call bit for bit, on DS1.100 x 8
     and on a 1,000-tree SBN-sampled support; then the three surfaces
     timed by both routes on both supports (host-clock median, device
     time, launches, idle share, peak memory, evals/s); the forest runs
     torch ops only: the counters show no kernel, twin or scan-engine call.
  13. the parallel layer and the helpers (after [12]): two ranks of
     libsbn_tpu_torch/parallel/multihost_demo.py on the card with gloo
     (NCCL refuses two ranks on one GPU) and one rank with nccl, started
     first, each JitVBPI(mesh=global_mesh()) at config 5's width (DS1, 10
     particles, float32, 3 steps); meanwhile, with the counters at 0, the
     path: the dp-sharded K1 wrapper on the headline batch (float32 and
     float64) and the K4 wrapper at config 2 over make_mesh(2, dp=2,
     devices=[cuda:0, cuda:0]), and run_branch_ascent(1e-2, 10) on fluA
     over sp = 2 and 4 shards of the card (float64, float32; 238 patterns
     padded to 240 at sp = 4); then each wrapper against the unsharded
     call (bit for bit, or within TWIN_TOL with the largest difference
     printed), each GP fit against the unsharded kernel route's (1e-7 f64,
     1e-2 f32), a torch.profiler trace of one K1 launch that must name
     jc69_ll_grad_kernel, PhaseTimer(sync=True) over K1, and the native CPU
     baseline at dtype_bits=64 against the card's f64 K1 (rel 1e-10); the
     ranks' states bit-identical across ranks, each rank's K1 launched once
     a step, and within the f32 gates of one process on the card fed the
     ranks' samples concatenated; then dp = 1 against dp = 2 on the one
     card (the cost of the split, not scaling) and the baseline's f32
     evals/s on all cores (bench.py's loop) beside the card's, with the
     host CPU.
  14. one dispatch per VBPI window (after [13]): with the counters at 0,
     the DS1 soak (vi/soak.py: 20,000 JitVBPI steps of config 5 at f32,
     step_many(20) on the graph route, beta annealed over 2,000 steps),
     which must take one CUDA graph replay a window and K1 once a step
     (and once for the capture's warm-up), with ELBO(100) and the IW
     marginal(1000) within SOAK_TOL of the JAX package's soak on the CPU
     (the JAX tool's gate, the marginal above -6790, is printed, met or
     not); then at f32 and f64, split and PSP:
     a window of 20 steps replayed from a state against
     vbpi_train_steps_packed run eagerly from it (bit for bit: every sum
     of a step has a fixed order), a second window's mean LL a step
     against K1's twin at the states the steps start from (so K1 ran in
     the graph and read the new inputs), step() (the K = 1 graph) against
     one eager step, and a checkpoint restored into the captured trainer
     against the eager route from it; each window one replay with K1 K
     times; then step(), step_overlapped(), step_many(16) and
     step_many(20) by each route (host clock, in turns), and each route's
     device time and idle share traced in a fresh process.
  15. the GP ascent and the rooted engine as CUDA graphs (after [14]):
     with the counters at 0, the path: gp_ascent_flua (fluA, the kernel
     route, float32 and float64, run_branch_ascent(1e-2, 10) and (1e-6,
     100)) and flua_rooted_gradients (fluA x 256, JC69, float32 and
     float64: rooted_phylo_gradients by the hand route and
     rooted_log_likelihoods) by their graphs (gp/ascent_graph.py,
     models/rooted_graph.py), as the engines run them by default on a
     card; then each fit against the eager loop (cuda_graphs=False) bit for
     bit (marginal, branch lengths, sweeps, the converged flag), a second
     graphed ascent whose every K7 and K8 launch is a replay's and as many
     as the eager loop's, the float64 (1e-6, 100) fit within 1e-7 of
     libsbn_tpu's optimum; each rooted call against the eager call bit for
     bit, twice each, a call one replay with K1, H1 and H2 (K2 for the
     LLs) once, and
     a replay at new ratios whose LLs match K1's twin on the eager route's
     inputs; then host-clock ms a call by route (graph, eager, in turns;
     the GP ascent on the kernel and the level route at float32), and each
     call's device time and idle share traced in a fresh process.
  16. one replay per engine call (after [15]): with the counters at 0, the
     path: log_likelihoods, branch_gradients and phylo_gradients by the
     engine's graphs (models/unrooted_graph.py) on DS1 x 512 (JC69, and
     JC69 + Weibull+4 at shape 0.1) and config 2 (GTR + Weibull+4 at shape
     0.5, DS1.100_topologies x 256), and the rooted autograd route
     (models/rooted_graph.py) on fluA x 256 (GTR, and JC69 + Weibull+4),
     float32 and float64, each call twice (a key's first call runs
     eagerly, its second is a capture and one replay, into one memory pool
     an engine; the f64 JC69 + Weibull+4 key runs K2/K3's slab routes and
     stays eager), with the MB each key adds and each engine holds; then
     both calls against an engine built with cuda_graphs=False bit for
     bit, a third call one replay launching each kernel as the eager call
     does and copying no int32 buffer (the same schedule object), new
     inputs on a new schedule object read with no capture, an engine's
     keys called in turns with new inputs bit for bit, a Burrito step (new
     topologies) two replays and no capture, the slab key under 200 MB,
     config 2's keys each alone against the engine holding all three (at
     most the largest plus 20 MB a key); the B = 10,000 float64
     final-ELBO key called once on fresh engines, graph and eager in
     turns (no program kept, the reserved memory back within 2 MB), then
     its capture and replays; the slab key eagerly against a graph of its
     own; then host-clock ms a call by route (graph, eager, eager,
     graph; float32, from host arrays) of engine.branch_gradients and
     engine.log_likelihoods at DS1 x 512, engine.log_likelihoods and
     engine.phylo_gradients at config 2, and the rooted autograd route at
     fluA x 256 (JC69: K2 + K3; GTR: K5 + K6), and each call's device time,
     idle share and host-to-device copies traced in a fresh process.
  17. the parity tier (after [16]): with the counters at 0,
     libsbn_tpu_torch/utils/parity.py's run() in this process, as
     `python -m libsbn_tpu_torch.utils.parity` runs it: golden numbers at
     float32 on the kernels and the engines' graphs (DS1 JC69 and
     Weibull+4, fluA rooted strict clock, GTR and Weibull+4, GP hello and
     five_taxon on both routes, one VBPI step, config 2's GTR gradients),
     one line a check, with K1-K8 all launched.
  18. the scale tools (run after [7], before the main paths, while
     torch.profiler is fresh in the process): with the counters at 0,
     libsbn_tpu_torch/utils/scale_compare.py's run() at 1,024 patterns x
     64 trees over its sweep (27, 200, 433 and 434 taxa, the two sides of
     K1's f32 on-chip plan, and 1,000), K1 at f32 and f64 against the
     native f64 baseline: the JAX tool's gate at 200 taxa, f64 K1 against
     native f64 at rel 1e-9 wherever native's LLs are finite, finite f32
     results and the expected route at every point; gp_scale.run() at 200
     taxa x 4,096 sites, f64 and f32: at f64 the streamed (K7) ascent
     within the JAX tool's bound of the fused (K7 + K8) and of the
     in-memory Newton ascent, at f32 finite marginals with both gaps
     printed (neither f32 fit meets that bound: a finding, PERF.md); at
     both dtypes the streamed ascent by its chunk programs' graphs equal
     to the same ascent with cuda_graphs=False bit for bit (marginal,
     sweeps, branch lengths), each timed at f32, and the graphs' pool MB;
     forest_scale.run() at 1,000
     sampled trees, the three surfaces by graph and eagerly, graph = eager
     bit for bit; K1, K7 and K8 launched and no twin called; then, after
     the counters are read, K1 f32 on chip against its slab route at 200
     and 433 taxa (CUDA events). Throughput windows of 0.25 s, not the
     tools' 2 s, to keep the script inside its time limit.
  19. the JAX package's last compiled programs as CUDA graphs (after
     [17]): with the counters at 0, the path, each entry point as a user
     calls it on the card: run_branch_ascent_streamed(1e-6, 100, 100) on
     fluA by its chunk programs' graphs (gp/streamed_graph.py; f64 with A
     and B in host RAM and in an np.memmap, f32), calculate_hybrid_marginals
     three times each (gp/hybrid_graph.py: the first call eager, the
     second a capture) on fluA at f64 and f32 and on gp_scale's 200-taxon
     x 4,096-site DAG at f64, and EM(0, 23) and EM(0.5, 100) on
     DS1.100_topologies (the step's graph, sbn/probability.py
     EMStepGraph); the counters must show three captures a streamed fit,
     one a hybrid engine and one an EM call, a replay an EM iteration, and
     K7 once a chunk a statistics refresh, once at the statistics graph's
     warm-up, once at finalize and once a hybrid call; then each against
     cuda_graphs=False bit for bit (the streamed marginal, sweeps and
     branch lengths, and K7 one launch fewer; the hybrid values of every
     call; EM's scores, parameters and probabilities), each streamed fit
     within GP_FLUA_TOL of libsbn_tpu's optimum, the f64 hybrid values
     within rel 1e-10 of the port's CPU run, fluA's hybrid in chunks of 16
     (the last padded) by graph and eagerly; the graphs' MB; then each
     path's host ms, device ms and idle share by route, traced in a fresh
     process.
The last lines are the {"kernels": [...]} report (each kernel's launches
on its paths, its error against its twin, its time, its twin's, and its
bound: the larger of its operations at the peak of their type (float64's
for a float64 launch, float32's otherwise) and its inputs and outputs at
the HBM rate; K1 has two entries, the first counting the unrooted, vip,
parallel, soak, engine-graph, parity and scale-tool paths (the ranks'
launches of [13] included), the second the
rooted batch and path ([10] and [15]); H1 and H2, the heights kernels,
count the rooted paths' launches ([10] and [15]) and are timed on the
rooted batch; K2 has two,
the first counting every path but the vip path, the second the vip path's
launches with the B = 10,000 launch's time and bound), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data")
sys.path.insert(0, REPO)

import libsbn_tpu_torch as lt  # noqa: E402
from libsbn_tpu_torch.core.site_pattern import SitePattern  # noqa: E402
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection  # noqa: E402
from libsbn_tpu_torch.gp import GPInstance, ascent_graph, engine_kernels  # noqa: E402
from libsbn_tpu_torch.gp import hybrid_graph, streamed_graph  # noqa: E402
from libsbn_tpu_torch.gp.engine import _jc69_transition  # noqa: E402
from libsbn_tpu_torch.gp.quartet import quartet_hybrid_request_of  # noqa: E402
from libsbn_tpu_torch.io import newick  # noqa: E402
from libsbn_tpu_torch.io.fasta import Alignment  # noqa: E402
from libsbn_tpu_torch.models import rooted_graph  # noqa: E402
from libsbn_tpu_torch.models import unrooted_graph as lt_unrooted_graph  # noqa: E402
from libsbn_tpu_torch.models.engine import LikelihoodEngine  # noqa: E402
from libsbn_tpu_torch.models.phylo_model import default_parameters  # noqa: E402
from libsbn_tpu_torch.ops import (  # noqa: E402
    _kernels, heights, pruning, pruning_generic, pruning_jc, pruning_vjp,
    schedule,
)
from libsbn_tpu_torch.ops import forest, forest_graph  # noqa: E402
from libsbn_tpu_torch.ops import substitution, transforms  # noqa: E402
from libsbn_tpu_torch.ops.site_model import weibull_rates  # noqa: E402
from libsbn_tpu_torch.parallel.sharding import make_mesh  # noqa: E402
from libsbn_tpu_torch.sbn import probability as sbn_probability  # noqa: E402
from libsbn_tpu_torch.utils import cpu_baseline, parity, profiling  # noqa: E402
from libsbn_tpu_torch.utils import forest_scale, gp_scale  # noqa: E402
from libsbn_tpu_torch.utils import scale_compare  # noqa: E402
from libsbn_tpu_torch.utils.graphs import PackedPrograms  # noqa: E402
# The golden numbers, kept by the parity tier.
from libsbn_tpu_torch.utils.parity import (  # noqa: E402
    CLOCK_RATE, GP_HELLO, GP_HELLO_BL, GTR_FREQS, GTR_GRADIENTS_BL0,
    GTR_LIKELIHOODS, GTR_RATES, GTR_SHAPE, GTR_SITE_GRADIENTS,
    GTR_SUBSTITUTION_GRADIENTS, PHYSHER_GRADIENTS, PHYSHER_JACOBIAN,
    PHYSHER_LL, PHYSHER_RATIO_GRADIENTS, PHYSHER_WEIBULL_LIKELIHOODS,
    PYBEAGLE_LIKELIHOODS, ROOTED_GTR_FREQS, ROOTED_GTR_GRADIENTS,
    ROOTED_GTR_LL, ROOTED_GTR_RATES, ROOTED_WEIBULL_LL,
    ROOTED_WEIBULL_SHAPE_GRADIENT,
)
from libsbn_tpu_torch.vi import Burrito, JitVBPI, benchmark, cli  # noqa: E402
from libsbn_tpu_torch.vi import checkpoint, soak, step_graph  # noqa: E402
from libsbn_tpu_torch.vi.jit_step import (  # noqa: E402
    AdamState, VBPIState, _branch_lengths, pack_ints, unpack_ints,
    vbpi_train_step, vbpi_train_step_packed, vbpi_train_steps_packed,
)

# The reference's unrooted_sbn_instance.hpp goldens not in the tier (as
# the JAX package's tests/test_likelihood.py pins them): d LL / d b of edge
# 0 of each DS1 tree, Weibull+4 at shape 0.1, and hello's LL.
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
HEIGHTS_SOURCE = "libsbn_tpu_torch/csrc/heights.cu"
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
COUNTED = (pruning_jc, pruning_generic, pruning_vjp, engine_kernels, heights)
PARTICLES = 10  # the JAX bench's config 5
# Generalized pruning: the reference's goldens (gp_doctest.cpp, as
# tests/test_gp.py pins them) and the fluA optimum of run_branch_ascent(1e-6,
# 100) in f64 (libsbn_tpu: -4337.885058592374 on its level route and
# -4337.885058592593 on its Pallas route, both in 12 sweeps;
# tests/test_torch_gp_kernels.py holds the port's CPU routes to it).
GP_GRADIENT = (-4.806671945, -0.6109379521)
GP_FLUA = -4337.885058592
GP_FLUA_TOL = {torch.float64: 1e-7, torch.float32: 1e-2}
GP_CHUNK = 100  # the streamed ascent's chunk: fluA's 238 patterns in 3
# K7 against its twin, (rtol, atol) of the PLVs and of the log-scales;
# K8 against its twin, the largest objective gap over |f| + sum(w) and the
# largest log-branch-length gap on edges that are not flat
# (engine_kernels.sweep_disagreement).
# Rooted time trees on fluA at a strict clock of CLOCK_RATE: the
# tolerances of the JAX package's tests/test_rooted_likelihood.py for the
# physher and phylotorch goldens, (rtol, atol).
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
    """(em, rates, props) in ``dtype`` on the card: one rate category, or K
    Weibull categories at ``shape``."""
    if K == 1:
        rates = torch.ones(1, dtype=torch.float64, device=DEV)
        props = rates.clone()
    else:
        rates, props = weibull_rates(shape, K, device=DEV)
    rates, props = rates.to(dtype), props.to(dtype)
    em = pruning_jc.exp_complements(d["bl"], rates, dtype)
    return em, rates, props


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
    em, rates, props = kernel_inputs(d, dtype, K)
    args = (d["pc"], em, rates, props, d["tips"], d["w"])
    args2 = (d["pc"], em, props, d["tips"], d["w"])
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


ROUTE_CALLS = ("eager", "graph")  # an engine key's first call, its second


def both_calls(fn):
    """{"eager": fn(), "graph": fn()}: an engine key's first call runs
    eagerly, its second captures the key's graph and replays it."""
    return {route: fn() for route in ROUTE_CALLS}


def phase_main_path():
    """The user's likelihood entry points on the card; returns the launch
    counts."""
    print("[4] likelihood path: UnrootedInstance on cuda vs goldens")
    shape_fd = shape_finite_difference()
    reset_counters()
    reset_graph_counts()
    for dtype in (torch.float64, torch.float32):
        tol = GOLDEN_TOL[dtype]
        tag = str(dtype)[6:]
        jc = lt.PhyloModelSpec("JC69", "constant", "strict")
        inst = instance("DS1.subsampled_10.t", "DS1.fasta", jc, dtype)
        for route, lls in both_calls(inst.log_likelihoods).items():
            close(f"DS1 LLs vs pybeagle, {tag}, {route} call", lls,
                  PYBEAGLE_LIKELIHOODS, tol["ll"])
        for route, grads in both_calls(inst.phylo_gradients).items():
            g = grads["branch_lengths"]
            if (g.device.type != torch.device(DEV).type
                    or g.shape != (10, 51)):
                raise AssertionError(f"gradients on {g.device}, shape "
                                     f"{g.shape}")
            close(f"DS1 LLs of phylo_gradients, {tag}, {route} call",
                  grads["log_likelihood"].cpu(), PYBEAGLE_LIKELIHOODS,
                  tol["ll"])
            mine = np.sort(np.concatenate([g[-1].cpu().numpy(), [0.0, 0.0]]))
            close(f"DS1 last-tree gradient vs physher, {tag}, {route} call",
                  mine, PHYSHER_GRADIENTS, tol["grad"])
        wb = lt.PhyloModelSpec("JC69", "weibull+4", "strict")
        inst = instance("DS1.subsampled_10.t", "DS1.fasta", wb, dtype)
        inst.phylo_model_params["site"]["shape"] = torch.tensor(
            0.1, dtype=torch.float64, device=DEV)
        for route, lls in both_calls(inst.log_likelihoods).items():
            close(f"DS1 Weibull+4 LLs vs physher, {tag}, {route} call", lls,
                  PHYSHER_WEIBULL_LIKELIHOODS, tol["ll"])
        for route, grads in both_calls(inst.phylo_gradients).items():
            shape_grad = grads["site_model"]
            if (shape_grad.device.type != torch.device(DEV).type
                    or shape_grad.shape != (10,)):
                raise AssertionError(f"shape gradient on {shape_grad.device}"
                                     f", shape {tuple(shape_grad.shape)}")
            close(f"DS1 Weibull+4 edge-0 gradients vs physher, {tag}, "
                  f"{route} call", grads["branch_lengths"][:, 0].cpu(),
                  PHYSHER_WEIBULL_GRADIENTS_BL0, tol["grad"])
            close(f"DS1 Weibull+4 shape gradient vs f64 finite difference, "
                  f"{tag}, {route} call", shape_grad.cpu(), shape_fd,
                  tol["shape"])
        inst = instance("hello.nwk", "hello.fasta", jc, dtype)
        for route, lls in both_calls(inst.log_likelihoods).items():
            close(f"hello LL, {tag}, {route} call", lls, [HELLO_LL],
                  tol["hello"])
    # Each of the five calls a dtype (DS1 log_likelihoods and
    # phylo_gradients, JC69 and Weibull+4, and hello's LL) is made twice:
    # its key's first call runs eagerly, its second is a capture and one
    # replay (its kernels launch twice then, in the warm-up and the replay).
    graph_path_counts("likelihood path", 10, 10)
    return launch_counts("likelihood path",
                         ["ll_grad_jc69", "ll_jc69", "ll_dea_jc69"])


def graph_path_counts(path, captures, replays, rooted=False):
    """Fail unless the path's engine calls were ``replays`` replays of
    ``captures`` captured graphs (the unrooted engine's, or the rooted
    one's): its goldens held through the graph route."""
    got = graph_counts()[1 if rooted else 0]
    if got != {"captures": captures, "replays": replays}:
        raise AssertionError(f"{path}: graphs {got}, not {captures} "
                             f"captures and {replays} replays")
    print(f"  {path}: the goldens held through {replays} replays of "
          f"{captures} captured {'rooted' if rooted else 'unrooted'} "
          "engine graphs")


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
    reset_graph_counts()
    for dtype in (torch.float64, torch.float32):
        tol = GOLDEN_TOL[dtype]
        tag = str(dtype)[6:]
        inst = gtr_instance(dtype)
        for route, lls in both_calls(inst.log_likelihoods).items():
            close(f"GTR LLs, {tag}, {route} call", lls, GTR_LIKELIHOODS,
                  tol["ll"])
        for route, grads in both_calls(inst.phylo_gradients).items():
            shapes = {k: tuple(v.shape) for k, v in grads.items()}
            want = {"log_likelihood": (100,), "branch_lengths": (100, 51),
                    "substitution_model": (100, 8), "site_model": (100,)}
            if shapes != want or any(v.device.type != torch.device(DEV).type
                                     for v in grads.values()):
                raise AssertionError(f"phylo_gradients: {shapes}")
            what = f"{tag}, {route} call"
            close(f"GTR LLs of phylo_gradients, {what}",
                  grads["log_likelihood"].cpu(), GTR_LIKELIHOODS, tol["ll"])
            close(f"GTR edge-0 gradients, {what}",
                  grads["branch_lengths"][:, 0].cpu(), GTR_GRADIENTS_BL0,
                  tol["grad"])
            close(f"GTR substitution gradients (10 trees), {what}",
                  grads["substitution_model"][:10].cpu(),
                  GTR_SUBSTITUTION_GRADIENTS, tol["grad"])
            close(f"GTR shape gradients (10 trees), {what}",
                  grads["site_model"][:10].cpu(), GTR_SITE_GRADIENTS,
                  tol["grad"])
    # log_likelihoods and phylo_gradients a dtype, each made twice: an eager
    # first call, then a capture and one replay.
    graph_path_counts("GTR path", 4, 4)
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


def host_and_device(fn, calls, evals=None):
    """(line, peak GiB) for an entry point called from the host: the median
    and least host-clock ms of ``calls`` synchronised calls after two
    warm-ups, with the peak device memory over them (and, given ``evals``
    evaluations a call, evals / median per second); then, over ``calls``
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
    rate = "" if evals is None else f", {evals / med * 1e3:.1f} evals/s"
    return (f"median {med:.3f} ms (min {min(times):.3f}, {calls} calls, host "
            f"clock, synchronised{rate}); {device} (torch.profiler, {calls} "
            "more calls)"), peak


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


def bound(ops, inputs, outputs, f64=None):
    """(ms, "operations" or "bytes"): the least time of the work on this
    card, the larger of its operations at the peak of the type it computes
    in (f64; by default float64's when an output is float64, else
    float32's) and its inputs read once and outputs written once at the
    HBM rate."""
    if f64 is None:
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
        em, rates, props = kernel_inputs(d, torch.float32, K)
        a1 = (d["pc"], em, rates, props, d["tips"], d["w"])
        a2 = (d["pc"], em, props, d["tips"], d["w"])
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
    trees, perturbed lengths, f32; eagerly (cuda_graphs=False, the records'
    route), then by the graph route ([16] holds the two to each other)."""
    sp, sched, bl = headline_batch()
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    params = default_parameters(spec, device=DEV)
    for route in ("eager", "graph"):
        engine = LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV,
                                  cuda_graphs=route == "graph")
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
            print(f"  engine.{name} from host arrays, B = {B}, {route}: "
                  f"median {statistics.median(times):.3f} ms (min "
                  f"{min(times):.3f}, {calls} calls, host clock, "
                  f"synchronised; {smi})")


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
    params = card_params(spec, BENCH_SHAPE)
    # Eagerly (cuda_graphs=False, the records' route), then by the graph
    # route ([16] holds the two to each other).
    for route in ("eager", "graph"):
        engine = LikelihoodEngine(d["sp"], spec, dtype=dt, device=DEV,
                                  cuda_graphs=route == "graph")
        for name, fn in (("log_likelihoods", engine.log_likelihoods),
                         ("phylo_gradients", engine.phylo_gradients)):
            line, peak = host_and_device(
                lambda fn=fn: fn(d["sched"], d["bl_host"], params), calls)
            print(f"  engine.{name} from host arrays, {route}: {line}; peak "
                  f"{peak:.2f} GiB")
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


def gp_instance(fasta, newick_file, dtype, use_kernels="auto",
                cuda_graphs=True):
    """GPInstance on the card; "auto" is the kernel route there."""
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{newick_file}")
    inst.make_engine(dtype=dtype, device=DEV, use_kernels=use_kernels,
                     cuda_graphs=cuda_graphs)
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
    with tempfile.TemporaryDirectory() as tmp:
        streamed = {"host RAM": gp_streamed_fit(torch.float64),
                    "np.memmap": gp_streamed_fit(torch.float64, tmp)}
        if os.listdir(tmp):
            raise AssertionError(f"the streamed ascent left {os.listdir(tmp)}")
    f32 = gp_streamed_fit(torch.float32)
    launches = launch_counts("GP path", ["populate_plvs", "golden_sweep"],
                             ["populate_plvs_slab", "golden_sweep_slab"])
    level = gp_fit(torch.float64, use_kernels=False)
    for where, (marginal, _) in streamed.items():
        close(f"fluA streamed fit ({where}) vs the card's in-memory level-"
              "route fit, f64", marginal, level, (0.0, GP_FLUA_TOL[torch.float64]))
    # K7 on the last chunk's own inputs (38 patterns and 62 copies of the
    # last) at the fitted lengths, against its twin.
    for dtype, eng in ((torch.float64, streamed["host RAM"][1]),
                       (torch.float32, f32[1])):
        k7_vs_twin(eng._edge_streams(), eng._tensor(eng.q),
                   _jc69_transition(eng._tensor(eng.branch_lengths)).contiguous(),
                   gp_chunk_tips(eng, -1), dtype,
                   f"fluA last streamed chunk (S = {GP_CHUNK}) "
                   f"{str(dtype)[6:]}", "populate_plvs")
    return launches


def gp_chunk_tips(eng, c):
    """The tips (L, 4, GP_CHUNK) of chunk c of the streamed ascent on the
    engine's device: the last chunk padded with copies of the last
    pattern, as the engine pads it."""
    tips = np.asarray(eng.tips)
    pad = -tips.shape[-1] % GP_CHUNK
    tips = np.pad(tips, ((0, 0), (0, 0), (0, pad)), mode="edge")
    chunks = np.split(tips, tips.shape[-1] // GP_CHUNK, axis=-1)
    return eng._tensor(np.ascontiguousarray(chunks[c]))


def gp_streamed_fit(dtype, memmap_dir=None, tol=1e-6, max_iter=100):
    """run_branch_ascent_streamed(tol, max_iter, GP_CHUNK) on fluA on the
    kernel route by its chunk programs' graphs, its A and B in host RAM or
    under ``memmap_dir``, against libsbn_tpu's optimum; fails unless every
    chunk of every statistics refresh, the statistics graph's capture
    warm-up and finalize's full-width populate launched K7 and K8 did not
    launch. Returns (marginal, engine)."""
    eng = gp_instance("fluA.fa", "fluA.tree", dtype).get_engine()
    before = dict(engine_kernels.LAUNCHES)
    t0 = time.perf_counter()
    marginal, sweeps = eng.run_branch_ascent_streamed(
        tol, max_iter, GP_CHUNK, memmap_dir=memmap_dir)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    added = {k: v - before[k] for k, v in engine_kernels.LAUNCHES.items()}
    chunks = -(-eng.patterns // GP_CHUNK)
    # Less finalize's full-width populate and the capture warm-up of the
    # statistics program's graph (gp/streamed_graph.py, the default).
    k7 = added["populate_plvs"] - 2
    if (k7 < chunks * (sweeps + 1) or k7 % chunks
            or added["golden_sweep"] or added["golden_sweep_slab"]
            or added["populate_plvs_slab"]):
        raise AssertionError(f"streamed fit: launches {added} for {chunks} "
                             f"chunks and {sweeps} sweeps")
    where = "host RAM" if memmap_dir is None else "np.memmap"
    close(f"fluA streamed fit ({tol}, {max_iter}, pattern_chunk={GP_CHUNK}), "
          f"A and B in {where}, {str(dtype)[6:]} ({sweeps} sweeps, "
          f"{k7 // chunks} statistics refreshes of {chunks} chunks, "
          f"{seconds:.2f} s)", marginal, GP_FLUA, (0.0, GP_FLUA_TOL[dtype]))
    return marginal, eng


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
        # The eager loop, as before the graphs; [15] times both.
        eng = gp_instance("fluA.fa", "fluA.tree", torch.float32,
                          use_kernels, cuda_graphs=False).get_engine()
        bl0 = eng.branch_lengths.copy()

        def ascent(eng=eng, bl0=bl0):
            eng.branch_lengths = bl0.copy()
            return eng.run_branch_ascent(1e-2, 10)

        line, _ = host_and_device(ascent, runs)
        marginal, sweeps = ascent()
        route = ("kernel route (K7 + K8)" if use_kernels
                 else "level route") + ", eager"
        print(f"  run_branch_ascent(1e-2, 10), {route}, per ascent: {line}; "
              f"{sweeps} sweeps, marginal {marginal:.6f}")
    for graphs in (True, False):
        eng = gp_instance("fluA.fa", "fluA.tree", torch.float32,
                          cuda_graphs=graphs).get_engine()
        bl0 = eng.branch_lengths.copy()

        def streamed(eng=eng, bl0=bl0):
            eng.branch_lengths = bl0.copy()
            return eng.run_branch_ascent_streamed(1e-2, 10, GP_CHUNK)

        line, _ = host_and_device(streamed, runs)
        marginal, sweeps = streamed()
        route = "chunk programs' graphs" if graphs else "eager"
        print(f"  run_branch_ascent_streamed(1e-2, 10, {GP_CHUNK}), kernel "
              f"route (K7 per chunk, Newton on the host), {route}, per "
              f"ascent: {line}; {sweeps} sweeps, marginal {marginal:.6f}")
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
    return {"pc": a["pc"], "bl": eng._bl_padded2((bl * a["rates"]).to(
                eng.dtype)),
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
    reset_graph_counts()
    f64, tol = torch.float64, ROOTED_TOL
    inst = rooted_instance(lt.PhyloModelSpec("JC69", "constant", "strict"), f64)
    jc_cases = [(rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4]), f64, 1,
                 "rooted fluA, float64 K=1")]
    parts = both_calls(
        lambda: inst.engine.rooted_log_likelihoods(*rooted_args(inst), True))
    for route, (lls, ldjs) in parts.items():
        close(f"fluA rooted LL vs physher, {route} call", lls.cpu(),
              [PHYSHER_LL], tol["ll"])
        close(f"fluA log-det-Jacobian vs physher, {route} call", ldjs.cpu(),
              [PHYSHER_JACOBIAN], tol["ll"])
    close("fluA log_likelihoods() = LL + ldj", inst.log_likelihoods(),
          [PHYSHER_LL + PHYSHER_JACOBIAN], tol["ll"])
    for route, g in both_calls(inst.phylo_gradients).items():
        r = g["ratios_root_height"]
        if r.device.type != torch.device(DEV).type or r.shape != (1, 68):
            raise AssertionError(f"ratio gradients on {r.device}, shape "
                                 f"{r.shape}")
        close(f"fluA LL of phylo_gradients vs physher, {route} call",
              g["log_likelihood"].cpu(), [PHYSHER_LL], tol["ll"])
        close(f"fluA ratio and root-height gradients vs physher, {route} "
              "call", r[0].cpu(), PHYSHER_RATIO_GRADIENTS, tol["grad"])
        close(f"fluA clock gradient vs f64 central difference, {route} call",
              g["clock_model"][0].cpu(), [clock_fd], tol["clock"])
    inst = rooted_instance(lt.PhyloModelSpec("JC69", "weibull+4", "strict"),
                           f64)
    inst.phylo_model_params["site"]["shape"] = torch.tensor(
        0.1, dtype=f64, device=DEV)
    jc_cases.append((rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4]),
                     f64, 4, "rooted fluA, float64 Weibull+4 at shape 0.1"))
    # f64 K = 4 on fluA takes K1-K3's slab routes: these keys stay eager.
    parts = both_calls(
        lambda: inst.engine.rooted_log_likelihoods(*rooted_args(inst), True))
    for route, (lls, _) in parts.items():
        close(f"fluA Weibull+4 LL vs physher, {route} call", lls.cpu(),
              [ROOTED_WEIBULL_LL], tol["ll"])
    for route, g in both_calls(inst.phylo_gradients).items():
        close(f"fluA Weibull+4 shape gradient vs physher, {route} call",
              g["site_model"].cpu(), [ROOTED_WEIBULL_SHAPE_GRADIENT],
              tol["shape"])
    inst = rooted_instance(lt.PhyloModelSpec("GTR", "constant", "strict"), f64)
    inst.phylo_model_params["substitution"] = {
        "rates": torch.tensor(ROOTED_GTR_RATES, dtype=f64, device=DEV),
        "frequencies": torch.tensor(ROOTED_GTR_FREQS, dtype=f64, device=DEV),
    }
    gtr_d = rooted_kernel_inputs(inst.engine, *rooted_args(inst)[:4])
    parts = both_calls(
        lambda: inst.engine.rooted_log_likelihoods(*rooted_args(inst), True))
    for route, (lls, ldjs) in parts.items():
        close(f"fluA GTR LL vs phylotorch, {route} call", lls.cpu(),
              [ROOTED_GTR_LL], tol["gtr"])
        close(f"fluA GTR log-det-Jacobian, {route} call", ldjs.cpu(),
              [PHYSHER_JACOBIAN], tol["ll"])
    for route, g in both_calls(inst.phylo_gradients).items():
        close(f"fluA GTR LL of phylo_gradients vs phylotorch, {route} call",
              g["log_likelihood"].cpu(), [ROOTED_GTR_LL], tol["gtr"])
        close(f"fluA GTR substitution gradients vs phylotorch, {route} call",
              g["substitution_model"][0].cpu(), ROOTED_GTR_GRADIENTS,
              tol["gtr"])
    # The f64 goldens' calls, each made twice (an eager first call, then a
    # capture and one replay) and JC69's LLs a third time (a replay):
    # JC69 rooted_log_likelihoods and phylo_gradients (the hand route), GTR
    # rooted_log_likelihoods and phylo_gradients (the autograd route); the
    # Weibull+4 keys run K1-K3's slab routes and stay eager.
    graph_path_counts("rooted path (f64 goldens)", 4, 5, rooted=True)
    jc_cases += rooted_routes_f32()
    launches = launch_counts("rooted path", ["ll_grad_jc69", "ll_jc69",
                                             "ll_dea_jc69", "ll_generic",
                                             "ll_dp_generic", "forward",
                                             "adjoint"],
                             ["forward_slab", "adjoint_slab"])
    errs = rooted_kernels_vs_twins(jc_cases, gtr_d)
    for dtype in (torch.float64, torch.float32):  # the f32 errors kept
        errs.update(heights_vs_twins(dtype))
    return launches, errs


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


def rooted_heights_inputs():
    """H1's and H2's inputs on flua_rooted_gradients' batch, as the hand
    route passes them: (ratios, bounds, rates) float64, parent and
    post_children int32 on the card, the leaf count and the engine's
    sweep count; and K1's branch gradient stand-in, (B, N + 1) normal
    values from default_rng(5), of which H2 reads the first N - 1
    columns as it reads K1's output."""
    _, sched, bounds, ratios, rates = rooted_batch()

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=DEV)

    tree = (dev(ratios), dev(bounds), dev(rates))
    parent, pc = (dev(getattr(sched, k)).to(torch.int32) for k in (
        "parent", "post_children"))
    n_iters = LikelihoodEngine._height_iters(None, sched)
    g = np.random.default_rng(5).normal(size=(B_ROOTED, sched.node_count + 1))
    return tree, parent, pc, sched.leaf_count, n_iters, dev(g)


def heights_vs_twins(dtype):
    """H1 (forward_cuda) and H2 (adjoint_cuda, strict clock) on
    flua_rooted_gradients' inputs at dtype against their twins
    (forward_plain, adjoint_plain) on the card, bit for bit, each launched
    once on its shared-memory route with the counters at 0 just before.
    Returns {"forward": max abs error, "adjoint": max abs error}."""
    tree, parent, pc, L, n_iters, g = rooted_heights_inputs()
    n = tree[1].shape[1]
    grad = g.to(dtype)[:, :n - 1]
    reset_counters()
    h, op = heights.forward_cuda(*tree, parent, L, n_iters, dtype)
    got = heights.adjoint_cuda(grad, h, *tree, pc, parent, L, n_iters, True)
    torch.cuda.synchronize()
    launched = {k: v for k, v in heights.LAUNCHES.items() if v}
    if launched != {"forward": 1, "adjoint": 1}:
        raise AssertionError(f"H1/H2 launches {launched}, not one each")
    want_h, want_op = heights.forward_plain(*tree, parent, L, n_iters, dtype)
    want = heights.adjoint_plain(grad, h, *tree, pc, parent, L, n_iters,
                                 True)
    tag = f"rooted fluA x {B_ROOTED}, {str(dtype)[6:]}"
    bit_for_bit(f"H1 vs its twin, {tag} (heights, K1's operand)",
                [h, op], [want_h, want_op])
    bit_for_bit(f"H2 vs its twin, {tag} (ratio and clock gradients)",
                list(got), list(want))
    reset_counters()
    return {"forward": 0.0, "adjoint": 0.0}


def heights_ops(kernel, B, L, N, n_iters):
    """float64 operations of H1 ("forward") or H2 ("adjoint", strict
    clock) on B trees, counted from csrc/heights.cu: one per add,
    subtract, multiply or divide. H1: three a sweep at each internal node
    and the root, two a branch for K1's operand. H2: a branch's g rates
    and g (h[p] - h), two a Jacobian term, six a slot for g_h, six a slot
    each adjoint sweep, two a ratio gradient, one add a branch for the
    clock's sum."""
    n1, R = N + 1, N - L
    if kernel == "forward":
        return B * (3 * n_iters * R + 2 * (N - 1))
    return B * (3 * (N - 1) + 2 * (R - 1) + 6 * n1 + 6 * n_iters * n1
                + 2 * (R - 1) + (N - 1))


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
    """flua_rooted_gradients at float32: K1, H1 and H2 timed beside their
    twins on the rooted batch (phase 10 held each to its twin), with their
    bounds; the entry points from host arrays. Returns {key: ((ms, twin
    ms), (bound ms, bound_by))} of K1 ("ll_grad_jc69"), H1 ("forward") and
    H2 ("adjoint") on this batch."""
    print(f"  flua_rooted_gradients timing: fluA x {B_ROOTED}, JC69, float32 "
          f"({smi})")
    sp, sched, bounds, ratios, rates = rooted_batch()
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    args = (sched, bounds, ratios, rates, default_parameters(spec, device=DEV))
    # The eager calls, as before the graphs; [15] times both.
    eng = LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV,
                           cuda_graphs=False)
    # K1 on the rooted batch's rate-scaled branch lengths.
    d = rooted_kernel_inputs(eng, *args[:4])
    em, one, _ = kernel_inputs(d, torch.float32, 1)
    a1 = (d["pc"], em, one, one, d["tips"], d["w"])
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
    out = {"ll_grad_jc69": (times, b)}
    # H1 and H2 on the batch's inputs, H2 from a strict clock; both
    # compute in float64 whatever the working dtype.
    tree, parent, pc, L, n_iters, g = rooted_heights_inputs()
    f32, N = torch.float32, tree[1].shape[1]
    grad = g.to(f32)[:, :N - 1]
    fwd = (*tree, parent, L, n_iters, f32)
    h, op = heights.forward_cuda(*fwd)
    adj = (grad, h, *tree, pc, parent, L, n_iters, True)
    got = heights.adjoint_cuda(*adj)
    h_times = time_pairs({
        "heights_forward (H1, rooted fluA)": (
            lambda: heights.forward_cuda(*fwd),
            lambda: heights.forward_plain(*fwd)),
        "heights_adjoint (H2, rooted fluA)": (
            lambda: heights.adjoint_cuda(*adj),
            lambda: heights.adjoint_plain(*adj))}, B_ROOTED,
        plain_reps=(5, 5))
    for kernel, ms, inputs, outputs in (
            ("forward", h_times["heights_forward (H1, rooted fluA)"],
             (tree, parent), (h, op)),
            ("adjoint", h_times["heights_adjoint (H2, rooted fluA)"],
             (grad, h, tree, pc, parent), got)):
        hb = bound(heights_ops(kernel, B_ROOTED, L, N, n_iters), inputs,
                   outputs, f64=True)
        print(f"  H{1 + (kernel == 'adjoint')} ({kernel}), rooted fluA "
              f"batch: bound {hb[0]:.5f} ms ({hb[1]}), {hb[0] / ms[0]:.2%} "
              "of it")
        out[kernel] = (ms, hb)
    entries = (
        ("rooted_phylo_gradients (hand route: H1, K1, H2)",
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
    return out


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


EM_CASES = ((0.0, 23), (0.5, 100))  # (alpha, iterations)
VIP_RUNS = (  # (tag, model, branch model, steps)
    ("JC69 split", ("JC69", "constant", "strict"), "split", VIP_STEPS),
    ("GTR + Weibull+4 split", ("GTR", "weibull+4", "strict"), "split", 2),
    ("JC69 psp", ("JC69", "constant", "strict"), "psp", 2),
)


def em_instance():
    inst = lt.UnrootedInstance("charlie")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    return inst


def em_runs(device, cuda_graphs=True):
    """EM(0, 23) and EM(0.5, 100) on DS1.100_topologies on ``device`` (on
    the card by the step's graph unless ``cuda_graphs`` is False):
    {(alpha, iterations): (scores, parameters, probabilities, seconds)}."""
    inst = em_instance()
    out = {}
    for alpha, iters in EM_CASES:
        t0 = time.perf_counter()
        scores = inst.train_expectation_maximization(
            alpha, iters, device=device, cuda_graphs=cuda_graphs)
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
    # (c) The Burrito on the card: a step's branch_gradients and its ELBO's
    # log_likelihoods are one key each for every step: the first step runs
    # them eagerly, the second captures their graphs, later steps replay
    # them, so each kernel launches once a step and once more for the
    # warm-up before its graph's capture.
    burros = {}
    for tag, spec, bm, steps in VIP_RUNS:
        jc = spec[0] == "JC69"
        want = ({"ll_grad_jc69": steps + 1, "ll_jc69": steps + 1} if jc
                else {"ll_grad_generic": steps + 1, "ll_generic": steps + 1})
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
            # A step's two graphs as in (c): their warm-ups add one K1 and
            # one K2; the final ELBO's B = 10,000 call is a key of its own,
            # called once: eagerly, one K2 and no graph.
            {"ll_grad_jc69": VIP_FIXED_STEPS + 1,
             "ll_jc69": VIP_FIXED_STEPS + 1 + 1})
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
    em, _, one = kernel_inputs(d, dt, 1)
    a2 = (d["pc"], em, one, d["tips"], d["w"])
    n = K2_TWIN_ROWS
    rows = (d["pc"][:n].contiguous(), em[:n].contiguous(), one, d["tips"],
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

FOREST_R = 8  # length sets a call (bench.py config_forest)
FOREST_SAMPLED = 1000  # trees of the SBN-sampled support
FOREST_PER_TREE_REL = 1e-9  # the f64 forest against the per-tree K1 engine
# The f32 forest with bf16 gathers against the f64 forest: the bench's
# gate (bench.py:683-692), (rtol, atol).
FOREST_GATE = {"ll": (1e-5, 0.5), "grad": (2e-2, 0.5)}
FOREST_ASCENT_STEPS = 20


def forest_ds1_100():
    """DS1.100_topologies (polished) and DS1: (topologies, their forest,
    build seconds, the (T, N-1) split id of each tree's edges, the
    per-split mean lengths, the site pattern)."""
    tops, bls, ttm = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    for t in tops:
        t.polish()
    t0 = time.perf_counter()
    fs = forest.build_forest(tops)
    build_s = time.perf_counter() - t0
    split_ids = np.zeros((len(tops), fs.node_count - 1), np.int64)
    for ti, top in enumerate(tops):
        for node in top.postorder():
            if node.id != top.id:
                split_ids[ti, node.id] = fs.split_of_clade[
                    forest._clade_mask(node)]
    # Split-keyed lengths: the per-split mean of the observed lengths
    # (HotStartBranchLengths, gp_engine.cpp:363-394).
    observed = np.stack(bls)[:, :fs.node_count - 1]
    sums, counts = np.zeros(fs.n_splits), np.zeros(fs.n_splits)
    np.add.at(sums, split_ids, observed)
    np.add.at(counts, split_ids, 1)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    return tops, fs, build_s, split_ids, sums / np.maximum(counts, 1), sp


def forest_per_tree(tops, split_ids, bl_sets, sp):
    """(lls (R, T), grads (R, T, N-1)) of every tree under each length set
    through the port's per-tree engine on the card: LikelihoodEngine
    branch_gradients, JC69, float64 (K1 on R T trees, by the engine's
    graph: a launch in its capture's warm-up and one in the replay)."""
    R, T = bl_sets.shape[0], len(tops)
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    engine = LikelihoodEngine(sp, spec, dtype=torch.float64, device=DEV)
    bl = np.zeros((R, T, split_ids.shape[1] + 1))
    bl[:, :, :-1] = bl_sets[:, split_ids]
    lls, grads = engine.branch_gradients(
        schedule.schedules_of_topologies(tops * R), bl.reshape(R * T, -1),
        default_parameters(spec, device=DEV))
    return (lls.reshape(R, T).cpu().numpy(),
            grads.reshape(R, T, -1).cpu().numpy())


# The forest surfaces a graph replays: (forest_graph surface, gather dtype,
# name in the timings).
FOREST_SURFACES = (
    ("ll", None, "ll_only"),
    ("grad", torch.bfloat16,
     "full path (LL + per-tree gradients, bf16 gathers)"),
    ("split", None, "split gradient"),
)


def forest_graph_checks(tag, fs, bl, bl_new, tips, w, graphs, dtype):
    """Every forest surface at ``dtype``: two eager calls equal bit for bit;
    then the graph route's first call (eager), second (a capture and its
    replay) and third (a replay), each equal to the eager call bit for
    bit, and a replay with the lengths ``bl_new`` equal to an eager call
    on them; one capture and three replays a surface."""
    for surface, gd, what in FOREST_SURFACES:
        def eager(b):
            return forest_graph.eager(surface, fs, b, tips, w, dtype, gd)

        want = eager(bl)
        if not forest_graph.bit_for_bit(want, eager(bl)):
            raise AssertionError(f"forest {what} ({tag}, {dtype}): two eager "
                                 "calls differ")
        before = dict(forest_graph.COUNTS)
        for call in ("eager", "capture", "replay"):
            if not forest_graph.bit_for_bit(
                    graphs.run(surface, fs, bl, dtype, gd), want):
                raise AssertionError(f"forest {what} ({tag}, {dtype}): the "
                                     f"graph route's {call} call differs")
        want_new = eager(bl_new)
        if not forest_graph.bit_for_bit(
                graphs.run(surface, fs, bl_new, dtype, gd), want_new):
            raise AssertionError(f"forest {what} ({tag}, {dtype}): a replay "
                                 "with new lengths differs")
        counts = {k: forest_graph.COUNTS[k] - before[k] for k in before}
        if counts != {"captures": 1, "replays": 3, "eager": 1}:
            raise AssertionError(f"forest {what} ({tag}): graph counts "
                                 f"{counts}")
    print(f"  ok  forest graphs, {tag}, {str(dtype)[6:]}: every surface "
          "equal to its eager call bit for bit (two eager calls equal; the "
          "graph's eager call, capture, replay and a replay with new "
          "lengths)")


def time_forest_surfaces(fs, bl, tips, w, graphs, calls, evals):
    """Each surface at f32 by its graph and eagerly: host_and_device's
    line and peak memory."""
    for surface, gd, what in FOREST_SURFACES:
        for route, fn in (
                ("graph", lambda: graphs.run(surface, fs, bl, torch.float32,
                                             gd)),
                ("eager", lambda: forest_graph.eager(surface, fs, bl, tips,
                                                     w, torch.float32, gd))):
            line, peak = host_and_device(fn, calls, evals=evals)
            print(f"    {what}, {route}: {line}; peak {peak:.3f} GiB")


def phase_forest(smi, calls=10):
    """[12] Forest mode on the card: DS1.100_topologies under R = 8
    split-keyed length sets, U(0.8, 1.2) from default_rng(0) times the
    per-split means, as the JAX bench's forest_shared_ds1_100; correctness
    against the per-tree engine (K1) and the bench's gate, every surface's
    graph against its eager call bit for bit, then timings of both routes,
    then the same on the SBN-sampled 1,000-tree support. The forest runs
    torch ops and no kernel of this package: the counters show no launch
    and no twin."""
    print("[12] forest: DS1.100_topologies, split-keyed lengths, R = "
          f"{FOREST_R}, on cuda")
    t_phase = time.perf_counter()
    tops, fs, build_s, split_ids, means, sp = forest_ds1_100()
    T = len(tops)
    rng = np.random.default_rng(0)
    bl_sets = (means[None, :] * rng.uniform(0.8, 1.2, (FOREST_R, fs.n_splits))
               ).astype(np.float32)
    print(f"  build_forest: {build_s:.3f} s (host); forest_stats "
          f"{forest.forest_stats(fs)}")
    # The per-tree reference, before the path's counters are set to 0.
    ref_ll, ref_g = forest_per_tree(tops, split_ids, bl_sets.astype(np.float64),
                                    sp)

    def dev(a, dt):
        return torch.as_tensor(np.asarray(a), device=DEV).to(dt)

    f64, f32 = torch.float64, torch.float32
    tips64, w64, bl64 = (dev(x, f64) for x in (sp.tip_partials(), sp.weights,
                                               bl_sets))
    tips32, w32, bl32 = (dev(x, f32) for x in (sp.tip_partials(), sp.weights,
                                               bl_sets))
    reset_counters()
    pruning.reset_counters()
    ll64, g64 = forest.forest_jc_log_likelihoods_and_gradients(
        fs, bl64, tips64, w64, dtype=f64)
    rel_close("forest LLs, f64, vs the per-tree engine (K1)", ll64.cpu(),
              ref_ll, FOREST_PER_TREE_REL)
    rel_close("forest gradients, f64, vs the per-tree engine (K1)", g64.cpu(),
              ref_g, FOREST_PER_TREE_REL)
    ll32, g32 = forest.forest_jc_log_likelihoods_and_gradients(
        fs, bl32, tips32, w32, gather_dtype=torch.bfloat16)
    # The bench holds the first length set to its gate; the others are
    # reported: bf16 rounding of near-uniform partials (lengths near 1)
    # leaves a few entries of some sets outside it, in libsbn_tpu too.
    close("forest LLs of the first length set, f32 with bf16 gathers, vs "
          "f64 (bench gate)", ll32[0].cpu(), ll64[0].cpu(), FOREST_GATE["ll"])
    close("forest gradients of the first length set, f32 with bf16 gathers, "
          "vs f64 (bench gate)", g32[0].cpu(), g64[0].cpu(),
          FOREST_GATE["grad"])
    g64_cpu, g32_cpu = (g.double().cpu().numpy() for g in (g64, g32))
    gap = np.abs(g32_cpu - g64_cpu)
    rtol, atol = FOREST_GATE["grad"]
    outside = (gap > atol + rtol * np.abs(g64_cpu)).sum(axis=(1, 2))
    ll_gap = np.abs(ll32.double().cpu().numpy() - ll64.cpu().numpy())
    print("      every set, bf16 gathers: largest relative gradient error per "
          f"set {np.round(np.max(gap / np.abs(g64_cpu), axis=(1, 2)), 5)}, "
          f"entries outside the gradient gate per set {outside} of "
          f"{g64_cpu[0].size}; largest LL gap {ll_gap.max():.3e}")
    split = [forest.forest_jc_weighted_ll_and_split_gradient(
        fs, bl64, tips64, w64, dtype=f64) for _ in range(2)]
    want = np.zeros((FOREST_R, fs.n_splits))
    for r in range(FOREST_R):
        np.add.at(want[r], split_ids, ref_g[r])
    rel_close("split gradient, f64, vs the per-tree gradients summed onto "
              "splits", split[0][1].cpu(), want, FOREST_PER_TREE_REL)
    if not (torch.equal(split[0][0], split[1][0])
            and torch.equal(split[0][1], split[1][1])):
        raise AssertionError("the split gradient differs between two runs")
    print("  ok  split gradient: a second run equal bit for bit")
    _, _, trace = forest.forest_branch_ascent(
        fs, means, tips32, w32, steps=FOREST_ASCENT_STEPS)
    trace = trace.cpu().numpy()
    if not (np.all(np.isfinite(trace)) and trace[-1] > trace[0]):
        raise AssertionError(f"forest_branch_ascent trace {trace}")
    print(f"  ok  forest_branch_ascent, {FOREST_ASCENT_STEPS} Adam steps, "
          f"f32: objective {trace[0]:.4f} -> {trace[-1]:.4f}")

    graphs = {dt: forest_graph.ForestGraphs(t, w) for dt, t, w in (
        (f32, tips32, w32), (f64, tips64, w64))}
    new_bl = rng.uniform(0.8, 1.2, (FOREST_R, fs.n_splits)) * means[None, :]
    forest_graph_checks("DS1.100", fs, bl64, dev(new_bl, f64), tips64, w64,
                        graphs[f64], f64)
    forest_graph_checks("DS1.100", fs, bl32, dev(new_bl, f32), tips32, w32,
                        graphs[f32], f32)
    print(f"  timings, f32, R = {FOREST_R} x T = {T} ({smi}):")
    time_forest_surfaces(fs, bl32, tips32, w32, graphs[f32], calls,
                         FOREST_R * T)

    inst = lt.UnrootedInstance("forest-sampled")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.sample_trees(FOREST_SAMPLED)
    tops_s = [t.topology for t in inst.tree_collection.trees]
    t0 = time.perf_counter()
    fs_s = forest.build_forest(tops_s)
    build_s = time.perf_counter() - t0
    print(f"  SBN-sampled support: build_forest {build_s:.3f} s (host); "
          f"forest_stats {forest.forest_stats(fs_s)}")
    rng_s = np.random.default_rng(1)
    bl_s, bl_s_new = (dev(rng_s.uniform(0.02, 0.2, (
        FOREST_R, fs_s.n_splits)), f32) for _ in range(2))
    forest_graph_checks(f"{FOREST_SAMPLED} sampled trees", fs_s, bl_s,
                        bl_s_new, tips32, w32, graphs[f32], f32)
    print(f"  timings, f32, R = {FOREST_R} x T = {FOREST_SAMPLED} ({smi}):")
    time_forest_surfaces(fs_s, bl_s, tips32, w32, graphs[f32], calls,
                         FOREST_R * FOREST_SAMPLED)
    del graphs
    torch.cuda.synchronize()
    counts = vip_counts()
    print(f"  forest path: launches, twin and scan-engine calls {counts}")
    if any(counts.values()):
        raise AssertionError("the forest path ran a kernel, twin or the scan "
                             "engine")
    print(f"[12] took {time.perf_counter() - t_phase:.1f} s")


# [13] the parallel layer and the helpers.
DIST_STEPS = 3
RANK_TIMEOUT_S = 300
# A distributed f32 VBPI job against one process fed the ranks' samples,
# (rtol, atol): the f32 gates of BASELINE.md for the metrics (LLs rtol 1e-5,
# atol 0.5); for the parameters the gradient gate's rtol 2e-2 with atol
# 2 lr x steps, since Adam's first steps move an entry by about lr sign(g)
# and a summation-order difference can flip the sign of a gradient entry
# near zero.
DIST_F32_TOL = {"metrics": (1e-5, 0.5), "params": (2e-2, 2e-3 * DIST_STEPS)}
BASELINE_REL = 1e-10  # the native f64 baseline against the card's f64 K1


def spawn_ranks(tmp, tag, world, backend, extra):
    """Start ``world`` ranks of parallel/multihost_demo.py on the card with
    a file:// rendezvous under tmp; returns (processes, their .npz
    paths)."""
    env = dict(os.environ, LIBSBN_COORDINATOR=f"file://{tmp}/{tag}_store",
               LIBSBN_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        outs.append(os.path.join(tmp, f"{tag}_rank{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "libsbn_tpu_torch.parallel.multihost_demo",
             "--out", outs[-1], "--backend", backend, *extra],
            cwd=REPO, env=dict(env, LIBSBN_PROCESS_ID=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def collect_ranks(tag, procs, outs):
    """Wait for the ranks (RANK_TIMEOUT_S each), fail unless each exits 0
    with its MULTIHOST_OK line; returns their .npz contents."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0 or "MULTIHOST_OK" not in log:
            raise AssertionError(f"{tag}: a rank failed (rc {p.returncode}):"
                                 f"\n{log[-3000:]}")
        print("  " + next(l for l in log.splitlines() if "MULTIHOST_OK" in l))
    return [dict(np.load(o)) for o in outs]


def replay_ranks(ranks, dtype):
    """One process on the card fed the ranks' samples concatenated in rank
    order, DIST_STEPS vbpi_train_steps from the initial state; returns
    (metrics (steps, 2), state)."""
    jv = JitVBPI(bench_instance(DEV, dtype), particle_count=PARTICLES, seed=0,
                 dtype=dtype)
    for name, key in (("q_params", "init_q_params"),
                      ("sbn_params", "init_sbn_params")):
        if not np.array_equal(getattr(jv.state, name).cpu().numpy(),
                              ranks[0][key]):
            raise AssertionError(f"the ranks started from another {name}")
    state, metrics = jv.state, []
    for step in range(DIST_STEPS):
        ints = tuple(np.concatenate([r[k][step] for r in ranks])
                     for k in ("post_children", "branch_rep", "reps",
                               "touched"))
        eps = np.concatenate([r["eps"][step] for r in ranks])
        state, m = vbpi_train_step(
            state, jv.statics, jv.optimizer, *jv._device_put(ints, eps), 1.0,
            jv.tips, jv.weights, jv.segment_ids)
        metrics.append([float(m["mean_ll"]), float(m["elbo_like"])])
    return np.array(metrics), state


def check_ranks(tag, ranks, dtype):
    """The ranks' replicated state bit-identical, each rank's K1 launched
    once a step and no twin called, and the state within DIST_F32_TOL of
    one process fed their samples; returns the ranks' K1 launches."""
    for key in ("q_params", "sbn_params", "adam_q_mu", "adam_sbn_nu",
                "metrics"):
        if not all(np.array_equal(r[key], ranks[0][key]) for r in ranks):
            raise AssertionError(f"{tag}: {key} differs between the ranks")
    sums = [float(np.sum(r["sbn_params"], dtype=np.float64)) for r in ranks]
    print(f"  ok  {tag}: {len(ranks)} ranks ({ranks[0]['backend']}, "
          f"{ranks[0]['device']}) bit-identical; sbn_params checksums {sums}")
    k1 = 0
    for r in ranks:
        launches, twins = json.loads(str(r["launches"])), json.loads(
            str(r["twin_calls"]))
        if launches["ll_grad_jc69"] != DIST_STEPS or any(twins.values()):
            raise AssertionError(f"{tag}: rank launches {launches}, twin "
                                 f"calls {twins}")
        k1 += launches["ll_grad_jc69"]
    metrics, state = replay_ranks(ranks, dtype)
    close(f"{tag}: metrics vs one process on the ranks' samples",
          ranks[0]["metrics"], metrics, DIST_F32_TOL["metrics"])
    for name in ("q_params", "sbn_params"):
        close(f"{tag}: {name} vs one process on the ranks' samples",
              ranks[0][name], getattr(state, name).cpu(),
              DIST_F32_TOL["params"])
    return k1


def gp_sp_fit(dtype, sp):
    """run_branch_ascent(1e-2, 10) on fluA, from the default lengths:
    unsharded (sp = 0) or over sp shards of the card; (marginal, sweeps)."""
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    if sp:
        inst.make_engine(dtype=dtype, mesh=make_mesh(
            sp, dp=1, sp=sp, devices=[DEV] * sp))
    else:
        inst.make_engine(dtype=dtype, device=DEV)
    return inst.get_engine().run_branch_ascent(1e-2, 10)


def bitwise_or_close(name, got, want, tol):
    """Bit for bit, or else within tol with the largest difference printed
    (the per-tile partial sums of K1 and K4, torch.sum over a tile axis,
    may reduce in another order for another batch shape); returns the max
    abs error."""
    got, want = got.cpu(), want.cpu()
    if torch.equal(got, want):
        print(f"  ok  {name}: equal bit for bit")
        return 0.0
    err = close(name, got, want, tol)
    print(f"      (not bit for bit: largest difference {err:.3e})")
    return err


def headline_schedule():
    """The up-pass arrays of load_ds1's 512-tree batch, for the native
    baseline: (up_node, up_parent, up_sibs, leaf count)."""
    tops, _, _ = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sched = schedule.schedules_of_topologies(tops)
    reps = B // len(tops) + 1
    return (tuple(np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B]
                  for a in (sched.up_node, sched.up_parent, sched.up_sibs))
            + (sched.leaf_count,))


def baseline_evals_per_s(args):
    """bench.py's native_baseline_ll_grad (bench.py:222-240): evals/s of
    the f32 baseline on all cores, the best of four 1-second loops after a
    warm-up."""
    def run():
        return cpu_baseline.eval_batch(*args, threads=0, dtype_bits=32)
    run()
    best = 0.0
    for _ in range(4):
        t0, iters = time.time(), 0
        while time.time() - t0 < 1.0:
            run()
            iters += 1
        best = max(best, B * iters / (time.time() - t0))
    return best


def trace_one_k1():
    """device_trace around one K1 launch on the headline batch (f32): the
    trace's file name, the kernel names in it that contain
    jc69_ll_grad_kernel, and whether it holds the annotated span."""
    d = load_ds1(torch.float32)
    args = (d["pc"], pruning_jc.exp_complements(
        d["bl"], torch.ones(1, device=DEV), torch.float32),
        torch.ones(1, device=DEV), torch.ones(1, device=DEV), d["tips"],
        d["w"])
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.device_trace(logdir):
            with profiling.annotate("K1 launch"):
                pruning_jc.ll_grad_jc69_cuda(*args, root_id=d["root_id"])
        (trace,) = os.listdir(logdir)
        with open(os.path.join(logdir, trace)) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    return (trace, sorted({n for n in names if "jc69_ll_grad_kernel" in n}),
            "K1 launch" in names)


def host_cpu():
    with open("/proc/cpuinfo") as f:
        model = next((line.split(":", 1)[1].strip() for line in f
                      if line.startswith("model name")), "unknown")
    return f"{model}, {os.cpu_count()} logical cores"


def phase_parallel(smi):
    """[13] the parallel layer and the helpers on the one card; returns the
    launch counts of its path (the sharded K1 and K4 wrappers, the ranks'
    K1 launches and the GP fits on sp meshes)."""
    print("[13] parallel layer and helpers: dp wrappers over [cuda:0, "
          "cuda:0], distributed VBPI, GP on an sp mesh, profiling and the "
          "CPU baseline")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lsbn_ranks_")
    extra = ["--trees", f"{DATA}/DS1.subsampled_10.t", "--fasta",
             f"{DATA}/DS1.fasta", "--particles", str(PARTICLES), "--steps",
             str(DIST_STEPS), "--dtype", "float32"]
    print("  two ranks on one card take gloo: NCCL refuses two ranks on one "
          "GPU; the one-rank job takes nccl")
    jobs = {"gloo x 2": spawn_ranks(tmp, "gloo", 2, "gloo", extra),
            "nccl x 1": spawn_ranks(tmp, "nccl", 1, "nccl", extra)}
    # The trace runs in a process of its own: in this one, torch.profiler
    # has recorded the earlier phases, and a later small trace sometimes
    # lacks some or all of its device events (seen after [12]'s sessions).
    tracer = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.trace_one_k1()))"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    mesh = make_mesh(2, dp=2, devices=[DEV, DEV])
    d32, d64 = load_ds1(torch.float32), load_ds1(torch.float64)
    for d in (d32, d64):
        d["bl"][:, d["root_id"]:] = 0.0  # the root and ones slots
    dg = load_ds1_100(torch.float32)
    P, Qs, freqs, props = generic_inputs(
        dg, torch.float32, "weibull+4",
        rates6=substitution.DEFAULT_GTR_RATES.tolist(),
        freqs=substitution.DEFAULT_FREQS.tolist(), shape=BENCH_SHAPE)
    a4 = (dg["pc"], P, Qs, dg["tips"], freqs, props, dg["w"])

    def k1(d, m=None):
        args = (d["pc"], d["bl"], d["tips"], d["w"])
        if m is None:
            return pruning_jc.log_likelihood_and_branch_gradient_jc69(
                *args, root_id=d["root_id"])
        return pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
            m, *args, root_id=d["root_id"])

    def k4(m=None):
        if m is None:
            return pruning_generic.log_likelihood_and_branch_gradient_generic(
                *a4, root_id=dg["root_id"])
        return pruning_generic.log_likelihood_and_branch_gradient_generic_sharded(
            m, *a4, root_id=dg["root_id"])

    # The path: the dp wrappers and the GP fits on sp meshes.
    reset_counters()
    got = {"K1 f32": k1(d32, mesh), "K1 f64": k1(d64, mesh), "K4 f32": k4(mesh)}
    fits = {(dt, sp): gp_sp_fit(dt, sp) for dt in (torch.float64,
                                                    torch.float32)
            for sp in (2, 4)}
    launches = launch_counts("parallel path", ["ll_grad_jc69",
                                               "ll_grad_generic",
                                               "populate_plvs",
                                               "golden_sweep"])
    launches = dict(launches)

    # Then each against its unsharded counterpart.
    for (tag, (ll, g)), want in zip(got.items(), (k1(d32), k1(d64), k4())):
        tol = TWIN_TOL[ll.dtype]
        bitwise_or_close(f"{tag} dp = 2 vs dp = 1, LLs", ll, want[0],
                         tol["ll"])
        bitwise_or_close(f"{tag} dp = 2 vs dp = 1, gradients", g, want[1],
                         tol["grad"])
    for dt in (torch.float64, torch.float32):
        want, sweeps = gp_sp_fit(dt, 0)
        for sp in (2, 4):
            m, s = fits[(dt, sp)]
            close(f"GP fluA {str(dt)[6:]} sp = {sp} ({sweeps} / {s} sweeps) "
                  "vs the unsharded kernel route", m, want,
                  (0.0, GP_FLUA_TOL[dt]))

    # Helpers: a trace of one K1 launch, PhaseTimer, the CPU baseline.
    try:
        out, err = tracer.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        tracer.kill()
        tracer.wait()
    if tracer.returncode != 0:
        raise AssertionError(f"the trace process failed:\n{err[-3000:]}")
    trace, kernel_names, span = json.loads(out.strip().splitlines()[-1])
    if not kernel_names or not span:
        raise AssertionError(f"the trace {trace} names no jc69_ll_grad_kernel "
                             "or lacks the annotated span")
    print(f"  ok  device_trace (a process of its own): {trace} names "
          f"{kernel_names[0][:60]} and the annotated span")
    k1_args = (d32["pc"], pruning_jc.exp_complements(
        d32["bl"], torch.ones(1, device=DEV), torch.float32),
        torch.ones(1, device=DEV), torch.ones(1, device=DEV), d32["tips"],
        d32["w"])
    timer = profiling.PhaseTimer(sync=True)
    for _ in range(20):
        timer.time_fn(f"K1 f32 B = {B}", pruning_jc.ll_grad_jc69_cuda,
                      *k1_args, root_id=d32["root_id"])
    print(f"  PhaseTimer(sync=True): {timer.report()} (host clock, "
          "synchronised, launch included)")
    up = headline_schedule()
    base_args = (d64["pc"].cpu().numpy(), *up[:3],
                 d64["bl"].cpu().numpy(), d64["tips"].cpu().numpy(),
                 d64["w"].cpu().numpy(), up[3])
    b_ll, b_g = cpu_baseline.eval_batch(*base_args, threads=0, dtype_bits=64)
    ll64, g64 = got["K1 f64"]
    r = d64["root_id"]
    rel_ll = float(np.max(np.abs(b_ll - ll64.cpu().numpy())
                          / np.abs(ll64.cpu().numpy())))
    g64 = g64.cpu().numpy()
    rel_g = float(np.max(np.abs(b_g[:, :r] - g64)) / np.max(np.abs(g64)))
    if max(rel_ll, rel_g) > BASELINE_REL:
        raise AssertionError(f"the CPU baseline vs the card's f64 K1: LLs "
                             f"{rel_ll:.3e}, gradients {rel_g:.3e}")
    print(f"  ok  CPU baseline (dtype_bits=64) vs the card's f64 K1, B = {B}: "
          f"LLs {rel_ll:.3e} per tree, gradients {rel_g:.3e} of the largest "
          f"|g| (rel {BASELINE_REL})")

    # The distributed jobs, started first, ran beside the checks above.
    for tag, job in jobs.items():
        ranks = collect_ranks(tag, *job)
        launches["ll_grad_jc69"] += check_ranks(tag, ranks, torch.float32)

    # Timings, after the ranks have left the card.
    cpu_rate = baseline_evals_per_s(base_args)
    print(f"  timings ({smi}; host {host_cpu()}):")
    dp1 = {}
    for tag, one, two in ((f"K1 f32 B = {B}", lambda: k1(d32),
                           lambda: k1(d32, mesh)),
                          ("K4 config 2 f32", k4, lambda: k4(mesh))):
        t1a, t2a = time_ms(one), time_ms(two)
        t2b, t1b = time_ms(two), time_ms(one)
        dp1[tag] = min(t1a, t1b)
        print(f"    {tag}: dp = 1 {t1a:.4f} / {t1b:.4f} ms, dp = 2 on the "
              f"one card {t2a:.4f} / {t2b:.4f} ms: the cost of the split "
              "(two launches of half the trees on one card), not scaling")
    card_rate = B / dp1[f"K1 f32 B = {B}"] * 1e3
    print(f"    headline denominator: the native CPU baseline (f32, all "
          f"cores, bench.py's loop) {cpu_rate:.1f} evals/s; the card's K1 "
          f"wrapper (f32, dp = 1) {card_rate:.1f} evals/s, "
          f"{card_rate / cpu_rate:.1f}x")
    print(f"[13] took {time.perf_counter() - t_phase:.1f} s")
    return launches

# [14] one dispatch per VBPI window and the soak.
WINDOW = soak.WINDOW  # steps a window: the soak's step_many(20)
GRAPH_CASES = [(dt, bm) for dt in (torch.float32, torch.float64)
               for bm in ("split", "psp")]
# The graph route against the eager route (vbpi_train_steps_packed) on the
# same window from the same state: bit for bit. Both run the same kernels,
# and every sum of a step has a fixed order (K1's tiles, torch's
# reductions, fixed_order_scatter_add), so nothing may differ. A replayed
# window's mean LL a step against K1's twin: TWIN_TOL["ll"].
TRACE_WINDOWS = 5  # windows of 20 steps a traced run (and steps: 100)
# The soak is held to the JAX package's own soak by the same protocol
# (tools/soak_vbpi.py: f32, seed 0, 20,000 steps), run on the CPU: its
# ELBO(100) and IW marginal(1000). The two packages draw the same host
# randomness, so the estimates differ only by what 20,000 steps of
# rounding leave in the state: within SOAK_TOL nats. The tool's own
# assertion, marginal > soak.MARGINAL_FLOOR, comes from its TPU record and
# is printed, met or not: the JAX package does not meet it on the CPU.
SOAK_REFERENCE = {"elbo": -7067.92822265625, "marginal": -7035.755411528982}
SOAK_TOL = 1.0


def snapshot(state):
    """A copy of a VBPIState's tensors."""
    return VBPIState(state.q_params.clone(), state.sbn_params.clone(), tuple(
        AdamState(st.mu.clone(), st.nu.clone(), st.count.clone())
        for st in state.opt_state))


def sample_window(jv, betas):
    """One window of host samples as step_many draws it: (ints (K, P, ...),
    eps (K, P, B), betas (K,))."""
    K, P = len(betas), jv.particle_count
    arts = jv._sample_artifacts(jv._host_params(), K * P)
    ints = tuple(np.stack(c).reshape((K, P) + c[0].shape) for c in zip(*arts))
    eps = jv.rng.standard_normal((K, P, ints[1].shape[-1]))
    return ints, eps, np.asarray(betas, np.float64)


def window_tensors(jv, ints, eps, betas):
    """(packed (K, P, W), eps, betas) on the card, and the shapes."""
    packed, shapes = pack_ints(ints)
    return (torch.from_numpy(packed).to(DEV),
            torch.as_tensor(eps, dtype=jv.dtype, device=DEV),
            torch.as_tensor(betas, dtype=jv.dtype, device=DEV)), shapes


def eager_window(jv, state, window):
    """vbpi_train_steps_packed on a window, from ``state``, eagerly."""
    (packed, eps, betas), shapes = window_tensors(jv, *window)
    return vbpi_train_steps_packed(
        state, jv.statics, jv.optimizer, packed, eps, betas, shapes, jv.tips,
        jv.weights, jv.segment_ids)


def bit_for_bit(name, got, want):
    """Fail unless every tensor of got equals want's bit for bit."""
    for i, (a, b) in enumerate(zip(step_graph.leaves(got),
                                   step_graph.leaves(want), strict=True)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(
                f"{name}: tensor {i} differs, max abs "
                f"{float((a.double() - b.double()).abs().max()):.3e}")
    print(f"  ok  {name}: bit for bit")


def replay_counts(what, fn, k1):
    """fn() with the graph and K1 counters set to 0 first: fails unless it
    was one replay, no capture, and ``k1`` K1 launches."""
    step_graph.reset_counters()
    pruning_jc.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    got = (dict(step_graph.COUNTS), pruning_jc.LAUNCHES["ll_grad_jc69"])
    if got != ({"captures": 0, "replays": 1}, k1):
        raise AssertionError(f"{what}: {got}, not one replay and {k1} K1")
    print(f"  {what}: one replay, {k1} K1 launches")
    return out


def twin_mean_lls(jv, state, window):
    """Per step of a window from ``state``: the mean LL by K1's twin at the
    state the step starts from (the eager trajectory's)."""
    (packed, eps, betas), shapes = window_tensors(jv, *window)
    ones = torch.ones(1, dtype=jv.dtype, device=DEV)
    out = []
    for k in range(packed.shape[0]):
        pc, branch_rep, _, _ = unpack_ints(packed[k], shapes)
        _, _, theta = _branch_lengths(state.q_params, branch_rep, eps[k])
        em = pruning_jc.exp_complements(
            torch.nn.functional.pad(theta, (0, 2)), ones, jv.dtype)
        ll, _ = pruning_jc.ll_grad_jc69_plain(
            pc, em, ones, ones, jv.tips, jv.weights,
            root_id=jv.statics.root_id)
        out.append(ll.mean())
        state, _ = vbpi_train_step_packed(
            state, jv.statics, jv.optimizer, packed[k], eps[k], betas[k],
            shapes, jv.tips, jv.weights, jv.segment_ids)
    return torch.stack(out)


def graph_checks(dtype, branch_model, tmp):
    """The graph route of config 5 at dtype and branch_model against the
    eager route and K1's twin (after the path's counters were read)."""
    tag = f"{str(dtype)[6:]} {branch_model}"
    jv = JitVBPI(bench_instance(DEV, dtype), particle_count=PARTICLES,
                 seed=0, dtype=dtype, branch_model=branch_model)
    jv.step_many(WINDOW)  # captures the K = 20 graph
    buffers = step_graph.leaves(jv.state)
    # 1. One window: the graph against vbpi_train_steps_packed eagerly.
    start = snapshot(jv.state)
    w1 = sample_window(jv, np.linspace(0.5, 1.0, WINDOW))
    want_state, want = eager_window(jv, snapshot(start), w1)
    got = replay_counts(f"{tag} step_many window", lambda: jv._window(*w1),
                        WINDOW)
    bit_for_bit(f"{tag} window of {WINDOW}, graph vs eager, state",
                jv.state, want_state)
    bit_for_bit(f"{tag} window of {WINDOW}, graph vs eager, metrics",
                (got["mean_ll"], got["elbo_like"]),
                (want["mean_ll"], want["elbo_like"]))
    # 2. The same graph on a second window: its LLs are that window's.
    start = snapshot(jv.state)
    w2 = sample_window(jv, np.ones(WINDOW))
    got2 = jv._window(*w2)
    close(f"{tag} replayed window 2, mean LL a step vs K1's twin",
          got2["mean_ll"].cpu(), twin_mean_lls(jv, start, w2).cpu(),
          TWIN_TOL[dtype]["ll"])
    if torch.equal(got2["mean_ll"], got["mean_ll"]):
        raise AssertionError(f"{tag}: window 2 repeated window 1's LLs")
    # 3. step() (the K = 1 graph) against one eager step on its inputs.
    jv.step()  # captures the K = 1 graph
    start = snapshot(jv.state)
    m = replay_counts(f"{tag} step()", jv.step, 1)
    ints, eps = jv.last_batch
    want_state, want = eager_window(
        jv, start, (tuple(a[None] for a in ints), eps[None], [1.0]))
    bit_for_bit(f"{tag} step(), graph vs eager", (jv.state, m["mean_ll"],
                                                  m["elbo_like"]),
                (want_state, want["mean_ll"][0], want["elbo_like"][0]))
    # A checkpoint restored into the captured trainer: the next replay
    # starts from it.
    path = os.path.join(tmp, f"{tag.replace(' ', '_')}.npz")
    checkpoint.save_jit_state(jv, path)
    saved = snapshot(jv.state)
    jv.step_many(WINDOW)
    checkpoint.restore_jit_state(jv, path)
    if not all(a is b for a, b in zip(step_graph.leaves(jv.state), buffers)):
        raise AssertionError(f"{tag}: the restore replaced the buffers")
    bit_for_bit(f"{tag} restored state", jv.state, saved)
    w3 = sample_window(jv, np.ones(WINDOW))
    want_state, want = eager_window(jv, snapshot(saved), w3)
    jv._window(*w3)
    bit_for_bit(f"{tag} window after the restore, graph vs eager",
                jv.state, want_state)


def time_vbpi(smi, steps=40):
    """ms per VBPI step at the bench's configuration by each route (host
    clock around synchronised runs after a warm-up; routes in turns eager,
    graph, graph, eager): {(route, call): [ms, ms]}."""
    print(f"  VBPI at P = {PARTICLES}, float32, DS1, ms a step ({smi}):")
    calls = {
        "step()": (lambda jv: [jv.step() for _ in range(steps)], steps),
        "step_overlapped()": (lambda jv: [jv.step_overlapped()
                                          for _ in range(steps)], steps),
        "step_many(16)": (lambda jv: [jv.step_many(16) for _ in range(3)], 48),
        "step_many(20)": (lambda jv: [jv.step_many(20) for _ in range(2)], 40),
    }
    out = {}
    for route in ("eager", "graph", "graph", "eager"):
        jv = JitVBPI(bench_instance(DEV, torch.float32),
                     particle_count=PARTICLES, seed=0, dtype=torch.float32,
                     cuda_graphs=route == "graph")
        for name, (run, n) in calls.items():
            run(jv)  # warm-up (capture, and the topology cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(jv)
            torch.cuda.synchronize()
            out.setdefault((route, name), []).append(
                (time.perf_counter() - t0) * 1e3 / n)
    for (route, name), ms in out.items():
        print(f"    {route} {name}: {ms[0]:.3f} / {ms[1]:.3f} ms a step")
    return out


def trace_vbpi(cuda_graphs):
    """step() and step_many(20) of config 5 (f32) by one route, each with
    host_and_device's line (a call: a step, or a window of 20 steps): run
    in a fresh process (see trace_one_k1)."""
    jv = JitVBPI(bench_instance(DEV, torch.float32), particle_count=PARTICLES,
                 seed=0, dtype=torch.float32, cuda_graphs=cuda_graphs)
    return {"step()": host_and_device(jv.step, 4 * TRACE_WINDOWS)[0],
            "step_many(20)": host_and_device(lambda: jv.step_many(WINDOW),
                                             TRACE_WINDOWS)[0]}


def phase_graphs(smi):
    """[14] the one-dispatch trainer and the soak; returns the launch
    counts of its path (the soak)."""
    print("[14] one dispatch per VBPI window: CUDA graphs over K1, and the "
          "DS1 soak")
    t_phase = time.perf_counter()
    # The path: the soak, JitVBPI.step_many(20) on the graph route.
    reset_counters()
    step_graph.reset_counters()
    result = soak.run(soak.CHECKED_STEPS)
    launches = launch_counts("soak path", ["ll_grad_jc69", "ll_jc69"])
    windows = result["steps"] // WINDOW
    graphs = dict(step_graph.COUNTS)
    print(f"  soak: {result['steps']} steps in {result['seconds']:.3f} s, "
          f"{result['ms_per_step']:.4f} ms a step ({result['route']} route, "
          f"{graphs['replays']} replays, {graphs['captures']} capture); "
          f"ELBO({soak.ELBO_PARTICLES}) {result['elbo']:.3f}, IW marginal"
          f"({soak.MARGINAL_PARTICLES}) {result['marginal']:.3f}; {smi}")
    if (result["route"] != "graph"
            or graphs != {"captures": 1, "replays": windows}
            or launches["ll_grad_jc69"] != result["steps"] + 1):
        raise AssertionError("the soak did not take one replay a window "
                             "(K1: the steps and one warm-up)")
    for name in ("elbo", "marginal"):
        close(f"soak {name} vs the JAX package's soak on the CPU",
              result[name], SOAK_REFERENCE[name], (0.0, SOAK_TOL))
    met = result["marginal"] > soak.MARGINAL_FLOOR
    print(f"  the JAX tool's assertion, IW marginal > {soak.MARGINAL_FLOOR} "
          f"(from its TPU record): {'met' if met else 'not met'}; the JAX "
          f"package on the CPU: {SOAK_REFERENCE['marginal']}")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, branch_model in GRAPH_CASES:
            graph_checks(dtype, branch_model, tmp)
    time_vbpi(smi)
    # Device time and idle share, each route traced in a fresh process.
    for route in ("eager", "graph"):
        out = subprocess.run(
            [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
             f"chip_smoke.trace_vbpi({route == 'graph'})))"],
            cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"trace of the {route} route failed:\n"
                                 f"{out.stderr[-4000:]}")
        for name, line in json.loads(out.stdout.splitlines()[-1]).items():
            print(f"    {route} {name}: {line}")
    print(f"[14] took {time.perf_counter() - t_phase:.1f} s")
    return launches


# [15] the GP ascent and the rooted engine as replays of CUDA graphs.
GP_GRAPH_CASES = [(dt, case) for dt in (torch.float32, torch.float64)
                  for case in ((1e-2, 10), (1e-6, 100))]
GRAPH_DTYPES = (torch.float32, torch.float64)
GRAPH_RUNS = 5  # host-clock calls a route and turn; traced calls a route


def gp_graph_engine(dtype, use_kernels=True, cuda_graphs=True):
    """gp_ascent_flua's engine (fluA) on the card, by route."""
    return gp_instance("fluA.fa", "fluA.tree", dtype, use_kernels,
                       cuda_graphs).get_engine()


def gp_ascent(eng, bl0, tol, max_iter):
    """run_branch_ascent from bl0: (marginal, sweeps, converged, branch
    lengths)."""
    eng.branch_lengths = bl0.copy()
    m, sweeps = eng.run_branch_ascent(tol, max_iter)
    return m, sweeps, eng.last_ascent_converged, eng.branch_lengths.copy()


def gp_graph_checks(dtype, case, eng, bl0, got):
    """The graphed fit ``got`` against the eager loop from bl0, bit for bit;
    a second graphed ascent whose every K7 and K8 launch is a replay's (the
    phases' replays times their captured launches) and as many as the eager
    loop's."""
    tag = f"gp_ascent_flua {str(dtype)[6:]} run_branch_ascent{case}"
    reset_counters()
    want = gp_ascent(gp_graph_engine(dtype, cuda_graphs=False), bl0, *case)
    eager = dict(engine_kernels.LAUNCHES)
    if got[:3] != want[:3] or not np.array_equal(got[3], want[3]):
        raise AssertionError(f"{tag}: graph {got[:3]} vs eager {want[:3]}")
    print(f"  ok  {tag}: graph vs eager bit for bit (marginal {got[0]!r}, "
          f"{got[1]} sweeps, converged {got[2]})")
    phases = (eng.graphs.start, eng.graphs.propose, eng.graphs.damp,
              eng.graphs.accept)
    before = [g.replays for g in phases]
    reset_counters()
    ascent_graph.reset_counters()
    again = gp_ascent(eng, bl0, *case)
    torch.cuda.synchronize()
    replayed = {}
    for g, n in zip(phases, before):
        for name, k in (g.counted[0] if g.counted else {}).items():
            replayed[name] = replayed.get(name, 0) + (g.replays - n) * k
    launches = {k: v for k, v in engine_kernels.LAUNCHES.items() if v}
    if (again[:3] != got[:3] or launches != replayed
            or launches != {k: v for k, v in eager.items() if v}
            or ascent_graph.COUNTS["captures"]):
        raise AssertionError(f"{tag}: {launches} launched, {replayed} by "
                             f"replays, eager {eager}, {ascent_graph.COUNTS}")
    print(f"  {tag}: {ascent_graph.COUNTS['replays']} replays, launches "
          f"{launches}, each a replay's (the eager loop's: the same)")
    return got[0]


def rooted_graph_call(eng, args, hand, eager=False):
    """The hand route's gradient dict, or rooted_log_likelihoods' parts, as
    a flat list, the LLs first; eager turns the engine's graphs off for the
    call."""
    graphs = eng.graphs
    if eager:
        eng.graphs = None
    try:
        if hand:
            out = eng.rooted_phylo_gradients(*args)
            return [out["log_likelihood"]] + [
                out[k] for k in sorted(out) if k != "log_likelihood"]
        return list(eng.rooted_log_likelihoods(*args, return_parts=True))
    finally:
        eng.graphs = graphs


def rooted_graph_checks(dtype, eng, args, got_hand, got_ll):
    """flua_rooted_gradients at dtype: the path's two calls of each route
    ({"eager": its first, "graph": its second, the capture's replay})
    against the eager calls bit for bit, twice each; a call one replay
    with K1 (K2 for the LLs) once; new ratios read, their LLs against K1's
    twin on the eager route's own inputs. Returns the twin's error."""
    tag = f"flua_rooted_gradients {str(dtype)[6:]}"
    for hand, calls in ((True, got_hand), (False, got_ll)):
        what = f"{tag} {'hand route' if hand else 'LLs'}"
        got = calls["graph"]
        want = rooted_graph_call(eng, args, hand, eager=True)
        bit_for_bit(f"{what}, the key's first (eager) call vs eager",
                    calls["eager"], want)
        again = rooted_graph_call(eng, args, hand, eager=True)
        reset_counters()
        rooted_graph.reset_counters()
        second = rooted_graph_call(eng, args, hand)
        torch.cuda.synchronize()
        k = ({"ll_grad_jc69": 1, "forward": 1, "adjoint": 1} if hand
             else {"ll_jc69": 1})
        counts = (graph_counts()[1],
                  {n: v for m in (pruning_jc, heights)
                   for n, v in m.LAUNCHES.items() if v})
        if counts != ({"captures": 0, "replays": 1}, k):
            raise AssertionError(f"{what}: {counts}, not one replay")
        bit_for_bit(f"{what}, graph vs eager", got, want)
        bit_for_bit(f"{what}, graph twice", second, got)
        bit_for_bit(f"{what}, eager twice", again, want)
    sched, bounds, ratios, rates, params = args
    ratios = ratios.copy()
    ratios[:, :-1] = np.clip(ratios[:, :-1] * 0.97, 1e-4, 1 - 1e-4)
    args2 = (sched, bounds, ratios, rates, params)
    replayed = rooted_graph_call(eng, args2, True)
    d = rooted_kernel_inputs(eng, *args2[:4])
    em, one, _ = kernel_inputs(d, dtype, 1)
    twin, _ = pruning_jc.ll_grad_jc69_plain(
        d["pc"], em, one, one, d["tips"], d["w"], root_id=d["root_id"])
    if torch.equal(replayed[0], got_hand["graph"][0]):
        raise AssertionError(f"{tag}: new ratios gave the old LLs")
    return close(f"{tag} replay at new ratios, LLs vs K1's twin",
                 replayed[0].cpu(), twin.cpu(), TWIN_TOL[dtype]["ll"])


def rooted_graph_engine(dtype, cuda_graphs=True):
    """flua_rooted_gradients' engine and arguments on the card."""
    sp, sched, bounds, ratios, rates = rooted_batch()
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    eng = LikelihoodEngine(sp, spec, dtype=dtype, device=DEV,
                           cuda_graphs=cuda_graphs)
    return eng, (sched, bounds, ratios, rates,
                 default_parameters(spec, device=DEV))


def graph_path_calls(level=True):
    """{(what, route): call} of [15]'s timings at float32: gp_ascent_flua
    (run_branch_ascent(1e-2, 10) from the same lengths) on the kernel route
    and, with ``level``, the level route, and flua_rooted_gradients' hand
    route and LLs, each by the graph route and eagerly."""
    calls = {}
    for graphs in (True, False):
        route = "graph" if graphs else "eager"
        for use_kernels in (True, False)[:1 + level]:
            eng = gp_graph_engine(torch.float32, use_kernels, graphs)
            bl0 = eng.branch_lengths.copy()
            what = ("gp_ascent_flua, kernel route" if use_kernels
                    else "gp_ascent_flua, level route")
            calls[(what, route)] = (
                lambda eng=eng, bl0=bl0: gp_ascent(eng, bl0, 1e-2, 10))
        eng, args = rooted_graph_engine(torch.float32, graphs)
        calls[("rooted_phylo_gradients (hand)", route)] = (
            lambda eng=eng, args=args: eng.rooted_phylo_gradients(*args))
        calls[("rooted_log_likelihoods", route)] = (
            lambda eng=eng, args=args: eng.rooted_log_likelihoods(*args))
    return calls


def time_graph_paths(smi):
    """Host-clock ms a call of each (what, route) of graph_path_calls,
    synchronised, after two warm-up calls (the captures), in turns graph, eager,
    eager, graph: {(what, route): [median, median]}."""
    print(f"  [15] timings, float32, host clock ({smi}):")
    calls = graph_path_calls()
    for fn in calls.values():
        fn()
        fn()
    out = {}
    for route in ("graph", "eager", "eager", "graph"):
        for (what, r), fn in calls.items():
            if r != route:
                continue
            times = []
            for _ in range(2 if "level" in what else GRAPH_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out.setdefault((what, route), []).append(statistics.median(times))
    for (what, route), ms in out.items():
        runs = 2 if "level" in what else GRAPH_RUNS
        print(f"    {what}, {route}: {ms[0]:.3f} / {ms[1]:.3f} ms a call "
              f"(median of {runs}, two turns)")
    return out


def trace_graph_paths():
    """host_and_device's line for every call of graph_path_calls but the
    level route's (a call: an ascent or a rooted call): run in a fresh
    process (see trace_one_k1)."""
    return {f"{what}, {route}": host_and_device(fn, GRAPH_RUNS)[0]
            for (what, route), fn in graph_path_calls(level=False).items()}


def phase_graph_paths(smi):
    """[15] the GP ascent and the rooted engine by their CUDA graphs;
    returns the launch counts of its path."""
    print("[15] one replay per populate and per rooted call: CUDA graphs of "
          "the GP ascent (K7/K8) and the rooted engine (K1/K2)")
    t_phase = time.perf_counter()
    # The path, with every counter at 0: the graph route of gp_ascent_flua
    # and flua_rooted_gradients, as a user calls them.
    reset_counters()
    ascent_graph.reset_counters()
    rooted_graph.reset_counters()
    gp_runs, rooted_runs = {}, {}
    for dtype, case in GP_GRAPH_CASES:
        eng = gp_graph_engine(dtype)
        bl0 = eng.branch_lengths.copy()
        gp_runs[(dtype, case)] = (eng, bl0, gp_ascent(eng, bl0, *case))
    for dtype in GRAPH_DTYPES:
        # Each rooted call twice: its key's first call runs eagerly, its
        # second captures the graph and replays it.
        eng, args = rooted_graph_engine(dtype)
        rooted_runs[dtype] = (eng, args, *(
            both_calls(lambda h=hand: rooted_graph_call(eng, args, h))
            for hand in (True, False)))
    launches = launch_counts("graph paths", ["populate_plvs", "golden_sweep",
                                             "ll_grad_jc69", "ll_jc69",
                                             "forward", "adjoint"])
    graphs = (dict(ascent_graph.COUNTS), graph_counts()[1])
    print(f"  graph paths: GP phases {graphs[0]}, rooted programs {graphs[1]}")
    if graphs[0]["replays"] < 1 or graphs[1] != {
            "captures": 2 * len(GRAPH_DTYPES), "replays": 2 * len(GRAPH_DTYPES)}:
        raise AssertionError("the graph paths did not replay their graphs")
    # The checks, after the counters were read.
    for (dtype, case), (eng, bl0, got) in gp_runs.items():
        m = gp_graph_checks(dtype, case, eng, bl0, got)
        if case == (1e-6, 100):
            close(f"gp_ascent_flua {str(dtype)[6:]} graph fit vs libsbn_tpu's "
                  "optimum", m, GP_FLUA, (0.0, GP_FLUA_TOL[dtype]))
    for dtype, (eng, args, hand, ll) in rooted_runs.items():
        rooted_graph_checks(dtype, eng, args, hand, ll)
    print(f"  [15] path and checks: {time.perf_counter() - t_phase:.1f} s")
    time_graph_paths(smi)
    print(f"  [15] timings done: {time.perf_counter() - t_phase:.1f} s")
    # Device time and idle share, traced in a fresh process.
    out = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.trace_graph_paths()))"],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"trace of [15]'s calls failed:\n"
                             f"{out.stderr[-4000:]}")
    for name, line in json.loads(out.stdout.splitlines()[-1]).items():
        print(f"    {name}: {line}")
    print(f"[15] took {time.perf_counter() - t_phase:.1f} s")
    return launches

# [16] one replay per engine call: the unrooted engine's calls and the
# rooted autograd route as CUDA graphs (models/unrooted_graph.py,
# models/rooted_graph.py).
ENGINE_CALLS = ("log_likelihoods", "branch_gradients", "phylo_gradients")
DS1_SHAPE = 0.1  # the Weibull shape of [4]'s DS1 Weibull+4 goldens


def headline_batch(n=B):
    """The headline workload: DS1.subsampled_10 tiled to n trees, branch
    lengths perturbed by U(0.8, 1.2) from default_rng(0): (site patterns,
    schedule, branch lengths (n, N) on the host)."""
    tops, bls, ttm = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    reps = n // len(tops) + 1
    sched = schedule.schedules_of_topologies((tops * reps)[:n])
    bl = np.tile(np.stack(bls), (reps, 1))[:n]
    return sp, sched, bl * np.random.default_rng(0).uniform(0.8, 1.2, bl.shape)


def card_params(spec, shape=None, rates6=None, freqs=None):
    """A spec's default parameters on the card, with the Weibull shape and
    GTR's rates and frequencies where given."""
    params = default_parameters(spec, device=DEV)
    f64 = dict(dtype=torch.float64, device=DEV)
    if shape is not None:
        params["site"]["shape"] = torch.tensor(shape, **f64)
    if rates6 is not None:
        params["substitution"] = {"rates": torch.tensor(rates6, **f64),
                                  "frequencies": torch.tensor(freqs, **f64)}
    return params


def unrooted_graph_cases():
    """{tag: (site patterns, spec, schedule, host branch lengths, parameters
    on the card)}: the headline batch under JC69 and JC69 + Weibull+4 (shape
    DS1_SHAPE), and config 2 (GTR at its default + Weibull+4 at shape
    BENCH_SHAPE, DS1.100_topologies x B_GTR)."""
    sp, sched, bl = headline_batch()
    cases = {}
    for site, shape in (("constant", None), ("weibull+4", DS1_SHAPE)):
        spec = lt.PhyloModelSpec("JC69", site, "strict")
        tag = f"DS1 x {B}, JC69" + ("" if shape is None else " + Weibull+4")
        cases[tag] = (sp, spec, sched, bl, card_params(spec, shape))
    d = load_ds1_100(torch.float32)
    spec = lt.PhyloModelSpec("GTR", "weibull+4", "strict")
    cases[f"config 2, DS1.100 x {B_GTR}, GTR + Weibull+4"] = (
        d["sp"], spec, d["sched"], d["bl_host"], card_params(spec, BENCH_SHAPE))
    return cases


def rooted_graph_cases():
    """{tag: (site patterns, spec, arguments)} of [16]'s rooted autograd
    route: fluA x B_ROOTED (rooted_batch) under GTR (ROOTED_GTR_*) and JC69
    + Weibull+4 (shape 0.1)."""
    sp, sched, bounds, ratios, rates = rooted_batch()
    cases = {}
    for spec, params in (
            (lt.PhyloModelSpec("GTR", "constant", "strict"),
             dict(rates6=ROOTED_GTR_RATES, freqs=ROOTED_GTR_FREQS)),
            (lt.PhyloModelSpec("JC69", "weibull+4", "strict"),
             dict(shape=0.1))):
        tag = f"fluA x {B_ROOTED}, {spec.substitution}" + (
            " + Weibull+4" if spec.site != "constant" else "")
        cases[tag] = (sp, spec, (sched, bounds, ratios, rates,
                                 card_params(spec, **params)))
    return cases


def rooted_autograd(eng, args):
    """The rooted autograd route by the engine's graphs: rooted_phylo_
    gradients for GTR (its route), RootedGraphs' "autograd" route for JC69
    (whose engine call takes the hand route)."""
    if eng.spec.substitution == "GTR":
        return eng.rooted_phylo_gradients(*args)
    return eng.graphs.phylo_gradients(*args, True, "autograd")


def flat(out):
    """A call's outputs as a list of tensors (a dict's by sorted key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


def graph_counts():
    """The unrooted and the rooted engine graphs' captures and replays."""
    return tuple({k: m.COUNTS[k] for k in ("captures", "replays")}
                 for m in (lt_unrooted_graph, rooted_graph))


def reset_graph_counts():
    lt_unrooted_graph.reset_counters()
    rooted_graph.reset_counters()


def nonzero_launches():
    torch.cuda.synchronize()
    return {k: v for m in COUNTED for k, v in m.LAUNCHES.items() if v}


def key_mb(fn):
    """(fn's outputs, MB of device memory that stays reserved over fn(),
    less the outputs' own bytes), unused cache released before and after."""
    gc.collect()  # nothing dead from before counts here
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - before - nbytes(out)
    return out, held / 2**20


def slab_key(spec, dtype, sched):
    """Whether a JC69 key of ``spec`` at ``dtype`` on ``sched``'s trees runs
    K2/K3's slab routes (beyond their on-chip plan); such a key stays eager
    (utils/graphs.py)."""
    if spec.substitution != "JC69":
        return False
    _, S, _ = np.shape(sched.post_children)
    K = spec.site_category_count()
    return any(pruning_jc.onchip_plan(dtype, K, S, sched.leaf_count, kind)
               is None for kind in ("ll", "dea"))


def engine_keys(sp, spec, dtype, calls, held, tag):
    """A graph engine (the default on a card) with each of ``calls(eng)``
    ({name: call}) made twice, its first call and its capture's replay:
    {"engine": the engine, name: {"eager": outputs, "graph": outputs}}, with
    the MB each key adds to the engine in ``held``."""
    eng = LikelihoodEngine(sp, spec, dtype=dtype, device=DEV)
    got = {"engine": eng}
    for name, call in calls(eng).items():
        got[name], held[(tag, dtype, name)] = key_mb(lambda: both_calls(call))
    return got


def unrooted_calls(sched, bl, params):
    return lambda eng: {
        call: (lambda f=getattr(eng, call): flat(f(sched, bl, params)))
        for call in ENGINE_CALLS}


def engine_graph_checks(tag, dtype, case, got):
    """One unrooted case at dtype: both calls of each key (``got``: its
    eager first call and its capture's replay) against an eager engine's
    call, bit for bit; a third call one replay launching what the eager
    call launches and copying no int32 buffer (the same schedule object);
    a call with new branch lengths and parameters on a new schedule object
    of the same shapes (as a VI step hands over) one replay that reads
    them and copies the new ints."""
    sp, spec, sched, bl, params = case
    graph_eng = got["engine"]
    uploads = graph_eng.unrooted_graphs.programs.uploads
    eager = LikelihoodEngine(sp, spec, dtype=dtype, device=DEV,
                             cuda_graphs=False)
    bl2 = bl * 0.97
    params2 = {g: {k: v * 1.05 for k, v in d.items()}
               for g, d in params.items()}
    if "substitution" in params2:
        for k, v in params2["substitution"].items():
            params2["substitution"][k] = v / v.sum()
    again = copy_schedule(sched)
    for call in ENGINE_CALLS:
        what = f"{tag} {str(dtype)[6:]} engine.{call}"
        reset_counters()
        want = flat(getattr(eager, call)(sched, bl, params))
        eager_launches = nonzero_launches()
        for route in ROUTE_CALLS:
            bit_for_bit(f"{what}, {route} call vs eager engine",
                        got[call][route], want)
        reset_counters()
        reset_graph_counts()
        copied = dict(uploads)
        third = flat(getattr(graph_eng, call)(sched, bl, params))
        launches = nonzero_launches()
        copied = {k: uploads[k] - copied[k] for k in uploads}
        if (graph_counts()[0] != {"captures": 0, "replays": 1}
                or launches != eager_launches
                or copied != {"ints": 0, "floats": 1}):
            raise AssertionError(f"{what}: {graph_counts()}, launches "
                                 f"{launches}, eager {eager_launches}, "
                                 f"copies {copied}")
        bit_for_bit(f"{what}, graph twice", third, got[call]["graph"])
        ints = uploads["ints"]
        new = flat(getattr(graph_eng, call)(again, bl2, params2))
        if (graph_counts()[0] != {"captures": 0, "replays": 2}
                or uploads["ints"] != ints + 1):
            raise AssertionError(f"{what}: new inputs {graph_counts()}, "
                                 f"{uploads['ints'] - ints} int copies")
        bit_for_bit(f"{what}, new inputs on a new schedule object, graph vs "
                    "eager", new, flat(getattr(eager, call)(again, bl2,
                                                            params2)))
        if torch.equal(new[0], got[call]["graph"][0]):
            raise AssertionError(f"{what}: new inputs gave the old outputs")
        print(f"  {what}: one replay a call, launches {launches} (the eager "
              "call's), one float64 copy and no int32 copy for a repeated "
              "schedule object")


def interleaved_check(tag, dtype, case, got):
    """The case's three keys on its one graph engine (their graphs in one
    pool) called in turns, twice round, each with new branch lengths:
    every call one replay, equal to the eager engine's bit for bit."""
    sp, spec, sched, bl, params = case
    eng = got["engine"]
    eager = LikelihoodEngine(sp, spec, dtype=dtype, device=DEV,
                             cuda_graphs=False)
    reset_graph_counts()
    n = 0
    for turn in range(2):
        for call in ENGINE_CALLS:
            bl_n = bl * (0.9 + 0.02 * n)
            n += 1
            bit_for_bit(f"{tag} {str(dtype)[6:]} interleaved keys, turn "
                        f"{turn}, engine.{call}",
                        flat(getattr(eng, call)(sched, bl_n, params)),
                        flat(getattr(eager, call)(sched, bl_n, params)))
    if graph_counts()[0] != {"captures": 0, "replays": n}:
        raise AssertionError(f"{tag}: interleaved keys {graph_counts()}")


def copy_schedule(sched):
    """A new schedule object with the same arrays, as a new batch of the
    same shapes is."""
    import copy

    out = copy.copy(sched)
    object.__setattr__(out, "_dev_cache", None)
    object.__setattr__(out, "_height_iters_cache", None)
    return out


def rooted_autograd_checks(tag, dtype, case, eng, got, slab):
    """The rooted autograd route's two calls (``got``: its first and its
    capture's replay, or two eager calls for a ``slab`` key) against
    _rooted_phylo_gradients_autograd, bit for bit, twice each; a third call
    one replay (a slab key: none) launching what the eager call launches;
    new ratios read with no capture."""
    sp, spec, args = case
    what = f"{tag} {str(dtype)[6:]} rooted autograd route"
    reset_counters()
    want = flat(eng._rooted_phylo_gradients_autograd(*args, True))
    eager_launches = nonzero_launches()
    again = flat(eng._rooted_phylo_gradients_autograd(*args, True))
    for route in ROUTE_CALLS:
        bit_for_bit(f"{what}, {route} call vs eager", got[route], want)
    bit_for_bit(f"{what}, eager twice", again, want)
    reset_counters()
    reset_graph_counts()
    third = flat(rooted_autograd(eng, args))
    launches = nonzero_launches()
    replays = 0 if slab else 1
    if (graph_counts()[1] != {"captures": 0, "replays": replays}
            or launches != eager_launches):
        raise AssertionError(f"{what}: {graph_counts()}, launches {launches},"
                             f" eager {eager_launches}")
    bit_for_bit(f"{what}, graph twice", third, got["graph"])
    sched, bounds, ratios, rates, params = args
    ratios2 = ratios.copy()
    ratios2[:, :-1] = np.clip(ratios2[:, :-1] * 0.97, 1e-4, 1 - 1e-4)
    args2 = (sched, bounds, ratios2, rates, params)
    new = flat(rooted_autograd(eng, args2))
    if graph_counts()[1] != {"captures": 0, "replays": 2 * replays}:
        raise AssertionError(f"{what}: new ratios {graph_counts()}")
    bit_for_bit(f"{what}, new ratios, graph vs eager", new,
                flat(eng._rooted_phylo_gradients_autograd(*args2, True)))
    if torch.equal(new[0], got["graph"][0]):
        raise AssertionError(f"{what}: new ratios gave the old outputs")
    print(f"  {what}: {'eager (slab routes)' if slab else 'one replay'} a "
          f"call, launches {launches} (the eager call's)")


def burrito_replay_check():
    """A Burrito step (a new topology set, so a new schedule object of the
    same shapes) replays its graphs and captures none, once its first step
    has run them eagerly and its second has captured them."""
    burro = vip_burrito(DEV)
    burro.gradient_steps(2)
    reset_counters()
    reset_graph_counts()
    burro.gradient_steps(1)
    launches = nonzero_launches()
    if graph_counts()[0] != {"captures": 0, "replays": 2} or launches != {
            "ll_grad_jc69": 1, "ll_jc69": 1}:
        raise AssertionError(f"Burrito step: {graph_counts()}, {launches}")
    print(f"  ok  a Burrito gradient step (new topologies, B = {PARTICLES}):"
          f" {graph_counts()[0]['replays']} replays (branch_gradients and the"
          f" ELBO's log_likelihoods), no capture, launches {launches}")


def engine_graph_calls():
    """{(what, route): call} of [16]'s timings at float32: the five calls of
    the records' table and the GTR rooted autograd route, by the graph
    route and eagerly."""
    cases = unrooted_graph_cases()
    headline = cases[f"DS1 x {B}, JC69"]
    config2 = cases[f"config 2, DS1.100 x {B_GTR}, GTR + Weibull+4"]
    sp, sched, bounds, ratios, rates = rooted_batch()
    jc = lt.PhyloModelSpec("JC69", "constant", "strict")
    gtr = rooted_graph_cases()[f"fluA x {B_ROOTED}, GTR"]
    calls = {}
    for graphs in (True, False):
        route = "graph" if graphs else "eager"

        def engine(sp, spec):
            return LikelihoodEngine(sp, spec, dtype=torch.float32, device=DEV,
                                    cuda_graphs=graphs)

        for (name, case) in (("DS1 x %d" % B, headline),
                             ("config 2", config2)):
            sp_, spec, sched_, bl, params = case
            eng = engine(sp_, spec)
            names = (("branch_gradients", "log_likelihoods")
                     if case is headline else
                     ("log_likelihoods", "phylo_gradients"))
            for call in names:
                calls[(f"engine.{call}, {name}", route)] = (
                    lambda f=getattr(eng, call), a=(sched_, bl, params): f(*a))
        for what, spec, args in (
                ("fluA x %d JC69 (K2 + K3)" % B_ROOTED, jc,
                 (sched, bounds, ratios, rates,
                  default_parameters(jc, device=DEV))),
                ("fluA x %d GTR (K5 + K6)" % B_ROOTED, gtr[1], gtr[2])):
            eng = engine(sp, spec)
            fn = ((lambda eng=eng, args=args: rooted_autograd(eng, args))
                  if graphs else
                  (lambda eng=eng, args=args:
                   eng._rooted_phylo_gradients_autograd(*args, True)))
            calls[(f"rooted autograd route, {what}", route)] = fn
    return calls


def time_engine_graphs(smi):
    """Host-clock ms a call of each (what, route) of engine_graph_calls,
    synchronised, from host arrays, after two warm-up calls (a graph
    route's first runs eagerly, its second captures), in turns graph,
    eager, eager, graph: {(what, route): [median, median]}."""
    print(f"  [16] timings, float32, from host arrays, host clock ({smi}):")
    calls = engine_graph_calls()
    for fn in calls.values():
        fn()
        fn()
    out = {}
    for route in ("graph", "eager", "eager", "graph"):
        for (what, r), fn in calls.items():
            if r != route:
                continue
            times = []
            for _ in range(GRAPH_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out.setdefault((what, route), []).append(statistics.median(times))
    for what in dict.fromkeys(w for w, _ in out):
        g, e = out[(what, "graph")], out[(what, "eager")]
        print(f"    {what}: graph {g[0]:.3f} / {g[1]:.3f} ms, eager "
              f"{e[0]:.3f} / {e[1]:.3f} ms a call (medians of {GRAPH_RUNS}, "
              f"two turns), eager / graph {min(e) / min(g):.2f}x")
    return out


def htod_copies(fn, calls=GRAPH_RUNS):
    """Host-to-device copies a call of fn on the card (torch.profiler's
    "Memcpy HtoD" device events), after two warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "Memcpy HtoD" in e.key) / calls


def trace_engine_graphs():
    """host_and_device's line for every call of engine_graph_calls, and the
    host-to-device copies a call of the engine's calls (the same schedule
    object each call): run in a fresh process (see trace_one_k1)."""
    calls = engine_graph_calls()
    out = {f"{what}, {route}": host_and_device(fn, GRAPH_RUNS)[0]
           for (what, route), fn in calls.items()}
    for (what, route), fn in calls.items():
        if what.startswith("engine."):
            out[f"{what}, {route}: host-to-device copies a call"] = (
                f"{htod_copies(fn):g} (torch.profiler)")
    return out


def final_elbo_key(smi):
    """The B = FINAL_ELBO_PARTICLES float64 JC69 log_likelihoods key (vi.
    benchmark.fixed's final ELBO, called once) on the headline recipe:
    the first call of a fresh engine on a fresh schedule object, by a graph
    engine and an eager one in turns (graph, eager, eager, graph), with the
    programs the graph engine keeps (none) and the memory it leaves
    reserved (within one 2 MB segment); then a graph engine's second call
    (the capture) and replays, and an eager engine's later calls, on one
    schedule object, with the int32 copies of the replays (none)."""
    sp, sched, bl = headline_batch(FINAL_ELBO_PARTICLES)
    spec = lt.PhyloModelSpec("JC69", "constant", "strict")
    params = default_parameters(spec, device=DEV)

    def engine(route):
        return LikelihoodEngine(sp, spec, dtype=torch.float64, device=DEV,
                                cuda_graphs=route == "graph")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    first, left = {}, {}
    for route in ("graph", "eager", "eager", "graph"):
        eng, s = engine(route), copy_schedule(sched)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        first.setdefault(route, []).append(
            timed(lambda: eng.log_likelihoods(s, bl, params)))
        torch.cuda.empty_cache()
        left.setdefault(route, []).append(
            (torch.cuda.memory_reserved() - before) / 2**20)
        if route == "graph" and (len(eng.unrooted_graphs.programs)
                                 or left[route][-1] > 2):
            raise AssertionError(
                f"final-ELBO key: {len(eng.unrooted_graphs.programs)} "
                f"programs kept, {left[route][-1]:.2f} MB left reserved")
        del eng, s
    later = {}
    for route in ("graph", "eager"):
        eng, s = engine(route), copy_schedule(sched)
        call = (lambda: eng.log_likelihoods(s, bl, params))
        timed(call)
        later[route] = [timed(call) for _ in range(4)]
        if route == "graph":
            uploads = eng.unrooted_graphs.programs.uploads
            copied = dict(uploads)
            timed(call)
            if uploads["ints"] != copied["ints"]:
                raise AssertionError("final-ELBO key: a replay on the same "
                                     "schedule object copied its ints")
        del eng, s
    g, e = min(first["graph"]), min(first["eager"])
    print(f"  final-ELBO key, B = {FINAL_ELBO_PARTICLES} float64 JC69 "
          f"log_likelihoods, called once on a fresh engine ({smi}): graph "
          f"engine {', '.join(f'{t * 1e3:.3f}' for t in first['graph'])} ms,"
          f" eager engine {', '.join(f'{t * 1e3:.3f}' for t in first['eager'])}"
          f" ms (graph / eager, least of each {g / e:.3f}); no program kept;"
          f" left reserved {left['graph']} MB (graph), {left['eager']} MB "
          "(eager)")
    print(f"  final-ELBO key, later calls on one schedule object: graph "
          f"engine's second call (capture) {later['graph'][0] * 1e3:.3f} ms,"
          f" replays {', '.join(f'{t * 1e3:.3f}' for t in later['graph'][1:])}"
          f" ms (no int32 copy); eager engine "
          f"{', '.join(f'{t * 1e3:.3f}' for t in later['eager'])} ms")


def slab_key_costs(smi, case):
    """The float64 JC69 + Weibull+4 rooted autograd key on fluA x 256 (K2/K3
    on their slab routes): host-clock ms a call by the engine's policy
    (eager: the caching allocator keeps the slab scratch between calls
    until it is released) against a graph of its own holding the scratch
    in its pool (a PackedPrograms shown no slab counter), and the MB each
    leaves reserved."""
    sp, spec, args = case

    def time_calls(fn, n=3):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    eng = LikelihoodEngine(sp, spec, dtype=torch.float64, device=DEV)
    _, eager_mb = key_mb(lambda: both_calls(
        lambda: rooted_autograd(eng, args)))
    eager_ms = time_calls(lambda: rooted_autograd(eng, args))
    graphs = rooted_graph.RootedGraphs(eng)
    graphs.programs = PackedPrograms(eng.device, (), {"captures": 0,
                                                      "replays": 0,
                                                      "eager": 0})
    _, graph_mb = key_mb(lambda: both_calls(
        lambda: graphs.phylo_gradients(*args, True, "autograd")))
    graph_ms = time_calls(lambda: graphs.phylo_gradients(*args, True,
                                                         "autograd"))
    del graphs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  f64 JC69 + Weibull+4 rooted autograd key, fluA x {B_ROOTED} "
          f"(slab routes; {smi}): eager (the engine's route) "
          f"{', '.join(f'{t:.3f}' for t in eager_ms)} ms a call, "
          f"{eager_mb:.2f} MB held after its calls; captured in a pool of "
          f"its own {', '.join(f'{t:.3f}' for t in graph_ms)} ms a replay, "
          f"{graph_mb:.2f} MB held")
    return eager_mb


SLAB_KEY_LIMIT_MB = 200  # what a slab-route key may leave held
KEY_OUTPUTS_MB = 20  # outputs and buffers a key adds to a shared pool


def phase_engine_graphs(smi):
    """[16] the engine's unrooted calls and the rooted autograd route by
    their CUDA graphs; returns the launch counts of its path."""
    print("[16] one replay per engine call: CUDA graphs of log_likelihoods, "
          "branch_gradients, phylo_gradients (K1-K6) and the rooted "
          "autograd route, captured from a key's second call into one pool "
          "an engine")
    t_phase = time.perf_counter()
    cases, rcases = unrooted_graph_cases(), rooted_graph_cases()
    # The path, with every counter at 0: each call twice by the graph
    # engine, as a user calls it on a card (the first eagerly, the second
    # the capture and its replay); the MB each key adds and each engine
    # holds.
    reset_counters()
    reset_graph_counts()
    runs, rruns, held, totals = {}, {}, {}, {}
    slabs = set()
    for dtype in GRAPH_DTYPES:
        for tag, (sp, spec, sched, bl, params) in cases.items():
            runs[(tag, dtype)], totals[(tag, dtype)] = key_mb(
                lambda: engine_keys(sp, spec, dtype,
                                    unrooted_calls(sched, bl, params), held,
                                    tag))
        for tag, (sp, spec, args) in rcases.items():
            if slab_key(spec, dtype, args[0]):
                slabs.add((tag, dtype))
            got, _ = key_mb(lambda: engine_keys(
                sp, spec, dtype,
                lambda eng: {"rooted autograd": (
                    lambda: flat(rooted_autograd(eng, args)))}, held, tag))
            rruns[(tag, dtype)] = (got["engine"], got["rooted autograd"])
    launches = launch_counts(
        "engine graphs path", ["ll_grad_jc69", "ll_jc69", "ll_dea_jc69",
                               "ll_grad_generic", "ll_generic",
                               "ll_dp_generic"],
        ["ll_grad_generic_slab", "ll_generic_slab", "ll_dp_generic_slab"])
    n_unrooted = len(GRAPH_DTYPES) * len(cases) * len(ENGINE_CALLS)
    n_rooted = len(GRAPH_DTYPES) * len(rcases) - len(slabs)
    counts = graph_counts()
    print(f"  engine graphs path: unrooted programs {counts[0]}, rooted "
          f"programs {counts[1]} (slab-route keys, eager: {sorted(slabs)})")
    if counts != ({"captures": n_unrooted, "replays": n_unrooted},
                  {"captures": n_rooted, "replays": n_rooted}):
        raise AssertionError("the engine calls did not replay their graphs")
    print("  MB each key adds to its engine (device memory reserved over its "
          "two calls, less their outputs; the engine's keys share one pool):")
    for (tag, dtype, call), mb in held.items():
        print(f"    {tag}, {str(dtype)[6:]}, {call}: {mb:.2f} MB")
    for (tag, dtype), mb in totals.items():
        print(f"    {tag}, {str(dtype)[6:]}: the engine holds {mb:.2f} MB "
              f"after its {len(ENGINE_CALLS)} keys")
    for tag, dtype in slabs:
        mb = held[(tag, dtype, "rooted autograd")]
        if mb >= SLAB_KEY_LIMIT_MB:
            raise AssertionError(f"{tag} {dtype}: the slab-route key holds "
                                 f"{mb:.2f} MB")
    # The checks, after the counters were read.
    for (tag, dtype), got in runs.items():
        engine_graph_checks(tag, dtype, cases[tag], got)
        interleaved_check(tag, dtype, cases[tag], got)
    for (tag, dtype), (eng, got) in rruns.items():
        rooted_autograd_checks(tag, dtype, rcases[tag], eng, got,
                               (tag, dtype) in slabs)
    burrito_replay_check()
    config2_alone(held, totals)
    print(f"  [16] path and checks: {time.perf_counter() - t_phase:.1f} s")
    final_elbo_key(smi)
    for tag, dtype in slabs:
        slab_key_costs(smi, rcases[tag])
    time_engine_graphs(smi)
    print(f"  [16] timings done: {time.perf_counter() - t_phase:.1f} s")
    # Device time, idle share and copies a call, traced in a fresh process.
    out = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.trace_engine_graphs()))"],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"trace of [16]'s calls failed:\n"
                             f"{out.stderr[-4000:]}")
    for name, line in json.loads(out.stdout.splitlines()[-1]).items():
        print(f"    {name}: {line}")
    print(f"[16] took {time.perf_counter() - t_phase:.1f} s")
    return launches


def config2_alone(held, totals):
    """Config 2's keys each alone in an engine of its own (two calls): the
    MB each holds, against the engine of [16]'s path that holds all three
    in one pool, which must hold no more than the largest alone plus
    KEY_OUTPUTS_MB a key."""
    tag = f"config 2, DS1.100 x {B_GTR}, GTR + Weibull+4"
    sp, spec, sched, bl, params = unrooted_graph_cases()[tag]
    for dtype in GRAPH_DTYPES:
        alone = {}
        for call in ENGINE_CALLS:
            calls = unrooted_calls(sched, bl, params)
            one = {}
            key_mb(lambda: engine_keys(
                sp, spec, dtype, lambda eng: {call: calls(eng)[call]}, one,
                tag))
            alone[call] = one[(tag, dtype, call)]
        total, limit = (totals[(tag, dtype)],
                        max(alone.values()) + KEY_OUTPUTS_MB * len(alone))
        print(f"  {tag}, {str(dtype)[6:]}: keys alone "
              f"{', '.join(f'{c} {mb:.2f}' for c, mb in alone.items())} MB "
              f"(sum {sum(alone.values()):.2f}); one engine with all three "
              f"holds {total:.2f} MB (at most {limit:.2f})")
        if total > limit:
            raise AssertionError(f"{tag} {dtype}: the engine holds "
                                 f"{total:.2f} MB, over {limit:.2f}")


# [17] the parity tier on the card (utils/parity.py).


def phase_parity(smi):
    """[17] the parity tier (python -m libsbn_tpu_torch.utils.parity) in
    this process, with every counter at 0: each check's line, and every
    kernel K1-K8 launched; returns the launch counts of its path."""
    print(f"[17] the parity tier on the card: golden numbers at float32 on "
          f"the kernels and the engines' graphs ({smi})")
    t_phase = time.perf_counter()
    reset_counters()
    checks = parity.run(DEV, echo=lambda line: print(f"  {line}"))
    launches = launch_counts("parity path", [k["key"] for k in KERNELS])
    print(f"  parity: {len(checks)} checks passed; [17] took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# [18] the scale tools (libsbn_tpu_torch/utils/scale_compare.py,
# gp_scale.py and forest_scale.py) at their defaults.
SCALE_PATTERNS, SCALE_BATCH = 1024, 64  # scale_compare's defaults
SCALE_GATED_TAXA = 200  # its default point, where the JAX tool's gate holds
GP_SCALE = (200, 4096)  # gp_scale's defaults: taxa, sites
FOREST_SCALE_TREES = 1000  # forest_scale's default


SCALE_WINDOW_S = 0.25  # timed_evals_per_sec's window in [18] (default 2 s)


def k1_routes_at_scale(taxa):
    """K1 f32 on chip against its slab route on scale_compare's inputs at
    ``taxa`` (which the plan must fit), in turns slab, chip, chip, slab
    (CUDA events): (chip ms, slab ms) a call."""
    inp = scale_compare.make_inputs(taxa, SCALE_PATTERNS, SCALE_BATCH)
    f32 = torch.float32
    one = torch.ones(1, dtype=f32, device=DEV)
    pc = torch.as_tensor(inp["pc"], device=DEV)
    em = pruning_jc.exp_complements(torch.as_tensor(inp["bl"], device=DEV),
                                    one, f32)
    tips, w = (torch.as_tensor(inp[k], device=DEV) for k in ("tips", "w"))
    r = inp["sched"].root_id
    args = (pc, em, one, one, tips, w)
    dims = (SCALE_BATCH, taxa, pc.shape[1], r + 2, 1, SCALE_PATTERNS)
    lib = _kernels.load("pruning_jc")

    def chip():
        return pruning_jc.ll_grad_jc69_cuda(*args, root_id=r)

    def slab():
        return pruning_jc._ll_grad_jc69_slab(lib, dims, *args)

    times = [time_ms(fn, reps=3, inner=3) for fn in (slab, chip, chip, slab)]
    return min(times[1:3]), min(times[0], times[3])


def phase_scale_tools(smi):
    """[18] the three scale tools in this process, with the counters at 0:
    scale_compare over its sweep (the gate at 200 taxa, the routes on both
    sides of K1's f32 plan), gp_scale at f32 and f64, forest_scale at
    1,000 trees; each tool's check raises on a missed gate. Returns the
    launch counts of its path."""
    print(f"[18] scale tools on the card ({smi})")
    t_phase = time.perf_counter()
    reset_counters()
    points = scale_compare.sweep_points()
    edge = points[2]
    for taxa in points:
        r = scale_compare.run(taxa, SCALE_PATTERNS, SCALE_BATCH, DEV,
                              target_s=SCALE_WINDOW_S)
        for line in scale_compare.describe(r, smi):
            print(f"  {line}")
        scale_compare.check(r, gated=taxa == SCALE_GATED_TAXA)
        want = "on-chip" if taxa <= edge else "slab"
        if r["route"]["f32"] != want:
            raise AssertionError(f"{taxa} taxa: K1 f32 took the "
                                 f"{r['route']['f32']} route, not {want}")
        del r
        torch.cuda.empty_cache()
    print(f"  ok  scale_compare: the gate at {SCALE_GATED_TAXA} taxa, f64 K1 "
          "against native f64 wherever native is finite, finite f32 results "
          f"and K1 f32 on chip up to {edge} taxa, the slab route past it")
    for dtype in (torch.float64, torch.float32):
        # Device time and idle share at the production dtype only.
        r = gp_scale.run(*GP_SCALE, dtype, DEV,
                         timing=dtype == torch.float32)
        for line in gp_scale.describe(r, smi):
            print(f"  {line}")
        marginals = [r[k]["marginal"] for k in ("fused", "streamed", "newton")]
        if not np.all(np.isfinite(marginals)):
            raise AssertionError(f"gp_scale {dtype}: marginals {marginals}")
        gp_scale.check_graphs(r)
        print(f"  ok  gp_scale, {str(dtype)[6:]}: the streamed ascent by its "
              "chunk programs' graphs equals the eager one bit for bit "
              f"(marginal {r['streamed']['marginal']!r}, "
              f"{r['streamed']['sweeps']} sweeps, the branch lengths)")
        if dtype == torch.float64:
            gp_scale.check(r)
            gp_scale.check(r, "newton")
            print("  ok  gp_scale, f64: the streamed marginal within the JAX "
                  "tool's bound of the fused (K7 + K8) and of the in-memory "
                  "Newton ascent")
        else:
            # A finding, not a gate: the JAX package's own f32 fit of this
            # instance on the CPU gives a fused marginal of -inf.
            print(f"  f32: gaps {r['gap']:.3e} (fused) and "
                  f"{r['gap_newton']:.3e} (Newton) against the JAX tool's "
                  f"bound {r['bound']:.3e}: recorded, not asserted")
        del r
        torch.cuda.empty_cache()
    r = forest_scale.run(FOREST_SCALE_TREES, DEV, target_s=SCALE_WINDOW_S)
    for line in forest_scale.describe(r, smi):
        print(f"  {line}")
    forest_scale.check(r)
    if not all(r["bit_for_bit"].values()):
        raise AssertionError(f"forest_scale: {r['bit_for_bit']}")
    del r
    torch.cuda.empty_cache()
    print("  ok  forest_scale: every surface finite, graph = eager bit for "
          "bit")
    launches = launch_counts("scale tools path", [
        "ll_grad_jc69", "ll_grad_jc69_slab", "populate_plvs", "golden_sweep"])
    # After the counters are read: K1's on-chip route against its slab
    # route inside the plan, f32, CUDA events.
    for taxa in (SCALE_GATED_TAXA, edge):
        chip, slab = k1_routes_at_scale(taxa)
        print(f"  K1 f32 at {taxa} taxa x {SCALE_PATTERNS} x {SCALE_BATCH}: on "
              f"chip {chip:.3f} ms, slab route {slab:.3f} ms a call "
              f"({slab / chip:.2f}x) ({smi})")
    print(f"[18] took {time.perf_counter() - t_phase:.1f} s")
    return launches


# [19] the streamed ascent's chunk programs, the hybrid marginals' program
# and EM's step as CUDA graphs.
# The streamed fits of the path: (dtype, A and B in an np.memmap).
STREAMED_CASES = ((torch.float64, False), (torch.float64, True),
                  (torch.float32, False))
# The hybrid marginals of the path: (data, dtype); "gp_scale" is the scale
# tool's 200-taxon tree and 4,096 random sites.
HYBRID_CASES = (("fluA", torch.float64), ("fluA", torch.float32),
                ("gp_scale", torch.float64))
HYBRID_CALLS = 3  # a program's first call eager, its second a capture
HYBRID_CHUNK = 16  # rows a chunk: fluA's 65 combinations in five, padded
HYBRID_CPU_REL = 1e-10  # the f64 hybrid values against the port's CPU run
PROGRAM_RUNS = 5  # host_and_device's calls a route for fluA's hybrid; 2
# for the others (the profiler's pass over 7,000-9,000 kernels a call takes
# seconds)


def hybrid_gp(data, dtype, tmp, device=DEV, cuda_graphs=True):
    """GPInstance for the hybrid marginals on ``device`` at seeded lengths
    U(0.01, 0.3): fluA, or gp_scale's 200 x 4,096 data written under
    ``tmp``."""
    if data == "fluA":
        files = (f"{DATA}/fluA.tree", f"{DATA}/fluA.fa")
    else:
        files = gp_scale.make_data(*GP_SCALE, tmp)
    inst = GPInstance()
    inst.read_newick_file(files[0])
    inst.read_fasta_file(files[1])
    inst.make_engine(dtype=dtype, device=device, cuda_graphs=cuda_graphs)
    eng = inst.get_engine()
    eng.branch_lengths = np.random.default_rng(2).uniform(
        0.01, 0.3, eng.branch_lengths.size)
    return inst


def hybrid_calls(inst, calls=HYBRID_CALLS, chunk=None):
    """The hybrid values of ``calls`` calls: calculate_hybrid_marginals, or
    with ``chunk`` process_quartet_hybrid_requests over the same requests
    in chunks of that many rows (after one populate)."""
    eng = inst.get_engine()
    if chunk is not None:
        eng.populate_plvs()
        reqs = [quartet_hybrid_request_of(inst.dag, p, r, c) for p, r, c, _
                in inst.dag.reverse_postorder_index_traversal()]
    out = []
    for _ in range(calls):
        eng.hybrid_marginal_log_likelihoods[:] = -np.inf
        if chunk is None:
            inst.calculate_hybrid_marginals()
        else:
            eng.process_quartet_hybrid_requests(reqs, chunk=chunk)
        out.append(eng.hybrid_marginal_log_likelihoods.copy())
    return out


def streamed_fit(dtype, memmap_dir, cuda_graphs, tol=1e-6, max_iter=100):
    """fluA's streamed fit in chunks of GP_CHUNK by route: (marginal,
    sweeps, branch lengths, K7 launches, the graphs' MB or None)."""
    eng = gp_instance("fluA.fa", "fluA.tree", dtype,
                      cuda_graphs=cuda_graphs).get_engine()
    before = engine_kernels.LAUNCHES["populate_plvs"]
    m, sweeps = eng.run_branch_ascent_streamed(tol, max_iter, GP_CHUNK,
                                               memmap_dir=memmap_dir)
    torch.cuda.synchronize()
    return (m, sweeps, eng.branch_lengths.copy(),
            engine_kernels.LAUNCHES["populate_plvs"] - before,
            eng.last_streamed_graphs)


def array_equal(name, got, want):
    """Fail unless the numpy arrays are equal bit for bit (NaN at the same
    places)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want,
                                                     equal_nan=True):
        raise AssertionError(f"{name}: differs, max abs "
                             f"{np.nanmax(np.abs(got - want)):.3e}")
    print(f"  ok  {name}: bit for bit")


def program_counts():
    return (dict(streamed_graph.COUNTS), dict(hybrid_graph.COUNTS),
            dict(sbn_probability.COUNTS))


def program_calls():
    """{(what, route): call} of [19]'s timings at float32 (EM: float64, its
    only dtype): the streamed ascent run_branch_ascent_streamed(1e-2, 10,
    GP_CHUNK) on fluA, calculate_hybrid_marginals on fluA and on gp_scale's
    data, EM(0.5, 100); each by its graphs and eagerly."""
    calls = {}
    tmp = tempfile.mkdtemp()
    try:
        for graphs in (True, False):
            route = "graph" if graphs else "eager"
            eng = gp_instance("fluA.fa", "fluA.tree", torch.float32,
                              cuda_graphs=graphs).get_engine()
            bl0 = eng.branch_lengths.copy()

            def streamed(eng=eng, bl0=bl0):
                eng.branch_lengths = bl0.copy()
                return eng.run_branch_ascent_streamed(1e-2, 10, GP_CHUNK)

            calls[("streamed ascent, fluA", route)] = streamed
            for data in ("fluA", "gp_scale"):
                inst = hybrid_gp(data, torch.float32, tmp,
                                 cuda_graphs=graphs)
                calls[(f"hybrid marginals, {data}", route)] = (
                    inst.calculate_hybrid_marginals)
            em = em_instance()
            calls[("EM(0.5, 100), DS1.100", route)] = (
                lambda em=em, graphs=graphs: em.train_expectation_maximization(
                    0.5, 100, cuda_graphs=graphs))
    finally:
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    return calls


def trace_programs():
    """host_and_device's line for every call of program_calls: run in a
    fresh process (see trace_one_k1)."""
    return {f"{what}, {route}": host_and_device(
        fn, PROGRAM_RUNS if what == "hybrid marginals, fluA" else 2)[0]
        for (what, route), fn in program_calls().items()}


def phase_programs(smi):
    """[19] the streamed ascent, the hybrid marginals and EM by their CUDA
    graphs; returns the launch counts of its path."""
    print("[19] the JAX package's last compiled GP and SBN programs as CUDA "
          "graphs: the streamed ascent's chunk programs, the hybrid "
          f"marginals' chunk and EM's step ({smi})")
    t_phase = time.perf_counter()
    # The path, with every counter at 0: each entry point as a user calls
    # it on the card (cuda_graphs on, the default).
    reset_counters()
    streamed_graph.reset_counters()
    hybrid_graph.reset_counters()
    sbn_probability.reset_counters()
    streamed, hybrid, held = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, memmap in STREAMED_CASES:
            streamed[(dtype, memmap)] = streamed_fit(
                dtype, tmp if memmap else None, True)
        if os.listdir(tmp):
            raise AssertionError(f"the streamed ascent left {os.listdir(tmp)}")
        for data, dtype in HYBRID_CASES:
            inst = hybrid_gp(data, dtype, tmp)
            hybrid[(data, dtype)] = hybrid_calls(inst)
            held[(data, dtype)] = inst.get_engine().hybrid_graphs.held_mb()
    em = em_runs(DEV)
    launches = launch_counts("programs path", ["populate_plvs"],
                             ["populate_plvs_slab", "golden_sweep",
                              "golden_sweep_slab"])
    counts = program_counts()
    print(f"  programs path: streamed {counts[0]}, hybrid {counts[1]}, "
          f"EM {counts[2]}")
    k7_streamed = sum(r[3] for r in streamed.values())
    want = (
        {"captures": 3 * len(STREAMED_CASES),
         "eager": 3 * len(STREAMED_CASES)},
        {"captures": len(HYBRID_CASES),
         "replays": (HYBRID_CALLS - 1) * len(HYBRID_CASES),
         "eager": len(HYBRID_CASES)},
        {"captures": len(EM_CASES),
         "replays": sum(iters for _, iters in EM_CASES)})
    got = ({k: counts[0][k] for k in ("captures", "eager")},) + counts[1:]
    k7_want = k7_streamed + HYBRID_CALLS * len(HYBRID_CASES)
    if got != want or launches["populate_plvs"] != k7_want:
        raise AssertionError(f"programs path: {got}, K7 "
                             f"{launches['populate_plvs']}; want {want}, "
                             f"K7 {k7_want}")
    print(f"  ok  programs path: {counts[0]['replays']} streamed replays; K7 "
          f"{launches['populate_plvs']} = the streamed fits' {k7_streamed} "
          f"+ one populate a hybrid call")
    # The checks, after the counters were read.
    with tempfile.TemporaryDirectory() as tmp:
        for (dtype, memmap), got in streamed.items():
            tag = (f"fluA streamed fit (1e-6, 100, {GP_CHUNK}), "
                   f"{str(dtype)[6:]}, A and B in "
                   f"{'an np.memmap' if memmap else 'host RAM'}")
            want = streamed_fit(dtype, tmp if memmap else None, False)
            if got[:2] != want[:2] or got[3] != want[3] + 1:
                raise AssertionError(f"{tag}: graph {got[:2]}, K7 {got[3]}; "
                                     f"eager {want[:2]}, K7 {want[3]}")
            array_equal(f"{tag}: branch lengths, graph vs eager", got[2],
                        want[2])
            chunks = -(-238 // GP_CHUNK)
            print(f"  ok  {tag}: graph vs eager bit for bit (marginal "
                  f"{got[0]!r}, {got[1]} sweeps), K7 {got[3]} = {chunks} "
                  f"chunks x {(got[3] - 2) // chunks} refreshes + the capture "
                  f"warm-up + finalize (eager {want[3]}); the graphs' pool "
                  f"{got[4]['pool_mb']:.1f} MB, buffers "
                  f"{got[4]['buffers_mb']:.2f} MB while they lived ({smi})")
            close(f"{tag} vs libsbn_tpu's optimum", got[0], GP_FLUA,
                  (0.0, GP_FLUA_TOL[dtype]))
        for (data, dtype), calls in hybrid.items():
            tag = f"hybrid marginals, {data}, {str(dtype)[6:]}"
            eager = hybrid_calls(hybrid_gp(data, dtype, tmp,
                                           cuda_graphs=False), 1)[0]
            fin = np.isfinite(eager)
            for i, got in enumerate(calls):
                array_equal(f"{tag}, call {i + 1} "
                            f"({('eager', 'capture', 'replay')[min(i, 2)]}) "
                            "vs cuda_graphs=False", got, eager)
            print(f"  {tag}: {int(fin.sum())} central edges; the engine "
                  f"holds {held[(data, dtype)]:.1f} MB for its program "
                  f"({smi})")
            if dtype == torch.float64:
                cpu = hybrid_calls(hybrid_gp(data, dtype, tmp, device="cpu"),
                                   1)[0]
                if not np.array_equal(np.isfinite(cpu), fin):
                    raise AssertionError(f"{tag}: finite entries differ")
                close(f"{tag} vs the port's CPU run", eager[fin], cpu[fin],
                      (HYBRID_CPU_REL, 0.0))
        # Chunks of HYBRID_CHUNK rows, the last padded with rows of zeros.
        hybrid_graph.reset_counters()
        for dtype in (torch.float64, torch.float32):
            tag = f"hybrid marginals, fluA, {str(dtype)[6:]}, chunks of " \
                  f"{HYBRID_CHUNK}"
            got = hybrid_calls(hybrid_gp("fluA", dtype, tmp), chunk=HYBRID_CHUNK)
            eager = hybrid_calls(hybrid_gp("fluA", dtype, tmp,
                                           cuda_graphs=False), 1,
                                 chunk=HYBRID_CHUNK)[0]
            for i, values in enumerate(got):
                array_equal(f"{tag}, call {i + 1} vs cuda_graphs=False",
                            values, eager)
            whole = hybrid[("fluA", dtype)][0]
            fin = np.isfinite(whole)
            close(f"{tag} vs one chunk", eager[fin], whole[fin],
                  (1e-12 if dtype == torch.float64 else 1e-5, 0.0))
        chunks = -(-65 // HYBRID_CHUNK)
        if hybrid_graph.COUNTS != {
                "captures": 2, "replays": 2 * 2 * chunks, "eager": 2}:
            raise AssertionError(f"hybrid chunks: {hybrid_graph.COUNTS}")
    em_eager = em_runs(DEV, cuda_graphs=False)
    for key, (scores, params, probs, _) in em.items():
        tag = f"EM{key}"
        for name, a, b in (("scores", scores, em_eager[key][0]),
                           ("parameters", params, em_eager[key][1]),
                           ("probabilities", probs, em_eager[key][2])):
            array_equal(f"{tag} {name}, graph vs cuda_graphs=False", a, b)
    print(f"  [19] path and checks: {time.perf_counter() - t_phase:.1f} s")
    # Device time and idle share by route, traced in a fresh process.
    out = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.trace_programs()))"],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"trace of [19]'s calls failed:\n"
                             f"{out.stderr[-4000:]}")
    print(f"  [19] timings, by route ({smi}):")
    for name, line in json.loads(out.stdout.splitlines()[-1]).items():
        print(f"    {name}: {line}")
    print(f"[19] took {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    errs = phase_kernel_vs_twin()
    errs.update(phase_generic_vs_twin())
    errs.update(phase_gp_vs_twin())
    # [18] runs here, while torch.profiler is fresh in the process.
    scale_launches = phase_scale_tools(smi)
    runs = [phase_main_path(), phase_gtr_path(), phase_vbpi(), phase_gp_path()]
    rooted_launches, rooted_errs = phase_rooted_path()
    vip_launches, vip_errs, vip_k2 = phase_vip(smi)
    phase_forest(smi)
    runs.append(phase_parallel(smi))
    runs.append(phase_graphs(smi))
    graph_launches = phase_graph_paths(smi)
    # [15]'s K1 launches are on the rooted batch: K1's second entry.
    rooted_launches["ll_grad_jc69"] += graph_launches.pop("ll_grad_jc69")
    runs.append(graph_launches)
    runs.append(phase_engine_graphs(smi))
    runs.append(phase_parity(smi))
    runs.append(phase_programs(smi))
    runs.append(scale_launches)
    launches = {k: sum(run.get(k, 0) for run in runs) for k in runs[0]}
    # K1's rooted launches stand in its second entry below and K2's vip
    # launches in its second; every other kernel's entry counts every path.
    for k, n in rooted_launches.items():
        if k != "ll_grad_jc69":
            launches[k] += n
    for k, n in vip_launches.items():
        if k != "ll_jc69":
            launches[k] += n
    times, bounds = phase_timing(smi)
    for phase in (phase_generic_timing, phase_gp_timing):
        t, b = phase(smi)
        times.update(t)
        bounds.update(b)
    rooted_timed = phase_rooted_timing(smi)
    rooted_times, rooted_bound = rooted_timed["ll_grad_jc69"]
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
    # H1 and H2, the heights kernels: the rooted paths' launches ([10] and
    # [15]), their errors against the twins on the f32 batch, their times
    # and bounds on it. libsbn_tpu computes the heights with array ops
    # that XLA fuses into the rooted program, no Pallas kernel.
    for kernel, label, line in (("forward", "heights_forward (H1)", 16),
                                ("adjoint", "heights_adjoint (H2)", 88)):
        (ms, plain_ms), (b_ms, b_by) = rooted_timed[kernel]
        report.append({
            "name": f"{label}, rooted fluA B = {B_ROOTED}", "route": "cuda",
            "source": HEIGHTS_SOURCE,
            "replaces": f"libsbn_tpu/ops/heights.py:{line}",
            "launches": launches[kernel] + launches[kernel + "_slab"],
            "max_abs_err": rooted_errs[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          "included")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
