"""The CUDA kernels of libsbn_tpu_torch against their plain PyTorch twins,
the VBPI step, the GTR engine path, the GP fit (in memory and streamed),
the rooted engine, the vip layer (the Burrito, EM, per-tree parameter rows,
K2 at 10,000 trees), forest mode and the parallel layer (the dp-sharded K1
and K4 wrappers, JitVBPI on a local mesh, GP on an sp mesh, two shards of
one card each) on the card against the same on the CPU.

The VBPI trainer's graph route (one CUDA graph replay a window,
vi/step_graph.py) is held to its eager route bit for bit, and a replay's
LLs to K1's twin; so are the GP ascent's phase graphs (gp/ascent_graph.py:
the kernel route bit for bit, the level route at rel 1e-12) and the
rooted engine's (models/rooted_graph.py: one replay a call, the hand and
the autograd routes) and the unrooted engine's (models/unrooted_graph.py:
log_likelihoods, branch_gradients and phylo_gradients, one replay a call),
and forest's surfaces (ops/forest_graph.py), the streamed ascent's chunk
programs (gp/streamed_graph.py), the hybrid marginals' program
(gp/hybrid_graph.py) and EM's step (sbn/probability.py EMStepGraph), each
bit for bit, and a failed capture of each raises. The scale tools' K1 routes
on both sides of its float32 plan and a small gp_scale fit run here too.
These tests need a CUDA card and skip without one. The file imports no JAX,
so that it also runs on a machine with the card and no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)
"""

import os

import numpy as np
import pytest
import torch

import libsbn_tpu_torch
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection
from libsbn_tpu_torch.gp import GPInstance, ascent_graph, engine_kernels
from libsbn_tpu_torch.gp.engine import _jc69_transition
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.models import rooted_graph, unrooted_graph
from libsbn_tpu_torch.ops import (
    forest, forest_graph, heights, pruning_generic, pruning_jc, pruning_vjp,
    schedule, substitution,
)
from libsbn_tpu_torch.ops.site_model import weibull_rates
from libsbn_tpu_torch.parallel.sharding import make_mesh
from libsbn_tpu_torch.utils import gp_scale, scale_compare
from libsbn_tpu_torch.vi import JitVBPI, jit_step, step_graph

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
# (rtol, atol) for LLs and gradients, as in chip_smoke.py: same card, same
# dtype, differing only in summation order and fused multiply-adds.
TOL = {
    torch.float64: ((1e-12, 1e-9), (1e-9, 1e-8)),
    torch.float32: ((2e-6, 0.05), (1e-3, 0.05)),
}


def _synthetic(trees, patterns, seed=0, taxa=256):
    """``trees`` random unrooted trees of ``taxa`` leaves (joins drawn from
    default_rng(seed)) in the schedules' postorder-linear form, random tip
    partials (most one-hot), weights and branch lengths: (post_children,
    branch lengths with the root and ones slots, tips, weights, root_id)."""
    rng = np.random.default_rng(seed)
    L, S = taxa, taxa - 2
    ones = L + S
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
    return (np.array(pcs), bl, np.ascontiguousarray(tips),
            rng.integers(1, 5, patterns).astype(np.float64), L + S - 1)


def _inputs(data, dtype, K):
    """On the card: the one hello tree (one combine step, a ragged tile of 9
    patterns), three DS1 trees (934 patterns, a ragged last tile), one DS1
    tree ("ds1_b1"), or "big": two synthetic 256-taxon trees over 200
    patterns (_synthetic: beyond shared memory, so on the slab route,
    except at float32 K = 1, where a tile of 32 fits); DS1 branch
    lengths perturbed by a seeded U(0.8, 1.2), one or K Weibull rate
    categories: (post_children, em, rates, props, tips, weights, root_id)."""
    if data == "big":
        pc, bl, tips, w, root_id = _synthetic(2, 200)
    else:
        if data == "hello":
            tops, bls, ttm = newick.parse_newick_file(f"{DATA}/hello.nwk")
            aln = Alignment.read_fasta(f"{DATA}/hello.fasta")
        else:
            tops, bls, ttm = newick.parse_nexus_file(
                f"{DATA}/DS1.subsampled_10.t")
            aln = Alignment.read_fasta(f"{DATA}/DS1.fasta")
        n = 1 if data == "ds1_b1" else 3
        tops, bls = tops[:n], np.stack(bls[:n])
        sp = SitePattern(aln, ttm)
        sched = schedule.schedules_of_topologies(tops)
        rng = np.random.default_rng(1)
        bl = np.pad(bls * rng.uniform(0.8, 1.2, bls.shape), ((0, 0), (0, 1)))
        pc, tips, w, root_id = (sched.post_children, sp.tip_partials(),
                                sp.weights, sched.root_id)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(dt).cuda()

    if K == 1:
        rates = props = dev(np.ones(1))
    else:
        rates, props = (dev(x) for x in weibull_rates(0.3, K))
    em = pruning_jc.exp_complements(dev(bl), rates, dtype)
    return (dev(pc, torch.int32), em, rates, props, dev(tips), dev(w),
            root_id)


# Every K of the kernels' dispatch on DS1, the edge cases at K = 1 and 3,
# and the synthetic tree beyond shared memory at f64 K = 8 and f32 K = 1.
K1_K3_CASES = ([("ds1", K) for K in range(1, 9)]
               + [(data, K) for data in ("hello", "ds1_b1") for K in (1, 3)]
               + [("big", 8), ("big", 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data,K", K1_K3_CASES)
def test_kernels_match_twins_on_card(data, K, dtype):
    """K1 and K2 against their twins on one card (inputs: _inputs); each
    takes the on-chip route where its onchip_plan fits and the slab route
    beyond it (on the 256-taxon tree, all but float32 K = 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, em, rates, props, tips, w, r = _inputs(data, dtype, K)
    args = (pc, em, rates, props, tips, w)
    pruning_jc.reset_counters()
    k_ll, k_g = pruning_jc.ll_grad_jc69_cuda(*args, root_id=r)
    plan = pruning_jc.onchip_plan(dtype, K, pc.shape[1], tips.shape[0])
    assert (plan is None) == (data == "big" and (K, dtype) != (1, torch.float32))
    route = "ll_grad_jc69" if plan else "ll_grad_jc69_slab"
    assert pruning_jc.LAUNCHES[route] == 1
    t_ll, t_g = pruning_jc.ll_grad_jc69_plain(*args, root_id=r)
    k2 = pruning_jc.ll_jc69_cuda(pc, em, props, tips, w, root_id=r)
    torch.cuda.synchronize()
    plan2 = pruning_jc.onchip_plan(dtype, K, pc.shape[1], tips.shape[0], "ll")
    assert (plan2 is None) == (plan is None)
    assert pruning_jc.LAUNCHES["ll_jc69" if plan2 else "ll_jc69_slab"] == 1
    (ll_rtol, ll_atol), (g_rtol, g_atol) = TOL[dtype]
    want = t_ll.cpu().numpy()
    assert np.all(np.isfinite(want)) and want.shape == (pc.shape[0],)
    for got in (k_ll, k2):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=ll_rtol,
                                   atol=ll_atol)
    np.testing.assert_allclose(k_g[:, :r].cpu().numpy(),
                               t_g[:, :r].cpu().numpy(), rtol=g_rtol,
                               atol=g_atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data,K", K1_K3_CASES)
def test_k3_matches_twin_on_card(data, K, dtype):
    """K3 (d ll / d e, d ll / d props) against its twin on one card, at
    the gradient tolerance of TOL; the root and ones-slot rows are zero;
    on chip where onchip_plan fits, the slab route beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, em, _, props, tips, w, r = _inputs(data, dtype, K)
    pruning_jc.reset_counters()
    k_dea, k_dp = pruning_jc.ll_dea_jc69_cuda(pc, em, props, tips, w,
                                              root_id=r)
    t_dea, t_dp = pruning_jc.ll_dea_jc69_plain(pc, em, props, tips, w,
                                               root_id=r)
    torch.cuda.synchronize()
    plan = pruning_jc.onchip_plan(dtype, K, pc.shape[1], tips.shape[0], "dea")
    assert pruning_jc.LAUNCHES["ll_dea_jc69" if plan else "ll_dea_jc69_slab"] == 1
    B = pc.shape[0]
    assert k_dea.shape == (B, r + 2, K) and k_dp.shape == (B, K)
    assert not k_dea[:, r:].any()
    g_rtol, g_atol = TOL[dtype][1]
    np.testing.assert_allclose(k_dea.cpu().numpy(), t_dea.cpu().numpy(),
                               rtol=g_rtol, atol=g_atol)
    np.testing.assert_allclose(k_dp.cpu().numpy(), t_dp.cpu().numpy(),
                               rtol=g_rtol, atol=g_atol)


def _added(fn):
    """Device memory one call of fn adds: its peak less what was allocated
    before it, in bytes."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


@pytest.mark.cuda
def test_onchip_k1_adds_only_tile_partials():
    """At B = 512 DS1 f32 K = 1, one on-chip K1 call adds only the per-tile
    partials (grad_part is (512, 30, 53) floats, 3.3 MB; under 50 MB),
    where the slab route adds its (B, N1, 4K, P) scratch (about 0.9 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, em, rates, props, tips, w, r = _inputs("ds1", torch.float32, 1)
    reps = 512 // pc.shape[0] + 1
    pc, em = pc.repeat(reps, 1, 1)[:512].contiguous(), em.repeat(reps, 1, 1)[:512].contiguous()
    args = (pc, em, rates, props, tips, w)
    onchip = _added(lambda: pruning_jc.ll_grad_jc69_cuda(*args, root_id=r))
    dims = (512, tips.shape[0], pc.shape[1], r + 2, 1, tips.shape[2])
    lib = pruning_jc._kernels.load("pruning_jc")
    slab = _added(lambda: pruning_jc._ll_grad_jc69_slab(lib, dims, *args))
    assert onchip < 5e7 and slab > 5e8, (onchip, slab)


@pytest.mark.cuda
def test_onchip_k2_adds_only_tile_partials():
    """At B = 512 DS1 f32 K = 1, one on-chip K2 call adds only its per-tile
    LL partials ((512, 30) floats) and the sum, under 1 MB, where the slab
    route adds its E and ES scratch (about 0.5 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, em, _, props, tips, w, r = _inputs("ds1", torch.float32, 1)
    reps = 512 // pc.shape[0] + 1
    pc, em = pc.repeat(reps, 1, 1)[:512].contiguous(), em.repeat(reps, 1, 1)[:512].contiguous()
    args = (pc, em, props, tips, w)
    pruning_jc.reset_counters()
    onchip = _added(lambda: pruning_jc.ll_jc69_cuda(*args, root_id=r))
    assert pruning_jc.LAUNCHES["ll_jc69"] == 1
    dims = (512, tips.shape[0], pc.shape[1], r + 2, 1, tips.shape[2])
    lib = pruning_jc._kernels.load("pruning_jc")
    slab = _added(lambda: pruning_jc._ll_jc69_slab(lib, dims, *args))
    assert onchip < 1e6 and slab > 4e8, (onchip, slab)


@pytest.mark.cuda
def test_onchip_k6_adds_only_chunk_partials():
    """At the JAX bench's config 2 shapes (256 DS1.100_topologies trees,
    f32, GTR + Weibull+4), one on-chip K6 call adds its per-(tree, chunk)
    dP partials, (256, 8, 3392) floats, 28 MB, and their sum: under
    128 MB, where the slab route adds its E, U and M scratch (about 2 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, _, tips, freqs, props, w, r = _generic_inputs("ds1", torch.float32, 4)
    reps = 256 // pc.shape[0] + 1
    pc, P = pc.repeat(reps, 1, 1)[:256].contiguous(), P.repeat(reps, 1, 1, 1, 1)[:256].contiguous()
    args = (pc, P, tips, freqs, props, w)
    pruning_vjp.reset_counters()
    onchip = _added(lambda: pruning_vjp.ll_dp_generic_cuda(*args, root_id=r))
    assert pruning_vjp.LAUNCHES["ll_dp_generic"] == 1
    dims = (256, tips.shape[0], pc.shape[1], r + 2, 4, tips.shape[2])
    lib = pruning_vjp.load_checked(4)
    slab = _added(lambda: pruning_vjp._ll_dp_generic_slab(
        lib, dims, pc, P, tips, (freqs, 0), (props, 0), w))
    assert onchip < 1.28e8 and slab > 1e9, (onchip, slab)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [
    "prepare_for_phylo_likelihood", "LikelihoodEngine", "make_engine",
    "GPEngine",
])
def test_entry_points_default_to_the_card(entry):
    """Called without device, each entry point computes on cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.gp.engine import GPEngine
    from libsbn_tpu_torch.models.engine import LikelihoodEngine
    gp = GPInstance()
    gp.read_fasta_file(f"{DATA}/hello.fasta")
    gp.read_newick_file(f"{DATA}/hello_rooted.nwk")
    if entry == "prepare_for_phylo_likelihood":
        inst = libsbn_tpu_torch.UnrootedInstance("default device")
        inst.read_newick_file(f"{DATA}/hello.nwk")
        inst.read_fasta_file(f"{DATA}/hello.fasta")
        inst.prepare_for_phylo_likelihood(libsbn_tpu_torch.PhyloModelSpec())
        eng = inst.engine
        assert abs(float(inst.log_likelihoods()[0]) - -84.852358) < 1e-6
    elif entry == "make_engine":
        gp.make_engine()
        eng = gp.get_engine()
        assert eng.use_kernels
    else:
        gp.make_engine(device="cpu")
        cpu = gp.get_engine()
        if entry == "LikelihoodEngine":
            eng = LikelihoodEngine(cpu.site_pattern,
                                   libsbn_tpu_torch.PhyloModelSpec())
        else:
            eng = GPEngine(cpu.site_pattern, gp.dag, cpu.q,
                           cpu.unconditional_node_probabilities,
                           cpu.inverted_sbn_prior)
    assert eng.device.type == "cuda"


def _ds1_instance(device):
    inst = libsbn_tpu_torch.UnrootedInstance("vbpi")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(libsbn_tpu_torch.PhyloModelSpec(),
                                      device=device)
    return inst


@pytest.mark.cuda
def test_vbpi_step_on_card_matches_cpu():
    """Two f64 VBPI steps on DS1 (10 particles, VIMCO, split-lognormal) on
    the card and on the CPU from one seed, so with the same host samples.
    They differ only in summation order (the kernel's tile sums, and
    index_add_, which sums with atomics in no fixed order on the card):
    the metrics within rtol 1e-9 / atol 1e-10; the parameters within
    rtol 1e-9 / atol 1e-8, since Adam's step lr g / (|g| + eps) passes a
    summation-order difference in a gradient entry near zero to the
    parameter times lr / eps = 1e5 (chip_smoke.py observed 7.1e-10 on
    sbn_params). The card's step launches K1 and calls no twin: once a
    step, and once more in the first, for the warm-up before its graph's
    capture (the graph route, vi/step_graph.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = JitVBPI(_ds1_instance("cpu"), particle_count=10, seed=0)
    card = JitVBPI(_ds1_instance("cuda"), particle_count=10, seed=0)
    for k in range(2):
        want = cpu.step()
        pruning_jc.reset_counters()
        got = card.step()
        torch.cuda.synchronize()
        assert pruning_jc.LAUNCHES["ll_grad_jc69"] == (2 if k == 0 else 1)
        assert sum(pruning_jc.TWIN_CALLS.values()) == 0
        for name in ("mean_ll", "elbo_like"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-9, atol=1e-10)
        for name in ("q_params", "sbn_params"):
            np.testing.assert_allclose(
                getattr(card.state, name).cpu().numpy(),
                getattr(cpu.state, name).numpy(), rtol=1e-9, atol=1e-8,
            )


def _generic_inputs(data, dtype, K):
    """The hello tree, three DS1.100_topologies trees, or "big" (two
    synthetic 256-taxon trees over 200 patterns, _synthetic), GTR at
    non-uniform rates and frequencies with one or K Weibull categories
    (shape 0.7), on the card: (post_children, P, Q_scaled, tips, freqs,
    props, weights, root_id)."""
    if data == "big":
        pc, bl, tips, w, root_id = _synthetic(2, 200)
    elif data == "hello":
        tops, bls, ttm = newick.parse_newick_file(f"{DATA}/hello.nwk")
        aln = Alignment.read_fasta(f"{DATA}/hello.fasta")
    else:
        tops, bls, ttm = newick.parse_newick_file(
            f"{DATA}/DS1.100_topologies.nwk")
        aln = Alignment.read_fasta(f"{DATA}/DS1.fasta")
    if data != "big":
        tops, bls = tops[:3], np.stack(bls[:3])
        sp = SitePattern(aln, ttm)
        sched = schedule.schedules_of_topologies(tops)
        bl = np.pad(bls * np.random.default_rng(1).uniform(0.8, 1.2, bls.shape),
                    ((0, 0), (0, 1)))
        pc, tips, w, root_id = (sched.post_children, sp.tip_partials(),
                                sp.weights, sched.root_id)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(dt).cuda()

    freqs = dev([0.3, 0.25, 0.2, 0.25], torch.float64)
    Q = substitution.gtr_q(dev([0.1, 0.2, 0.15, 0.25, 0.2, 0.1], torch.float64),
                           freqs)
    if K == 1:
        rates = props = dev(np.ones(1), torch.float64)
    else:
        rates, props = (dev(x, torch.float64) for x in weibull_rates(0.7, K))
    ts = dev(bl)[:, :, None] * rates.to(dtype)
    P = substitution.expm_transition(Q.to(dtype), freqs.to(dtype), ts)
    Qs = Q.to(dtype)[None] * rates.to(dtype)[:, None, None]
    return (dev(pc, torch.int32), P.contiguous(), Qs.contiguous(), dev(tips),
            freqs.to(dtype), props.to(dtype), dev(w), root_id)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "ds1"])
def test_generic_kernels_match_twins_on_card(data, dtype, K):
    """K4, K5 and K6 against their twins on one card, at the tolerances of
    TOL (inputs: _generic_inputs); K5 and K6 with shared freqs and props
    and with one row per tree; K4 and K6 on chip, their root and ones-slot
    rows zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, Qs, tips, freqs, props, w, r = _generic_inputs(data, dtype, K)
    B = pc.shape[0]
    (ll_rtol, ll_atol), (g_rtol, g_atol) = TOL[dtype]

    def close(got, want, rtol, atol):
        want = want.cpu().numpy()
        assert np.all(np.isfinite(want))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=rtol,
                                   atol=atol)

    args = (pc, P, Qs, tips, freqs, props, w)
    pruning_generic.reset_counters()
    k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
    torch.cuda.synchronize()
    assert pruning_generic.LAUNCHES == {"ll_grad_generic": 1,
                                        "ll_grad_generic_slab": 0}
    assert not k_g[:, r:].any()
    t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
    close(k_ll, t_ll, ll_rtol, ll_atol)
    close(k_g[:, :r], t_g[:, :r], g_rtol, g_atol)
    rows = (freqs * torch.linspace(0.9, 1.1, B, dtype=dtype,
                                   device="cuda")[:, None]).contiguous()
    for f, p in ((freqs, props), (rows, props.expand(B, K).contiguous())):
        args = (pc, P, tips, f, p, w)
        close(pruning_vjp.ll_generic_cuda(*args, root_id=r),
              pruning_vjp.ll_generic_plain(*args, root_id=r), ll_rtol, ll_atol)
        pruning_vjp.reset_counters()
        got = pruning_vjp.ll_dp_generic_cuda(*args, root_id=r)
        want = pruning_vjp.ll_dp_generic_plain(*args, root_id=r)
        torch.cuda.synchronize()
        assert pruning_vjp.LAUNCHES["ll_dp_generic"] == 1
        assert got[0].shape == (B, r + 2, K, 4, 4) and not got[0][:, r:].any()
        for a, b in zip(got, want):
            close(a, b, g_rtol, g_atol)


# K6 beyond its on-chip plan (the slab route: the 256-taxon tree at float64,
# or float32 K >= 4; at float64 K = 8 the tree's matrices exceed a block's
# shared memory and the slab route reads them from device memory), where
# the plan still fits on that tree (float32 K <= 3), and on DS1 at K that
# leave lanes idle (5) or fill the most shared memory (float64 K = 8).
K6_ROUTE_CASES = [("big", torch.float32, 4, "slab"),
                  ("big", torch.float64, 1, "slab"),
                  ("big", torch.float64, 8, "slab"),
                  ("big", torch.float32, 1, "onchip"),
                  ("big", torch.float32, 3, "onchip"),
                  ("ds1", torch.float32, 5, "onchip"),
                  ("ds1", torch.float64, 8, "onchip")]


@pytest.mark.cuda
@pytest.mark.parametrize("data,dtype,K,route", K6_ROUTE_CASES)
def test_k6_routes_match_twin_on_card(data, dtype, K, route):
    """K6 against its twin where dp_onchip_plan refuses the shapes (the
    slab route) and where it fits (K6_ROUTE_CASES); the counters show the
    route taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, _, tips, freqs, props, w, r = _generic_inputs(data, dtype, K)
    plan = pruning_vjp.dp_onchip_plan(dtype, K, pc.shape[1], tips.shape[0])
    assert (plan is None) == (route == "slab")
    pruning_vjp.reset_counters()
    got = pruning_vjp.ll_dp_generic_cuda(pc, P, tips, freqs, props, w, root_id=r)
    want = pruning_vjp.ll_dp_generic_plain(pc, P, tips, freqs, props, w,
                                           root_id=r)
    torch.cuda.synchronize()
    key = "ll_dp_generic_slab" if route == "slab" else "ll_dp_generic"
    assert pruning_vjp.LAUNCHES[key] == 1 and sum(pruning_vjp.LAUNCHES.values()) == 1
    assert not got[0][:, r:].any()
    g_rtol, g_atol = TOL[dtype][1]
    for a, b in zip(got, want):
        b = b.cpu().numpy()
        assert np.all(np.isfinite(b))
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=g_rtol, atol=g_atol)


# K4 beyond its on-chip plan (the slab route: the 256-taxon tree at float64,
# or float32 K >= 3; at float64 K = 8 with the matrices in device memory),
# where the plan still fits on that tree (float32 K <= 2), and on DS1 at
# the config-2 model, at K that leave lanes idle (5) or fill the most shared
# memory (float64 K = 8).
K4_ROUTE_CASES = [("big", torch.float32, 4, "slab"),
                  ("big", torch.float64, 1, "slab"),
                  ("big", torch.float64, 8, "slab"),
                  ("big", torch.float32, 3, "slab"),
                  ("big", torch.float32, 1, "onchip"),
                  ("big", torch.float32, 2, "onchip"),
                  ("ds1", torch.float32, 4, "onchip"),
                  ("ds1", torch.float64, 4, "onchip"),
                  ("ds1", torch.float32, 5, "onchip"),
                  ("ds1", torch.float64, 8, "onchip")]


@pytest.mark.cuda
@pytest.mark.parametrize("data,dtype,K,route", K4_ROUTE_CASES)
def test_k4_routes_match_twin_on_card(data, dtype, K, route):
    """K4 against its twin where ll_grad_onchip_plan refuses the shapes
    (the slab route) and where it fits (K4_ROUTE_CASES), at the tolerances
    of TOL; the counters show the route taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, Qs, tips, freqs, props, w, r = _generic_inputs(data, dtype, K)
    plan = pruning_generic.ll_grad_onchip_plan(dtype, K, pc.shape[1],
                                               tips.shape[0])
    assert (plan is None) == (route == "slab")
    args = (pc, P, Qs, tips, freqs, props, w)
    pruning_generic.reset_counters()
    k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
    torch.cuda.synchronize()
    key = "ll_grad_generic_slab" if route == "slab" else "ll_grad_generic"
    assert pruning_generic.LAUNCHES[key] == 1
    assert sum(pruning_generic.LAUNCHES.values()) == 1
    assert not k_g[:, r:].any()
    t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
    (ll_rtol, ll_atol), (g_rtol, g_atol) = TOL[dtype]
    for got, want, rtol, atol in ((k_ll, t_ll, ll_rtol, ll_atol),
                                  (k_g[:, :r], t_g[:, :r], g_rtol, g_atol)):
        want = want.cpu().numpy()
        assert np.all(np.isfinite(want))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_onchip_k4_adds_only_chunk_partials():
    """At the JAX bench's config 2 shapes (256 DS1.100_topologies trees,
    f32, GTR + Weibull+4), one on-chip K4 call adds its per-(tree, chunk)
    LL and gradient partials, (256, 8) and (256, 8, 53) floats, and their
    sums: under 50 MB, where the slab route adds its E and U scratch (about
    1.6 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, Qs, tips, freqs, props, w, r = _generic_inputs("ds1", torch.float32, 4)
    reps = 256 // pc.shape[0] + 1
    pc, P = pc.repeat(reps, 1, 1)[:256].contiguous(), P.repeat(reps, 1, 1, 1, 1)[:256].contiguous()
    args = (pc, P, Qs, tips, freqs, props, w)
    pruning_generic.reset_counters()
    onchip = _added(lambda: pruning_generic.ll_grad_generic_cuda(*args, root_id=r))
    assert pruning_generic.LAUNCHES["ll_grad_generic"] == 1
    dims = (256, tips.shape[0], pc.shape[1], r + 2, 4, tips.shape[2])
    lib = pruning_generic.load_checked(4)
    slab = _added(lambda: pruning_generic._ll_grad_generic_slab(lib, dims, *args))
    assert onchip < 5e7 and slab > 1e9, (onchip, slab)


# K5 on chip on DS1 at K = 1, 4 and 8 (the route the GTR path takes), and
# where its plan holds only one warp a block (the 256-taxon tree at float32
# K <= 3); beyond the plan (the 256-taxon tree at float32 K >= 4 and at
# float64), the slab route, which at float32 K = 8 and float64 K >= 4 reads
# the tree's matrices from device memory.
K5_ROUTE_CASES = ([("ds1", dt, K, "onchip") for dt in (torch.float32, torch.float64)
                   for K in (1, 4, 8)]
                  + [("big", torch.float32, 1, "onchip"),
                     ("big", torch.float32, 3, "onchip")]
                  + [("big", dt, K, "slab") for dt in (torch.float32, torch.float64)
                     for K in (4, 8)]
                  + [("big", torch.float64, 1, "slab")])


@pytest.mark.cuda
@pytest.mark.parametrize("data,dtype,K,route", K5_ROUTE_CASES)
def test_k5_routes_match_twin_on_card(data, dtype, K, route):
    """K5 against its twin, with shared freqs and props and with one row per
    tree, where ll_onchip_plan fits (on chip) and where it refuses the
    shapes (the slab route), at the tolerances of TOL; the counters show the
    route taken. On DS1 the slab route, called directly, is held to the twin
    too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, _, tips, freqs, props, w, r = _generic_inputs(data, dtype, K)
    B, L, S = pc.shape[0], tips.shape[0], pc.shape[1]
    plan = pruning_vjp.ll_onchip_plan(dtype, K, S, L)
    assert (plan is None) == (route == "slab")
    rows = (freqs * torch.linspace(0.9, 1.1, B, dtype=dtype,
                                   device="cuda")[:, None]).contiguous()
    ll_rtol, ll_atol = TOL[dtype][0]
    key = "ll_generic_slab" if route == "slab" else "ll_generic"
    lib = pruning_vjp.load_checked(K)
    dims = (B, L, S, r + 2, K, tips.shape[2])
    for f, p, strides in ((freqs, props, (0, 0)),
                          (rows, props.expand(B, K).contiguous(), (4, K))):
        args = (pc, P, tips, f, p, w)
        pruning_vjp.reset_counters()
        got = [pruning_vjp.ll_generic_cuda(*args, root_id=r)]
        torch.cuda.synchronize()
        assert pruning_vjp.LAUNCHES[key] == 1
        assert sum(pruning_vjp.LAUNCHES.values()) == 1
        if data == "ds1":
            got.append(pruning_vjp._ll_generic_slab(lib, dims, *args, *strides))
        want = pruning_vjp.ll_generic_plain(*args, root_id=r).cpu().numpy()
        assert np.all(np.isfinite(want))
        for g in got:
            np.testing.assert_allclose(g.cpu().numpy(), want, rtol=ll_rtol,
                                       atol=ll_atol)


@pytest.mark.cuda
def test_onchip_k5_adds_only_chunk_partials():
    """At the JAX bench's config 2 shapes (256 DS1.100_topologies trees,
    f32, GTR + Weibull+4), one on-chip K5 call adds its per-(tree, chunk)
    LL partials, (256, 1) floats, and their sum: under 1 MB, where the slab
    route adds its (B, N1, 4K, P) E scratch (about 811 MB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, P, _, tips, freqs, props, w, r = _generic_inputs("ds1", torch.float32, 4)
    reps = 256 // pc.shape[0] + 1
    pc, P = pc.repeat(reps, 1, 1)[:256].contiguous(), P.repeat(reps, 1, 1, 1, 1)[:256].contiguous()
    args = (pc, P, tips, freqs, props, w)
    pruning_vjp.reset_counters()
    onchip = _added(lambda: pruning_vjp.ll_generic_cuda(*args, root_id=r))
    assert pruning_vjp.LAUNCHES["ll_generic"] == 1
    dims = (256, tips.shape[0], pc.shape[1], r + 2, 4, tips.shape[2])
    lib = pruning_vjp.load_checked(4)
    slab = _added(lambda: pruning_vjp._ll_generic_slab(lib, dims, *args, 0, 0))
    assert onchip < 1e6 and slab > 5e8, (onchip, slab)


def _gtr_instance(device, count=10):
    inst = libsbn_tpu_torch.UnrootedInstance("gtr")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.tree_collection.trees = inst.tree_collection.trees[:count]
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        libsbn_tpu_torch.PhyloModelSpec("GTR", "weibull+4", "strict"),
        device=device)
    f64 = dict(dtype=torch.float64, device=device)
    inst.phylo_model_params["substitution"] = {
        "rates": torch.tensor([0.1, 0.2, 0.15, 0.25, 0.2, 0.1], **f64),
        "frequencies": torch.tensor([0.3, 0.25, 0.2, 0.25], **f64),
    }
    inst.phylo_model_params["site"]["shape"] = torch.tensor(0.7, **f64)
    return inst


@pytest.mark.cuda
def test_gtr_engine_on_card_matches_cpu():
    """The f64 GTR + Weibull+4 path through UnrootedInstance on the card
    against the same on the CPU: LLs within rtol 1e-12, every gradient
    within rtol 1e-9 / atol 1e-8 (summation order only). The card's run
    launches K4, K5 and K6 and calls no twin: each call is its key's
    first, which runs eagerly (utils/graphs.py), so its kernels launch
    once (log_likelihoods: K5; phylo_gradients: K4, then K5 + K6 for the
    model gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu, card = _gtr_instance("cpu"), _gtr_instance("cuda")
    want_ll, want = cpu.log_likelihoods(), cpu.phylo_gradients()
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        m.reset_counters()
    got_ll, got = card.log_likelihoods(), card.phylo_gradients()
    torch.cuda.synchronize()
    assert pruning_generic.LAUNCHES == {"ll_grad_generic": 1,
                                        "ll_grad_generic_slab": 0}
    assert pruning_vjp.LAUNCHES == {"ll_generic": 2, "ll_generic_slab": 0,
                                    "ll_dp_generic": 1, "ll_dp_generic_slab": 0}
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        assert not any(m.TWIN_CALLS.values())
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-12)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(),
                                   rtol=1e-9, atol=1e-8, err_msg=key)


def _gp_instance(data, device, dtype=torch.float64, use_kernels="auto",
                 cuda_graphs=True):
    fasta, nwk = {"hello": ("hello.fasta", "hello_rooted.nwk"),
                  "fluA": ("fluA.fa", "fluA.tree")}[data]
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{nwk}")
    inst.make_engine(dtype=dtype, device=device, use_kernels=use_kernels,
                     cuda_graphs=cuda_graphs)
    return inst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "fluA"])
def test_gp_kernels_match_twins_on_card(data, dtype):
    """K7 (on chip) and K8 against their twins on one card at seeded branch
    lengths: K7's 12 arrays within rtol 1e-12 (log-scales atol 1e-12) in f64, rtol
    1e-5 with atol 1e-6 (log-scales 1e-4) in f32; K8's objective at the two
    outputs within 1e-12 (f64) or 1e-5 (f32) of |f| + sum(w), and in f64 the
    log branch lengths within 1e-6 where the objective is not flat
    (engine_kernels.sweep_disagreement)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = _gp_instance(data, "cuda", dtype).get_engine()
    assert eng.use_kernels
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    args = (eng._edge_streams(), eng._tensor(eng.q),
            _jc69_transition(bl).contiguous(), eng._tips)
    engine_kernels.reset_counters()
    got = engine_kernels.populate_plvs_cuda(*args)
    want = engine_kernels.populate_plvs_twin(*args)
    torch.cuda.synchronize()
    assert engine_kernels.LAUNCHES["populate_plvs"] == 1
    assert engine_kernels.LAUNCHES["populate_plvs_slab"] == 0
    f64 = dtype == torch.float64
    for k in engine_kernels.PLV_KEYS:
        if k.startswith("ls_"):
            rtol, atol = (1e-12, 1e-12) if f64 else (1e-5, 1e-4)
        else:
            rtol, atol = (1e-12, 1e-300) if f64 else (1e-5, 1e-6)
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)
    A, B = engine_kernels.sweep_stats(got, eng._pa, eng._ch, eng._rot)
    A, B = A.contiguous(), B.contiguous()
    cur = torch.log(bl[eng._g]).contiguous()
    k8 = engine_kernels.golden_sweep_cuda(A, B, eng._w, cur)
    t8 = engine_kernels.golden_sweep_twin(A, B, eng._w, cur)
    obj_gap, lb_gap, _ = engine_kernels.sweep_disagreement(A, B, eng._w, k8, t8)
    assert obj_gap <= (1e-12 if f64 else 1e-5), obj_gap
    if f64:
        assert lb_gap <= 1e-6, lb_gap


# K8 against its twin (engine_kernels.sweep_disagreement): the largest
# objective gap over |f| + sum(w), and the largest log-branch-length gap on
# edges that are not flat (None: not held, float32 resolves the minimiser
# only to about its square root of eps), as chip_smoke.py's GP_TWIN_TOL.
SWEEP_TOL = {torch.float64: (1e-12, 1e-6), torch.float32: (1e-5, None)}


def _sweep_inputs(data, dtype):
    """K8's inputs on the card at seeded branch lengths, from K7's PLVs:
    (A, B, w, current log branch lengths)."""
    eng = _gp_instance(data, "cuda", dtype).get_engine()
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    plvs = engine_kernels.populate_plvs_cuda(
        eng._edge_streams(), eng._tensor(eng.q),
        _jc69_transition(bl).contiguous(), eng._tips)
    A, B = engine_kernels.sweep_stats(plvs, eng._pa, eng._ch, eng._rot)
    return (A.contiguous(), B.contiguous(), eng._w,
            torch.log(bl[eng._g]).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["main", "slab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "fluA"])
def test_k8_routes_match_twin_on_card(data, dtype, route):
    """K8's main design (a block per edge over staged rows, the route its
    plan takes on hello and fluA) and its slab route (the first design,
    called directly) against the twin, by sweep_disagreement at
    SWEEP_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _sweep_inputs(data, dtype)
    plan = engine_kernels.golden_sweep_plan(dtype, args[0].shape[1])
    assert plan is not None
    engine_kernels.reset_counters()
    if route == "main":
        got = engine_kernels.golden_sweep_cuda(*args)
    else:
        got = engine_kernels._golden_sweep_launch(*args, None)
    torch.cuda.synchronize()
    key = "golden_sweep_slab" if route == "slab" else "golden_sweep"
    assert engine_kernels.LAUNCHES[key] == 1
    assert sum(engine_kernels.LAUNCHES.values()) == 1
    want = engine_kernels.golden_sweep_twin(*args)
    obj_gap, lb_gap, _ = engine_kernels.sweep_disagreement(*args[:3], got, want)
    obj_tol, lb_tol = SWEEP_TOL[dtype]
    assert torch.isfinite(got).all()
    assert obj_gap <= obj_tol, obj_gap
    if lb_tol is not None:
        assert lb_gap <= lb_tol, lb_gap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_repeats_bit_for_bit(dtype):
    """Two launches of the main K8 on fluA's rows give the same bits: its
    warp sums are added in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _sweep_inputs("fluA", dtype)
    first = engine_kernels.golden_sweep_cuda(*args)
    second = engine_kernels.golden_sweep_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S", [(torch.float32, 19_361), (torch.float64, 9_675)])
def test_k8_rows_beyond_the_plan_take_the_slab_route(dtype, S):
    """Rows of one pattern more than golden_sweep_plan holds take the slab
    route, held to the twin by sweep_disagreement at SWEEP_TOL; seeded
    rows A, B > 0 and weights, 4 edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert engine_kernels.golden_sweep_plan(dtype, S) is None
    rng = np.random.default_rng(0)
    A, B = (torch.as_tensor(rng.uniform(0.01, 1.0, (4, S)), dtype=dtype,
                            device="cuda") for _ in range(2))
    w = torch.as_tensor(rng.integers(1, 5, S), dtype=dtype, device="cuda")
    cur = torch.as_tensor(np.log(rng.uniform(0.01, 0.3, 4)), dtype=dtype,
                          device="cuda")
    engine_kernels.reset_counters()
    got = engine_kernels.golden_sweep_cuda(A, B, w, cur)
    torch.cuda.synchronize()
    assert engine_kernels.LAUNCHES == {"populate_plvs": 0, "populate_plvs_slab": 0,
                                       "golden_sweep": 0, "golden_sweep_slab": 1}
    want = engine_kernels.golden_sweep_twin(A, B, w, cur)
    obj_gap, lb_gap, _ = engine_kernels.sweep_disagreement(A, B, w, got, want)
    obj_tol, lb_tol = SWEEP_TOL[dtype]
    assert obj_gap <= obj_tol, obj_gap
    if lb_tol is not None:
        assert lb_gap <= lb_tol, lb_gap


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "level"])
def test_gp_fit_on_card_matches_cpu(use_kernels):
    """run_branch_ascent(1e-6, 100) on fluA in f64 on the card and on the
    CPU, on one route: the kernel route (K7 + K8 on the card, their twins on
    the CPU) or the level route. Both land on libsbn_tpu's optimum
    -4337.885058592 within 1e-7. The level route's Newton sweeps differ
    in summation order only: same sweep count, branch lengths within rtol
    1e-6. The card's kernel route launches K7 and K8 (once a sweep, and
    once for the capture's warm-up of the propose graph) and calls no
    twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = []
    for device in ("cpu", "cuda"):
        eng = _gp_instance("fluA", device, use_kernels=use_kernels).get_engine()
        engine_kernels.reset_counters()
        m, sweeps = eng.run_branch_ascent(1e-6, 100)
        torch.cuda.synchronize()
        assert abs(m - -4337.885058592) < 1e-7, (device, m)
        out.append((sweeps, eng.branch_lengths.copy()))
    assert eng.graphs is not None
    if use_kernels:
        assert engine_kernels.LAUNCHES["golden_sweep"] == out[1][0] + 1
        assert sum(engine_kernels.TWIN_CALLS.values()) == 0
    else:
        assert sum(engine_kernels.LAUNCHES.values()) == 0
        assert out[0][0] == out[1][0]
        np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)


def _synthetic_gp(taxa, sites, seed=0, dtype=torch.float64):
    """A GP engine on the card over one random rooted tree of ``taxa``
    leaves (joins and branch lengths from default_rng(seed)) and a random
    alignment of ``sites`` columns; 600 taxa make a DAG of 1,199 nodes,
    beyond K7's on-chip plan at both dtypes."""
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
    inst.make_engine(dtype=dtype, device="cuda")
    return inst.get_engine()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_slab_route_matches_twin_on_card(dtype):
    """K7 on a 600-taxon synthetic rooted tree (_synthetic_gp), whose
    1,199-node DAG does not fit one pattern on chip: the slab route,
    against the twin at the tolerances of test_gp_kernels_match_twins_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = _synthetic_gp(600, 200, dtype=dtype)
    st = eng._edge_streams()
    dims = (st.node_count, eng.dag.gpcsp_count_with_fake(), st.rootward.shape[0],
            st.leafward.shape[0], st.roots.shape[0])
    assert engine_kernels.populate_onchip_plan(dtype, *dims) is None
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    args = (st, eng._tensor(eng.q), _jc69_transition(bl).contiguous(), eng._tips)
    engine_kernels.reset_counters()
    got = engine_kernels.populate_plvs_cuda(*args)
    torch.cuda.synchronize()
    assert engine_kernels.LAUNCHES == {"populate_plvs": 0, "populate_plvs_slab": 1,
                                       "golden_sweep": 0, "golden_sweep_slab": 0}
    want = engine_kernels.populate_plvs_twin(*args)
    f64 = dtype == torch.float64
    for k in engine_kernels.PLV_KEYS:
        if k.startswith("ls_"):
            rtol, atol = (1e-12, 1e-12) if f64 else (1e-5, 1e-4)
        else:
            rtol, atol = (1e-12, 1e-300) if f64 else (1e-5, 1e-6)
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.cuda
def test_onchip_k7_adds_only_its_outputs():
    """On fluA, float32, one on-chip K7 call adds its 8 output tensors (the
    12 PLV views of them) and nothing else: exactly what allocating those 8
    tensors adds, from an emptied cache each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = _gp_instance("fluA", "cuda", torch.float32).get_engine()
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    args = (eng._edge_streams(), eng._tensor(eng.q),
            _jc69_transition(bl).contiguous(), eng._tips)
    N, S = args[0].node_count, eng._tips.shape[2]
    shapes = [(N, 4, S), (2 * N, 4, S), (N, 4, S), (2 * N, 4, S), (N, S),
              (2 * N, S), (N, S), (2 * N, S)]
    engine_kernels.reset_counters()
    torch.cuda.empty_cache()
    added = _added(lambda: engine_kernels.populate_plvs_cuda(*args))
    assert engine_kernels.LAUNCHES["populate_plvs"] == 1
    torch.cuda.empty_cache()
    want = _added(lambda: [torch.empty(x, dtype=torch.float32, device="cuda")
                           for x in shapes])
    assert added == want >= sum(np.prod(x) * 4 for x in shapes), (added, want)


def _rooted_instance(device, dtype, sub, site, batch=4):
    """RootedInstance on fluA (dates from the taxon names, clock rate
    0.001), its one tree tiled to ``batch`` with the ratios perturbed by
    U(0.95, 1.05) from default_rng(0): (instance, the engine's arguments)."""
    inst = libsbn_tpu_torch.RootedInstance("fluA")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.parse_dates_from_taxon_names(True)
    inst.set_clock_rates(0.001)
    inst.prepare_for_phylo_likelihood(
        libsbn_tpu_torch.PhyloModelSpec(sub, site, "strict"), device=device,
        dtype=dtype)
    f64 = dict(dtype=torch.float64, device=device)
    if sub == "GTR":
        inst.phylo_model_params["substitution"] = {
            "rates": torch.tensor([0.05, 0.1, 0.15, 0.2, 0.25, 0.25], **f64),
            "frequencies": torch.tensor([0.1, 0.2, 0.3, 0.4], **f64),
        }
    if site != "constant":
        inst.phylo_model_params["site"]["shape"] = torch.tensor(0.1, **f64)
    bounds, ratios, rates = (np.repeat(x, batch, axis=0)
                             for x in inst._time_tree_arrays())
    rng = np.random.default_rng(0)
    ratios[:, :-1] = np.clip(
        ratios[:, :-1] * rng.uniform(0.95, 1.05, ratios[:, :-1].shape),
        1e-4, 1 - 1e-4)
    sched = schedule.schedules_of_topologies(
        [inst.tree_collection.trees[0].topology] * batch)
    return inst, (sched, bounds, ratios, rates, inst.phylo_model_params)


# route -> (substitution, the engine method, {kernel: launches per call} at
# K = 1 and at K = 4 (Weibull+4 adds the shape gradient's K2 + K3)); the
# hand route's heights kernels are "forward" and "adjoint".
ROOTED_ROUTES = {
    "hand": ("JC69", "rooted_phylo_gradients",
             ({"ll_grad_jc69": 1, "forward": 1, "adjoint": 1},
              {"ll_grad_jc69": 1, "ll_jc69": 1, "ll_dea_jc69": 1,
               "forward": 1, "adjoint": 1})),
    "autograd_jc69": ("JC69", "_rooted_phylo_gradients_autograd",
                      ({"ll_jc69": 1, "ll_dea_jc69": 1},
                       {"ll_jc69": 2, "ll_dea_jc69": 2})),
    "autograd_gtr": ("GTR", "rooted_phylo_gradients",
                     ({"ll_generic": 2, "ll_dp_generic": 2},) * 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", sorted(ROOTED_ROUTES))
def test_rooted_engine_on_card_matches_cpu(route, dtype, K):
    """The rooted engine on fluA x 4 perturbed trees on the card against the
    same on the CPU (the kernels' twins, the heights kernels' too), at the
    kernels' tolerances: the LLs + ldjs of
    rooted_log_likelihoods and every gradient of each route. The route is
    read from the launch counters of a third call (the first runs eagerly
    and the second captures a graph route's key): its kernels, on chip or
    on their slab routes (f64 K = 4 exceeds K1-K3's plan, and such a key
    stays eager), the heights kernels on the hand route, and no twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sub, method, launches = ROOTED_ROUTES[route]
    site = "constant" if K == 1 else "weibull+4"
    cpu, cpu_args = _rooted_instance("cpu", dtype, sub, site)
    card, card_args = _rooted_instance("cuda", dtype, sub, site)
    extra = () if method == "rooted_phylo_gradients" else (True,)
    want = getattr(cpu.engine, method)(*cpu_args, *extra)
    want_ll = cpu.engine.rooted_log_likelihoods(*cpu_args)
    kernels = (pruning_jc, pruning_generic, pruning_vjp, heights)
    for _ in range(2):
        getattr(card.engine, method)(*card_args, *extra)
    for m in kernels:
        m.reset_counters()
    got = getattr(card.engine, method)(*card_args, *extra)
    torch.cuda.synchronize()
    counts = {k: v for m in kernels for k, v in m.LAUNCHES.items()}
    onchip = pruning_jc.onchip_plan(dtype, K, 68, 69) is not None
    took = {}
    for key, count in counts.items():
        if count:
            base = key.replace("_slab", "")
            took[base] = took.get(base, 0) + count
            if key.endswith("_slab"):
                assert not onchip and sub == "JC69", key
    assert took == launches[K > 1], counts
    for m in kernels:
        assert not any(m.TWIN_CALLS.values())
    got_ll = card.engine.rooted_log_likelihoods(*card_args)
    ll_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(got_ll.cpu().numpy(), want_ll.numpy(),
                               rtol=ll_tol[0], atol=ll_tol[1])
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cuda"
        tol = ll_tol if key == "log_likelihood" else grad_tol
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=key)


# -- the vip layer on the card ------------------------------------------------


def _burrito(device, data, branch_model="split"):
    """A Burrito (lognormal, the simple optimizer, seed 0, float64) on
    ``device``: hello (3 particles) or DS1.subsampled_10 (burn in 0.1, 10
    particles)."""
    from libsbn_tpu_torch.vi import Burrito

    tree, fasta, burn_in, particles = {
        "hello": ("hello_out.t", "hello.fasta", 0.0, 3),
        "DS1": ("DS1.subsampled_10.t", "DS1.fasta", 0.1, 10)}[data]
    return Burrito(
        mcmc_nexus_path=f"{DATA}/{tree}", burn_in_fraction=burn_in,
        fasta_path=f"{DATA}/{fasta}",
        phylo_model_specification=libsbn_tpu_torch.PhyloModelSpec(
            "JC69", "constant", "strict"),
        branch_model_name=branch_model, scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=particles, seed=0,
        device=device, dtype=torch.float64)


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), np.max(
        np.abs(got - want) / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("branch_model", ["split", "psp"])
@pytest.mark.parametrize("data", ["hello", "DS1"])
def test_burrito_on_card_matches_cpu(data, branch_model):
    """Five gradient steps of the Burrito on the card (K1 and K2) against
    the same seed on the CPU (their twins): the ELBO traces, q-params and
    SBN parameters at rel 1e-9; the card run launches K1 and K2 and calls
    no twin: once a step each, and once more each for the warm-up before
    the capture of its graph (branch_gradients and log_likelihoods, the
    same key every step: the first step runs them eagerly, the second
    captures them, each later step replays them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = _burrito("cpu", data, branch_model)
    cpu.gradient_steps(5)
    card = _burrito("cuda", data, branch_model)
    pruning_jc.reset_counters()
    unrooted_graph.reset_counters()
    card.gradient_steps(5)
    torch.cuda.synchronize()
    assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 5 + 1
    assert pruning_jc.LAUNCHES["ll_jc69"] == 5 + 1
    assert unrooted_graph.COUNTS == {"captures": 2, "replays": 8,
                                     "eager": 2}
    assert not any(pruning_jc.TWIN_CALLS.values())
    _rel_close(card.elbo_trace, cpu.elbo_trace, 1e-9)
    _rel_close(card.scalar_model.q_params, cpu.scalar_model.q_params, 1e-9)
    _rel_close(card.inst.sbn_parameters, cpu.inst.sbn_parameters, 1e-9)


@pytest.mark.cuda
def test_em_on_card_matches_goldens():
    """EM on the card against the zcrabbit goldens (tests/golden_sbn.py:
    atol 1e-12, EM(0.5, 100) at 1e-5); a second run on the card equal bit
    for bit (every sum in a fixed order); and against EM on the CPU: the
    trees' probabilities at atol 1e-12, the scores at rtol 1e-12, the log
    parameters at rel 1e-12 (|card - cpu| <= 1e-12 (|cpu| + max |cpu|),
    the measure that holds the port to libsbn_tpu on the CPU: the card sums
    each slot in another fixed order than the CPU, and EM(0, 23) carries
    that rounding along directions the trees do not determine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from golden_sbn import EXPECTED_EM_0_23, EXPECTED_EM_05_100

    insts = []
    for _ in range(3):
        inst = libsbn_tpu_torch.UnrootedInstance("charlie")
        inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
        inst.process_loaded_trees()
        insts.append(inst)
    card, again, cpu = insts
    for alpha, iters, golden, atol in ((0.0, 23, EXPECTED_EM_0_23, 1e-12),
                                       (0.5, 100, EXPECTED_EM_05_100, 1e-5)):
        scores = card.train_expectation_maximization(alpha, iters)
        np.testing.assert_allclose(card.calculate_sbn_probabilities(), golden,
                                   atol=atol)
        np.testing.assert_array_equal(
            again.train_expectation_maximization(alpha, iters), scores)
        np.testing.assert_array_equal(again.sbn_parameters,
                                      card.sbn_parameters)
        want = cpu.train_expectation_maximization(alpha, iters, device="cpu")
        np.testing.assert_allclose(card.calculate_sbn_probabilities(),
                                   cpu.calculate_sbn_probabilities(),
                                   atol=1e-12)
        np.testing.assert_allclose(scores, want, rtol=1e-12)
        _rel_close(card.sbn_parameters, cpu.sbn_parameters, 1e-12)


@pytest.mark.cuda
def test_per_tree_gtr_rows_on_card_match_cpu():
    """GTR + Weibull+4 with a parameter row per tree (DS1.subsampled_10,
    float64) on the card against the CPU, rel 1e-10: the LLs on K5, the
    branch gradients on the scan engine, the model gradients on K5 + K6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.ops import pruning

    out = []
    for device in ("cpu", "cuda"):
        inst = libsbn_tpu_torch.UnrootedInstance("per tree")
        inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
        inst.read_fasta_file(f"{DATA}/DS1.fasta")
        inst.prepare_for_phylo_likelihood(
            libsbn_tpu_torch.PhyloModelSpec("GTR", "weibull+4", "strict"),
            device=device)
        blocks = inst.get_phylo_model_param_block_map()
        rng = np.random.default_rng(7)
        blocks["frequencies"][:] = rng.dirichlet(np.full(4, 20.0), size=10)
        blocks["GTR rates"][:] = rng.dirichlet(np.full(6, 20.0), size=10)
        blocks["Weibull shape"][:, 0] = rng.uniform(0.3, 2.0, 10)
        for m in (pruning, pruning_generic, pruning_vjp):
            m.reset_counters()
        out.append((inst.log_likelihoods(), inst.phylo_gradients()))
    torch.cuda.synchronize()
    assert pruning_vjp.LAUNCHES["ll_generic"] == 2
    assert pruning_vjp.LAUNCHES["ll_dp_generic"] == 1
    assert pruning.CALLS["ll_grad"] == 1
    assert not pruning_generic.LAUNCHES["ll_grad_generic"]
    (cpu_ll, cpu_g), (card_ll, card_g) = out
    _rel_close(card_ll, cpu_ll, 1e-10)
    for key in cpu_g:
        assert card_g[key].device.type == "cuda"
        _rel_close(card_g[key].cpu(), cpu_g[key], 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_at_ten_thousand_trees(dtype):
    """K2 at B = 10,000 (vi.benchmark.fixed's final ELBO: DS1's ten trees
    tiled, branch lengths perturbed by a seeded U(0.8, 1.2)): finite, on
    chip, and equal to ten B = 1,000 launches at the twin tolerance; the
    first thousand also against the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, rates, props, tips, w, r = _inputs("ds1", dtype, 1)
    tops, bls, _ = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sched = schedule.schedules_of_topologies(tops * 1000)
    rng = np.random.default_rng(2)
    bl = np.tile(np.stack(bls), (1000, 1))
    bl = np.pad(bl * rng.uniform(0.8, 1.2, bl.shape), ((0, 0), (0, 1)))
    pc = torch.as_tensor(sched.post_children, dtype=torch.int32).cuda()
    em = pruning_jc.exp_complements(torch.as_tensor(bl).cuda(), rates,
                                    dtype)
    pruning_jc.reset_counters()
    full = pruning_jc.ll_jc69_cuda(pc, em, props, tips, w, root_id=r)
    parts = torch.cat([
        pruning_jc.ll_jc69_cuda(pc[i:i + 1000].contiguous(),
                                em[i:i + 1000].contiguous(), props, tips, w,
                                root_id=r)
        for i in range(0, 10_000, 1000)])
    torch.cuda.synchronize()
    assert pruning_jc.LAUNCHES["ll_jc69"] == 11
    assert full.shape == (10_000,) and torch.isfinite(full).all()
    (rtol, atol), _ = TOL[dtype]
    np.testing.assert_allclose(full.cpu().numpy(), parts.cpu().numpy(),
                               rtol=rtol, atol=atol)
    twin = pruning_jc.ll_jc69_plain(pc[:1000].contiguous(),
                                    em[:1000].contiguous(), props, tips, w,
                                    root_id=r)
    np.testing.assert_allclose(full[:1000].cpu().numpy(), twin.cpu().numpy(),
                               rtol=rtol, atol=atol)


# -- forest mode and the streamed GP ascent -----------------------------------


def _ds1_100_forest():
    """DS1.100_topologies' forest, DS1's tips and weights as numpy, and two
    seeded split-keyed length sets."""
    tops, _, ttm = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    fs = forest.build_forest(tops)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    bl = np.random.default_rng(7).uniform(0.02, 0.2, (2, fs.n_splits))
    return fs, sp.tip_partials(), sp.weights, bl


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "unfused", "ll_only", "generic"])
def test_forest_on_card_matches_cpu(path):
    """The f64 forest on DS1.100 (two length sets) on the card and on the
    CPU, from the same numpy inputs: LLs and per-tree gradients at rel
    1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fs, tips, w, bl = _ds1_100_forest()
    out = []
    for device in ("cpu", "cuda"):
        if path == "generic":
            freqs, evec, ivec, evals = substitution.jc69_eigen(device=device)
            one = torch.ones(1, dtype=torch.float64, device=device)
            ll, g = forest.forest_log_likelihoods_and_gradients(
                fs, bl, evec, ivec, evals, substitution.jc69_q(device=device)[None],
                tips, freqs, one, one, w, device=device)
        else:
            ll, g = forest.forest_jc_log_likelihoods_and_gradients(
                fs, bl, tips, w, dtype=torch.float64, device=device,
                fused=path == "fused", ll_only=path == "ll_only")
        assert ll.device.type == device
        out.append([x.cpu().numpy() for x in (ll, g) if x is not None])
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forest_split_gradient_repeats_bit_for_bit(dtype):
    """The split gradient on the card (autograd through the LL-only forest:
    its gathers' backward sums in a fixed order) twice, equal bit for bit;
    at f64 within rel 1e-10 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fs, tips, w, bl = _ds1_100_forest()
    args = [torch.as_tensor(x).to(dtype).cuda() for x in (bl, tips, w)]
    runs = [forest.forest_jc_weighted_ll_and_split_gradient(
        fs, *args, dtype=dtype) for _ in range(2)]
    assert runs[0][1].device.type == "cuda"
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    if dtype == torch.float64:
        _, want = forest.forest_jc_weighted_ll_and_split_gradient(
            fs, bl, tips, w, dtype=dtype, device="cpu")
        np.testing.assert_allclose(runs[0][1].cpu().numpy(), want.numpy(),
                                   rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))


@pytest.mark.cuda
def test_streamed_ascent_on_card_matches_level_route():
    """run_branch_ascent_streamed(1e-6, 100, 100) on fluA, f64, on the kernel
    route (K7 a chunk: 238 patterns in three chunks, the last padded; by
    the chunk programs' graphs, the engine's default) lands within 1e-7 of
    the in-memory level-route fit on the card and of libsbn_tpu's optimum;
    K7 launched, K8 and the twins did not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    level = _gp_instance("fluA", "cuda", use_kernels=False).get_engine()
    m_level, _ = level.run_branch_ascent(1e-6, 100)
    eng = _gp_instance("fluA", "cuda").get_engine()
    assert eng.use_kernels
    engine_kernels.reset_counters()
    m, sweeps = eng.run_branch_ascent_streamed(1e-6, 100, 100)
    torch.cuda.synchronize()
    # Less finalize's launch and the statistics graph's capture warm-up.
    k7 = engine_kernels.LAUNCHES["populate_plvs"] - 2
    assert k7 >= 3 * (sweeps + 1) and k7 % 3 == 0
    assert engine_kernels.LAUNCHES["golden_sweep"] == 0
    assert sum(engine_kernels.TWIN_CALLS.values()) == 0
    assert abs(m - m_level) < 1e-7 and abs(m - -4337.885058592) < 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [100, 7, 33])
def test_k7_at_chunk_widths_matches_twin(width, dtype):
    """K7 on fluA over a chunk of ``width`` patterns (no multiple of 32;
    the on-chip plan does not depend on the width) against its twin, at
    the tolerances of test_gp_kernels_match_twins_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = _gp_instance("fluA", "cuda", dtype).get_engine()
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    args = (eng._edge_streams(), eng._tensor(eng.q),
            _jc69_transition(bl).contiguous(),
            eng._tips[..., 50:50 + width].contiguous())
    engine_kernels.reset_counters()
    got = engine_kernels.populate_plvs_cuda(*args)
    torch.cuda.synchronize()
    assert engine_kernels.LAUNCHES["populate_plvs"] == 1
    want = engine_kernels.populate_plvs_twin(*args)
    f64 = dtype == torch.float64
    for k in engine_kernels.PLV_KEYS:
        assert got[k].shape[-1] == width
        if k.startswith("ls_"):
            rtol, atol = (1e-12, 1e-12) if f64 else (1e-5, 1e-4)
        else:
            rtol, atol = (1e-12, 1e-300) if f64 else (1e-5, 1e-6)
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.cuda
def test_streamed_chunks_beyond_the_plan_take_the_slab_route():
    """K7's plan depends on the DAG, not on the chunk width: on the 600-taxon
    synthetic tree (_synthetic_gp), beyond the plan at f64, every chunk of
    the streamed ascent takes K7's slab route, and the fit lands where the
    level route's streamed fit does. The statistics program, whose first
    call ran the slab route, stays eager (no capture, no warm-up launch);
    the derivative and objective programs are captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.gp import streamed_graph

    eng = _synthetic_gp(600, 200)
    engine_kernels.reset_counters()
    streamed_graph.reset_counters()
    m, sweeps = eng.run_branch_ascent_streamed(1e-2, 3, 64, finalize=False)
    torch.cuda.synchronize()
    assert engine_kernels.LAUNCHES["populate_plvs"] == 0
    slab = engine_kernels.LAUNCHES["populate_plvs_slab"]
    assert slab >= 4 * (sweeps + 1) and slab % 4 == 0
    assert streamed_graph.COUNTS["captures"] == 2
    assert streamed_graph.COUNTS["eager"] == slab + 2
    level = _synthetic_gp(600, 200)
    level.use_kernels = False
    m_level, sweeps_level = level.run_branch_ascent_streamed(
        1e-2, 3, 64, finalize=False)
    assert sweeps == sweeps_level and abs(m - m_level) < 1e-7 * abs(m_level)


def _two_shards():
    """A dp = 2 mesh of the one card, twice."""
    return make_mesh(2, dp=2, devices=["cuda:0", "cuda:0"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_k1_k4_match_local_on_card(dtype):
    """The dp wrappers of K1 (DS1 x 10, then x 64) and K4 (three
    DS1.100_topologies trees at Weibull+4) over two shards of the card: two
    launches each, no twin, results on the card within the twin tolerance
    of the unsharded launch (each tree is independent; the per-tile sums
    may reduce in another order for another batch size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (ll_tol, g_tol) = TOL[dtype]
    pc, em, rates, props, tips, w, r = _inputs("ds1", dtype, 1)
    tops, bls, _ = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    bl = torch.as_tensor(np.pad(np.stack(bls), ((0, 0), (0, 1)))).to(
        dtype).cuda()
    pc10 = torch.as_tensor(schedule.schedules_of_topologies(tops).post_children,
                           dtype=torch.int32).cuda()
    for reps in (1, 7):
        pcb, blb = pc10.repeat(reps, 1, 1)[:64], bl.repeat(reps, 1)[:64]
        pruning_jc.reset_counters()
        got = pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
            _two_shards(), pcb, blb, tips, w, root_id=r)
        torch.cuda.synchronize()
        assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 2
        assert sum(pruning_jc.TWIN_CALLS.values()) == 0
        want = pruning_jc.log_likelihood_and_branch_gradient_jc69(
            pcb, blb, tips, w, root_id=r)
        for a, b, (rtol, atol) in zip(got, want, (ll_tol, g_tol)):
            assert a.device.type == "cuda"
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=rtol, atol=atol)
    *args, r4 = _generic_inputs("ds1", dtype, 4)
    pruning_generic.reset_counters()
    got = pruning_generic.log_likelihood_and_branch_gradient_generic_sharded(
        _two_shards(), *args, root_id=r4)
    torch.cuda.synchronize()
    assert pruning_generic.LAUNCHES["ll_grad_generic"] == 2
    want = pruning_generic.log_likelihood_and_branch_gradient_generic(
        *args, root_id=r4)
    for a, b, (rtol, atol) in zip(got, want, (ll_tol, g_tol)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_local_mesh_vbpi_on_card_matches_unsharded():
    """Two f64 VBPI steps on DS1 with the particles over two shards of the
    card against the unsharded trainer, as test_vbpi_step_on_card_matches_cpu
    holds the card to the CPU; two K1 launches a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    one = JitVBPI(_ds1_instance("cuda"), particle_count=10, seed=0)
    two = JitVBPI(_ds1_instance("cuda"), particle_count=10, seed=0,
                  mesh=_two_shards())
    for _ in range(2):
        want = one.step()
        pruning_jc.reset_counters()
        got = two.step()
        torch.cuda.synchronize()
        assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 2
        for name in ("mean_ll", "elbo_like"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-9, atol=1e-10)
        for name in ("q_params", "sbn_params"):
            np.testing.assert_allclose(
                getattr(two.state, name).cpu().numpy(),
                getattr(one.state, name).cpu().numpy(), rtol=1e-9, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [2, 4])
def test_gp_sp_mesh_on_card(sp):
    """fluA's 238 patterns over sp shards of the card (sp = 4 pads them to
    240), f64 kernel route: the fit (1e-6, 100) within 1e-7 of the
    unsharded kernel route's, K7 launched per shard and K8 once a sweep
    on the gathered rows, no twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = _gp_instance("fluA", "cuda").get_engine().run_branch_ascent(
        1e-6, 100)[0]
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.make_engine(mesh=make_mesh(sp, dp=1, sp=sp,
                                    devices=["cuda:0"] * sp))
    engine_kernels.reset_counters()
    got, sweeps = inst.get_engine().run_branch_ascent(1e-6, 100)
    torch.cuda.synchronize()
    assert abs(got - want) < 1e-7
    assert engine_kernels.LAUNCHES["golden_sweep"] == sweeps
    assert engine_kernels.LAUNCHES["populate_plvs"] % sp == 0
    assert sum(engine_kernels.TWIN_CALLS.values()) == 0


# -- the GP ascent's and the rooted engine's graphs ----------------------------


def _ascent(eng, bl0, tol, max_iter):
    """run_branch_ascent from bl0 with every counter at 0 first: (marginal,
    sweeps, converged, branch lengths, launches, graph counts)."""
    eng.branch_lengths = bl0.copy()
    engine_kernels.reset_counters()
    ascent_graph.reset_counters()
    m, sweeps = eng.run_branch_ascent(tol, max_iter)
    torch.cuda.synchronize()
    return (m, sweeps, eng.last_ascent_converged, eng.branch_lengths.copy(),
            dict(engine_kernels.LAUNCHES), dict(ascent_graph.COUNTS))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1e-2, 10), (1e-6, 100)],
                         ids=["1e-2_10", "1e-6_100"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "level"])
def test_gp_ascent_graph_equals_eager(use_kernels, dtype, case):
    """run_branch_ascent on fluA by the phase graphs against the eager loop
    on the card. The kernel route bit for bit (marginal, branch lengths,
    sweeps, converged flag); the level route (f64 only: its index_add_
    adds with atomics) at rel 1e-12 and the same sweeps. A second ascent of
    the graphed engine (no capture) launches K7 as often as the eager one
    (once a populate) and K8 once a sweep, in one replay per phase; an
    ascent from new lengths reads them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if not use_kernels and dtype == torch.float32:
        pytest.skip("the level route is the f64 oracle")
    engines = [_gp_instance("fluA", "cuda", dtype, use_kernels,
                            cuda_graphs=graphs).get_engine()
               for graphs in (True, False)]
    rng = np.random.default_rng(1)
    bl0 = engines[0].branch_lengths.copy()
    fits = []
    for start in (bl0, bl0 * rng.uniform(0.5, 1.5, bl0.shape)):
        graph, eager = (_ascent(e, start, *case) for e in engines)
        graph = _ascent(engines[0], start, *case)  # captured already
        fits.append(graph[0])
        assert graph[5]["captures"] == 0
        assert graph[1:3] == eager[1:3]
        if use_kernels:
            assert graph[0] == eager[0]
            np.testing.assert_array_equal(graph[3], eager[3])
        else:
            assert abs(graph[0] - eager[0]) <= 1e-12 * abs(eager[0])
            np.testing.assert_allclose(graph[3], eager[3], rtol=1e-10)
        assert graph[4] == eager[4]
        k7 = graph[4]["populate_plvs"] if use_kernels else 0
        assert graph[4]["golden_sweep"] == (graph[1] if use_kernels else 0)
        if use_kernels:
            assert k7 <= graph[5]["replays"] <= k7 + graph[1]
    if dtype == torch.float64 and case == (1e-6, 100):
        assert abs(fits[0] - -4337.885058592) < 1e-7


def _rooted_call(eng, args, hand, eager=False):
    """rooted_phylo_gradients (hand) or rooted_log_likelihoods' parts, with
    the counters at 0 first; eager turns the engine's graphs off for the
    call. Returns (outputs as a flat list, K1-K3 launches on either route
    and the heights kernels', graph counts)."""
    graphs = eng.graphs
    if eager:
        eng.graphs = None
    pruning_jc.reset_counters()
    heights.reset_counters()
    rooted_graph.reset_counters()
    try:
        if hand:
            out = eng.rooted_phylo_gradients(*args)
            out = [out[k] for k in sorted(out)]
        else:
            out = list(eng.rooted_log_likelihoods(*args, return_parts=True))
        torch.cuda.synchronize()
    finally:
        eng.graphs = graphs
    launches = {}
    for k, v in pruning_jc.LAUNCHES.items():  # on chip or the slab route
        if v:
            launches[k.replace("_slab", "")] = launches.get(
                k.replace("_slab", ""), 0) + v
    launches.update({f"heights_{k}": v for k, v in heights.LAUNCHES.items()
                     if v})
    return out, launches, dict(rooted_graph.COUNTS)


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rooted_graph_equals_eager(dtype, K):
    """The rooted hand route and rooted_log_likelihoods on fluA x 4 perturbed
    trees, by their graphs and eagerly on the card: bit for bit; a key's
    first call runs eagerly, its second captures, its third is one replay
    (K1 and the two heights kernels once, and K2 + K3 once for Weibull+4's
    shape gradient; K2 once for the LLs), except at f64 K = 4, whose keys
    run K1-K3's slab routes and stay eager; two calls of each route with
    the same inputs equal bit for bit (the heights kernels have no
    atomics), new ratios read on the next replay, and a new batch size a
    new key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    site = "constant" if K == 1 else "weibull+4"
    card, args = _rooted_instance("cuda", dtype, "JC69", site)
    eng = card.engine
    slab = pruning_jc.onchip_plan(dtype, K, 68, 69, "ll") is None
    hand = {"ll_grad_jc69": 1, "heights_forward": 1, "heights_adjoint": 1}
    per_call = {"hand": hand if K == 1 else
                {**hand, "ll_jc69": 1, "ll_dea_jc69": 1},
                "ll": {"ll_jc69": 1}}
    eager_first = {"captures": 0, "replays": 0, "eager": 1}
    captured = ({"captures": 0, "replays": 0, "eager": 1} if slab else
                {"captures": 1, "replays": 1, "eager": 0})
    replay = {"captures": 0, "replays": 0 if slab else 1,
              "eager": 1 if slab else 0}
    for hand in (True, False):
        route = "hand" if hand else "ll"
        first = _rooted_call(eng, args, hand)
        assert first[2] == eager_first, first[2]
        assert first[1] == per_call[route], first[1]
        second = _rooted_call(eng, args, hand)
        assert second[2] == captured, second[2]
        got = _rooted_call(eng, args, hand)
        want = _rooted_call(eng, args, hand, eager=True)
        again = _rooted_call(eng, args, hand, eager=True)
        _equal(got[0], want[0])
        _equal(first[0], got[0])
        _equal(second[0], got[0])
        _equal(again[0], want[0])
        assert got[2] == replay, got[2]
        assert got[1] == per_call[route], got[1]
        assert want[1] == per_call[route] and want[2]["replays"] == 0
        sched, bounds, ratios, rates, params = args
        ratios2 = ratios.copy()
        ratios2[:, :-1] *= 0.98
        args2 = (sched, bounds, ratios2, rates, params)
        got2 = _rooted_call(eng, args2, hand)
        _equal(got2[0], _rooted_call(eng, args2, hand, eager=True)[0])
        assert not torch.equal(got2[0][0], got[0][0])
        small = _rooted_instance("cuda", dtype, "JC69", site, batch=2)[1]
        want3 = _rooted_call(eng, small, hand, eager=True)[0]
        for counts in (eager_first, captured):
            got3 = _rooted_call(eng, small, hand)
            assert got3[2] == counts, got3[2]
            _equal(got3[0], want3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rooted_gtr_ll_graph_equals_eager(dtype):
    """GTR's rooted_log_likelihoods by its graph (K5 once a replay, the
    eigensystem solved on the host ahead) against the eager call, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, args = _rooted_instance("cuda", dtype, "GTR", "constant")
    eng = card.engine
    for _ in range(2):  # the key's eager first call, then its capture
        eng.rooted_log_likelihoods(*args)
    pruning_vjp.reset_counters()
    rooted_graph.reset_counters()
    got = eng.rooted_log_likelihoods(*args, return_parts=True)
    torch.cuda.synchronize()
    assert rooted_graph.COUNTS == {"captures": 0, "replays": 1, "eager": 0}
    assert pruning_vjp.LAUNCHES["ll_generic"] == 1
    eng.graphs, graphs = None, eng.graphs
    want = eng.rooted_log_likelihoods(*args, return_parts=True)
    eng.graphs = graphs
    _equal(got, want)


# -- the heights kernels (csrc/heights.cu) ------------------------------------


def _random_time_trees(taxa, trees, seed):
    """``trees`` random rooted trees of ``taxa`` leaves t0, t1, ... (joins
    from default_rng(seed)), as (topologies, their taxon map, schedule,
    bounds, ratios, rates): tip dates U(0, 20), each internal node's bound
    the largest below it, ratios U(0.2, 0.8), the root height 5 above its
    bound, clock rates 0.001 x U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(trees):
        pool = [f"t{i}:0.1" for i in range(taxa)]
        while len(pool) > 1:
            i, j = sorted(rng.choice(len(pool), 2, replace=False))
            a, b = pool.pop(j), pool.pop(i)
            pool.append(f"({b},{a}):0.1")
        lines.append(pool[0][:-4] + ";")
    tops, _, ttm = newick.parse_newick_string("\n".join(lines))
    sched = schedule.schedules_of_topologies(tops)
    B, n, L = trees, sched.node_count, sched.leaf_count
    bounds = np.zeros((B, n))
    bounds[:, :L] = rng.uniform(0.0, 20.0, (B, L))
    pc = np.asarray(sched.post_children)
    rows = np.arange(B)
    for step in range(pc.shape[1]):
        kids = np.where(pc[:, step] < n, pc[:, step], 0)
        bounds[:, L + step] = bounds[rows[:, None], kids].max(axis=1)
    ratios = rng.uniform(0.2, 0.8, (B, L - 1))
    ratios[:, -1] = bounds[:, -1] + 5.0
    rates = 0.001 * rng.uniform(0.5, 2.0, (B, n - 1))
    return tops, ttm, sched, bounds, ratios, rates


def _heights_case(case):
    """(schedule, bounds, ratios, rates) on the card's inputs: fluA x 256
    with perturbed ratios (the rooted cell's shape), or 16 random rooted
    trees of 69 taxa."""
    if case == "flua":
        sched, bounds, ratios, rates, _ = _rooted_instance(
            "cpu", torch.float64, "JC69", "constant", batch=256)[1]
        return sched, bounds, ratios, rates
    return _random_time_trees(69, 16, seed=3)[2:]


def _heights_grads_close(got, want):
    """The kernels' ratio or clock gradient (working dtype) against the
    torch adjoint's float64 one: in f32 within one unit in the last place
    of want rounded; in f64 at rel 1e-12, as on the CPU (torch's reduction
    on the card adds the root's three children in another order than the
    kernel, and the sweeps carry the last bits on: up to a few f64 ulps)."""
    if got.dtype == torch.float64:
        _rel_close(got.cpu().numpy(), want.cpu().numpy(), 1e-12)
        return
    want = want.to(got.dtype).cpu().numpy()
    gap = np.abs(got.cpu().numpy().astype(np.float64) - want)
    assert np.all(gap <= np.spacing(np.abs(want))), gap.max()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "slab"])
@pytest.mark.parametrize("case", ["flua", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_heights_kernels_match_twins_on_card(dtype, case, route,
                                             monkeypatch):
    """forward_cuda and adjoint_cuda against their twins (forward_plain,
    adjoint_plain, run on the card) bit for bit; against the torch
    sweeps (node_heights_from_ratios, then the operand as the torch hand
    route makes it) the heights and K1's operand bit for bit, and against
    ratio_and_rate_gradients_from_branch_gradient with the engine's
    rounding the ratio and clock gradients (_heights_grads_close: one f32
    rounding, rel 1e-12 in f64); a strict and a relaxed clock; two runs
    bit for bit; one launch each, n_iters sweeps each. The slab route:
    the same trees with heights.SHARED_LIMIT at 0, so that both kernels
    keep their per-node values in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if route == "slab":
        monkeypatch.setattr(heights, "SHARED_LIMIT", 0)
    fwd, adj = (("forward", "adjoint") if route == "shared"
                else ("forward_slab", "adjoint_slab"))
    sched, bounds, ratios, rates = _heights_case(case)
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")  # noqa: E731
    bounds, ratios, rates = t(bounds), t(ratios), t(rates)
    pn, pp, parent, pc = (t(getattr(sched, k)).to(torch.int32) for k in (
        "pre_internal_node", "pre_internal_parent", "parent",
        "post_children"))
    L, n = sched.leaf_count, sched.node_count
    B = bounds.shape[0]
    n_iters = n - L - 1  # I: always enough
    tree = (ratios, bounds, rates)
    heights.reset_counters()
    h, op = heights.forward_cuda(*tree, parent, L, n_iters, dtype)
    h2, op2 = heights.forward_cuda(*tree, parent, L, n_iters, dtype)
    torch.cuda.synchronize()
    assert {k: v for k, v in heights.LAUNCHES.items() if v} == {fwd: 2}
    assert heights.SWEEPS == {"forward": 2 * n_iters, "adjoint": 0}
    h_twin, op_twin = heights.forward_plain(*tree, parent, L, n_iters, dtype)
    h_want = heights.node_heights_from_ratios(ratios, bounds, L, pn, pp,
                                              n_iters=n_iters)
    op_want = torch.nn.functional.pad(
        (heights.branch_lengths_from_heights(h_want, parent) * rates).to(
            dtype), (0, 2))
    for got in ((h, op), (h2, op2), (h_twin, op_twin)):
        assert torch.equal(got[0], h_want) and torch.equal(got[1], op_want)
    # K1's gradient as K1 leaves it: the first N - 1 columns of (B, N + 1).
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(B, n + 1)),
                        device="cuda").to(dtype)[:, :n - 1]
    dratios, drates, _ = heights.ratio_and_rate_gradients_from_branch_gradient(
        g.to(torch.float64), *tree, L, pn, pp, parent, n_iters, heights=h,
        post_children=pc)
    for strict in (True, False):
        heights.reset_counters()
        got = heights.adjoint_cuda(g, h, *tree, pc, parent, L, n_iters,
                                   strict)
        again = heights.adjoint_cuda(g, h, *tree, pc, parent, L, n_iters,
                                     strict)
        torch.cuda.synchronize()
        assert {k: v for k, v in heights.LAUNCHES.items() if v} == {adj: 2}
        assert heights.SWEEPS == {"forward": 0, "adjoint": 2 * n_iters}
        twin = heights.adjoint_plain(g, h, *tree, pc, parent, L, n_iters,
                                     strict)
        clock = drates.sum(-1, keepdim=True) if strict else drates
        for a, b, c, want in zip(got, again, twin, (dratios, clock)):
            assert a.dtype == dtype and a.shape == want.shape
            assert torch.equal(a, b) and torch.equal(a, c)
            _heights_grads_close(a, want)


@pytest.mark.cuda
@pytest.mark.parametrize("taxa, routes", [
    (1100, {"forward": 1, "adjoint": 1}),
    (1400, {"forward": 1, "adjoint_slab": 1}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_heights_past_48kb_on_card(dtype, taxa, routes):
    """Two random rooted trees of 1,100 taxa (2,199 nodes: both kernels
    above 48 KB of shared memory, which a launch must opt into) or 1,400
    (2,799 nodes: the forward kernel opts in, the adjoint's values pass
    SHARED_LIMIT and take the slab route) and 40 random sites: the card's
    hand route launches the heights kernels on those routes (K1 on its
    slab route, so the key stays eager) and agrees with the CPU's (the
    twins) at the kernels' tolerances, by the engine's graphs and without
    them; the kernels against the twins on the card bit for bit at the
    engine's sweep count."""
    from libsbn_tpu_torch.models.engine import LikelihoodEngine

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ttm, sched, bounds, ratios, rates = _random_time_trees(taxa, 2, 9)
    n, L = sched.node_count, sched.leaf_count
    assert heights.tree_bytes("adjoint", n) > 48 * 1024
    rng = np.random.default_rng(9)
    aln = Alignment({f"t{i}": "".join(row) for i, row in enumerate(
        rng.choice(list("ACGT"), size=(taxa, 40)))})
    sp = SitePattern(aln, ttm)
    spec = libsbn_tpu_torch.PhyloModelSpec("JC69", "constant", "strict")
    params = {"clock": {"rate": torch.tensor(1.0, dtype=torch.float64)}}
    args = (sched, bounds, ratios, rates, params)
    cpu = LikelihoodEngine(sp, spec, dtype=dtype, device="cpu")
    want = cpu.rooted_phylo_gradients(*args)
    card = LikelihoodEngine(sp, spec, dtype=dtype, device="cuda")
    ll_tol, grad_tol = TOL[dtype]
    for graphs in (card.graphs, None):
        card.graphs = graphs
        heights.reset_counters()
        got = card.rooted_phylo_gradients(*args)
        torch.cuda.synchronize()
        assert {k: v for k, v in heights.LAUNCHES.items() if v} == routes
        assert heights.TWIN_CALLS == {"forward": 0, "adjoint": 0}
        assert set(got) == set(want)
        for key in want:
            tol = ll_tol if key == "log_likelihood" else grad_tol
            np.testing.assert_allclose(got[key].cpu().numpy(),
                                       want[key].numpy(), rtol=tol[0],
                                       atol=tol[1], err_msg=key)
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")  # noqa: E731
    tree = (t(ratios), t(bounds), t(rates))
    parent, pc = (t(getattr(sched, k)).to(torch.int32) for k in (
        "parent", "post_children"))
    n_iters = card._height_iters(sched)
    h, op = heights.forward_cuda(*tree, parent, L, n_iters, dtype)
    h_twin, op_twin = heights.forward_plain(*tree, parent, L, n_iters, dtype)
    assert torch.equal(h, h_twin) and torch.equal(op, op_twin)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(2, n - 1)),
                        device="cuda").to(dtype)
    for strict in (True, False):
        got = heights.adjoint_cuda(g, h, *tree, pc, parent, L, n_iters,
                                   strict)
        twin = heights.adjoint_plain(g, h, *tree, pc, parent, L, n_iters,
                                     strict)
        for a, b in zip(got, twin):
            assert torch.equal(a, b)


# -- the VBPI graph route (vi/step_graph.py) ----------------------------------


def _clone_state(state):
    return jit_step.VBPIState(
        state.q_params.clone(), state.sbn_params.clone(),
        tuple(jit_step.AdamState(*(x.clone() for x in st))
              for st in state.opt_state))


def _window(jv, K, beta=1.0):
    """K steps of host samples as step_many draws them: (ints (K, P, ...),
    eps (K, P, B), betas (K,))."""
    P = jv.particle_count
    arts = jv._sample_artifacts(jv._host_params(), K * P)
    ints = tuple(np.stack(c).reshape((K, P) + c[0].shape) for c in zip(*arts))
    eps = jv.rng.standard_normal((K, P, ints[1].shape[-1]))
    return ints, eps, np.full(K, beta)


def _eager(jv, state, window):
    """(state, metrics) of vbpi_train_steps_packed on a window, eagerly,
    and the window's (packed, eps, betas) tensors and shapes."""
    ints, eps, betas = window
    packed, shapes = jit_step.pack_ints(ints)
    inputs = (torch.from_numpy(packed).cuda(),
              torch.as_tensor(eps, dtype=jv.dtype, device="cuda"),
              torch.as_tensor(betas, dtype=jv.dtype, device="cuda"))
    return jit_step.vbpi_train_steps_packed(
        state, jv.statics, jv.optimizer, *inputs, shapes, jv.tips, jv.weights,
        jv.segment_ids), inputs, shapes


def _graph_trainer(dtype, branch_model="split", K=5):
    """A config 5 JitVBPI on the card (DS1, 10 particles) that has taken
    one window of K steps, so its K graph is captured."""
    jv = JitVBPI(_ds1_instance("cuda"), particle_count=10, seed=0,
                 dtype=dtype, branch_model=branch_model)
    assert jv.graphs is not None
    jv.step_many(K)
    return jv


def _assert_bit_for_bit(got, want):
    for a, b in zip(step_graph.leaves(got), step_graph.leaves(want),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("branch_model", ["split", "psp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_route_matches_eager_on_card(dtype, branch_model):
    """A window of 5 steps replayed from the trainer's state equals
    vbpi_train_steps_packed run eagerly from the same state on the same
    inputs bit for bit (state and metrics: every sum of a step has a
    fixed order); the window is one replay with 5 K1 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jv = _graph_trainer(dtype, branch_model)
    start = _clone_state(jv.state)
    window = _window(jv, 5, beta=0.5)
    (want_state, want), _, _ = _eager(jv, start, window)
    step_graph.reset_counters()
    pruning_jc.reset_counters()
    got = jv._window(*window)
    torch.cuda.synchronize()
    assert step_graph.COUNTS == {"captures": 0, "replays": 1}
    assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 5
    _assert_bit_for_bit(jv.state, want_state)
    _assert_bit_for_bit((got["mean_ll"], got["elbo_like"]),
                        (want["mean_ll"], want["elbo_like"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_replay_reads_new_inputs_on_card(dtype):
    """Replays of one graph on two windows: each window's mean LL a step
    against K1's twin on that window's inputs, at the state each step
    starts from (the eager trajectory, equal to the graph's), within the
    kernel-vs-twin LL tolerance; the second window's LLs are not the
    first's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jv = _graph_trainer(dtype)
    ones = torch.ones(1, dtype=dtype, device="cuda")
    (ll_rtol, ll_atol), _ = TOL[dtype]
    seen = []
    for _ in range(2):
        state = _clone_state(jv.state)
        window = _window(jv, 5)
        _, (packed, eps, betas), shapes = _eager(jv, state, window)
        got = jv._window(*window)["mean_ll"]
        want = []
        for k in range(5):
            pc, branch_rep, _, _ = jit_step.unpack_ints(packed[k], shapes)
            _, _, theta = jit_step._branch_lengths(state.q_params, branch_rep,
                                                   eps[k])
            em = pruning_jc.exp_complements(
                torch.nn.functional.pad(theta, (0, 2)), ones, dtype)
            ll, _ = pruning_jc.ll_grad_jc69_plain(
                pc, em, ones, ones, jv.tips, jv.weights,
                root_id=jv.statics.root_id)
            want.append(float(ll.mean()))
            state, _ = jit_step.vbpi_train_step_packed(
                state, jv.statics, jv.optimizer, packed[k], eps[k], betas[k],
                shapes, jv.tips, jv.weights, jv.segment_ids)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=ll_rtol,
                                   atol=ll_atol)
        seen.append(got.cpu().numpy())
    assert not np.array_equal(seen[0], seen[1])


@pytest.mark.cuda
def test_graph_state_assignment_reaches_replay():
    """Assigning JitVBPI.state after the capture copies into the graph's
    buffers (the same tensors), and the next replay starts from it: equal
    to the eager window from the assigned state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jv = _graph_trainer(torch.float64)
    buffers = step_graph.leaves(jv.state)
    q = torch.full_like(jv.state.q_params, 0.1)
    q[:, 0] = -1.5
    assigned = jit_step.init_state(q, jv.state.sbn_params.clone() * 0.5,
                                   jv.optimizer)
    jv.state = assigned
    assert all(a is b for a, b in zip(step_graph.leaves(jv.state), buffers))
    _assert_bit_for_bit(jv.state, assigned)
    window = _window(jv, 5)
    (want_state, _), _, _ = _eager(jv, assigned, window)
    jv._window(*window)
    _assert_bit_for_bit(jv.state, want_state)
    assert int(jv.state.opt_state[0].count) == 5


@pytest.mark.cuda
def test_graph_shape_change_raises():
    """The captured graphs have fixed shapes: a window of wider packed
    ints, or a state of other shapes, raises and changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    jv = _graph_trainer(torch.float32)
    before = _clone_state(jv.state)
    ints, eps, betas = _window(jv, 5)
    packed, shapes = jit_step.pack_ints(ints)
    wider = np.concatenate([packed, packed[..., :1]], axis=-1)
    floats = np.concatenate([eps.ravel(), betas]).astype(np.float32)
    with pytest.raises(ValueError, match="fixed shapes"):
        jv.graphs.run(wider, floats, shapes, eps.shape)
    with pytest.raises(ValueError, match="shapes"):
        jv.state = jit_step.init_state(jv.state.q_params[1:],
                                       jv.state.sbn_params, jv.optimizer)
    _assert_bit_for_bit(jv.state, before)
    assert step_graph.COUNTS["captures"] >= 1


_CAPTURE_FAILURE = """
import json, torch
from libsbn_tpu_torch.ops import pruning_jc
from libsbn_tpu_torch.vi import JitVBPI, jit_step, step_graph
import test_torch_cuda as t

jv = JitVBPI(t._ds1_instance("cuda"), particle_count=10, seed=0,
             dtype=torch.float32)
before = [x.clone() for x in step_graph.leaves(jv.state)]
step = jit_step.vbpi_train_step

def syncing_step(*args, **kw):  # a host sync: illegal under capture
    torch.cuda.synchronize()
    return step(*args, **kw)

jit_step.vbpi_train_step = syncing_step
step_graph.reset_counters()
pruning_jc.reset_counters()
try:
    jv.step_many(3)
    error = None
except RuntimeError as err:
    error = str(err)
torch.cuda.synchronize()
print(json.dumps({
    "error": error, "counts": step_graph.COUNTS,
    "k1": pruning_jc.LAUNCHES["ll_grad_jc69"], "windows": len(jv.graphs.windows),
    "unchanged": all(torch.equal(a, b) for a, b in
                     zip(step_graph.leaves(jv.state), before))}))
"""


@pytest.mark.cuda
def test_graph_capture_failure_raises():
    """A capture that fails (here a host synchronisation inside the step,
    which stream capture forbids) raises out of step_many, and nothing
    falls back to an eager step: no replay, no graph kept, the state as it
    was, K1 launched only by the warm-up. In a process of its own, so that
    the failed capture touches no other test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _CAPTURE_FAILURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["error"], got
    assert got["counts"] == {"captures": 0, "replays": 0}
    assert got["windows"] == 0 and got["unchanged"]
    assert got["k1"] == 1


# -- the unrooted engine's graphs and the rooted autograd route ---------------


UNROOTED_MODELS = {  # model -> (substitution, site, {route: launches a call})
    "jc69": ("JC69", "constant", {
        "ll": {"ll_jc69": 1}, "bgrad": {"ll_grad_jc69": 1},
        "phylo": {"ll_grad_jc69": 1}}),
    "jc69_weibull": ("JC69", "weibull+4", {
        "ll": {"ll_jc69": 1}, "bgrad": {"ll_grad_jc69": 1},
        "phylo": {"ll_grad_jc69": 1, "ll_jc69": 1, "ll_dea_jc69": 1}}),
    "gtr": ("GTR", "constant", {
        "ll": {"ll_generic": 1}, "bgrad": {"ll_grad_generic": 1},
        "phylo": {"ll_grad_generic": 1, "ll_generic": 1,
                  "ll_dp_generic": 1}}),
    "gtr_weibull": ("GTR", "weibull+4", {
        "ll": {"ll_generic": 1}, "bgrad": {"ll_grad_generic": 1},
        "phylo": {"ll_grad_generic": 1, "ll_generic": 1,
                  "ll_dp_generic": 1}}),
}
ENGINE_METHODS = {"ll": "log_likelihoods", "bgrad": "branch_gradients",
                  "phylo": "phylo_gradients"}


def _unrooted_engines(model, dtype, count=10):
    """(graph engine, eager engine, schedule, numpy branch lengths and
    parameters from default_rng(0)) on DS1.100_topologies' first ``count``
    trees with DS1.fasta."""
    from libsbn_tpu_torch.models.engine import LikelihoodEngine

    tops, _, ttm = newick.parse_newick_file(
        f"{DATA}/DS1.100_topologies.nwk")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    sched = schedule.schedules_of_topologies(tops[:count])
    sub, site, _ = UNROOTED_MODELS[model]
    spec = libsbn_tpu_torch.PhyloModelSpec(sub, site, "strict")
    engines = [LikelihoodEngine(sp, spec, dtype=dtype, device="cuda",
                                cuda_graphs=graphs) for graphs in (True, False)]
    return (*engines, sched, _unrooted_inputs(model, sched, 0))


def _unrooted_inputs(model, sched, seed):
    rng = np.random.default_rng(seed)
    bl = rng.uniform(0.01, 0.2, (np.shape(sched.post_children)[0],
                                 sched.node_count))
    bl[:, -1] = 0.0
    f64 = dict(dtype=torch.float64, device="cuda")
    sub, site, _ = UNROOTED_MODELS[model]
    params = {"clock": {"rate": torch.tensor(1.0, **f64)}}
    if sub == "GTR":
        params["substitution"] = {
            "rates": torch.tensor(rng.dirichlet(np.full(6, 20.0)), **f64),
            "frequencies": torch.tensor(rng.dirichlet(np.full(4, 20.0)),
                                        **f64)}
    if site != "constant":
        params["site"] = {"shape": torch.tensor(rng.uniform(0.3, 1.5), **f64)}
    return bl, params


def _flat_out(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


def _counted(fn):
    """fn()'s outputs as a flat list, with the K1-K6 launches it added
    (on chip and slab routes together) and the unrooted graphs' counts."""
    counted = (pruning_jc, pruning_generic, pruning_vjp)
    for m in counted:
        m.reset_counters()
    unrooted_graph.reset_counters()
    rooted_graph.reset_counters()
    out = _flat_out(fn())
    torch.cuda.synchronize()
    launches = {}
    for m in counted:
        assert not any(m.TWIN_CALLS.values())
        for k, v in m.LAUNCHES.items():
            if v:
                base = k.replace("_slab", "")
                launches[base] = launches.get(base, 0) + v
    return out, launches, (dict(unrooted_graph.COUNTS),
                           dict(rooted_graph.COUNTS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", sorted(UNROOTED_MODELS))
def test_unrooted_graph_equals_eager(model, dtype):
    """log_likelihoods, branch_gradients and phylo_gradients on ten
    DS1.100_topologies trees (seeded lengths and parameters), by the
    engine's graphs (cuda_graphs=True) and eagerly: bit for bit; a key's
    first call runs eagerly and launches what the eager call launches, its
    second captures the key (the warm-up and the replay launch it twice),
    and a call after the capture is one replay that launches each kernel
    of the route as the eager call does; a call with new inputs reads them
    with no new capture; a new schedule object of the same shapes
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graph, eager, sched, (bl, params) = _unrooted_engines(model, dtype)
    per_call = UNROOTED_MODELS[model][2]
    for route, method in ENGINE_METHODS.items():
        call_g, call_e = getattr(graph, method), getattr(eager, method)
        first = _counted(lambda: call_g(sched, bl, params))
        assert first[2][0] == {"captures": 0, "replays": 0, "eager": 1}, \
            first[2]
        assert first[1] == per_call[route], first[1]
        second = _counted(lambda: call_g(sched, bl, params))
        assert second[2][0] == {"captures": 1, "replays": 1, "eager": 0}, \
            second[2]
        assert second[1] == {k: 2 * v for k, v in per_call[route].items()}
        got = _counted(lambda: call_g(sched, bl, params))
        want = _counted(lambda: call_e(sched, bl, params))
        _equal(got[0], want[0])
        _equal(first[0], got[0])
        _equal(second[0], got[0])
        assert got[2][0] == {"captures": 0, "replays": 1, "eager": 0}, got[2]
        assert got[1] == want[1] == per_call[route], (got[1], want[1])
        bl2, params2 = _unrooted_inputs(model, sched, 1)
        again = schedule.schedules_of_topologies(_topologies(sched))
        got2 = _counted(lambda: call_g(again, bl2, params2))
        assert got2[2][0] == {"captures": 0, "replays": 1, "eager": 0}, \
            got2[2]
        _equal(got2[0], _counted(lambda: call_e(again, bl2, params2))[0])
        assert not torch.equal(got2[0][0], got[0][0])


def _topologies(sched):
    """The schedule's topologies again, from DS1.100_topologies."""
    tops, _, _ = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    return tops[:np.shape(sched.post_children)[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", [("GTR", "constant"),
                                   ("JC69", "weibull+4")],
                         ids=["gtr", "jc69_weibull"])
def test_rooted_autograd_graph_equals_eager(model, dtype):
    """The rooted autograd route on fluA x 4 perturbed trees by its graph
    (rooted_phylo_gradients on GTR; RootedGraphs' "autograd" route on JC69
    + Weibull+4, whose engine call takes the hand route) against
    _rooted_phylo_gradients_autograd, bit for bit, twice each: the key's
    first call eager, its second a capture, then one replay a call, with
    K5 + K6 (GTR) or K2 + K3 launched as the eager call launches them; new
    ratios read with no new capture. JC69 + Weibull+4 at f64 runs K2/K3's
    slab routes on fluA: that key stays eager, every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, args = _rooted_instance("cuda", dtype, *model)
    eng = card.engine
    slab = model[0] == "JC69" and pruning_jc.onchip_plan(
        dtype, 4, 68, 69, "ll") is None
    replay = {"captures": 0, "replays": 0 if slab else 1,
              "eager": 1 if slab else 0}

    def graph(a):
        if model[0] == "GTR":
            return eng.rooted_phylo_gradients(*a)
        return eng.graphs.phylo_gradients(*a, True, "autograd")

    first = _counted(lambda: graph(args))
    assert first[2][1] == {"captures": 0, "replays": 0, "eager": 1}, first[2]
    second = _counted(lambda: graph(args))
    assert second[2][1] == ({"captures": 0, "replays": 0, "eager": 1}
                            if slab else
                            {"captures": 1, "replays": 1, "eager": 0}), \
        second[2]
    got = _counted(lambda: graph(args))
    want = _counted(lambda: eng._rooted_phylo_gradients_autograd(*args, True))
    again = _counted(lambda: eng._rooted_phylo_gradients_autograd(*args, True))
    _equal(got[0], want[0])
    _equal(first[0], got[0])
    _equal(second[0], got[0])
    _equal(again[0], want[0])
    assert got[2][1] == replay, got[2]
    assert got[1] == want[1] == first[1], (got[1], want[1], first[1])
    assert len(eng.graphs.programs) == (0 if slab else 1)
    sched, bounds, ratios, rates, params = args
    ratios2 = ratios.copy()
    ratios2[:, :-1] *= 0.98
    args2 = (sched, bounds, ratios2, rates, params)
    got2 = _counted(lambda: graph(args2))
    assert got2[2][1] == replay
    _equal(got2[0], _counted(
        lambda: eng._rooted_phylo_gradients_autograd(*args2, True))[0])
    assert not torch.equal(got2[0][0], got[0][0])


_HOST_READ_CAPTURE = """
import json, torch
from libsbn_tpu_torch.models import unrooted_graph
import test_torch_cuda as t

graph, eager, sched, (bl, params) = t._unrooted_engines("gtr", torch.float64)
want = eager.log_likelihoods(sched, bl, params)
# The eigensystem left to be solved inside the call: expm_transition then
# reads Q on the host, which the capture cannot do.
graph._shared_eigen = lambda params: None
# The key's first call runs eagerly, where the host read is allowed.
first = graph.log_likelihoods(sched, bl, params)
unrooted_graph.reset_counters()
try:
    out = graph.log_likelihoods(sched, bl, params)  # the capture
    error = None
except RuntimeError as err:
    out, error = None, str(err)
print(json.dumps({"error": error, "out": out is not None,
                  "first_close": bool(torch.allclose(first, want, rtol=1e-10,
                                                     atol=0.0)),
                  "counts": unrooted_graph.COUNTS,
                  "programs": len(graph.unrooted_graphs.programs),
                  "want_finite": bool(torch.isfinite(want).all())}))
"""


@pytest.mark.cuda
def test_unrooted_capture_reading_the_host_raises():
    """A GTR log_likelihoods whose eigensystem is left to be solved inside
    the captured function (a host read under capture): the key's first
    call runs eagerly, within rel 1e-10 of the eager engine's (its own
    eigen solve takes another path); its second, the
    capture, raises out of the engine call: no result, no replay, no graph
    kept, nothing run eagerly in its place. In a process of its own, so that the failed capture
    touches no other test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _HOST_READ_CAPTURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["error"] and not got["out"], got
    assert got["counts"] == {"captures": 0, "replays": 0, "eager": 0}
    assert got["programs"] == 0 and got["want_finite"] and got["first_close"]


# -- what captured keys keep (utils/graphs.py PackedPrograms) -----------------


def _reserved_after(fn):
    """(fn's outputs, device memory reserved after fn() less before it, in
    MB), unused cache released before and after."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, (torch.cuda.memory_reserved() - before) / 2**20


@pytest.mark.cuda
def test_one_off_key_leaves_no_pool():
    """A key called once (log_likelihoods of DS1 tiled to 10,000 trees at
    f64, as vi.benchmark.fixed's final ELBO): it runs eagerly, keeps no
    program and leaves the reserved memory within one 2 MB segment of
    what it was; its LLs equal an eager engine's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.models.engine import LikelihoodEngine

    tops, bls, ttm = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    sched = schedule.schedules_of_topologies(tops * 1000)
    bl = np.tile(np.stack(bls), (1000, 1))
    bl = bl * np.random.default_rng(3).uniform(0.8, 1.2, bl.shape)
    spec = libsbn_tpu_torch.PhyloModelSpec("JC69", "constant", "strict")
    params = {"clock": {"rate": torch.tensor(1.0, dtype=torch.float64,
                                             device="cuda")}}
    graph, eager = (LikelihoodEngine(sp, spec, device="cuda",
                                     cuda_graphs=g) for g in (True, False))
    got, left = _reserved_after(lambda: graph.log_likelihoods(sched, bl,
                                                               params))
    left -= got.numel() * got.element_size() / 2**20
    assert len(graph.unrooted_graphs.programs) == 0
    assert left <= 2.0, left
    _equal([got], [eager.log_likelihoods(sched, bl, params)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interleaved_keys_equal_eager_on_card(dtype):
    """Three keys of one engine, their graphs in one pool (log_likelihoods
    and phylo_gradients on ten DS1.100_topologies trees, log_likelihoods on
    seven), called in turns A, B, C three times round with new branch
    lengths and parameters every call: each call equals the eager engine's
    bit for bit; from the third round on every call is one replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graph, eager, sched, _ = _unrooted_engines("gtr_weibull", dtype)
    small = schedule.schedules_of_topologies(_topologies(sched)[:7])
    keys = [("log_likelihoods", sched), ("phylo_gradients", sched),
            ("log_likelihoods", small)]
    seed = 10
    for turn in range(3):
        for method, s in keys:
            bl, params = _unrooted_inputs("gtr_weibull", s, seed)
            seed += 1
            got = _counted(lambda: getattr(graph, method)(s, bl, params))
            want = _counted(lambda: getattr(eager, method)(s, bl, params))
            _equal(got[0], want[0])
            if turn == 2:
                assert got[2][0] == {"captures": 0, "replays": 1,
                                     "eager": 0}, got[2]
    assert len(graph.unrooted_graphs.programs) == 3


@pytest.mark.cuda
def test_slab_rooted_key_holds_little():
    """The f64 JC69 + Weibull+4 rooted autograd route on fluA x 256 runs
    K2/K3's slab routes: the key stays eager (no program kept) and, after
    two calls, the engine holds under 200 MB (a captured key kept 2,862 MB
    of slab scratch in its pool on an H100); each call equals
    _rooted_phylo_gradients_autograd bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, args = _rooted_instance("cuda", torch.float64, "JC69", "weibull+4",
                                  batch=256)
    eng = card.engine
    assert pruning_jc.onchip_plan(torch.float64, 4, 68, 69, "ll") is None
    got, held = _reserved_after(lambda: [
        eng.graphs.phylo_gradients(*args, True, "autograd")
        for _ in range(2)])
    held -= sum(v.numel() * v.element_size() for d in got
                for v in d.values()) / 2**20
    assert len(eng.graphs.programs) == 0
    assert held < 200, held
    want = eng._rooted_phylo_gradients_autograd(*args, True)
    for out in got:
        _equal([out[k] for k in sorted(out)], [want[k] for k in sorted(want)])


# -- forest graphs and the scale tools -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("surface,gather", [("ll", None),
                                            ("grad", torch.bfloat16),
                                            ("grad", None), ("split", None)])
def test_forest_graph_equals_eager_on_card(surface, gather, dtype):
    """A forest surface by ForestGraphs on DS1.100 (two seeded length
    sets): the key's first call runs eagerly, its second captures it and
    replays, its third replays; each equals the eager call bit for bit, and
    so does a replay with new lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fs, tips, w, bl = _ds1_100_forest()
    tips_c, w_c, bl_c = (torch.as_tensor(x).to(dtype).cuda()
                         for x in (tips, w, bl))
    graphs = forest_graph.ForestGraphs(tips_c, w_c)

    def eager(b):
        return forest_graph.eager(surface, fs, b, tips_c, w_c, dtype, gather)

    want = eager(bl_c)
    assert forest_graph.bit_for_bit(want, eager(bl_c))
    forest_graph.reset_counters()
    for captures, replays in ((0, 0), (1, 1), (1, 2)):
        assert forest_graph.bit_for_bit(
            graphs.run(surface, fs, bl_c, dtype, gather), want)
        assert forest_graph.COUNTS == {"captures": captures,
                                       "replays": replays, "eager": 1}
    bl_new = bl_c.flip(0).contiguous()
    assert forest_graph.bit_for_bit(
        graphs.run(surface, fs, bl_new, dtype, gather), eager(bl_new))
    assert forest_graph.COUNTS == {"captures": 1, "replays": 3, "eager": 1}
    assert len(graphs) == 1


def _conserved(inp, seed=1, changed=0.03):
    """scale_compare's inputs with conserved tips: each taxon shows state 0
    at a site but for a ``changed`` share of (taxon, site) pairs drawn from
    ``default_rng(seed)``, so that the native float64 baseline, which does
    not rescale, stays finite on trees of 400 taxa and more (on the
    tool's random tips it underflows from about 400 taxa)."""
    rng = np.random.default_rng(seed)
    L, _, P = inp["tips"].shape
    states = np.where(rng.random((L, P)) < changed,
                      rng.integers(0, 4, (L, P)), 0)
    tips = np.zeros_like(inp["tips"])
    tips[np.arange(L)[:, None], states, np.arange(P)[None, :]] = 1.0
    return dict(inp, tips=tips)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["on-chip", "slab"])
def test_k1_scale_gate_across_the_plan_edge(side):
    """K1 float32 on the largest tree of its on-chip plan and on one taxon
    more (the slab route), scale_compare's trees and lengths at 256
    patterns x 8 trees: on the tool's random tips, finite and within the
    JAX tool's gate of K1 float64; and K1 float64 within rel 1e-9 of the
    native float64 baseline on conserved tips (on the random tips native
    underflows at these sizes), so the float32 route is held to native
    through the float64 kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    edge = scale_compare.onchip_limit()
    taxa = edge if side == "on-chip" else edge + 1
    dev = torch.device("cuda")
    inp = scale_compare.make_inputs(taxa, 256, 8)
    edges = inp["sched"].node_count - 1
    f32, route32, _ = scale_compare.first_call(
        scale_compare.k1_call(inp, torch.float32, dev), dev)
    f64, _, _ = scale_compare.first_call(
        scale_compare.k1_call(inp, torch.float64, dev), dev)
    assert route32 == side
    assert all(np.all(np.isfinite(x)) for x in f32)
    assert scale_compare.gate_value(f32[1], f64[1], edges) < scale_compare.GATE
    conserved = _conserved(inp)
    ll, grad = scale_compare.first_call(
        scale_compare.k1_call(conserved, torch.float64, dev), dev)[0]
    ll_n, g_n = scale_compare.native_call(conserved)()
    assert np.all(np.isfinite(ll_n))
    assert scale_compare.rel_err(ll, ll_n) < scale_compare.F64_REL
    assert scale_compare.rel_err(grad, g_n[:, :edges]) < scale_compare.F64_REL


@pytest.mark.cuda
def test_gp_scale_small_on_card():
    """gp_scale at 40 taxa x 1,000 sites on the card, float64: the fused
    ascent runs K7 + K8, the streamed K7, and the streamed marginal lies
    within the JAX tool's bound of the in-memory Newton ascent's (the
    ascent the JAX tool compares it with on the CPU; K8's golden section
    takes another path and neither converges in 20 sweeps here); the
    streamed ascent by its graphs equals its eager run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = gp_scale.run(40, 1000, torch.float64, device="cuda", timing=False)
    assert "K7" in r["fused"]["route"] and "K8" in r["fused"]["route"]
    assert "K7" in r["streamed"]["route"]
    assert r["newton"]["route"].startswith("level route")
    gp_scale.check(r, "newton")
    gp_scale.check_graphs(r)


# -- the streamed ascent's chunk programs, the hybrid marginals' program and
# EM's step as CUDA graphs (gp/streamed_graph.py, gp/hybrid_graph.py,
# sbn/probability.py EMStepGraph) ---------------------------------------------


def _streamed(eng, bl0, memmap_dir=None):
    """run_branch_ascent_streamed(1e-6, 100, 100) on fluA from bl0, without
    finalize, with the counters at 0 first: (marginal, sweeps, branch
    lengths, K7/K8 launches, the chunk programs' counts)."""
    from libsbn_tpu_torch.gp import streamed_graph

    eng.branch_lengths = bl0.copy()
    engine_kernels.reset_counters()
    streamed_graph.reset_counters()
    m, sweeps = eng.run_branch_ascent_streamed(1e-6, 100, 100,
                                               memmap_dir=memmap_dir,
                                               finalize=False)
    torch.cuda.synchronize()
    return (m, sweeps, eng.branch_lengths.copy(),
            {k: v for k, v in engine_kernels.LAUNCHES.items() if v},
            dict(streamed_graph.COUNTS))


@pytest.mark.cuda
@pytest.mark.parametrize("memmap", [False, True], ids=["host_ram", "memmap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streamed_graphs_equal_eager_on_card(dtype, memmap, tmp_path):
    """The streamed ascent on fluA in chunks of 100 by its chunk programs'
    graphs against cuda_graphs=False, bit for bit (marginal, sweeps, branch
    lengths), A and B in host RAM or an np.memmap: three programs, each
    called eagerly once and captured once; K7 once a chunk a statistics
    refresh, as eagerly, plus the statistics capture's warm-up; no K8. The
    graphs are gone after the call: the allocated memory back where it
    was, the reserved memory too once the cache is emptied, and their pool
    O(DAG nodes x chunk) while they lived."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graph_eng, eager_eng = (_gp_instance("fluA", "cuda", dtype,
                                         cuda_graphs=g).get_engine()
                            for g in (True, False))
    bl0 = graph_eng.branch_lengths.copy()
    mm = str(tmp_path) if memmap else None
    want = _streamed(eager_eng, bl0, mm)
    _streamed(graph_eng, bl0 * 1.1, mm)  # K7's streams built, caches warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = (torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved())
    got = _streamed(graph_eng, bl0, mm)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    assert want[4] == {"captures": 0, "replays": 0, "eager": 0}
    assert got[4]["captures"] == 3 and got[4]["eager"] == 3
    assert got[4]["replays"] > 3 * got[1]
    k7 = want[3]["populate_plvs"]
    assert k7 % 3 == 0 and k7 >= 3 * (want[1] + 1)
    assert got[3] == {"populate_plvs": k7 + 1}
    assert torch.cuda.memory_allocated() == allocated
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved
    held = graph_eng.last_streamed_graphs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nodes = graph_eng.dag.node_count()
    assert 0 < held["pool_mb"] <= 64 * nodes * 100 * itemsize / 2**20 + 20
    assert os.listdir(tmp_path) == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hybrid_graph_equals_eager_on_card(dtype):
    """calculate_hybrid_marginals on fluA by the engine's hybrid program
    against cuda_graphs=False, bit for bit: the first call eager, the
    second a capture and one replay, a third one replay and no capture;
    then chunks of 16 rows (65 combinations: five chunks, the last padded)
    the same way, a program of its own, within rounding of one chunk of
    65; at float64 within rel 1e-10 of the port's CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.gp import hybrid_graph
    from libsbn_tpu_torch.gp.quartet import quartet_hybrid_request_of

    insts = [_gp_instance("fluA", dev, dtype, cuda_graphs=g)
             for dev, g in (("cuda", True), ("cuda", False), ("cpu", False))]
    bl = insts[0].get_engine().branch_lengths
    bl = bl * np.random.default_rng(2).uniform(0.5, 1.5, bl.shape)
    for inst in insts:
        inst.get_engine().branch_lengths = bl.copy()
    insts[2].calculate_hybrid_marginals()
    cpu = insts[2].get_engine().hybrid_marginal_log_likelihoods.copy()
    insts[1].calculate_hybrid_marginals()
    want = insts[1].get_engine().hybrid_marginal_log_likelihoods.copy()
    eng = insts[0].get_engine()
    hybrid_graph.reset_counters()
    counts = []
    for _ in range(3):
        eng.hybrid_marginal_log_likelihoods[:] = -np.inf
        insts[0].calculate_hybrid_marginals()
        np.testing.assert_array_equal(eng.hybrid_marginal_log_likelihoods,
                                      want)
        counts.append(dict(hybrid_graph.COUNTS))
    assert counts == [{"captures": 0, "replays": 0, "eager": 1},
                      {"captures": 1, "replays": 1, "eager": 1},
                      {"captures": 1, "replays": 2, "eager": 1}]
    fin = np.isfinite(want)
    assert fin.sum() == 65
    if dtype == torch.float64:
        np.testing.assert_allclose(want[fin], cpu[fin], rtol=1e-10)
    reqs = [quartet_hybrid_request_of(insts[0].dag, p, r, c) for p, r, c, _
            in insts[0].dag.reverse_postorder_index_traversal()]
    small = []
    for e in (eng, insts[1].get_engine()):
        e.populate_plvs()
        for _ in range(3):
            e.hybrid_marginal_log_likelihoods[:] = -np.inf
            e.process_quartet_hybrid_requests(reqs, chunk=16)
            small.append(e.hybrid_marginal_log_likelihoods.copy())
    for got in small[1:]:
        np.testing.assert_array_equal(got, small[0])
    np.testing.assert_allclose(small[0][fin], want[fin],
                               rtol=1e-12 if dtype == torch.float64 else 1e-5)
    assert hybrid_graph.COUNTS["captures"] == 2
    assert len(eng.hybrid_graphs.programs) == 2
    assert eng.hybrid_graphs.held_mb() > 0


@pytest.mark.cuda
def test_em_graph_equals_eager_on_card():
    """EM(0, 23) and EM(0.5, 100) on DS1.100_topologies by the step's graph
    (the default) against cuda_graphs=False, bit for bit (scores and
    parameters; EM runs in float64 only): one capture a call and one replay
    an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from libsbn_tpu_torch.sbn import probability as tprob

    insts = []
    for _ in range(2):
        inst = libsbn_tpu_torch.UnrootedInstance("charlie")
        inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
        inst.process_loaded_trees()
        insts.append(inst)
    for alpha, iters in ((0.0, 23), (0.5, 100)):
        tprob.reset_counters()
        scores = insts[0].train_expectation_maximization(alpha, iters)
        assert tprob.COUNTS == {"captures": 1, "replays": iters}
        want = insts[1].train_expectation_maximization(alpha, iters,
                                                       cuda_graphs=False)
        assert tprob.COUNTS == {"captures": 1, "replays": iters}
        np.testing.assert_array_equal(scores, want)
        np.testing.assert_array_equal(insts[0].sbn_parameters,
                                      insts[1].sbn_parameters)


_PROGRAM_CAPTURE_FAILURE = r"""
import json, sys
import numpy as np
import torch
from libsbn_tpu_torch.gp import hybrid_graph, streamed_graph
from libsbn_tpu_torch.sbn import probability as tprob
from test_torch_cuda import DATA, _gp_instance
import libsbn_tpu_torch

which = sys.argv[1]


def reads_host(fn):
    def wrapped(*args):
        float(torch.as_tensor(0.0, device="cuda") + 1)  # forbidden in capture
        return fn(*args)
    return wrapped


out = {"error": None}
if which == "streamed":
    streamed_graph.chunk_obj = reads_host(streamed_graph.chunk_obj)
    eng = _gp_instance("fluA", "cuda").get_engine()
    bl0 = eng.branch_lengths.copy()
    try:
        eng.run_branch_ascent_streamed(1e-6, 100, 100, finalize=False)
    except Exception as err:
        out["error"] = type(err).__name__
    out["unchanged"] = bool(np.array_equal(eng.branch_lengths, bl0))
    out["counts"] = dict(streamed_graph.COUNTS)
elif which == "hybrid":
    hybrid_graph.hybrid_chunk = reads_host(hybrid_graph.hybrid_chunk)
    inst = _gp_instance("fluA", "cuda")
    inst.calculate_hybrid_marginals()
    eng = inst.get_engine()
    eng.hybrid_marginal_log_likelihoods[:] = -np.inf
    try:
        inst.calculate_hybrid_marginals()
    except Exception as err:
        out["error"] = type(err).__name__
    out["unchanged"] = bool(np.all(np.isneginf(
        eng.hybrid_marginal_log_likelihoods)))
    out["counts"] = dict(hybrid_graph.COUNTS)
    out["programs"] = len(eng.hybrid_graphs.programs)
else:
    tprob._em_step = reads_host(tprob._em_step)
    inst = libsbn_tpu_torch.UnrootedInstance("charlie")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    before = np.array(inst.sbn_parameters, copy=True)
    try:
        inst.train_expectation_maximization(0.0, 5)
    except Exception as err:
        out["error"] = type(err).__name__
    out["unchanged"] = bool(np.array_equal(inst.sbn_parameters, before))
    out["counts"] = dict(tprob.COUNTS)
print(json.dumps(out))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["streamed", "hybrid", "em"])
def test_program_capture_failure_raises(program):
    """A capture that fails (a host read inside the program, which stream
    capture forbids) raises out of the entry point, and nothing falls back
    to eager launches: the streamed ascent's lengths, the hybrid values and
    EM's parameters as they were, no replay of the failed program, no
    hybrid program kept. In a process of its own, so that the failed
    capture touches no other test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _PROGRAM_CAPTURE_FAILURE,
                          program], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["error"] and got["unchanged"], got
    if program == "hybrid":
        assert got["counts"]["captures"] == 0 and got["programs"] == 0
    if program == "em":
        assert got["counts"] == {"captures": 0, "replays": 0}
