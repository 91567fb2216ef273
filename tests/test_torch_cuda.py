"""The CUDA kernels of libsbn_tpu_torch against their plain PyTorch twins,
the VBPI step, the GTR engine path, the GP fit, the rooted engine and the
vip layer (the Burrito, EM, per-tree parameter rows, K2 at 10,000 trees) on
the card against the same on the CPU.

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
from libsbn_tpu_torch.gp import GPInstance, engine_kernels
from libsbn_tpu_torch.gp.engine import _jc69_transition
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.ops import (
    pruning_generic, pruning_jc, pruning_vjp, schedule, substitution,
)
from libsbn_tpu_torch.ops.site_model import weibull_rates
from libsbn_tpu_torch.vi import JitVBPI

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
    categories: (post_children, ea, rates, props, tips, weights, root_id)."""
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
    ea = pruning_jc.exp_factors(dev(bl), rates, dtype)
    return (dev(pc, torch.int32), ea, rates, props, dev(tips), dev(w),
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
    pc, ea, rates, props, tips, w, r = _inputs(data, dtype, K)
    args = (pc, ea, rates, props, tips, w)
    pruning_jc.reset_counters()
    k_ll, k_g = pruning_jc.ll_grad_jc69_cuda(*args, root_id=r)
    plan = pruning_jc.onchip_plan(dtype, K, pc.shape[1], tips.shape[0])
    assert (plan is None) == (data == "big" and (K, dtype) != (1, torch.float32))
    route = "ll_grad_jc69" if plan else "ll_grad_jc69_slab"
    assert pruning_jc.LAUNCHES[route] == 1
    t_ll, t_g = pruning_jc.ll_grad_jc69_plain(*args, root_id=r)
    k2 = pruning_jc.ll_jc69_cuda(pc, ea, props, tips, w, root_id=r)
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
    """K3 (d ll / d ea, d ll / d props) against its twin on one card, at
    the gradient tolerance of TOL; the root and ones-slot rows are zero;
    on chip where onchip_plan fits, the slab route beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, ea, _, props, tips, w, r = _inputs(data, dtype, K)
    pruning_jc.reset_counters()
    k_dea, k_dp = pruning_jc.ll_dea_jc69_cuda(pc, ea, props, tips, w,
                                              root_id=r)
    t_dea, t_dp = pruning_jc.ll_dea_jc69_plain(pc, ea, props, tips, w,
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
    pc, ea, rates, props, tips, w, r = _inputs("ds1", torch.float32, 1)
    reps = 512 // pc.shape[0] + 1
    pc, ea = pc.repeat(reps, 1, 1)[:512].contiguous(), ea.repeat(reps, 1, 1)[:512].contiguous()
    args = (pc, ea, rates, props, tips, w)
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
    pc, ea, _, props, tips, w, r = _inputs("ds1", torch.float32, 1)
    reps = 512 // pc.shape[0] + 1
    pc, ea = pc.repeat(reps, 1, 1)[:512].contiguous(), ea.repeat(reps, 1, 1)[:512].contiguous()
    args = (pc, ea, props, tips, w)
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
    sbn_params). The card's step launches K1 and calls no twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = JitVBPI(_ds1_instance("cpu"), particle_count=10, seed=0)
    card = JitVBPI(_ds1_instance("cuda"), particle_count=10, seed=0)
    for _ in range(2):
        want = cpu.step()
        pruning_jc.reset_counters()
        got = card.step()
        torch.cuda.synchronize()
        assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 1
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
    launches K4, K5 and K6 and calls no twin."""
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


def _gp_instance(data, device, dtype=torch.float64, use_kernels="auto"):
    fasta, nwk = {"hello": ("hello.fasta", "hello_rooted.nwk"),
                  "fluA": ("fluA.fa", "fluA.tree")}[data]
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{nwk}")
    inst.make_engine(dtype=dtype, device=device, use_kernels=use_kernels)
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
    1e-6. The card's kernel route launches K7 and K8 and calls no twin."""
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
    if use_kernels:
        assert engine_kernels.LAUNCHES["golden_sweep"] == out[1][0]
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
# K = 1 and at K = 4 (Weibull+4 adds the shape gradient's K2 + K3)).
ROOTED_ROUTES = {
    "hand": ("JC69", "rooted_phylo_gradients",
             ({"ll_grad_jc69": 1}, {"ll_grad_jc69": 1, "ll_jc69": 1,
                                     "ll_dea_jc69": 1})),
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
    same on the CPU (the kernels' twins), at the kernels' tolerances: the
    LLs + ldjs of rooted_log_likelihoods and every gradient of each route.
    The route is read from the launch counters: its kernels, on chip or
    on their slab routes (f64 K = 4 exceeds K1-K3's plan), and no twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sub, method, launches = ROOTED_ROUTES[route]
    site = "constant" if K == 1 else "weibull+4"
    cpu, cpu_args = _rooted_instance("cpu", dtype, sub, site)
    card, card_args = _rooted_instance("cuda", dtype, sub, site)
    extra = () if method == "rooted_phylo_gradients" else (True,)
    want = getattr(cpu.engine, method)(*cpu_args, *extra)
    want_ll = cpu.engine.rooted_log_likelihoods(*cpu_args)
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        m.reset_counters()
    got = getattr(card.engine, method)(*card_args, *extra)
    torch.cuda.synchronize()
    counts = {k: v for m in (pruning_jc, pruning_generic, pruning_vjp)
              for k, v in m.LAUNCHES.items()}
    onchip = pruning_jc.onchip_plan(dtype, K, 68, 69) is not None
    took = {}
    for key, count in counts.items():
        if count:
            base = key.replace("_slab", "")
            took[base] = took.get(base, 0) + count
            if key.endswith("_slab"):
                assert not onchip and sub == "JC69", key
    assert took == launches[K > 1], counts
    for m in (pruning_jc, pruning_generic, pruning_vjp):
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
    no twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = _burrito("cpu", data, branch_model)
    cpu.gradient_steps(5)
    card = _burrito("cuda", data, branch_model)
    pruning_jc.reset_counters()
    card.gradient_steps(5)
    torch.cuda.synchronize()
    assert pruning_jc.LAUNCHES["ll_grad_jc69"] == 5
    assert pruning_jc.LAUNCHES["ll_jc69"] == 5
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
    ea = pruning_jc.exp_factors(torch.as_tensor(bl).cuda(), rates, dtype)
    pruning_jc.reset_counters()
    full = pruning_jc.ll_jc69_cuda(pc, ea, props, tips, w, root_id=r)
    parts = torch.cat([
        pruning_jc.ll_jc69_cuda(pc[i:i + 1000].contiguous(),
                                ea[i:i + 1000].contiguous(), props, tips, w,
                                root_id=r)
        for i in range(0, 10_000, 1000)])
    torch.cuda.synchronize()
    assert pruning_jc.LAUNCHES["ll_jc69"] == 11
    assert full.shape == (10_000,) and torch.isfinite(full).all()
    (rtol, atol), _ = TOL[dtype]
    np.testing.assert_allclose(full.cpu().numpy(), parts.cpu().numpy(),
                               rtol=rtol, atol=atol)
    twin = pruning_jc.ll_jc69_plain(pc[:1000].contiguous(),
                                    ea[:1000].contiguous(), props, tips, w,
                                    root_id=r)
    np.testing.assert_allclose(full[:1000].cpu().numpy(), twin.cpu().numpy(),
                               rtol=rtol, atol=atol)
