"""The CUDA kernels of libsbn_tpu_torch against their plain PyTorch twins,
the VBPI step and the GTR engine path on the card against the same on the
CPU.

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


def _inputs(data, dtype, K):
    """The one hello tree (one combine step, a ragged tile of 9 patterns)
    or three DS1 trees (934 patterns, 8 tiles), branch lengths perturbed by a
    seeded U(0.8, 1.2), with one or K Weibull rate categories, on the card:
    (post_children, ea, rates, props, tips, weights, root_id)."""
    if data == "hello":
        tops, bls, ttm = newick.parse_newick_file(f"{DATA}/hello.nwk")
        aln = Alignment.read_fasta(f"{DATA}/hello.fasta")
    else:
        tops, bls, ttm = newick.parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
        aln = Alignment.read_fasta(f"{DATA}/DS1.fasta")
    tops, bls = tops[:3], np.stack(bls[:3])
    sp = SitePattern(aln, ttm)
    sched = schedule.schedules_of_topologies(tops)
    rng = np.random.default_rng(1)
    bl = np.pad(bls * rng.uniform(0.8, 1.2, bls.shape), ((0, 0), (0, 1)))

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(dt).cuda()

    if K == 1:
        rates = props = dev(np.ones(1))
    else:
        rates, props = (dev(x) for x in weibull_rates(0.3, K))
    ea = pruning_jc.exp_factors(dev(bl), rates, dtype)
    pc = dev(sched.post_children, torch.int32)
    return pc, ea, rates, props, dev(sp.tip_partials()), dev(sp.weights), \
        sched.root_id


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "ds1"])
def test_kernels_match_twins_on_card(data, dtype, K):
    """K1 and K2 against their twins on one card (inputs: _inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, ea, rates, props, tips, w, r = _inputs(data, dtype, K)
    args = (pc, ea, rates, props, tips, w)
    k_ll, k_g = pruning_jc.ll_grad_jc69_cuda(*args, root_id=r)
    t_ll, t_g = pruning_jc.ll_grad_jc69_plain(*args, root_id=r)
    k2 = pruning_jc.ll_jc69_cuda(pc, ea, props, tips, w, root_id=r)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "ds1"])
def test_k3_matches_twin_on_card(data, dtype, K):
    """K3 (d ll / d ea, d ll / d props) against its twin on one card, at
    the gradient tolerance of TOL; the root and ones-slot rows are zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pc, ea, _, props, tips, w, r = _inputs(data, dtype, K)
    pruning_jc.reset_counters()
    k_dea, k_dp = pruning_jc.ll_dea_jc69_cuda(pc, ea, props, tips, w,
                                              root_id=r)
    t_dea, t_dp = pruning_jc.ll_dea_jc69_plain(pc, ea, props, tips, w,
                                               root_id=r)
    torch.cuda.synchronize()
    assert pruning_jc.LAUNCHES["ll_dea_jc69"] == 1
    B = pc.shape[0]
    assert k_dea.shape == (B, r + 2, K) and k_dp.shape == (B, K)
    assert not k_dea[:, r:].any()
    g_rtol, g_atol = TOL[dtype][1]
    np.testing.assert_allclose(k_dea.cpu().numpy(), t_dea.cpu().numpy(),
                               rtol=g_rtol, atol=g_atol)
    np.testing.assert_allclose(k_dp.cpu().numpy(), t_dp.cpu().numpy(),
                               rtol=g_rtol, atol=g_atol)


def _ds1_instance():
    inst = libsbn_tpu_torch.UnrootedInstance("vbpi")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(libsbn_tpu_torch.PhyloModelSpec())
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
    cpu = JitVBPI(_ds1_instance(), particle_count=10, seed=0, device="cpu")
    card = JitVBPI(_ds1_instance(), particle_count=10, seed=0, device="cuda")
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
    """The hello tree or three DS1.100_topologies trees, GTR at non-uniform
    rates and frequencies with one or K Weibull categories (shape 0.7), on
    the card: (post_children, P, Q_scaled, tips, freqs, props, weights,
    root_id)."""
    if data == "hello":
        tops, bls, ttm = newick.parse_newick_file(f"{DATA}/hello.nwk")
        aln = Alignment.read_fasta(f"{DATA}/hello.fasta")
    else:
        tops, bls, ttm = newick.parse_newick_file(
            f"{DATA}/DS1.100_topologies.nwk")
        aln = Alignment.read_fasta(f"{DATA}/DS1.fasta")
    tops, bls = tops[:3], np.stack(bls[:3])
    sp = SitePattern(aln, ttm)
    sched = schedule.schedules_of_topologies(tops)
    bl = np.pad(bls * np.random.default_rng(1).uniform(0.8, 1.2, bls.shape),
                ((0, 0), (0, 1)))

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
    return (dev(sched.post_children, torch.int32), P.contiguous(),
            Qs.contiguous(), dev(sp.tip_partials()), freqs.to(dtype),
            props.to(dtype), dev(sp.weights), sched.root_id)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["hello", "ds1"])
def test_generic_kernels_match_twins_on_card(data, dtype, K):
    """K4, K5 and K6 against their twins on one card, at the tolerances of
    TOL (inputs: _generic_inputs); K5 and K6 with shared freqs and props
    and with one row per tree; K6's root and ones-slot rows are zero."""
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
    k_ll, k_g = pruning_generic.ll_grad_generic_cuda(*args, root_id=r)
    t_ll, t_g = pruning_generic.ll_grad_generic_plain(*args, root_id=r)
    close(k_ll, t_ll, ll_rtol, ll_atol)
    close(k_g[:, :r], t_g[:, :r], g_rtol, g_atol)
    rows = (freqs * torch.linspace(0.9, 1.1, B, dtype=dtype,
                                   device="cuda")[:, None]).contiguous()
    for f, p in ((freqs, props), (rows, props.expand(B, K).contiguous())):
        args = (pc, P, tips, f, p, w)
        close(pruning_vjp.ll_generic_cuda(*args, root_id=r),
              pruning_vjp.ll_generic_plain(*args, root_id=r), ll_rtol, ll_atol)
        got = pruning_vjp.ll_dp_generic_cuda(*args, root_id=r)
        want = pruning_vjp.ll_dp_generic_plain(*args, root_id=r)
        torch.cuda.synchronize()
        assert got[0].shape == (B, r + 2, K, 4, 4) and not got[0][:, r:].any()
        for a, b in zip(got, want):
            close(a, b, g_rtol, g_atol)


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
    assert pruning_generic.LAUNCHES == {"ll_grad_generic": 1}
    assert pruning_vjp.LAUNCHES == {"ll_generic": 2, "ll_dp_generic": 1}
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        assert not any(m.TWIN_CALLS.values())
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-12)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].cpu().numpy(), want[key].numpy(),
                                   rtol=1e-9, atol=1e-8, err_msg=key)
