"""K3 and the differentiable JC69 likelihood against libsbn_tpu.

* The f32 K3 twin (d ll / d ea and d ll / d props) against the JAX package's
  K3 Pallas kernel run in interpret mode on the CPU.
* Autograd through ``log_likelihoods_jc69`` (K2 forward, K3 backward)
  against K1's direct branch gradients.
* The f64 Weibull shape gradient of ``phylo_gradients`` against the JAX f64
  engine's (its AD through the scan engine), and against a central finite
  difference.
The K3 kernel against its twin on a card: tests/test_torch_cuda.py.

Inputs are the repo's DS1 data; perturbations come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.ops import pruning_pallas, pruning_pallas_jc
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu.ops.site_model import weibull_rates as jweibull_rates
from libsbn_tpu_torch.ops import pruning_jc
from libsbn_tpu_torch.ops.site_model import weibull_rates

torch.set_num_threads(1)

SITES = ["constant", "weibull+4"]


@pytest.fixture(scope="module")
def ds1(data_dir):
    """Three DS1.subsampled_10 trees with branch lengths perturbed by
    U(0.8, 1.2) from default_rng(0), the ones slot appended (f64)."""
    tops, bls, ttm = jnewick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    sched = jschedule.schedules_of_topologies(tops[:3])
    bl = np.stack(bls[:3])
    bl = bl * np.random.default_rng(0).uniform(0.8, 1.2, bl.shape)
    return {
        "pc": np.asarray(sched.post_children, np.int32),
        "root_id": sched.root_id,
        "bl_p": np.pad(bl, ((0, 0), (0, 1))),
        "tips": sp.tip_partials(),
        "w": sp.weights.astype(np.float64),
    }


def _rates_props(site, shape=0.3):
    if site == "constant":
        return np.ones(1), np.ones(1)
    rates, props = jweibull_rates(shape, 4)
    return np.asarray(rates), np.asarray(props)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a)).to(dtype)


@pytest.mark.parametrize("site", SITES)
def test_k3_twin_matches_jax_interpret(ds1, site):
    """The f32 K3 twin vs the JAX K3 (_bwd_dea_call, interpret=True, on
    pattern-padded tips) on three DS1 trees, from the same f32 exp factors
    (the twin reads their complements 1 - e, exact in f32 for e >= 1/2).
    Gates: dea within 1e-5 relative to the largest |dea| of its tree,
    dprops within rtol 1e-5. Observed: dea 9.8e-4 of 1487 (constant) / 3.1e-4
    of 756 (Weibull+4), 6.6e-7 relative; dprops 6.1e-4 of 1995 at most."""
    rates, props = _rates_props(site)
    K = rates.shape[0]
    tips = ds1["tips"].astype(np.float32)
    w = ds1["w"].astype(np.float32)
    tips_p, w_p = pruning_pallas.pad_patterns(tips, w)
    ea = pruning_pallas_jc.exp_factors(ds1["bl_p"].astype(np.float32),
                                       rates.astype(np.float32))
    B = ea.shape[0]
    jdea, jdprops = pruning_pallas_jc._bwd_dea_call(
        jnp.asarray(ds1["pc"]), ea[:, None, :],
        jnp.asarray(props, jnp.float32)[None], jnp.asarray(tips_p),
        jnp.asarray(w_p)[None], leaf_count=tips.shape[0],
        root_id=ds1["root_id"], tile=tips_p.shape[2], interpret=True,
    )
    jdea = np.asarray(jdea).reshape(B, -1, K)
    pruning_jc.reset_counters()
    dea, dprops = pruning_jc.ll_dea_jc69_plain(
        _t(ds1["pc"], torch.int32),
        (1.0 - _t(ea, torch.float32)).reshape(B, -1, K),
        _t(props, torch.float32), _t(tips, torch.float32),
        _t(w, torch.float32), root_id=ds1["root_id"],
    )
    assert pruning_jc.TWIN_CALLS["ll_dea_jc69"] == 1
    assert dea.dtype == torch.float32 and dea.shape == jdea.shape
    rel = (np.abs(dea.numpy() - jdea).max(axis=(1, 2))
           / np.abs(jdea).max(axis=(1, 2)))
    assert np.all(rel < 1e-5), rel
    np.testing.assert_allclose(dprops.numpy(), np.asarray(jdprops), rtol=1e-5)
    r = ds1["root_id"]
    assert not dea[:, r:].any()  # the root and ones-slot rows


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_autograd_branch_gradients_match_k1(ds1, site, dtype):
    """d sum(LL) / d bl through log_likelihoods_jc69 (K2 + K3 twins) vs
    K1's direct branch gradients (the twin) on three DS1 trees, as
    tests/test_pallas.py holds the JAX VJP against its fused kernel. Gates:
    f64 rtol 1e-10 (atol 1e-10 x the largest |gradient|); f32 rtol 1e-3,
    atol 0.05 (the JAX test's). Observed f64: 1.4e-12 of 1809 (constant),
    5.1e-13 of 1950 (Weibull+4). The forward LLs are equal, and the
    gradient comes back in f64 (the exp factors are built in f64)."""
    rates, props = _rates_props(site)
    pc = _t(ds1["pc"], torch.int32)
    tips, w = _t(ds1["tips"], dtype), _t(ds1["w"], dtype)
    bl = _t(ds1["bl_p"]).requires_grad_(True)
    kw = dict(root_id=ds1["root_id"], rates=_t(rates), props=_t(props))
    pruning_jc.reset_counters()
    ll = pruning_jc.log_likelihoods_jc69(pc, bl, tips, w, **kw)
    (grad,) = torch.autograd.grad(ll.sum(), bl)
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 0, "ll_jc69": 1,
                                     "ll_dea_jc69": 1}
    ll1, g1 = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        pc, bl.detach(), tips, w, **kw)
    assert grad.dtype == torch.float64 and ll.dtype == dtype
    r = ds1["root_id"]
    assert not grad[:, r:].any()
    if dtype == torch.float64:
        np.testing.assert_array_equal(ll.detach().numpy(), ll1.numpy())
        tol = dict(rtol=1e-10, atol=1e-10 * float(g1.abs().max()))
    else:
        tol = dict(rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(grad[:, :r].numpy(), g1.double().numpy(),
                               **tol)


def _weibull(package, data_dir, shape):
    inst = package.UnrootedInstance("weibull")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    kw = {"device": "cpu"} if package is libsbn_tpu_torch else {}
    inst.prepare_for_phylo_likelihood(
        package.PhyloModelSpec("JC69", "weibull+4", "strict"), **kw)
    if package is libsbn_tpu:
        inst.phylo_model_params["site"]["shape"] = jnp.asarray(shape)
    else:
        inst.phylo_model_params["site"]["shape"] = torch.tensor(
            shape, dtype=torch.float64)
    return inst


def test_weibull_phylo_gradients_match_jax(data_dir):
    """UnrootedInstance.phylo_gradients on DS1 Weibull+4 (shape 0.5), f64 on
    the CPU: "site_model" (B,) within relative error 1e-9 of the JAX
    engine's jacrev rows (observed 3.3e-15), from one K3 twin call for all
    ten trees; the branch gradients and LLs within 1e-10 (observed 1.9e-10
    absolute on entries up to ~2e3)."""
    ref = _weibull(libsbn_tpu, data_dir, 0.5).phylo_gradients()
    inst = _weibull(libsbn_tpu_torch, data_dir, 0.5)
    pruning_jc.reset_counters()
    got = inst.phylo_gradients()
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 1, "ll_jc69": 1,
                                     "ll_dea_jc69": 1}
    assert set(got) == set(ref)
    want = np.asarray(ref["site_model"])
    mine = got["site_model"]
    assert mine.dtype == torch.float64 and mine.shape == want.shape == (10,)
    np.testing.assert_allclose(mine.numpy(), want, rtol=1e-9)
    wb = np.asarray(ref["branch_lengths"])
    np.testing.assert_allclose(got["branch_lengths"].numpy(), wb, rtol=1e-10,
                               atol=1e-10 * np.abs(wb).max())
    np.testing.assert_allclose(got["log_likelihood"].numpy(),
                               np.asarray(ref["log_likelihood"]), rtol=1e-10)


def test_shape_gradient_matches_finite_difference(data_dir):
    """The summed shape gradient at shape 0.5 against a central finite
    difference of the summed LL (step 1e-5, f64): within 1e-6 relative
    (the JAX test's f32 gate is 2e-2)."""
    inst = _weibull(libsbn_tpu_torch, data_dir, 0.5)
    g = float(inst.phylo_gradients()["site_model"].sum())
    h = 1e-5

    def total(shape):
        inst.phylo_model_params["site"]["shape"] = torch.tensor(
            shape, dtype=torch.float64)
        return float(inst.log_likelihoods().sum())

    fd = (total(0.5 + h) - total(0.5 - h)) / (2 * h)
    assert abs(g - fd) < 1e-6 * abs(fd), (g, fd)


def test_weibull_rates_per_tree(ds1):
    """weibull_rates of a (B,) shape gives (B, K) rates, each row equal to
    the scalar-shape rates, and props (K,); exp_complements takes
    either."""
    shapes = torch.tensor([0.3, 0.5, 2.0], dtype=torch.float64)
    rates, props = weibull_rates(shapes, 4)
    assert rates.shape == (3, 4) and props.shape == (4,)
    bl = _t(ds1["bl_p"])
    em = pruning_jc.exp_complements(bl, rates, torch.float64)
    for b, s in enumerate(shapes):
        r1, _ = weibull_rates(float(s), 4)
        np.testing.assert_array_equal(rates[b].numpy(), r1.numpy())
        np.testing.assert_array_equal(
            em[b].numpy(),
            pruning_jc.exp_complements(bl[b:b + 1], r1,
                                       torch.float64)[0].numpy(),
        )
