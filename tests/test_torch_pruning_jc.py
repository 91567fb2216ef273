"""The port's JC69 pruning (ops/pruning_jc.py) against libsbn_tpu.

* The f32 twins against the JAX package's K1 and K2 Pallas kernels, run in
  interpret mode on the CPU as tests/test_pallas.py runs them.
* The f64 twins, through the port's engine, against the JAX f64 scan
  engine.
* The golden numbers of tests/test_likelihood.py.
The CUDA kernels against their twins on a card: tests/test_torch_cuda.py.

Inputs are the repo's DS1 data; perturbations come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.models.engine import LikelihoodEngine as JEngine
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.models.phylo_model import default_parameters as jdefaults
from libsbn_tpu.models.phylo_model import model_tensors as jmodel_tensors
from libsbn_tpu.ops import pruning_pallas, pruning_pallas_jc
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.models.phylo_model import (
    PhyloModelSpec, default_parameters, params_from_numpy,
)
from libsbn_tpu_torch.ops import pruning_jc, schedule
from libsbn_tpu_torch.ops.site_model import weibull_rates

torch.set_num_threads(1)

PYBEAGLE_LIKELIHOODS = [
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
]
PHYSHER_GRADIENTS = [
    -904.18956, -607.70500, -562.36274, -553.63315, -542.26058, -539.64210,
    -463.36511, -445.32555, -414.27197, -412.84218, -399.15359, -342.68038,
    -306.23644, -277.05392, -258.73681, -175.07391, -171.59627, -168.57646,
    -150.57623, -145.38176, -115.15798, -94.86412, -83.02880, -80.09165,
    -69.00574, -51.93337, 0.00000, 0.00000, 16.17497, 20.47784,
    58.06984, 131.18998, 137.10799, 225.73617, 233.92172, 253.49785,
    255.52967, 259.90378, 394.00504, 394.96619, 396.98933, 429.83873,
    450.71566, 462.75827, 471.57364, 472.83161, 514.59289, 650.72575,
    888.87834, 913.96566, 927.14730, 959.10746, 2296.55028,
]
PHYSHER_WEIBULL_LIKELIHOODS = [
    -9456.1201098061, -6624.4110704332, -6623.4474776131, -6617.25658038029,
    -6627.5385571548, -6621.6155048722, -6622.3314942713, -6618.7695717585,
    -6616.3837517370, -6623.8295828648,
]
PHYSHER_WEIBULL_GRADIENTS_BL0 = [
    -126.890527, 157.251275, 138.202510, -180.311856, 417.562897, -796.450894,
    -173.744375, -70.693513, 699.190754, -723.034349,
]
SITES = ["constant", "weibull+4"]


@pytest.fixture(scope="module")
def ds1(data_dir):
    """Both packages' view of DS1.subsampled_10: the branch lengths ("bl",
    for the goldens), and the same perturbed by U(0.8, 1.2) from numpy with a
    seed ("bl_r"; "bl_p" in f32 with the ones slot appended)."""
    tops, bls, ttm = jnewick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    jsp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    ttops, _, tttm = newick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{data_dir}/DS1.fasta"), tttm)
    bl = np.stack(bls)
    rng = np.random.default_rng(0)
    bl_r = bl * rng.uniform(0.8, 1.2, bl.shape)
    bl_p = np.pad(bl_r, ((0, 0), (0, 1)))
    return {
        "jsched": jschedule.schedules_of_topologies(tops),
        "sched": schedule.schedules_of_topologies(ttops),
        "jsp": jsp, "sp": sp, "bl": bl, "bl_r": bl_r,
        "bl_p": bl_p.astype(np.float32),
    }


def _jax_params(site, shape=0.1):
    spec = JSpec("JC69", site, "strict")
    params = jdefaults(spec)
    if site != "constant":
        params["site"]["shape"] = jnp.asarray(shape)
    return spec, params


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_f32_twins_match_jax_pallas_interpret(ds1, kernel, site):
    """Twins in f32 on the CPU vs the JAX kernels in interpret mode, on four
    trees with perturbed branch lengths. Gates: LLs rtol 1e-5, gradient
    entries rtol 2e-2 (the BASELINE.md f32 gate). Observed (K1 and K2
    alike): LL rel err 1.4e-7 (constant) / 2.1e-7 (Weibull+4); gradient
    rel err 3.6e-5 / 9.3e-5 (smallest |gradient| 5.7 / 0.055)."""
    B = 4
    spec, params = _jax_params(site)
    mt = jmodel_tensors(spec, params)
    rates = np.asarray(mt[4], np.float32)
    props = np.asarray(mt[5], np.float32)
    pc = np.asarray(ds1["jsched"].post_children[:B])
    bl_p = ds1["bl_p"][:B]
    tips = ds1["jsp"].tip_partials(np.float32)
    w = ds1["jsp"].weights.astype(np.float32)
    root_id = ds1["jsched"].root_id

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dt)

    args = (t(pc, torch.int32), t(bl_p), t(tips), t(w))
    kw = dict(root_id=root_id, rates=t(rates), props=t(props))
    if kernel == "K1":
        ll, grad = pruning_pallas_jc.log_likelihood_and_branch_gradient_pallas_jc69(
            pc, bl_p, tips, w, root_id=root_id, rates=rates, props=props,
            interpret=True,
        )
        tll, tgrad = pruning_jc.log_likelihood_and_branch_gradient_jc69(*args, **kw)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(grad), rtol=2e-2)
    else:
        tips_p, w_p = pruning_pallas.pad_patterns(tips, w)
        ll = pruning_pallas_jc.log_likelihoods_pallas_jc69(
            pc, bl_p, tips_p, w_p, leaf_count=tips.shape[0], root_id=root_id,
            rates=rates, props=props, interpret=True,
        )
        tll = pruning_jc.log_likelihoods_jc69(*args, **kw)
    assert tll.dtype == torch.float32 and tll.shape == (B,)
    np.testing.assert_allclose(tll.numpy(), np.asarray(ll), rtol=1e-5)


@pytest.mark.parametrize("site", SITES)
def test_f64_twins_match_jax_scan_engine(ds1, site):
    """The port's f64 engine (the twins, on the CPU) vs the JAX f64 scan
    engine on the ten DS1 trees, perturbed: relative error <= 1e-10 for LLs and for
    gradient entries (atol 1e-10 x the largest |gradient|, for entries near
    zero). Observed: LL 5.3e-16 (constant) / 3.1e-15 (Weibull+4); gradient
    entries 1.7e-12 / 4.9e-11."""
    spec, params = _jax_params(site)
    jeng = JEngine(ds1["jsp"], spec, dtype=jnp.float64)
    bl = ds1["bl_r"]
    jll = np.asarray(jeng.log_likelihoods(ds1["jsched"], bl, params))
    jll2, jgrad = map(
        np.asarray, jeng.branch_gradients(ds1["jsched"], bl, params)
    )
    eng = LikelihoodEngine(ds1["sp"], PhyloModelSpec("JC69", site, "strict"),
                           device="cpu")
    tparams = params_from_numpy(
        {k: {n: np.asarray(x) for n, x in v.items()} for k, v in params.items()},
        "cpu", torch.float64,
    )
    ll = eng.log_likelihoods(ds1["sched"], bl, tparams)
    ll2, grad = eng.branch_gradients(ds1["sched"], bl, tparams)
    assert grad.dtype == torch.float64 and grad.shape == jgrad.shape
    np.testing.assert_allclose(ll.numpy(), jll, rtol=1e-10)
    np.testing.assert_allclose(ll2.numpy(), jll2, rtol=1e-10)
    np.testing.assert_allclose(
        grad.numpy(), jgrad, rtol=1e-10, atol=1e-10 * np.abs(jgrad).max()
    )


def _engine_outputs(ds1, site, gradients):
    spec = PhyloModelSpec("JC69", site, "strict")
    params = default_parameters(spec)
    if site != "constant":
        params["site"]["shape"] = torch.tensor(0.1, dtype=torch.float64)
    eng = LikelihoodEngine(ds1["sp"], spec, device="cpu")
    if gradients:
        return eng.branch_gradients(ds1["sched"], ds1["bl"], params)
    return eng.log_likelihoods(ds1["sched"], ds1["bl"], params)


@pytest.mark.parametrize("golden", [
    "hello", "ds1_ll", "ds1_grad", "weibull_ll", "weibull_grad_bl0",
])
def test_goldens(ds1, data_dir, golden):
    """The tests/test_likelihood.py goldens through the port's f64 engine:
    hello within 1e-6, DS1 LLs within 1.1e-4, the 53 physher gradients
    within 1e-4, Weibull+4 LLs and first-edge gradients within 1.1e-4."""
    if golden == "hello":
        tops, bls, ttm = newick.parse_newick_file(f"{data_dir}/hello.nwk")
        sp = SitePattern(Alignment.read_fasta(f"{data_dir}/hello.fasta"), ttm)
        spec = PhyloModelSpec("JC69", "constant", "strict")
        ll = LikelihoodEngine(sp, spec, device="cpu").log_likelihoods(
            schedule.schedules_of_topologies(tops), np.stack(bls),
            default_parameters(spec),
        )
        assert abs(float(ll[0]) - (-84.852358)) < 1e-6
    elif golden == "ds1_ll":
        ll = _engine_outputs(ds1, "constant", gradients=False)
        np.testing.assert_allclose(ll.numpy(), PYBEAGLE_LIKELIHOODS, atol=1.1e-4)
    elif golden == "ds1_grad":
        ll, grad = _engine_outputs(ds1, "constant", gradients=True)
        np.testing.assert_allclose(ll.numpy(), PYBEAGLE_LIKELIHOODS, atol=1.1e-4)
        # Two structural zeros complete the reference's detrifurcated layout.
        mine = sorted(grad[-1].tolist() + [0.0, 0.0])
        np.testing.assert_allclose(mine, PHYSHER_GRADIENTS, atol=1e-4)
    elif golden == "weibull_ll":
        ll = _engine_outputs(ds1, "weibull+4", gradients=False)
        np.testing.assert_allclose(
            ll.numpy(), PHYSHER_WEIBULL_LIKELIHOODS, atol=1.1e-4
        )
    else:
        _, grad = _engine_outputs(ds1, "weibull+4", gradients=True)
        np.testing.assert_allclose(
            grad[:, 0].numpy(), PHYSHER_WEIBULL_GRADIENTS_BL0, atol=1.1e-4
        )


def test_exp_factors_match_jax(ds1):
    """The kernels' m = 1 - e, e = exp(-4br/3), by expm1 in f64: 1 - m
    rounded to f32 is the JAX package's f32 exp_factors to within one f32
    rounding (1 - m and exp differ by an f64 rounding, which can move a
    value across an f32 rounding boundary); and m in f32 keeps its
    precision on a short branch, where 1 - e rounded to f32 does not."""
    rates = np.asarray(weibull_rates(0.5, 4)[0], np.float32)
    want = np.asarray(pruning_pallas_jc.exp_factors(ds1["bl_p"], rates))
    m = pruning_jc.exp_complements(
        torch.as_tensor(ds1["bl_p"]), torch.as_tensor(rates), torch.float64
    )
    got = (1.0 - m).to(torch.float32)
    np.testing.assert_allclose(got.reshape(got.shape[0], -1).numpy(), want,
                               rtol=2.0 ** -23, atol=0)
    t = torch.tensor([[1e-6, 1e-5, 0.0]], dtype=torch.float64)
    exact = -torch.expm1(-4.0 / 3.0 * t[:, :2])
    m32 = pruning_jc.exp_complements(t, torch.ones(1), torch.float32)
    assert m32.shape == (1, 3, 1) and m32[0, 2, 0] == 0
    np.testing.assert_allclose(m32[0, :2, 0].double(), exact[0], rtol=1e-7)
    rounded = 1.0 - torch.exp(-4.0 / 3.0 * t[:, :2]).to(torch.float32)
    assert ((rounded.double() - exact).abs() / exact).max() > 1e-3


def test_cpu_tensors_route_to_twins_and_never_reach_kernels(ds1):
    """On the CPU the public functions run the twins (their counters move,
    the kernels' do not), the backward of log_likelihoods_jc69 included;
    the kernel wrappers refuse CPU tensors."""
    sched, sp = ds1["sched"], ds1["sp"]
    pc = torch.as_tensor(sched.post_children, dtype=torch.int32)
    bl = torch.as_tensor(ds1["bl_p"])
    tips = torch.as_tensor(sp.tip_partials(np.float32))
    w = torch.as_tensor(sp.weights.astype(np.float32))
    pruning_jc.reset_counters()
    pruning_jc.log_likelihoods_jc69(pc, bl, tips, w, root_id=sched.root_id)
    pruning_jc.log_likelihood_and_branch_gradient_jc69(
        pc, bl, tips, w, root_id=sched.root_id
    )
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 1, "ll_jc69": 1,
                                     "ll_dea_jc69": 0}
    bl_grad = bl.clone().requires_grad_(True)
    pruning_jc.log_likelihoods_jc69(
        pc, bl_grad, tips, w, root_id=sched.root_id).sum().backward()
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 1, "ll_jc69": 2,
                                     "ll_dea_jc69": 1}
    assert not any(pruning_jc.LAUNCHES.values())
    one = torch.ones(1)
    em = pruning_jc.exp_complements(bl, one, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_jc.ll_jc69_cuda(pc, em, one, tips, w, root_id=sched.root_id)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_jc.ll_grad_jc69_cuda(pc, em, one, one, tips, w,
                                     root_id=sched.root_id)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_jc.ll_dea_jc69_cuda(pc, em, one, tips, w,
                                    root_id=sched.root_id)
    assert not any(pruning_jc.LAUNCHES.values())


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_onchip_plan_fits_shared_memory(dtype, K):
    """The shared-memory plan of the on-chip K1 and K3: at DS1 (27 taxa,
    25 combine steps) every (dtype, K <= 8) gets a tile of 32 patterns
    within the 232,448 bytes a Hopper block may use; a 256-taxon tree gets
    it at float32 K = 1 and no plan otherwise (the slab route)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for kernel, G in (("ll_grad", 1), ("dea", K)):
        tile, smem = pruning_jc.onchip_plan(dtype, K, 25, 27, kernel)
        assert tile == 32 and smem <= 232_448
        assert smem == pruning_jc.onchip_bytes(itemsize, K, 25, 27, G)
        big = pruning_jc.onchip_plan(dtype, K, 254, 256, kernel)
        if dtype == torch.float32 and K == 1:
            assert big[0] == 32 and big[1] <= 232_448
        else:
            assert big is None


def _cu_onchip_bytes(itemsize, K, S, L, G, TP=32):
    """csrc/pruning_jc.cu onchip_bytes, written out again: exp factors
    (N1 K), rates and props (2K), the warps' edge sums (W N1 G) and root sums
    (W K), the slot rows ((S - 1) 4K TP) and the int32 schedule row (3S)."""
    N1, W = L + S + 1, TP // 32
    return (itemsize * (N1 * K + 2 * K + W * N1 * G + W * K + (S - 1) * 4 * K * TP)
            + 4 * 3 * S)


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_plan_fits_ds1_and_refuses_the_big_tree(dtype, K):
    """The on-chip K2's plan (kind "ll": no edge sums, G = 0) gives a tile of
    32 patterns at DS1 (S = 25, L = 27) for every (dtype, K <= 8), in
    exactly the bytes csrc/pruning_jc.cu carves, fewer than K1's; on the
    256-taxon tree only float32 K = 1 fits, so everything else takes the
    slab route there."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tile, smem = pruning_jc.onchip_plan(dtype, K, 25, 27, "ll")
    assert tile == 32 and smem <= pruning_jc.SHARED_LIMIT
    assert smem == pruning_jc.onchip_bytes(itemsize, K, 25, 27, 0)
    assert smem == _cu_onchip_bytes(itemsize, K, 25, 27, 0)
    assert smem < pruning_jc.onchip_plan(dtype, K, 25, 27, "ll_grad")[1]
    big = pruning_jc.onchip_plan(dtype, K, 254, 256, "ll")
    if dtype == torch.float32 and K == 1:
        assert big == (32, _cu_onchip_bytes(4, 1, 254, 256, 0))
    else:
        assert big is None


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_cpu_tensors_reach_only_the_twin(ds1, dtype, K):
    """log_likelihoods_jc69 on CPU tensors calls K2's twin (and K3's for
    its backward), never a kernel of either route, at every dtype and K;
    the K2 wrapper refuses CPU tensors before it chooses a route."""
    sched, sp = ds1["sched"], ds1["sp"]
    pc = torch.as_tensor(sched.post_children, dtype=torch.int32)
    bl = torch.as_tensor(ds1["bl_p"]).to(dtype).requires_grad_(True)
    tips = torch.as_tensor(sp.tip_partials()).to(dtype)
    w = torch.as_tensor(sp.weights).to(dtype)
    rates, props = (x.to(dtype) for x in weibull_rates(0.3, K))
    pruning_jc.reset_counters()
    ll = pruning_jc.log_likelihoods_jc69(pc, bl, tips, w, root_id=sched.root_id,
                                         rates=rates, props=props)
    ll.sum().backward()
    assert ll.dtype == dtype and torch.isfinite(bl.grad).all()
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 0, "ll_jc69": 1,
                                     "ll_dea_jc69": 1}
    em = pruning_jc.exp_complements(bl.detach(), rates, dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_jc.ll_jc69_cuda(pc, em, props, tips, w, root_id=sched.root_id)
    assert not any(pruning_jc.LAUNCHES.values())
