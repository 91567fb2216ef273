"""The generic kernels' twins and the GTR engine path against libsbn_tpu.

* The K4 twin (ops/pruning_generic.py) against the JAX package's K4
  (log_likelihood_and_branch_gradient_pallas), and the K5/K6 twins
  (ops/pruning_vjp.py, through autograd) against its K5/K6
  (log_likelihoods_pallas and its VJP), both in interpret mode on the CPU as
  tests/test_pallas.py runs them: f64 to 1e-9, f32 to the f32 gates.
* The GTR + Weibull+4 UnrootedInstance quick start against
  libsbn_tpu.UnrootedInstance: log_likelihoods and every key of
  phylo_gradients; the uniform-rates gradient against a central finite
  difference; use_tip_states equal to dense tips; rescale=False against the
  JAX engine with rescale=False; the flat-parameter interface.
* The values chip_smoke.py pins for the card against libsbn_tpu's f64 scan
  engine, so the on-card gate stays tied to the reference.
The CUDA kernels against their twins on a card: tests/test_torch_cuda.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.models.phylo_model import block_specification as jblock_spec
from libsbn_tpu.models.phylo_model import default_parameters as jdefaults
from libsbn_tpu.models.phylo_model import flat_from_parameters as jflat
from libsbn_tpu.models.phylo_model import model_tensors as jmodel_tensors
from libsbn_tpu.models.phylo_model import parameters_from_flat as jfrom_flat
from libsbn_tpu.ops import pruning as jpruning
from libsbn_tpu.ops import pruning_pallas, pruning_pallas_vjp
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu_torch.models.phylo_model import (
    PhyloModelSpec, flat_from_parameters,
)
from libsbn_tpu_torch.ops import (
    pruning_generic, pruning_jc, pruning_vjp, schedule, transforms,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GTR_RATES = [0.1, 0.2, 0.15, 0.25, 0.2, 0.1]
GTR_FREQS = [0.3, 0.25, 0.2, 0.25]
SHAPE = 0.7


def t(a, dt=torch.float64):
    return torch.as_tensor(np.array(a)).to(dt)


# -- twins against the JAX kernels in interpret mode ---------------------------


@pytest.fixture(scope="module")
def kernel_data(data_dir):
    """hello (one tree, 9 patterns) and three DS1.100_topologies trees with
    branch lengths perturbed by a seeded U(0.8, 1.2): schedules, tips,
    weights, padded branch lengths."""
    out = {}
    for name, trees, fasta, count in (
        ("hello", "hello.nwk", "hello.fasta", 1),
        ("ds1", "DS1.100_topologies.nwk", "DS1.fasta", 3),
    ):
        tops, bls, ttm = jnewick.parse_newick_file(f"{data_dir}/{trees}")
        tops, bls = tops[:count], np.stack(bls[:count])
        sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/{fasta}"), ttm)
        bl = bls * np.random.default_rng(7).uniform(0.8, 1.2, bls.shape)
        out[name] = {
            "sched": jschedule.schedules_of_topologies(tops),
            "tips": np.asarray(sp.tip_partials()),
            "w": np.asarray(sp.weights),
            "bl_p": np.pad(bl, ((0, 0), (0, 1))),
        }
    return out


def kernel_inputs(d, site, np_dt):
    """(post_children, P, Q_scaled, tips, freqs, props, weights) as numpy in
    np_dt, from JAX's model tensors at the generic GTR point."""
    spec = JSpec("GTR", site, "strict")
    params = jdefaults(spec)
    params["substitution"] = {"rates": jnp.asarray(GTR_RATES),
                              "frequencies": jnp.asarray(GTR_FREQS)}
    if site != "constant":
        params["site"]["shape"] = jnp.asarray(SHAPE)
    freqs, evec, ivec, evals, rates, props, Q = jmodel_tensors(spec, params)
    P = jax.vmap(lambda bl: jpruning.node_transition_matrices(
        evec, ivec, evals, bl, rates))(jnp.asarray(d["bl_p"]))
    Qs = Q[None] * rates[:, None, None]
    return [np.asarray(d["sched"].post_children, np.int32)] + [
        np.asarray(x, np_dt) for x in (P, Qs, d["tips"], freqs, props, d["w"])]


# (data, dtype, site) cases; f64 at 1e-9, f32 at the f32 gates.
TWIN_CASES = [
    ("hello", np.float64, "constant"),
    ("ds1", np.float64, "constant"),
    ("ds1", np.float64, "weibull+4"),
    ("hello", np.float32, "weibull+4"),
    ("ds1", np.float32, "weibull+4"),
]
CASE_IDS = [f"{d}-{np.dtype(dt).name}-{s}" for d, dt, s in TWIN_CASES]


def _close(got, want, dt, kind):
    """f64: relative to the largest entry, 1e-9. f32: LLs rtol 1e-5;
    gradients rtol 2e-2 with atol 1e-3 x the largest |entry| (entries near
    zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if dt == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)
    elif kind == "ll":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-3 * scale)


@pytest.mark.parametrize("data,dt,site", TWIN_CASES, ids=CASE_IDS)
def test_k4_twin_matches_jax_pallas_interpret(kernel_data, data, dt, site):
    """ll_grad_generic_plain against the JAX K4 in interpret mode on the
    same P, Q_scaled, freqs and props."""
    d = kernel_data[data]
    pc, P, Qs, tips, freqs, props, w = kernel_inputs(d, site, dt)
    root_id = d["sched"].root_id
    want_ll, want_g = pruning_pallas.log_likelihood_and_branch_gradient_pallas(
        pc, P, Qs, tips, freqs, w, root_id=root_id, props=props,
        interpret=True)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    ll, g = pruning_generic.log_likelihood_and_branch_gradient_generic(
        *[t(x, torch.int32 if i == 0 else tdt)
          for i, x in enumerate((pc, P, Qs, tips, freqs, props, w))],
        root_id=root_id)
    assert ll.dtype == tdt and g.shape == (pc.shape[0], root_id)
    _close(ll, want_ll, dt, "ll")
    _close(g, want_g, dt, "grad")


@pytest.mark.parametrize("data,dt,site", TWIN_CASES, ids=CASE_IDS)
def test_k5_k6_twins_match_jax_pallas_interpret(kernel_data, data, dt, site):
    """log_likelihoods_generic (K5 twin forward, K6 twin backward) against
    the JAX log_likelihoods_pallas and jax.vjp of it in interpret mode,
    under a seeded per-tree cotangent: LLs, dP, dfreqs and dprops."""
    d = kernel_data[data]
    pc, P, _, tips, freqs, props, w = kernel_inputs(d, site, dt)
    root_id = d["sched"].root_id
    tips_p, w_p = pruning_pallas.pad_patterns(tips, w)
    g = np.random.default_rng(8).uniform(0.5, 1.5, pc.shape[0]).astype(dt)

    def f(P_, freqs_, props_):
        return pruning_pallas_vjp.log_likelihoods_pallas(
            jnp.asarray(pc), P_, freqs_, props_, tips_p, w_p, tips.shape[0],
            root_id, True)

    want_ll, vjp = jax.vjp(f, jnp.asarray(P), jnp.asarray(freqs),
                           jnp.asarray(props))
    want = vjp(jnp.asarray(g))
    tdt = torch.float64 if dt == np.float64 else torch.float32
    inputs = [t(x, tdt).requires_grad_(True) for x in (P, freqs, props)]
    ll = pruning_vjp.log_likelihoods_generic(
        t(pc, torch.int32), inputs[0], t(tips, tdt), inputs[1], inputs[2],
        t(w, tdt), root_id=root_id)
    _close(ll.detach(), want_ll, dt, "ll")
    got = torch.autograd.grad(ll, inputs, t(g, tdt))
    for a, b in zip(got, want):
        assert a.dtype == tdt
        _close(a, b, dt, "grad")


def test_per_tree_rows_match_shared():
    """K5/K6 twins with freqs (B, 4) and props (B, K) rows equal to the
    shared (4,) and (K,) give the same LLs and per-tree cotangents, and a
    different row changes only its own tree."""
    rng = np.random.default_rng(9)
    tops, bls, ttm = jnewick.parse_newick_file(
        os.path.join(REPO, "data", "five_taxon_unrooted.nwk"))
    sp = JSitePattern(JAlignment.read_fasta(
        os.path.join(REPO, "data", "five_taxon.fasta")), ttm)
    sched = schedule.schedules_of_topologies(tops)
    B, N1, K = len(tops), sched.root_id + 2, 2
    P = torch.linalg.matrix_exp(
        t(rng.uniform(0.05, 0.3, (B, N1, K, 1, 1)))
        * t(np.eye(4) - 0.25)[None, None, None] * -1.0)
    freqs, props = t([0.3, 0.25, 0.2, 0.25]), t([0.4, 0.6])
    args = (torch.as_tensor(sched.post_children), P, t(sp.tip_partials()))
    shared = pruning_vjp.ll_dp_generic_plain(
        *args, freqs, props, t(sp.weights), root_id=sched.root_id)
    rows = pruning_vjp.ll_dp_generic_plain(
        *args, freqs.expand(B, 4).clone(), props.expand(B, K).clone(),
        t(sp.weights), root_id=sched.root_id)
    for a, b in zip(shared, rows):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    f2 = freqs.expand(B, 4).clone()
    f2[1] = t([0.1, 0.2, 0.3, 0.4])
    lls = pruning_vjp.ll_generic_plain(*args, f2, props, t(sp.weights),
                                       root_id=sched.root_id)
    ref = pruning_vjp.ll_generic_plain(*args, freqs, props, t(sp.weights),
                                       root_id=sched.root_id)
    changed = (lls != ref).numpy()
    assert changed[1] and not changed[0] and not changed[2:].any()


def test_cpu_tensors_route_to_generic_twins(kernel_data):
    """On the CPU the public functions run the twins, the backward of
    log_likelihoods_generic included; the kernel wrappers refuse CPU
    tensors, so no kernel launch is counted."""
    d = kernel_data["ds1"]
    pc, P, Qs, tips, freqs, props, w = [
        t(x, torch.int32 if i == 0 else torch.float64)
        for i, x in enumerate(kernel_inputs(d, "weibull+4", np.float64))]
    r = d["sched"].root_id
    pruning_generic.reset_counters()
    pruning_vjp.reset_counters()
    pruning_generic.log_likelihood_and_branch_gradient_generic(
        pc, P, Qs, tips, freqs, props, w, root_id=r)
    Pg = P.clone().requires_grad_(True)
    pruning_vjp.log_likelihoods_generic(pc, Pg, tips, freqs, props, w,
                                        root_id=r).sum().backward()
    assert pruning_generic.TWIN_CALLS == {"ll_grad_generic": 1}
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 1, "ll_dp_generic": 1}
    for call in (
        lambda: pruning_generic.ll_grad_generic_cuda(
            pc, P, Qs, tips, freqs, props, w, root_id=r),
        lambda: pruning_vjp.ll_generic_cuda(pc, P, tips, freqs, props, w,
                                            root_id=r),
        lambda: pruning_vjp.ll_dp_generic_cuda(pc, P, tips, freqs, props, w,
                                               root_id=r),
    ):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert pruning_generic.LAUNCHES == {"ll_grad_generic": 0,
                                        "ll_grad_generic_slab": 0}
    assert pruning_vjp.LAUNCHES == {"ll_generic": 0, "ll_dp_generic": 0,
                                    "ll_dp_generic_slab": 0}


# -- the engine and the instance ------------------------------------------------


def _instance(package, data_dir, spec_args, trees="DS1.100_topologies.nwk",
              fasta="DS1.fasta", count=10, params=True, **prepare):
    inst = package.UnrootedInstance("gtr")
    inst.read_newick_file(f"{data_dir}/{trees}")
    if count is not None:
        inst.tree_collection.trees = inst.tree_collection.trees[:count]
    inst.read_fasta_file(f"{data_dir}/{fasta}")
    spec = package.PhyloModelSpec(*spec_args)
    if package is libsbn_tpu_torch:
        prepare.setdefault("device", "cpu")
    inst.prepare_for_phylo_likelihood(spec, **prepare)
    if not params:
        return inst
    p = inst.phylo_model_params
    if package is libsbn_tpu:
        if spec.substitution == "GTR":
            p["substitution"] = {"rates": jnp.asarray(GTR_RATES),
                                 "frequencies": jnp.asarray(GTR_FREQS)}
        if "site" in p:
            p["site"]["shape"] = jnp.asarray(SHAPE)
    else:
        if spec.substitution == "GTR":
            p["substitution"] = {"rates": t(GTR_RATES),
                                 "frequencies": t(GTR_FREQS)}
        if "site" in p:
            p["site"]["shape"] = t(SHAPE)
    return inst


def _compare(got_inst, ref_inst):
    """LLs to relative error 1e-10; every key of phylo_gradients to rtol
    1e-8 / atol 1e-8."""
    np.testing.assert_allclose(got_inst.log_likelihoods(),
                               ref_inst.log_likelihoods(), rtol=1e-10)
    want = ref_inst.phylo_gradients()
    got = got_inst.phylo_gradients()
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].shape == value.shape, key
        rtol = 1e-10 if key == "log_likelihood" else 1e-8
        np.testing.assert_allclose(got[key].detach().numpy(), value,
                                   rtol=rtol, atol=1e-8, err_msg=key)


@pytest.mark.parametrize("site", ["constant", "weibull+4"])
def test_gtr_quick_start_matches_jax(data_dir, site):
    """The GTR quick start (ten DS1.100_topologies trees, f64 on the CPU)
    through both packages' UnrootedInstance: log_likelihoods, and
    phylo_gradients' log_likelihood, branch_lengths, substitution_model
    (B, 8) and site_model (B,)."""
    spec = ("GTR", site, "strict")
    got = _instance(libsbn_tpu_torch, data_dir, spec)
    _compare(got, _instance(libsbn_tpu, data_dir, spec))
    grads = got.phylo_gradients()
    assert grads["substitution_model"].shape == (10, 8)
    assert grads["substitution_model"].dtype == torch.float64


@pytest.mark.parametrize("sub", ["JC69", "GTR"])
def test_rescale_false_matches_jax(data_dir, sub):
    """rescaling=False takes the scan engine (no kernel or twin runs) and
    equals libsbn_tpu's CPU engine with rescale=False."""
    spec = (sub, "weibull+4", "strict")
    got = _instance(libsbn_tpu_torch, data_dir, spec, count=4,
                    rescaling=False)
    assert got.engine.rescale is False
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        m.reset_counters()
    _compare(got, _instance(libsbn_tpu, data_dir, spec, count=4,
                            rescaling=False))
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        assert not any(m.TWIN_CALLS.values()) and not any(m.LAUNCHES.values())


@pytest.mark.parametrize("spec", [("JC69", "weibull+4", "strict"),
                                  ("GTR", "weibull+4", "strict"),
                                  ("GTR", "constant", "strict")])
def test_tip_states_equal_dense_tips(data_dir, spec):
    """use_tip_states=True keeps the codes and expands them on the device:
    log_likelihoods and every phylo_gradients entry equal dense tips'."""
    dense = _instance(libsbn_tpu_torch, data_dir, spec, count=3)
    codes = _instance(libsbn_tpu_torch, data_dir, spec, count=3,
                      use_tip_states=True)
    assert codes.engine._tips is None
    assert codes.engine._tip_codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.engine.tips.numpy(),
                                  dense.engine.tips.numpy())
    np.testing.assert_array_equal(codes.log_likelihoods(),
                                  dense.log_likelihoods())
    want = dense.phylo_gradients()
    got = codes.phylo_gradients()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())


@pytest.mark.parametrize("case", ["hello-constant", "ds1-weibull+4"])
def test_uniform_rates_gradient_matches_finite_difference(data_dir, case):
    """At the default GTR parameters (uniform rates: Q has a triple
    eigenvalue, where autograd through eigh is undefined) the stick-space
    substitution gradient is finite and within 1e-4 max(1, |fd|) of a
    central difference (tests/test_models.py:118-185)."""
    data, site = case.split("-")
    files = (("hello.nwk", "hello.fasta", None) if data == "hello"
             else ("DS1.100_topologies.nwk", "DS1.fasta", 3))
    inst = _instance(libsbn_tpu_torch, data_dir, ("GTR", site, "strict"),
                     *files, params=False)
    got = inst.phylo_gradients()["substitution_model"].numpy()
    assert np.all(np.isfinite(got))
    sub = inst.phylo_model_params["substitution"]
    y0 = torch.cat([transforms.stick_breaking_inverse(sub["rates"]),
                    transforms.stick_breaking_inverse(sub["frequencies"])])

    def lls(y):
        inst.phylo_model_params["substitution"] = {
            "rates": transforms.stick_breaking(y[:5]),
            "frequencies": transforms.stick_breaking(y[5:]),
        }
        return inst.log_likelihoods()

    eps = 1e-6
    for j in range(8):
        step = torch.zeros(8, dtype=torch.float64)
        step[j] = eps
        fd = (lls(y0 + step) - lls(y0 - step)) / (2 * eps)
        assert np.all(np.abs(got[:, j] - fd) < 1e-4 * np.maximum(1.0, np.abs(fd)))


def test_engine_routes_gtr_through_the_generic_twins(data_dir):
    """On the CPU, GTR log_likelihoods runs the K5 twin; branch_gradients
    the K4 twin; phylo_gradients one K4, one K5 and one K6 twin call for all
    trees' model gradients. JC69 keeps its K1-K3 twins."""
    inst = _instance(libsbn_tpu_torch, data_dir, ("GTR", "weibull+4", "strict"),
                     count=3)
    for m in (pruning_jc, pruning_generic, pruning_vjp):
        m.reset_counters()
    inst.log_likelihoods()
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 1, "ll_dp_generic": 0}
    inst.phylo_gradients()
    assert pruning_generic.TWIN_CALLS == {"ll_grad_generic": 1}
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 2, "ll_dp_generic": 1}
    assert not any(pruning_jc.TWIN_CALLS.values())
    jc = _instance(libsbn_tpu_torch, data_dir, ("JC69", "weibull+4", "strict"),
                   count=3)
    jc.phylo_gradients()
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 1, "ll_jc69": 1,
                                     "ll_dea_jc69": 1}
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 2, "ll_dp_generic": 1}


def test_flat_parameters_match_jax(data_dir):
    """get_phylo_model_block_specification and
    set_phylo_model_params_from_flat as libsbn_tpu's instance has them; the
    flat vector round-trips."""
    spec = ("GTR", "weibull+4", "strict")
    got = _instance(libsbn_tpu_torch, data_dir, spec, count=2, params=False)
    ref = _instance(libsbn_tpu, data_dir, spec, count=2, params=False)
    assert (got.get_phylo_model_block_specification().get_map()
            == ref.get_phylo_model_block_specification().get_map())
    v = np.concatenate([GTR_RATES, GTR_FREQS, [SHAPE], [1.5]])
    got.set_phylo_model_params_from_flat(v)
    ref.set_phylo_model_params_from_flat(v)
    want = jfrom_flat(JSpec(*spec), v)
    for block, entries in want.items():
        for name, value in entries.items():
            tensor = got.phylo_model_params[block][name]
            assert tensor.dtype == torch.float64
            np.testing.assert_array_equal(tensor.numpy(), np.asarray(value))
    np.testing.assert_array_equal(
        flat_from_parameters(PhyloModelSpec(*spec), got.phylo_model_params),
        jflat(JSpec(*spec), want))
    np.testing.assert_allclose(got.log_likelihoods(), ref.log_likelihoods(),
                               rtol=1e-10)
    assert jblock_spec(JSpec(*spec)).parameter_count() == v.size


def test_chip_smoke_pins_match_jax(data_dir):
    """The GTR values chip_smoke.py pins for the card (phase 4b) equal
    libsbn_tpu's f64 scan engine on the CPU to rtol 1e-12: the 100 LLs and
    edge-0 gradients, and the first ten trees' substitution and shape
    gradients."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.GTR_RATES == GTR_RATES
    assert chip_smoke.GTR_FREQS == GTR_FREQS and chip_smoke.GTR_SHAPE == SHAPE
    spec = ("GTR", "weibull+4", "strict")
    full = _instance(libsbn_tpu, data_dir, spec, count=None)
    lls, bgrads = full.engine.branch_gradients(
        full._batched_schedule(), full.branch_length_matrix(),
        full.phylo_model_params)
    np.testing.assert_allclose(chip_smoke.GTR_LIKELIHOODS, np.asarray(lls),
                               rtol=1e-12)
    np.testing.assert_allclose(chip_smoke.GTR_GRADIENTS_BL0,
                               np.asarray(bgrads)[:, 0], rtol=1e-12)
    grads = _instance(libsbn_tpu, data_dir, spec).phylo_gradients()
    np.testing.assert_allclose(chip_smoke.GTR_SUBSTITUTION_GRADIENTS,
                               np.asarray(grads["substitution_model"]),
                               rtol=1e-12)
    np.testing.assert_allclose(chip_smoke.GTR_SITE_GRADIENTS,
                               np.asarray(grads["site_model"]), rtol=1e-12)
