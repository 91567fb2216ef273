"""The port's GTR model pieces and its scan engine against libsbn_tpu.

* ops/substitution.py: gtr_q, gtr_eigen, transition_matrices and
  expm_transition (forward, and its Daleckii-Krein backward against
  jax.vjp of the JAX custom-JVP function, at a generic point and at the
  uniform-rates point where Q has a triple eigenvalue);
* ops/transforms.py: stick breaking, batched, against JAX and the PyTorch
  golden;
* ops/pruning.py, the torch scan engine: LLs and the linear-time branch
  gradient against libsbn_tpu.ops.pruning on hello, five_taxon_unrooted
  and four DS1.100_topologies trees, JC69/GTR x constant/Weibull+4 x
  rescale True/False, and its autograd backward against jax.vjp of the JAX
  custom VJP.

All float64 on the CPU; inputs come from numpy with a seed.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.models.phylo_model import default_parameters as jdefaults
from libsbn_tpu.models.phylo_model import model_tensors as jmodel_tensors
from libsbn_tpu.ops import pruning as jpruning
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu.ops import substitution as jsubst
from libsbn_tpu.ops import transforms as jtransforms
from libsbn_tpu_torch.models.phylo_model import (
    PhyloModelSpec, model_tensors, params_from_numpy,
)
from libsbn_tpu_torch.ops import pruning, substitution, transforms

torch.set_num_threads(1)

GENERIC_RATES = [0.1, 0.2, 0.15, 0.25, 0.2, 0.1]
GENERIC_FREQS = [0.3, 0.25, 0.2, 0.25]
POINTS = {
    "generic": (GENERIC_RATES, GENERIC_FREQS),
    "uniform": (list(np.full(6, 1.0 / 6.0)), [0.25] * 4),
}


def t64(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("point", sorted(POINTS))
def test_gtr_q_and_eigen_match_jax(point):
    """gtr_q to 1e-12; gtr_eigen's eigenvalues to 1e-12, and its
    eigensystem rebuilds Q and the transition matrices of JAX's to 1e-12
    (the eigenvectors of a repeated eigenvalue are a basis of choice)."""
    rates, freqs = POINTS[point]
    want_q = np.asarray(jsubst.gtr_q(jnp.asarray(rates), jnp.asarray(freqs)))
    got_q = substitution.gtr_q(t64(rates), t64(freqs))
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=0, atol=1e-12)
    jf, jev, jiv, jlam = jsubst.gtr_eigen(jnp.asarray(rates), jnp.asarray(freqs))
    f, ev, iv, lam = substitution.gtr_eigen(t64(rates), t64(freqs))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), atol=1e-12)
    np.testing.assert_allclose(
        substitution.q_from_eigen(ev, iv, lam).numpy(), want_q, atol=1e-12)
    np.testing.assert_allclose((iv @ ev).numpy(), np.eye(4), atol=1e-12)
    ts = np.random.default_rng(0).uniform(0.0, 2.0, (3, 5))
    np.testing.assert_allclose(
        substitution.transition_matrices(ev, iv, lam, t64(ts)).numpy(),
        np.asarray(jsubst.transition_matrices(jev, jiv, jlam, jnp.asarray(ts))),
        atol=1e-12,
    )


def test_gtr_q_is_batched():
    """gtr_q over a leading axis equals it row by row."""
    rng = np.random.default_rng(1)
    rates = rng.uniform(0.05, 1.0, (3, 6))
    freqs = rng.dirichlet(np.ones(4), 3)
    got = substitution.gtr_q(t64(rates), t64(freqs))
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), substitution.gtr_q(t64(rates[b]), t64(freqs[b])).numpy())


@pytest.mark.parametrize("point", sorted(POINTS))
def test_expm_transition_forward_and_vjp_match_jax(point):
    """P = expm(Q t) to 1e-12, and the cotangents of Q and t under a seeded
    random cotangent of P to 1e-10 of jax.vjp through the JAX function's
    Daleckii-Krein JVP, including at the uniform-rates point."""
    rates, freqs = POINTS[point]
    rng = np.random.default_rng(2)
    ts = rng.uniform(0.0, 1.5, (5, 3))
    G = rng.standard_normal((5, 3, 4, 4))
    jq = jsubst.gtr_q(jnp.asarray(rates), jnp.asarray(freqs))
    want, vjp = jax.vjp(
        lambda q, t: jsubst.expm_transition(q, jnp.asarray(freqs), t),
        jq, jnp.asarray(ts))
    want_dq, want_dt = vjp(jnp.asarray(G))
    q = t64(jq).requires_grad_(True)
    tt = t64(ts).requires_grad_(True)
    got = substitution.expm_transition(q, t64(freqs), tt)
    assert got.shape == (5, 3, 4, 4) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-12)
    dq, dt = torch.autograd.grad(got, (q, tt), t64(G))
    assert torch.all(torch.isfinite(dq))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(dt.numpy(), np.asarray(want_dt), rtol=0,
                               atol=1e-10)


def test_expm_transition_batched_over_q():
    """Per-tree rate matrices (B, 4, 4) with times (B, N, K): each tree's
    P and its Q cotangent equal the unbatched JAX call's (1e-12, 1e-10)."""
    rng = np.random.default_rng(3)
    B = 3
    rates = rng.uniform(0.05, 1.0, (B, 6))
    rates[0] = 1.0 / 6.0  # one tree at the uniform-rates point
    freqs = rng.dirichlet(np.ones(4) * 5, B)
    freqs[0] = 0.25
    ts = rng.uniform(0.0, 1.0, (B, 7, 2))
    G = rng.standard_normal((B, 7, 2, 4, 4))
    q = substitution.gtr_q(t64(rates), t64(freqs)).detach().requires_grad_(True)
    got = substitution.expm_transition(q, t64(freqs), t64(ts))
    (dq,) = torch.autograd.grad(got, q, t64(G))
    for b in range(B):
        jq = jsubst.gtr_q(jnp.asarray(rates[b]), jnp.asarray(freqs[b]))
        want, vjp = jax.vjp(
            lambda q_: jsubst.expm_transition(q_, jnp.asarray(freqs[b]),
                                              jnp.asarray(ts[b])), jq)
        np.testing.assert_allclose(got[b].detach().numpy(), np.asarray(want),
                                   atol=1e-12)
        np.testing.assert_allclose(dq[b].numpy(),
                                   np.asarray(vjp(jnp.asarray(G[b]))[0]),
                                   atol=1e-10)


def test_stick_breaking_matches_jax():
    """Forward, inverse and log |det J|, batched over a leading axis, against
    JAX row by row (1e-12), and the forward's VJP against jax.vjp."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((4, 5)) * 2.0
    g = rng.standard_normal((4, 6))
    yt = t64(y).requires_grad_(True)
    x = transforms.stick_breaking(yt)
    (dy,) = torch.autograd.grad(x, yt, t64(g))
    for b in range(4):
        want, vjp = jax.vjp(jtransforms.stick_breaking, jnp.asarray(y[b]))
        np.testing.assert_allclose(x[b].detach().numpy(), np.asarray(want),
                                   atol=1e-12)
        np.testing.assert_allclose(dy[b].numpy(),
                                   np.asarray(vjp(jnp.asarray(g[b]))[0]),
                                   atol=1e-12)
        np.testing.assert_allclose(
            transforms.stick_breaking_inverse(x[b].detach()).numpy(),
            np.asarray(jtransforms.stick_breaking_inverse(want)), atol=1e-12)
        np.testing.assert_allclose(
            float(transforms.stick_breaking_log_abs_det_jacobian(
                x[b].detach(), t64(y[b]))),
            float(jtransforms.stick_breaking_log_abs_det_jacobian(
                want, jnp.asarray(y[b]))),
            atol=1e-12)
    np.testing.assert_allclose(
        transforms.stick_breaking_inverse(x.detach()).numpy(), y, atol=1e-12)


def test_stick_breaking_pytorch_golden():
    """The values PyTorch's StickBreakingTransform gives
    (tests/test_rooted_likelihood.py:163-174)."""
    y = t64([1.0, 2.0, 3.0])
    x = transforms.stick_breaking(y)
    np.testing.assert_allclose(
        x.numpy(), [0.475367, 0.412879, 0.106454, 0.00530004], atol=1e-5)
    np.testing.assert_allclose(transforms.stick_breaking_inverse(x).numpy(),
                               y.numpy(), atol=1e-5)
    assert abs(float(transforms.stick_breaking_log_abs_det_jacobian(x, y))
               - (-9.108352)) < 1e-5


@pytest.mark.parametrize("sub", ["JC69", "GTR"])
def test_model_tensors_match_jax(sub):
    """model_tensors (freqs, evec, ivec, evals, rates, props, Q) against
    JAX's for Weibull+4: freqs, eigenvalues, rates, props and Q to 1e-12,
    and evec diag(evals) ivec rebuilds Q."""
    spec = PhyloModelSpec(sub, "weibull+4", "strict")
    jparams = jdefaults(JSpec(sub, "weibull+4", "strict"))
    if sub == "GTR":
        jparams["substitution"] = {"rates": jnp.asarray(GENERIC_RATES),
                                   "frequencies": jnp.asarray(GENERIC_FREQS)}
    jparams["site"]["shape"] = jnp.asarray(0.7)
    want = [np.asarray(x) for x in jmodel_tensors(JSpec(sub, "weibull+4",
                                                        "strict"), jparams)]
    as_numpy = jax.tree_util.tree_map(np.asarray, jparams)
    got = model_tensors(spec, params_from_numpy(as_numpy, "cpu",
                                                torch.float64))
    for i in (0, 3, 4, 5, 6):
        np.testing.assert_allclose(got[i].numpy(), want[i], atol=1e-12)
    np.testing.assert_allclose(
        substitution.q_from_eigen(got[1], got[2], got[3]).numpy(), want[6],
        atol=1e-12)


# -- the scan engine -----------------------------------------------------------

DATASETS = {
    "hello": ("hello.nwk", "hello.fasta", None),
    "five_taxon": ("five_taxon_unrooted.nwk", "five_taxon.fasta", None),
    "ds1": ("DS1.100_topologies.nwk", "DS1.fasta", 4),
}


@pytest.fixture(scope="module")
def datasets(data_dir):
    """Per dataset: the JAX schedule and site patterns, and branch lengths
    perturbed by U(0.8, 1.2) from a seeded numpy generator, padded with the
    ones slot."""
    out = {}
    for name, (trees, fasta, count) in DATASETS.items():
        tops, bls, ttm = jnewick.parse_newick_file(f"{data_dir}/{trees}")
        tops, bls = tops[:count], np.stack(bls[:count])
        sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/{fasta}"), ttm)
        bl = bls * np.random.default_rng(5).uniform(0.8, 1.2, bls.shape)
        out[name] = {
            "sched": jschedule.schedules_of_topologies(tops),
            "tips": np.asarray(sp.tip_partials()),
            "w": np.asarray(sp.weights),
            "bl_p": np.pad(bl, ((0, 0), (0, 1))),
        }
    return out


def model_inputs(sub, site):
    """(evec, ivec, evals, rates, props, freqs, Q) from JAX's model_tensors
    at the generic GTR point and Weibull shape 0.7, as numpy."""
    spec = JSpec(sub, site, "strict")
    params = jdefaults(spec)
    if sub == "GTR":
        params["substitution"] = {"rates": jnp.asarray(GENERIC_RATES),
                                  "frequencies": jnp.asarray(GENERIC_FREQS)}
    if site != "constant":
        params["site"]["shape"] = jnp.asarray(0.7)
    freqs, evec, ivec, evals, rates, props, Q = jmodel_tensors(spec, params)
    return [np.asarray(x) for x in (evec, ivec, evals, rates, props, freqs, Q)]


def _jax_sched(sched):
    return tuple(jnp.asarray(getattr(sched, n)) for n in (
        "post_node", "post_children", "up_node", "up_parent", "up_sibs"))


def _one_sched(s5, root_id):
    return types.SimpleNamespace(
        root_id=root_id, post_node=s5[0], post_children=s5[1], up_node=s5[2],
        up_parent=s5[3], up_sibs=s5[4])


@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("site", ["constant", "weibull+4"])
@pytest.mark.parametrize("sub", ["JC69", "GTR"])
@pytest.mark.parametrize("data", sorted(DATASETS))
def test_scan_engine_matches_jax(datasets, data, sub, site, rescale):
    """ops/pruning.py log_likelihoods and log_likelihood_and_branch_gradient
    against libsbn_tpu.ops.pruning (vmapped over the trees) on the same
    transition matrices: LLs to relative error 1e-10, branch gradients to
    rtol 1e-8 / atol 1e-8."""
    d = datasets[data]
    evec, ivec, evals, rates, props, freqs, Q = model_inputs(sub, site)
    sched, root_id = d["sched"], d["sched"].root_id
    Qs = Q[None] * rates[:, None, None]

    def one(s5, bl):
        P = jpruning.node_transition_matrices(evec, ivec, evals, bl, rates)
        return jpruning.log_likelihood_and_branch_gradient(
            _one_sched(s5, root_id), P, Qs, d["tips"], freqs, props, d["w"],
            rescale)

    want_ll, want_g = jax.jit(jax.vmap(one))(_jax_sched(sched),
                                             jnp.asarray(d["bl_p"]))
    P = pruning.node_transition_matrices(t64(evec), t64(ivec), t64(evals),
                                         t64(d["bl_p"]), t64(rates))
    args = (torch.as_tensor(np.asarray(sched.post_children)), P)
    tail = (t64(d["tips"]), t64(freqs), t64(props), t64(d["w"]))
    ll, g = pruning.log_likelihood_and_branch_gradient(
        *args, t64(Qs), *tail, root_id=root_id, rescale=rescale)
    ll2 = pruning.log_likelihoods(*args, *tail, root_id=root_id,
                                  rescale=rescale)
    for got in (ll, ll2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ll),
                                   rtol=1e-10)
    assert g.shape == (P.shape[0], root_id)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("rescale", [True, False])
def test_scan_engine_backward_matches_jax_vjp(datasets, rescale):
    """The autograd backward of log_likelihoods (JAX's _ll_bwd, batched)
    gives dP, dtips, dfreqs, dprops and dweights equal to jax.vjp of the
    JAX custom VJP under a seeded per-tree cotangent, to 1e-10 (relative to
    each cotangent's largest entry). GTR + Weibull+4 on the DS1 trees."""
    d = datasets["ds1"]
    evec, ivec, evals, rates, props, freqs, _ = model_inputs("GTR", "weibull+4")
    sched, root_id = d["sched"], d["sched"].root_id
    P = np.asarray(jax.vmap(lambda bl: jpruning.node_transition_matrices(
        evec, ivec, evals, bl, rates))(jnp.asarray(d["bl_p"])))
    g = np.random.default_rng(6).standard_normal(P.shape[0])

    def batch(P_, tips, freqs_, props_, w):
        def one(s5, P1):
            return jpruning._log_likelihood(rescale, root_id, s5, P1, tips,
                                            freqs_, props_, w)
        return jax.vmap(one, in_axes=(0, 0))(_jax_sched(sched), P_)

    primals = (jnp.asarray(P), jnp.asarray(d["tips"]), jnp.asarray(freqs),
               jnp.asarray(props), jnp.asarray(d["w"]))
    want_ll, vjp = jax.vjp(batch, *primals)
    want = vjp(jnp.asarray(g))
    inputs = [t64(np.asarray(x)).requires_grad_(True) for x in primals]
    ll = pruning.log_likelihoods(
        torch.as_tensor(np.asarray(sched.post_children)), inputs[0],
        inputs[1], inputs[2], inputs[3], inputs[4], root_id=root_id,
        rescale=rescale)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(want_ll),
                               rtol=1e-10)
    got = torch.autograd.grad(ll, inputs, t64(g))
    for name, a, b in zip(("dP", "dtips", "dfreqs", "dprops", "dweights"),
                          got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max(), err_msg=name)
