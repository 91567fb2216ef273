"""Three small public helpers of the port against their libsbn_tpu
counterparts, on the same numpy inputs, float64 on the CPU:

* ops/site_model.py ``weibull_rate_gradient``: against libsbn_tpu's and
  against torch.autograd of ``weibull_rates`` (as tests/test_models.py
  holds libsbn_tpu's against jax.jacobian);
* models/phylo_model.py ``clock_rate``;
* ops/pruning.py ``log_likelihood``, the single-tree scan LL, and its
  gradient by autograd against libsbn_tpu's custom VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.models import phylo_model as jphylo_model
from libsbn_tpu.ops import pruning as jpruning
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu.ops import site_model as jsite_model
from libsbn_tpu.ops import substitution as jsubstitution
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.models import phylo_model
from libsbn_tpu_torch.ops import pruning, schedule, site_model, substitution

torch.set_num_threads(1)

REL = 1e-10


@pytest.mark.parametrize("shape,K", [(1.3, 4), (0.1, 4), (0.7, 8), (2.5, 3)])
def test_weibull_rate_gradient(shape, K):
    got = site_model.weibull_rate_gradient(shape, K)
    assert got.shape == (K,) and got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsite_model.weibull_rate_gradient(shape, K)),
        rtol=REL)
    jac = torch.autograd.functional.jacobian(
        lambda s: site_model.weibull_rates(s, K)[0],
        torch.tensor(shape, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), jac.numpy(), rtol=REL)


@pytest.mark.parametrize("clock", ["strict", "none"])
def test_clock_rate(clock):
    spec = phylo_model.PhyloModelSpec("JC69", "constant", clock)
    jspec = jphylo_model.PhyloModelSpec("JC69", "constant", clock)
    params = phylo_model.default_parameters(spec)
    jparams = jphylo_model.default_parameters(jspec)
    if clock == "strict":
        params["clock"]["rate"] = torch.tensor(0.001, dtype=torch.float64)
        jparams["clock"]["rate"] = jnp.asarray(0.001)
    got = phylo_model.clock_rate(spec, params)
    want = jphylo_model.clock_rate(jspec, jparams)
    assert float(got) == float(want)
    if clock == "strict":
        assert got is params["clock"]["rate"]


@pytest.mark.parametrize("data,K,rescale", [
    ("hello", 1, True), ("ds1", 1, True), ("ds1", 4, True), ("ds1", 4, False),
])
def test_single_tree_log_likelihood_and_its_gradient(data_dir, data, K,
                                                     rescale):
    """log_likelihood of one tree (hello, or the second DS1 tree with its
    lengths) equals libsbn_tpu's, and its gradient by autograd in P, tips,
    freqs, props and weights equals jax.grad through libsbn_tpu's custom
    VJP, at rel 1e-10."""
    if data == "hello":
        nwk, fasta, parse = "hello.nwk", "hello.fasta", "parse_newick_file"
    else:
        nwk, fasta, parse = ("DS1.subsampled_10.t", "DS1.fasta",
                             "parse_nexus_file")
    jtops, bls, ttm = getattr(jnewick, parse)(f"{data_dir}/{nwk}")
    tops, _, _ = getattr(newick, parse)(f"{data_dir}/{nwk}")
    i = 0 if data == "hello" else 1
    jsched = jschedule.schedule_of_topology(jtops[i])
    sched = schedule.schedule_of_topology(tops[i])
    np.testing.assert_array_equal(sched.post_children, jsched.post_children)
    sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/{fasta}"), ttm)
    tips, w = sp.tip_partials(), sp.weights
    bl = np.concatenate([np.asarray(bls[i]), [0.0]])
    rates, props = (np.ones(1), np.ones(1)) if K == 1 else (
        np.asarray(x) for x in jsite_model.weibull_rates(0.5, K))
    freqs = np.array([0.3, 0.2, 0.25, 0.25])
    _, evec, ivec, evals = jsubstitution.jc69_eigen()
    P = np.asarray(jpruning.node_transition_matrices(
        evec, ivec, evals, jnp.asarray(bl), jnp.asarray(rates)))

    args = (P, tips, freqs, props, w)
    want, jgrads = jax.value_and_grad(
        lambda *a: jpruning.log_likelihood(jsched, *a, rescale=rescale),
        argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
             for a in args]
    got = pruning.log_likelihood(sched, *targs, rescale=rescale)
    assert got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REL)
    grads = torch.autograd.grad(got, targs)
    for name, g, jg in zip(("P", "tips", "freqs", "props", "weights"), grads,
                           jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=REL,
                                   atol=REL * np.max(np.abs(jg)), err_msg=name)
    _, t_evec, t_ivec, t_evals = substitution.jc69_eigen()
    np.testing.assert_allclose(
        pruning.node_transition_matrices(
            t_evec, t_ivec, t_evals, torch.as_tensor(bl),
            torch.tensor(rates)).numpy(), P, rtol=1e-13, atol=1e-15)
