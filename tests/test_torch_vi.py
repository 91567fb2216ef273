"""The vip layer in the port (libsbn_tpu_torch.vi) against libsbn_tpu.vi.

* priors and scalar models: the log-normal's closed form, its hand-derived
  reparameterization gradients against torch autograd (rtol 1e-9), the
  autograd log-normal against the hand-coded one (rtol 1e-8), the gamma and
  truncated log-normal finite with finite gradients;
* optimizers: tests/test_vi.py's golden trajectories (simple and bump,
  1e-12), every rule of GroupedAscent against libsbn_tpu's optax rules on
  scripted gradients (1e-12), SGD_Server's six rules against libsbn_tpu's;
* the Burrito: the "From Mathieu" ELBO goldens (rel 1e-5), and the same
  seed giving libsbn_tpu's trajectory (ELBO trace, q-params, SBN
  parameters and a marginal-likelihood estimate at rel 1e-9) on hello and
  DS1.subsampled_10, split and psp, simple and bump, 5 steps, float64, and
  on DS1 with GTR + Weibull+4 for 2 steps;
* the vi package imports every submodule and no JAX; SBNModel's setter
  stores a writable copy.

Every port Burrito passes device="cpu", where the engine runs the kernels'
plain twins. "rel r" below means |got - want| <= r (|want| + max |want|)
elementwise.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.vi import optimizers as joptimizers
from libsbn_tpu.vi import priors as jpriors
from libsbn_tpu.vi import sgd_server as jsgd
from libsbn_tpu.vi.burrito import Burrito as JBurrito

from libsbn_tpu_torch import PhyloModelSpec
from libsbn_tpu_torch.vi import (
    branch_models, optimizers, priors, sbn_model, scalar_models, sgd_server,
)
from libsbn_tpu_torch.vi.burrito import Burrito

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")


def rel_close(got, want, rel, msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), (
        msg, np.max(np.abs(got - want) / scale))


@pytest.fixture(autouse=True)
def refreshed_libsbn_tpu_sampler(monkeypatch):
    """libsbn_tpu's Burrito builds its sampler once and never hands it the
    SBN updates; the port's instance hands each new parameter array to its
    sampler. Hold libsbn_tpu to the same algorithm: its optimizer hands the
    updated parameters to the sampler after each step, the sampler's
    random stream continuing. Nothing in libsbn_tpu is edited."""
    apply = joptimizers.BaseOptimizer._apply

    def _apply(self, grad_dict):
        ok = apply(self, grad_dict)
        sampler = getattr(self.inst, "_sampler", None)
        if sampler is not None:
            sampler.refresh_parameters(self.inst.sbn_parameters)
        return ok

    monkeypatch.setattr(joptimizers.BaseOptimizer, "_apply", _apply)


# -- priors and scalar models -------------------------------------------------
def test_log_exp_prior_matches_libsbn_tpu():
    sample = np.array([[1.0, 2.0, 3.0], [0.26097, 0.0286401, 0.113843]])
    expected = np.log(10.0) * 3 - 10.0 * sample.sum(axis=1)
    np.testing.assert_allclose(priors.log_exp_prior(sample), expected)
    np.testing.assert_array_equal(priors.log_exp_prior(sample),
                                  jpriors.log_exp_prior(sample))
    assert priors.grad_log_exp_prior(sample) == jpriors.grad_log_exp_prior(
        sample)
    with pytest.raises(ValueError, match="particles, branches"):
        priors.log_exp_prior(sample[0])


def test_lognormal_log_prob_closed_form():
    params = np.array([[0.4, 1.3], [-2.0, 4.0], [3.0, 0.2]])
    sample = np.array([0.3, 3.14159, 0.0001])
    model = scalar_models.LogNormalModel(3)
    model.q_params[:, :] = params
    mu, sigma = params[:, 0], params[:, 1]
    expected = np.sum(
        -np.log(sample) - np.log(sigma) - 0.5 * np.log(2 * np.pi)
        - (np.log(sample) - mu) ** 2 / (2 * sigma**2)
    )
    assert model.log_prob(sample, which_variables=np.arange(3)) == (
        pytest.approx(expected))


def test_lognormal_hand_gradients_match_autograd():
    """eq:dgdPsi and eq:dlogqgdPsi against torch autograd of the
    reparameterization at the model's own draw (rtol 1e-9)."""
    params = np.array([[0.4, 1.3], [-2.0, 0.7], [3.0, 0.2]])
    model = scalar_models.LogNormalModel(3)
    model.q_params[:, :] = params
    which = np.array([[0, 1, 2]])
    sample, dg_dpsi, dlog_qg_dpsi = model.sample_and_gradients(which)
    eps = torch.as_tensor((np.log(sample[0]) - params[:, 0]) / params[:, 1])
    psi = torch.tensor(params, requires_grad=True)
    theta = torch.exp(psi[:, 0] + psi[:, 1] * eps)
    rows = [torch.autograd.grad(theta[v], psi, retain_graph=True)[0][v]
            for v in range(3)]
    np.testing.assert_allclose(dg_dpsi[0], torch.stack(rows).numpy(),
                               rtol=1e-9)
    mu, sigma = psi[:, 0], psi[:, 1]
    lt = torch.log(theta)
    log_q = torch.sum(-lt - torch.log(sigma) - 0.5 * np.log(2 * np.pi)
                      - (lt - mu) ** 2 / (2 * sigma**2))
    (jq,) = torch.autograd.grad(log_q, psi)
    np.testing.assert_allclose(dlog_qg_dpsi[0], jq.numpy(), rtol=1e-9)


def test_ad_lognormal_matches_hand_coded():
    params = np.array([[0.4, 1.3], [-2.0, 0.7], [3.0, 0.2]])
    ad = scalar_models.of_name("tf_lognormal", 3)
    ad.q_params[:] = params
    hand = scalar_models.LogNormalModel(3)
    hand.q_params[:] = params
    which = np.array([[0, 1, 2]])
    sample, dg, dq = ad.sample_and_gradients(which)
    _, hand_dg, hand_dq = hand.sample_and_gradients(
        which, prebaked_sample=sample)
    np.testing.assert_allclose(dg[0], hand_dg[0], rtol=1e-8)
    np.testing.assert_allclose(dq[0], hand_dq[0], rtol=1e-8)
    np.testing.assert_allclose(
        ad.log_prob(sample[0], which[0]),
        hand.log_prob(sample[0], which[0]), rtol=1e-12)


@pytest.mark.parametrize(
    "name", ["tf_lognormal", "tf_gamma", "tf_truncated_lognormal"])
def test_ad_scalar_models_finite(name):
    """The autograd zoo: samples positive, densities and gradients finite,
    mode matching finite; the torch stream is seeded from one draw of the
    model's numpy rng, as libsbn_tpu draws its key's seed."""
    rng = np.random.default_rng(3)
    model = scalar_models.of_name(name, 3, rng)
    ref = np.random.default_rng(3)
    ref.integers(0, 2**31)
    assert rng.bit_generator.state == ref.bit_generator.state
    which = np.array([[0, 1, 2], [2, 1, 0]])
    sample, dg, dq = model.sample_and_gradients(which)
    assert sample.shape == (2, 3) and np.all(sample > 0)
    assert np.isfinite(dg).all() and np.isfinite(dq).all()
    assert np.abs(dg).sum() > 0 and np.abs(dq).sum() > 0
    assert np.isfinite(model.log_prob(sample[0], which[0]))
    assert model.sample(which).shape == (2, 3)
    assert model.sample_all(4).shape == (4, 3)
    model.mode_match(np.array([0.1, 0.2, 0.05]))
    assert np.isfinite(model.q_params).all()


def test_gamma_implicit_reparameterization_gradient():
    """The gamma's dg/dpsi: d theta / d log rate = -theta exactly, and
    d theta / d log concentration the implicit reparameterization gradient
    -(dF/da) / f at the draw (F the regularized incomplete gamma function,
    its a-derivative by central differences; rtol 1e-3: torch's
    _standard_gamma_grad evaluates the derivative by series and asymptotic
    approximations, 8e-5 off here)."""
    from scipy.special import gammainc
    from scipy.stats import gamma

    model = scalar_models.of_name("tf_gamma", 2)
    model.q_params[:] = [[1.3, 3.0], [0.2, 1.0]]
    which = np.array([[0, 1]])
    theta, dg, _ = model.sample_and_gradients(which)
    for v in range(2):
        a, rate = np.exp(model.q_params[v])
        x = theta[0, v] * rate  # the standard gamma draw
        np.testing.assert_allclose(dg[0, v, 1], -theta[0, v], rtol=1e-12)
        h = 1e-6 * a
        dF_da = (gammainc(a + h, x) - gammainc(a - h, x)) / (2 * h)
        implicit = -dF_da / gamma.pdf(x, a) / rate * a  # d / d log a
        np.testing.assert_allclose(dg[0, v, 0], implicit, rtol=1e-3)


def test_of_name_choices():
    for choice in ("lognormal", "tf_lognormal", "tf_gamma",
                   "tf_truncated_lognormal"):
        assert scalar_models.of_name(choice, 3) is not None
    assert scalar_models.TFScalarModel is scalar_models.ADScalarModel
    with pytest.raises(ValueError, match="not known"):
        scalar_models.of_name("normal", 3)
    with pytest.raises(ValueError, match="not known"):
        branch_models.of_name("clade", "lognormal", None)


# -- optimizers ---------------------------------------------------------------
class _DummyScalarModel:
    def __init__(self):
        self.q_params = np.zeros((4, 2))

    def suggested_step_size(self):
        return 0.1


class _DummyInst:
    def __init__(self):
        self.sbn_parameters = np.zeros(6)


def _scripted_run(module, opt_name, steps=25):
    rng = np.random.default_rng(42)
    sm, inst = _DummyScalarModel(), _DummyInst()
    elbo_script = iter(np.concatenate([
        np.linspace(-100.0, -80.0, 12),
        np.linspace(-85.0, -95.0, 8),
        np.linspace(-90.0, -88.0, 10),
    ]))
    opt = module.of_name(
        opt_name, inst, sm, lambda particle_count: next(elbo_script))
    for t in range(steps):
        g_scalar = rng.normal(size=sm.q_params.shape)
        g_sbn = rng.normal(size=inst.sbn_parameters.shape)
        if t == 7:
            g_scalar[0, 0] = np.nan
        opt.gradient_step({"scalar_params": g_scalar, "sbn_params": g_sbn})
    return sm.q_params, np.asarray(inst.sbn_parameters), opt.step_size


GOLDEN_SBN = [0.00625997775297908, -0.00482123994754173,
              -0.00356712387527671, -0.00282605875008791,
              0.00520004015586435, 0.00412473711705528]
GOLDEN = {
    "simple": ([[0.23821568852482944, -0.4106849239434605],
                [0.37644719998301396, 0.36710732397569545],
                [-0.5150804716844086, -0.6357384987438139],
                [0.43277085260722786, -0.0312598286768741]],
               0.03928390704036094),
    "bump": ([[0.15261367830466793, -0.5971235845294068],
              [0.5380459394059177, 0.6889955471485564],
              [-0.9007971628919077, -1.0723958517501575],
              [0.8193473043582463, 0.14955118246467874]],
             0.07475534218409334),
}


@pytest.mark.parametrize("opt_name", ["simple", "bump"])
def test_optimizer_trajectory_golden(opt_name):
    """tests/test_vi.py's golden trajectories (scripted gradients, a NaN
    step at t = 7, the bump's windowed turn-around), at 1e-12, and
    libsbn_tpu's optax run on the same script."""
    q, sbn, step = _scripted_run(optimizers, opt_name)
    golden_q, golden_step = GOLDEN[opt_name]
    np.testing.assert_allclose(q, golden_q, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sbn, GOLDEN_SBN, rtol=1e-12, atol=1e-14)
    assert step == pytest.approx(golden_step, rel=1e-12)
    jq, jsbn, jstep = _scripted_run(joptimizers, opt_name)
    np.testing.assert_allclose(q, jq, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sbn, jsbn, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("rule", sorted(joptimizers.RULES))
def test_grouped_ascent_rule_matches_optax(rule):
    """Each rule against libsbn_tpu's optax transform on scripted
    gradients (with exact zeros): the deltas each step and the state leaves
    in optax's order, at 1e-12; the leaves load back."""
    shapes = {"scalar_params": (4, 2), "sbn_params": (6,)}
    zeros = {k: np.zeros(s) for k, s in shapes.items()}
    mine = optimizers.GroupedAscent(zeros, rule)
    ref = joptimizers.GroupedAscent(zeros, rule)
    rng = np.random.default_rng(1)
    steps = {"scalar_params": np.array([0.1, 0.02]), "sbn_params": 0.01}
    for t in range(30):
        grads = {k: rng.normal(size=s) for k, s in shapes.items()}
        if t % 4 == 3:
            grads["sbn_params"][:2] = 0.0
        got = mine.ascent_updates(grads, zeros, steps)
        want = ref.ascent_updates(grads, zeros, steps)
        for k in shapes:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       atol=1e-300)
    mine_leaves, ref_leaves = mine.state_leaves(), ref.state_leaves()
    assert [(x.shape, x.dtype) for x in mine_leaves] == [
        (x.shape, x.dtype) for x in ref_leaves]
    for a, b in zip(mine_leaves, ref_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    fresh = optimizers.GroupedAscent(zeros, rule)
    fresh.load_state_leaves(ref_leaves)
    grads = {k: rng.normal(size=s) for k, s in shapes.items()}
    np.testing.assert_allclose(
        fresh.ascent_updates(grads, zeros, steps)["sbn_params"],
        ref.ascent_updates(grads, zeros, steps)["sbn_params"], rtol=1e-12)


@pytest.mark.parametrize(
    "rule", ["sgd", "adam", "amsgrad", "rmsprop", "adagrad", "adadelta"])
def test_sgd_server_rules_match_libsbn_tpu(rule):
    """SGD_Server's six rules (with L2 decay and a non-default gamma)
    against libsbn_tpu's, five steps, exactly."""
    dims = {"a": (3,), "b": (2, 2)}
    kwargs = {"decay": 0.01, "gamma": 0.8}
    mine = sgd_server.SGD_Server(dims, **kwargs)
    ref = jsgd.SGD_Server(dims, **kwargs)
    rng = np.random.default_rng(9)
    params = {k: rng.normal(size=s) for k, s in dims.items()}
    steps = {"a": 0.1, "b": 0.05}
    for _ in range(5):
        grads = {k: rng.normal(size=s) for k, s in dims.items()}
        got = getattr(mine, rule)(steps, params, grads)
        want = getattr(ref, rule)(steps, params, grads)
        for k in dims:
            np.testing.assert_array_equal(got[k], want[k])
            params[k] = params[k] + got[k]


# -- the Burrito --------------------------------------------------------------
def burrito_kwargs(tree, fasta, burn_in, branch_model, optimizer,
                   particles, spec=("JC69", "constant", "strict")):
    return dict(
        mcmc_nexus_path=f"{DATA}/{tree}", burn_in_fraction=burn_in,
        fasta_path=f"{DATA}/{fasta}", branch_model_name=branch_model,
        scalar_model_name="lognormal", optimizer_name=optimizer,
        particle_count=particles, seed=0, spec=spec)


def make_pair(spec, **kw):
    """(libsbn_tpu Burrito, port Burrito on the CPU), same arguments."""
    j = JBurrito(phylo_model_specification=JSpec(*spec), **kw)
    t = Burrito(phylo_model_specification=PhyloModelSpec(*spec), device="cpu",
                **kw)
    return j, t


def assert_same_trajectory(j, t, rel=1e-9):
    rel_close(t.elbo_trace, j.elbo_trace, rel, "ELBO trace")
    rel_close(t.scalar_model.q_params, j.scalar_model.q_params, rel,
              "q_params")
    rel_close(t.inst.sbn_parameters, j.inst.sbn_parameters, rel,
              "SBN parameters")
    rel_close(t.opt.step_size, j.opt.step_size, rel, "step size")


HELLO = ("hello_out.t", "hello.fasta", 0.0, 3)
DS1 = ("DS1.subsampled_10.t", "DS1.fasta", 0.1, 10)


def _trajectory_cases():
    for data in (HELLO, DS1):
        for branch_model in ("split", "psp"):
            for optimizer in ("simple", "bump"):
                marks = []
                if data is DS1 and branch_model == "split" and (
                        optimizer == "bump"):
                    # 500-particle ELBO estimates each step on both sides:
                    # 32 s on the CPU (psp's bump case, 25 s, stays).
                    marks = [pytest.mark.slow]
                yield pytest.param(data, branch_model, optimizer, marks=marks,
                                   id=f"{data[0][:5]}-{branch_model}-{optimizer}")


@pytest.mark.parametrize("data, branch_model, optimizer", _trajectory_cases())
def test_burrito_trajectory_matches_libsbn_tpu(data, branch_model, optimizer):
    """The same seed: the port's Burrito (float64, CPU twins of K1 and K2)
    draws libsbn_tpu's topologies and branch lengths and follows its
    trajectory for 5 steps (rel 1e-9), then gives its marginal-likelihood
    estimate."""
    tree, fasta, burn_in, particles = data
    kw = burrito_kwargs(tree, fasta, burn_in, branch_model, optimizer,
                        particles)
    spec = kw.pop("spec")
    j, t = make_pair(spec, **kw)
    j.gradient_steps(5)
    t.gradient_steps(5)
    assert len(t.elbo_trace) == 5 and np.all(np.isfinite(t.elbo_trace))
    assert_same_trajectory(j, t)
    if optimizer == "bump":
        rel_close(t.opt.trace, j.opt.trace, 1e-9, "bump ELBO trace")
    rel_close(t.marginal_likelihood_estimate(20),
              j.marginal_likelihood_estimate(20), 1e-9, "marginal")


def test_burrito_gtr_weibull_trajectory():
    """GTR + Weibull+4 (the K4 / K5 twins) on DS1, 2 steps, against
    libsbn_tpu (rel 1e-9)."""
    kw = burrito_kwargs(*DS1[:3], "split", "simple", DS1[3],
                        spec=("GTR", "weibull+4", "strict"))
    spec = kw.pop("spec")
    j, t = make_pair(spec, **kw)
    j.gradient_steps(2)
    t.gradient_steps(2)
    assert_same_trajectory(j, t)


@pytest.fixture(scope="module")
def hello_burrito():
    return Burrito(
        mcmc_nexus_path=f"{DATA}/hello_out.t", burn_in_fraction=0,
        fasta_path=f"{DATA}/hello.fasta",
        phylo_model_specification=PhyloModelSpec("JC69", "constant", "strict"),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=1, device="cpu",
    )


def test_elbo_innards(hello_burrito):
    """Golden ELBO internals 'From Mathieu' (vip/test/test_burrito.py, as
    tests/test_vi.py pins them): LL, log prior and log q (rel 1e-5)."""
    burro = hello_burrito
    burro.sample_topologies(1)
    theta_sample = np.array([0.184472, 0.027993, 0.045583])
    px_theta_sample = theta_sample[None, :]
    for tree in burro.inst.tree_collection.trees:
        tree.branch_lengths[:-1] = theta_sample
    mathieu_q_params = np.array(
        [[-1.728809, 0.459529], [-2.410943, 0.748569], [-2.410977, 0.748571]])
    px_branch_representation = burro.branch_model.px_branch_representation()
    branch_rep = px_branch_representation[0]
    burro.branch_model.scalar_model.q_params[branch_rep, :] = mathieu_q_params
    assert burro.inst.log_likelihoods()[0] == pytest.approx(-81.446550,
                                                            rel=1e-5)
    assert burro.branch_model.log_prior(px_theta_sample)[0] == pytest.approx(
        4.327275, rel=1e-5)
    assert burro.branch_model.log_prob(
        px_theta_sample, px_branch_representation) == pytest.approx(
            5.330697, rel=1e-5)


def test_sampler_draws_from_the_updated_sbn():
    """After each SBN update the Burrito's topologies come from the new
    parameters: the sampler holds the instance's current array, and its
    random stream continues (a fresh sampler over the same parameters and
    the same stream draws the same next topology)."""
    kw = burrito_kwargs(*HELLO[:3], "split", "simple", HELLO[3])
    spec = kw.pop("spec")
    t = Burrito(phylo_model_specification=PhyloModelSpec(*spec), device="cpu",
                **kw)
    first = t.inst.sbn_parameters.copy()
    t.gradient_steps(2)
    sampler = t.inst._sampler
    assert not np.array_equal(t.inst.sbn_parameters, first)
    np.testing.assert_array_equal(sampler.params, t.inst.sbn_parameters)
    twin = type(sampler)(t.inst.sbn_support, t.inst.sbn_parameters)
    twin.rng = copy.deepcopy(sampler.rng)
    assert (t.inst.sample_topology().newick()
            == twin.sample_topology(t.inst.rooted).newick())


def test_psp_model_needs_lognormal(hello_burrito):
    with pytest.raises(ValueError, match="LogNormal"):
        branch_models.PSPModel("tf_gamma", hello_burrito.inst)


# -- the package --------------------------------------------------------------
def test_vi_imports_every_submodule_and_no_jax():
    """A fresh interpreter: `import libsbn_tpu_torch.vi` reaches every vip
    module and imports neither JAX, optax nor libsbn_tpu."""
    code = (
        "import sys, libsbn_tpu_torch.vi as vi\n"
        "mods = ['benchmark', 'branch_models', 'burrito', 'checkpoint', "
        "'cli', 'jit_step', 'optimizers', 'priors', 'sbn_model', "
        "'scalar_models', 'sgd_server']\n"
        "assert all(f'libsbn_tpu_torch.vi.{m}' in sys.modules for m in mods)\n"
        "assert all(hasattr(vi, m) for m in mods)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'libsbn_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sbn_model_setter_stores_a_writable_copy():
    class Inst:
        sbn_parameters = np.zeros(3)

    inst = Inst()
    model = sbn_model.SBNModel(inst)
    frozen = np.arange(3.0)
    frozen.setflags(write=False)
    model.sbn_parameters = frozen
    assert inst.sbn_parameters.flags.writeable
    assert inst.sbn_parameters is not frozen
    model.sbn_parameters += 1.0  # in place through the proxy
    np.testing.assert_array_equal(inst.sbn_parameters, [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(frozen, [0.0, 1.0, 2.0])
