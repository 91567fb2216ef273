"""The port's VBPI trainer (vi/jit_step.py) against libsbn_tpu's.

Both packages draw their host randomness from numpy's default_rng(seed +
7919 * rank), so for one seed they sample the same topologies and normals,
and the trainers can be held against each other step by step, in float64
on the CPU: the port's step runs K1's twin, the JAX step its scan engine.

* One ``vbpi_train_step`` on DS1 (split and PSP), fed identical host
  samples, from a JAX state carried across with ``state_from_numpy``.
* Three ``JitVBPI.step()`` calls, ``step_many`` and ``log_f_values`` on
  hello_out.t, compared along the way, with and without the native
  library; ``mode_match``.
* ``step_overlapped``'s first call equals ``step()``; the estimators; the
  Adam against optax.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.io import native as jnative
from libsbn_tpu.vi import jit_step as jstep
from libsbn_tpu_torch.io import native
from libsbn_tpu_torch.ops import pruning_jc
from libsbn_tpu_torch.vi import JitVBPI, jit_step

torch.set_num_threads(1)

BRANCH_MODELS = ["split", "psp"]
# rtol / atol of the f64 state and metrics against the JAX package's.
RTOL, ATOL = 1e-9, 1e-10


def _instance(package, data_dir, trees, fasta):
    inst = package.UnrootedInstance("vbpi")
    inst.read_nexus_file(f"{data_dir}/{trees}")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{data_dir}/{fasta}")
    kw = {"device": "cpu"} if package is libsbn_tpu_torch else {}
    inst.prepare_for_phylo_likelihood(
        package.PhyloModelSpec("JC69", "constant", "strict"), **kw)
    return inst


def _pair(data_dir, trees="hello_out.t", fasta="hello.fasta", **kw):
    """(JAX JitVBPI, port JitVBPI) on the same data with the same seed."""
    return (
        jstep.JitVBPI(_instance(libsbn_tpu, data_dir, trees, fasta), **kw),
        JitVBPI(_instance(libsbn_tpu_torch, data_dir, trees, fasta), **kw),
    )


def _adam(opt_state):
    """((mu, nu, count) per group) from libsbn_tpu's optax state."""
    out = []
    for i, name in enumerate(("q_params", "sbn_params")):
        adam = opt_state.inner_states[name].inner_state[0]
        out.append((np.asarray(adam.mu[i]), np.asarray(adam.nu[i]),
                    int(adam.count)))
    return tuple(out)


def _assert_state_close(got, want, what=""):
    """The port's VBPIState against libsbn_tpu's, RTOL / ATOL."""
    for name, a, b in (("q_params", got.q_params, want.q_params),
                       ("sbn_params", got.sbn_params, want.sbn_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {name}")
    for st, (mu, nu, count) in zip(got.opt_state, _adam(want.opt_state)):
        assert st.count == count
        np.testing.assert_allclose(st.mu.numpy(), mu, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} mu")
        np.testing.assert_allclose(st.nu.numpy(), nu, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} nu")


def _assert_metrics_close(got, want):
    for name in ("mean_ll", "elbo_like"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_train_step_matches_jax(data_dir, branch_model):
    """One vbpi_train_step on DS1 (10 particles, VIMCO, the bench's
    configuration; PSP as well) from the state after one JAX step, carried
    across, fed the same host samples: q_params, sbn_params, Adam mu/nu/
    count and the metrics within rtol 1e-9 / atol 1e-10. Observed at most
    5.5e-12 (split) and 1.5e-11 (PSP) absolute, on sbn_params and mean_ll."""
    jv, tv = _pair(data_dir, "DS1.subsampled_10.t", "DS1.fasta",
                   particle_count=10, seed=3, branch_model=branch_model)
    jv.step()
    state = jit_step.state_from_numpy(
        np.asarray(jv.state.q_params), np.asarray(jv.state.sbn_params),
        _adam(jv.state.opt_state), device="cpu", dtype=torch.float64,
    )
    _assert_state_close(state, jv.state, "carried")
    sched5, branch_rep, reps, touched, eps = jv._host_sample()
    evec, ivec, evals, freqs, props, Q = jv.model_tensors
    want_state, want = jstep.vbpi_train_step(
        jv.state, jv.statics, jv.optimizer, tuple(map(jnp.asarray, sched5)),
        jnp.asarray(branch_rep), jnp.asarray(reps), jnp.asarray(touched),
        jnp.asarray(eps), jnp.asarray(1.0), jv.tips, jv.weights,
        jv.segment_ids, evec, ivec, evals, freqs, props, Q,
    )
    inputs = tv._device_put((sched5[1], branch_rep, reps, touched), eps)
    pruning_jc.reset_counters()
    got_state, got = jit_step.vbpi_train_step(
        state, tv.statics, tv.optimizer, *inputs, 1.0, tv.tips, tv.weights,
        tv.segment_ids,
    )
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 1
    assert got_state.opt_state[0].count == 2
    _assert_state_close(got_state, want_state, "stepped")
    _assert_metrics_close(got, want)


def test_train_step_rescale_false_matches_jax(data_dir):
    """JitVBPI(rescale=False): one vbpi_train_step on DS1 through the scan
    engine (ops/pruning.py, no rescaling), fed the same host samples as the
    JAX step with rescale=False from the same carried state, within
    rtol 1e-9 / atol 1e-10; no JC69 kernel or twin runs. Then the
    evaluation half, log_f_values(8) of a fresh pair on hello_out.t,
    likewise."""
    jv, tv = _pair(data_dir, "DS1.subsampled_10.t", "DS1.fasta",
                   particle_count=10, seed=5, rescale=False)
    assert not tv.statics.rescale
    jv.step()
    state = jit_step.state_from_numpy(
        np.asarray(jv.state.q_params), np.asarray(jv.state.sbn_params),
        _adam(jv.state.opt_state), device="cpu", dtype=torch.float64,
    )
    sched5, branch_rep, reps, touched, eps = jv._host_sample()
    evec, ivec, evals, freqs, props, Q = jv.model_tensors
    want_state, want = jstep.vbpi_train_step(
        jv.state, jv.statics, jv.optimizer, tuple(map(jnp.asarray, sched5)),
        jnp.asarray(branch_rep), jnp.asarray(reps), jnp.asarray(touched),
        jnp.asarray(eps), jnp.asarray(1.0), jv.tips, jv.weights,
        jv.segment_ids, evec, ivec, evals, freqs, props, Q,
    )
    inputs = tv._device_put((sched5[1], branch_rep, reps, touched), eps)
    pruning_jc.reset_counters()
    got_state, got = jit_step.vbpi_train_step(
        state, tv.statics, tv.optimizer, *inputs, 1.0, tv.tips, tv.weights,
        tv.segment_ids,
    )
    assert sum(pruning_jc.TWIN_CALLS.values()) == 0
    _assert_state_close(got_state, want_state, "stepped")
    _assert_metrics_close(got, want)
    jv, tv = _pair(data_dir, particle_count=4, seed=2, rescale=False)
    np.testing.assert_allclose(tv.log_f_values(8), jv.log_f_values(8),
                               rtol=RTOL, atol=ATOL)
    assert sum(pruning_jc.TWIN_CALLS.values()) == 0


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_steps_match_jax_trajectory(data_dir, monkeypatch, branch_model,
                                    route):
    """Three JitVBPI.step() calls with the same seed on hello_out.t: after
    each, the state and the metrics within rtol 1e-9 / atol 1e-10 of the
    JAX package's (observed: 3.7e-12 absolute at most). Then step_many(3)
    (topologies sampled up front) and log_f_values(16), likewise. The
    "python" route runs both packages without the native library: the
    Python sampler and the Python lowering of each topology."""
    if route == "python":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(native, "get_lib", lambda: None)
    jv, tv = _pair(data_dir, particle_count=4, seed=0,
                   branch_model=branch_model)
    for k in range(3):
        _assert_metrics_close(tv.step(beta=1.0), jv.step(beta=1.0))
        _assert_state_close(tv.state, jv.state, f"step {k}")
    assert tv.last_sampler == route
    got, want = tv.step_many(3, beta=1.0), jv.step_many(3, beta=1.0)
    assert got["elbo_like"].shape == (3,)
    _assert_metrics_close(got, want)
    _assert_state_close(tv.state, jv.state, "step_many")
    np.testing.assert_allclose(tv.log_f_values(16), jv.log_f_values(16),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_mode_match_matches_jax(data_dir, branch_model):
    """mode_match from per-split modes (here each split's mean length over
    the DS1 trees) resets q_params and the Adam state as the JAX package
    does; a step after it matches (rtol 1e-9 / atol 1e-10)."""
    jv, tv = _pair(data_dir, "DS1.subsampled_10.t", "DS1.fasta",
                   particle_count=4, seed=1, branch_model=branch_model)
    jv.step()
    tv.step()
    modes = np.array([np.mean(x) for x in tv.inst.split_lengths()])
    jv.mode_match(modes)
    tv.mode_match(modes)
    assert tv.state.opt_state[0].count == 0
    _assert_state_close(tv.state, jv.state, "mode_match")
    _assert_metrics_close(tv.step(), jv.step())
    _assert_state_close(tv.state, jv.state, "step after mode_match")


def test_step_overlapped_first_call_equals_step(data_dir):
    """step_overlapped's first call primes the pipeline synchronously, so it
    equals step() from the same seed, exactly; later calls train on
    one-step-stale topologies with finite metrics, and a step_many or step
    in between drops the pending batch."""
    def make():
        return JitVBPI(_instance(libsbn_tpu_torch, data_dir, "hello_out.t",
                                 "hello.fasta"), particle_count=4, seed=0)

    a, b = make(), make()
    m_live, m_over = a.step(beta=1.0), b.step_overlapped(beta=1.0)
    for name in ("mean_ll", "elbo_like"):
        assert float(m_live[name]) == float(m_over[name])
    assert torch.equal(a.state.sbn_params, b.state.sbn_params)
    assert torch.equal(a.state.q_params, b.state.q_params)
    assert b._pending_sample is not None
    vals = [float(b.step_overlapped()["elbo_like"]) for _ in range(5)]
    assert np.all(np.isfinite(vals))
    b.step_many(2)
    assert b._pending_sample is None


def test_estimators(data_dir):
    """log_f_values, estimate_elbo and marginal_likelihood_estimate after
    three steps on hello_out.t: finite, of the right shape, and the
    importance-sampled marginal from the same particles is at least their
    mean (Jensen), as tests/test_vi.py checks the JAX package. log f runs
    K2 (its twin here), not K1."""
    tv = JitVBPI(_instance(libsbn_tpu_torch, data_dir, "hello_out.t",
                           "hello.fasta"), particle_count=4, seed=0)
    for _ in range(3):
        tv.step(beta=1.0)
    pruning_jc.reset_counters()
    logf = tv.log_f_values(256)
    assert pruning_jc.TWIN_CALLS == {"ll_grad_jc69": 0, "ll_jc69": 1,
                                     "ll_dea_jc69": 0}
    assert logf.shape == (256,) and logf.dtype == np.float64
    assert np.all(np.isfinite(logf))
    marg = float(torch.logsumexp(torch.as_tensor(logf), 0)) - np.log(256)
    assert marg >= logf.mean() - 1e-9
    elbo = tv.estimate_elbo(256)
    mle = tv.marginal_likelihood_estimate(256)
    assert np.isfinite(elbo) and np.isfinite(mle)


def test_adam_matches_optax():
    """The port's Adam against libsbn_tpu's make_optimizer (optax) over five
    steps of random gradients on two groups, float64: within 1e-15."""
    rng = np.random.default_rng(4)
    q, s = rng.normal(size=(6, 2)), rng.normal(size=9)
    jopt = jstep.make_optimizer(1e-3, 2e-3)
    jstate = jstep.init_state(jnp.asarray(q), jnp.asarray(s), jopt)
    opt = jit_step.make_optimizer(1e-3, 2e-3)
    state = jit_step.init_state(torch.as_tensor(q), torch.as_tensor(s), opt)
    for k in range(5):
        gq, gs = rng.normal(size=q.shape), rng.normal(size=s.shape) * 1e-3
        updates, opt_state = jopt.update(
            (jnp.asarray(gq), jnp.asarray(gs)), jstate.opt_state,
            (jstate.q_params, jstate.sbn_params))
        jq = jstate.q_params + updates[0]
        js = jstate.sbn_params + updates[1]
        jstate = jstep.VBPIState(jq, js, opt_state)
        (tq, ts), topt = opt.update(
            (torch.as_tensor(gq), torch.as_tensor(gs)), state.opt_state,
            (state.q_params, state.sbn_params))
        state = jit_step.VBPIState(tq, ts, topt)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                                   atol=1e-15)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-15)
    assert state.opt_state[1].count == 5
