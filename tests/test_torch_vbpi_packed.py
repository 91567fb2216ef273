"""The port's packed VBPI steps (vi/jit_step.py ``vbpi_train_step_packed``,
``vbpi_train_steps_packed``, ``vbpi_log_f_packed``) against libsbn_tpu's
functions of the same names, and what the one-dispatch route rests on.

Both packages are fed the same host samples (drawn by libsbn_tpu's
JitVBPI on DS1, 10 particles, float64, split and PSP) from the same state,
each packed in its own layout (libsbn_tpu's eight int32 arrays, the port's
four); the port runs K1's twin on the CPU, libsbn_tpu its scan engine.
Tolerances as tests/test_torch_vbpi.py's: rtol 1e-9 / atol 1e-10.

Then, in the port alone: a window of K steps equals K single steps bit for
bit; the tensor-valued ``beta`` and Adam ``count`` give the trajectory of
a Python float and a Python int bit for bit; a checkpoint carries the
tensor count (and libsbn_tpu's files still load); and the graph route's
state buffers keep their shapes (``step_graph.StepGraphs.assign`` and the
window shape check, which raise before any CUDA call).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libsbn_tpu.vi import checkpoint as jcheckpoint
from libsbn_tpu.vi import jit_step as jstep
from libsbn_tpu_torch.ops import pruning_jc
from libsbn_tpu_torch.vi import checkpoint, jit_step, step_graph
from test_torch_vbpi import (
    BRANCH_MODELS, _adam, _assert_metrics_close, _assert_state_close, _pair,
)

torch.set_num_threads(1)

BETAS = (0.1, 0.5, 1.0)


def _ds1(data_dir, branch_model, seed=3):
    """(libsbn_tpu's JitVBPI after one step, the port's JitVBPI, the JAX
    state carried into the port's types) on DS1, 10 particles, f64."""
    jv, tv = _pair(data_dir, "DS1.subsampled_10.t", "DS1.fasta",
                   particle_count=10, seed=seed, branch_model=branch_model)
    jv.step()
    state = jit_step.state_from_numpy(
        np.asarray(jv.state.q_params), np.asarray(jv.state.sbn_params),
        _adam(jv.state.opt_state), device="cpu", dtype=torch.float64,
    )
    return jv, tv, state


def _samples(jv, count):
    """``count`` host samples of libsbn_tpu's JitVBPI, each packed by both
    packages: (libsbn_tpu's (packed, eps, shapes) list, the port's packed
    (count, P, W) tensor, eps (count, P, B) and shapes)."""
    jax_in, ints, eps_all = [], [], []
    for _ in range(count):
        sched5, branch_rep, reps, touched, eps = jv._host_sample()
        jax_in.append(jv._device_put(sched5, branch_rep, reps, touched, eps))
        ints.append((sched5[1], branch_rep, reps, touched))
        eps_all.append(eps)
    packed, shapes = jit_step.pack_ints(
        tuple(np.stack(column) for column in zip(*ints)))
    return (jax_in, torch.from_numpy(packed),
            torch.from_numpy(np.stack(eps_all)), shapes)


def _model(tv):
    return tv.tips, tv.weights, tv.segment_ids


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_train_step_packed_matches_jax(data_dir, branch_model):
    """One vbpi_train_step_packed from the carried state: state, Adam
    count and metrics against libsbn_tpu's; one K1 twin call."""
    jv, tv, state = _ds1(data_dir, branch_model)
    jax_in, packed, eps, shapes = _samples(jv, 1)
    j_packed, j_eps, j_shapes = jax_in[0]
    want_state, want = jstep.vbpi_train_step_packed(
        jv.state, jv.statics, jv.optimizer, j_packed, j_eps,
        jnp.asarray(1.0), j_shapes, jv.tips, jv.weights, jv.segment_ids,
        *jv.model_tensors)
    pruning_jc.reset_counters()
    got_state, got = jit_step.vbpi_train_step_packed(
        state, tv.statics, tv.optimizer, packed[0], eps[0], 1.0, shapes,
        *_model(tv))
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 1
    assert got_state.opt_state[0].count == 2
    _assert_state_close(got_state, want_state, "packed step")
    _assert_metrics_close(got, want)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_train_steps_packed_matches_jax(data_dir, branch_model):
    """A window of K = 3 steps at betas 0.1, 0.5, 1.0: the final state and
    the metrics, stacked to (3,), against libsbn_tpu's lax.scan window."""
    jv, tv, state = _ds1(data_dir, branch_model, seed=4)
    jax_in, packed_k, eps_k, shapes = _samples(jv, len(BETAS))
    want_state, want = jstep.vbpi_train_steps_packed(
        jv.state, jv.statics, jv.optimizer,
        jnp.stack([p for p, _, _ in jax_in]),
        jnp.stack([e for _, e, _ in jax_in]), jnp.asarray(BETAS),
        jax_in[0][2], jv.tips, jv.weights, jv.segment_ids, *jv.model_tensors)
    got_state, got = jit_step.vbpi_train_steps_packed(
        state, tv.statics, tv.optimizer, packed_k, eps_k,
        torch.tensor(BETAS, dtype=torch.float64), shapes, *_model(tv))
    assert got["mean_ll"].shape == (len(BETAS),)
    assert got_state.opt_state[1].count == 1 + len(BETAS)
    _assert_state_close(got_state, want_state, "packed window")
    _assert_metrics_close(got, want)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_log_f_packed_matches_jax(data_dir, branch_model):
    """vbpi_log_f_packed (K2's twin, beta = 1, no update) against
    libsbn_tpu's on the same 10 particles."""
    jv, tv, state = _ds1(data_dir, branch_model, seed=5)
    jax_in, packed, eps, shapes = _samples(jv, 1)
    want = jstep.vbpi_log_f_packed(
        jv.state, jv.statics, jax_in[0][0], jax_in[0][1], jax_in[0][2],
        jv.tips, jv.weights, jv.segment_ids, *jv.model_tensors)
    pruning_jc.reset_counters()
    got = jit_step.vbpi_log_f_packed(state, tv.statics, packed[0], eps[0],
                                     shapes, *_model(tv))
    assert pruning_jc.TWIN_CALLS["ll_jc69"] == 1
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-10)


def _assert_equal_states(a, b):
    for x, y in zip(step_graph.leaves(a), step_graph.leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_window_equals_single_steps(data_dir, branch_model):
    """vbpi_train_steps_packed over a window of 3 equals 3 calls of
    vbpi_train_step_packed bit for bit (state, count and metrics)."""
    jv, tv, state = _ds1(data_dir, branch_model, seed=6)
    _, packed_k, eps_k, shapes = _samples(jv, len(BETAS))
    betas = torch.tensor(BETAS, dtype=torch.float64)
    window_state, window = jit_step.vbpi_train_steps_packed(
        state, tv.statics, tv.optimizer, packed_k, eps_k, betas, shapes,
        *_model(tv))
    singles = []
    for k in range(len(BETAS)):
        state, metrics = jit_step.vbpi_train_step_packed(
            state, tv.statics, tv.optimizer, packed_k[k], eps_k[k], betas[k],
            shapes, *_model(tv))
        singles.append(metrics)
    _assert_equal_states(window_state, state)
    for name in window:
        assert torch.equal(window[name],
                           torch.stack([m[name] for m in singles]))


class _IntCountAdam(jit_step.Adam):
    """The Adam the port had before its count became a tensor: a Python
    int count and Python-float bias corrections."""

    def init(self, params):
        return tuple(jit_step.AdamState(torch.zeros_like(p),
                                        torch.zeros_like(p), 0)
                     for p in params)

    def update(self, grads, opt_state, params):
        b1, b2 = self.b1, self.b2
        new_params, new_state = [], []
        for lr, g, st, p in zip(self.learning_rates, grads, opt_state, params):
            mu = (1 - b1) * g + b1 * st.mu
            nu = (1 - b2) * (g ** 2) + b2 * st.nu
            count = st.count + 1
            step = (mu / (1 - b1 ** count)) / (
                torch.sqrt(nu / (1 - b2 ** count)) + self.eps)
            new_params.append(p + step * (-lr))
            new_state.append(jit_step.AdamState(mu, nu, count))
        return tuple(new_params), tuple(new_state)


@pytest.mark.parametrize("branch_model", BRANCH_MODELS)
def test_tensor_beta_and_count_keep_the_trajectory(data_dir, branch_model):
    """Four steps at betas 0.1, 0.5, 1.0, 1.0 with a 0-dim tensor beta and
    the tensor-count Adam against a Python-float beta and the int-count
    Adam: the same states and metrics bit for bit."""
    jv, tv, _ = _ds1(data_dir, branch_model, seed=7)
    _, packed_k, eps_k, shapes = _samples(jv, 4)
    q0, s0 = tv.state.q_params, tv.state.sbn_params
    old_opt = _IntCountAdam(tv.optimizer.learning_rates)
    new = jit_step.init_state(q0, s0, tv.optimizer)
    old = jit_step.init_state(q0, s0, old_opt)
    for k, beta in enumerate(BETAS + (1.0,)):
        inputs = jit_step.unpack_ints(packed_k[k], shapes) + (eps_k[k],)
        new, m_new = jit_step.vbpi_train_step(
            new, tv.statics, tv.optimizer, *inputs,
            torch.tensor(beta, dtype=torch.float64), *_model(tv))
        old, m_old = jit_step.vbpi_train_step(
            old, tv.statics, old_opt, *inputs, beta, *_model(tv))
        for name in m_new:
            assert torch.equal(m_new[name], m_old[name]), (k, name)
        assert torch.equal(new.q_params, old.q_params)
        assert torch.equal(new.sbn_params, old.sbn_params)
        for a, b in zip(new.opt_state, old.opt_state):
            assert a.count.dtype == torch.int32 and a.count.dim() == 0
            assert int(a.count) == b.count == k + 1
            assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)


def test_checkpoint_carries_the_tensor_count(data_dir, tmp_path):
    """save_jit_state / restore_jit_state carry the Adam count, a 0-dim
    int32 tensor in memory and an int32 scalar in the file, as libsbn_tpu
    writes it; libsbn_tpu reads the port's file and the port libsbn_tpu's,
    and the next steps from either match."""
    jv, tv = _pair(data_dir, particle_count=4, seed=0)
    for _ in range(3):
        _assert_metrics_close(tv.step(), jv.step())
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_jit_state(tv, mine)
    jcheckpoint.save_jit_state(jv, theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_allclose(a[name], b[name], rtol=1e-9,
                                       atol=1e-10)
    for path in (theirs, mine):
        jfresh, fresh = _pair(data_dir, particle_count=4, seed=1)
        checkpoint.restore_jit_state(fresh, path)
        jcheckpoint.restore_jit_state(jfresh, mine)
        for st in fresh.state.opt_state:
            assert st.count.dtype == torch.int32 and st.count.dim() == 0
            assert int(st.count) == 3
        _assert_metrics_close(fresh.step(), jfresh.step())
        _assert_state_close(fresh.state, jfresh.state, path)


def test_step_graphs_keep_their_shapes(data_dir):
    """The graph route's buffers (step_graph.StepGraphs, here over a CPU
    state, without capturing): assign copies into the same tensors, a state
    of other shapes raises and leaves them, and a window of other step
    shapes than the first raises before any CUDA call."""
    _, tv = _pair(data_dir, particle_count=4, seed=0)
    graphs = step_graph.StepGraphs(tv.state, None, "cpu")
    buffers = step_graph.leaves(graphs.state)
    q = torch.full_like(tv.state.q_params, 0.25)
    graphs.assign(jit_step.init_state(q, tv.state.sbn_params, tv.optimizer))
    assert all(a is b for a, b in zip(step_graph.leaves(graphs.state),
                                      buffers))
    assert torch.equal(buffers[0], q)
    with pytest.raises(ValueError, match="shapes"):
        graphs.assign(jit_step.init_state(q[1:], tv.state.sbn_params,
                                          tv.optimizer))
    assert torch.equal(buffers[0], q)
    ints, eps = tv._host_sample()
    packed, shapes = jit_step.pack_ints(tuple(a[None] for a in ints))
    graphs.step_shapes = (shapes, tuple(packed.shape[1:]),
                          tuple(eps.shape))
    wider = np.concatenate([packed, packed[..., :1]], axis=-1)
    with pytest.raises(ValueError, match="fixed shapes"):
        graphs.run(wider, eps.ravel(), shapes, (1,) + eps.shape)
