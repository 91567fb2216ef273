"""Checkpoints of the port's VBPI training state
(libsbn_tpu_torch.vi.checkpoint), against libsbn_tpu's.

* the carried state: a Burrito checkpoint written by libsbn_tpu after 5
  steps restores into the port (q-params, SBN parameters, step sizes, step
  number, Adam moments and ELBO trace exactly), and a fresh Burrito of each
  package restored from it follows the same trajectory for 3 more steps
  (rel 1e-9);
* the port's own round trip and the support-size mismatch error
  (tests/test_checkpoint.py:30-72), its file readable by libsbn_tpu;
* JitVBPI's state round trip, and a libsbn_tpu JitVBPI checkpoint restored
  into the port.

Every port call passes device="cpu". "rel r" below means
|got - want| <= r (|want| + max |want|) elementwise.
"""

import json
import os

import numpy as np
import pytest
import torch

import libsbn_tpu as jl
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.vi import checkpoint as jcheckpoint
from libsbn_tpu.vi.burrito import Burrito as JBurrito
from libsbn_tpu.vi.jit_step import JitVBPI as JJitVBPI

import libsbn_tpu_torch as lt
from libsbn_tpu_torch.vi import checkpoint
from libsbn_tpu_torch.vi.burrito import Burrito
from libsbn_tpu_torch.vi.jit_step import JitVBPI
from test_torch_vi import refreshed_libsbn_tpu_sampler  # noqa: F401

torch.set_num_threads(2)

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def rel_close(got, want, rel, msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), (
        msg, np.max(np.abs(got - want) / scale))


def make(port, tree="hello_out.t", fasta="hello.fasta", burn_in=0.0,
         particles=3, seed=0):
    kw = dict(
        mcmc_nexus_path=f"{DATA}/{tree}", burn_in_fraction=burn_in,
        fasta_path=f"{DATA}/{fasta}", branch_model_name="split",
        scalar_model_name="lognormal", optimizer_name="simple",
        particle_count=particles, seed=seed)
    if port:
        return Burrito(
            phylo_model_specification=lt.PhyloModelSpec(
                "JC69", "constant", "strict"), device="cpu", **kw)
    return JBurrito(
        phylo_model_specification=JSpec("JC69", "constant", "strict"), **kw)


@pytest.mark.parametrize("data", [
    ("hello_out.t", "hello.fasta", 0.0, 3),
    ("DS1.subsampled_10.t", "DS1.fasta", 0.1, 10)], ids=["hello", "DS1"])
def test_libsbn_tpu_checkpoint_carries_into_the_port(tmp_path, data):
    jax_burro = make(False, *data)
    jax_burro.gradient_steps(5)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_burrito(jax_burro, path)

    port = checkpoint.restore_burrito(make(True, *data, seed=99), path)
    np.testing.assert_array_equal(port.scalar_model.q_params,
                                  jax_burro.scalar_model.q_params)
    np.testing.assert_array_equal(port.inst.sbn_parameters,
                                  jax_burro.inst.sbn_parameters)
    np.testing.assert_array_equal(port.opt.step_size, jax_burro.opt.step_size)
    assert port.opt.sbn_step_size == jax_burro.opt.sbn_step_size
    assert port.opt.step_number == jax_burro.opt.step_number == 5
    assert port.elbo_trace == jax_burro.elbo_trace
    for mine, theirs in zip(port.opt.ascent.state_leaves(),
                            jax_burro.opt.ascent.state_leaves(), strict=True):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype

    # Both packages continue from the checkpoint in a fresh Burrito: the
    # same sampler seed, the same restored state, the same 3 steps.
    jax_fresh = jcheckpoint.restore_burrito(make(False, *data, seed=0), path)
    port_fresh = checkpoint.restore_burrito(make(True, *data, seed=0), path)
    jax_fresh.gradient_steps(3)
    port_fresh.gradient_steps(3)
    assert len(port_fresh.elbo_trace) == 8
    rel_close(port_fresh.elbo_trace, jax_fresh.elbo_trace, 1e-9, "ELBO")
    rel_close(port_fresh.scalar_model.q_params,
              jax_fresh.scalar_model.q_params, 1e-9, "q_params")
    rel_close(port_fresh.inst.sbn_parameters, jax_fresh.inst.sbn_parameters,
              1e-9, "SBN parameters")


def test_burrito_checkpoint_round_trip(tmp_path):
    """The port's save/restore round trip; training continues; libsbn_tpu
    reads the port's file."""
    burro = make(True)
    burro.gradient_steps(5)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_burrito(burro, path)
    fresh = checkpoint.restore_burrito(make(True, seed=99), path)
    np.testing.assert_array_equal(fresh.scalar_model.q_params,
                                  burro.scalar_model.q_params)
    np.testing.assert_array_equal(fresh.inst.sbn_parameters,
                                  burro.inst.sbn_parameters)
    assert fresh.inst.sbn_parameters.flags.writeable
    assert fresh.opt.step_number == burro.opt.step_number
    for mine, theirs in zip(fresh.opt.ascent.state_leaves(),
                            burro.opt.ascent.state_leaves(), strict=True):
        np.testing.assert_array_equal(mine, theirs)
    fresh.gradient_steps(2)
    assert len(fresh.elbo_trace) == 7
    jax_burro = jcheckpoint.restore_burrito(make(False), path)
    np.testing.assert_array_equal(jax_burro.scalar_model.q_params,
                                  burro.scalar_model.q_params)


def test_burrito_checkpoint_mismatch(tmp_path):
    burro = make(True)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_burrito(burro, path)
    with np.load(path) as data:
        payload = {k: data[k] for k in data.files}
    meta = json.loads(bytes(payload["meta_json"].tobytes()).decode())
    meta["gpcsp_count"] += 7
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="support size"):
        checkpoint.restore_burrito(make(True), path)


def vbpi_instance(lib, **kw):
    inst = lib.UnrootedInstance("x")
    inst.read_nexus_file(f"{DATA}/hello_out.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/hello.fasta")
    spec = lib.PhyloModelSpec if lib is lt else JSpec
    inst.prepare_for_phylo_likelihood(spec("JC69", "constant", "strict"), **kw)
    return inst


def test_jit_state_round_trip(tmp_path):
    jv = JitVBPI(vbpi_instance(lt, device="cpu"), particle_count=4, seed=0)
    jv.step()
    jv.step()
    path = str(tmp_path / "jit.npz")
    checkpoint.save_jit_state(jv, path)
    before = jv.state.q_params.clone()
    jv.step()
    assert not torch.allclose(jv.state.q_params, before)
    checkpoint.restore_jit_state(jv, path)
    torch.testing.assert_close(jv.state.q_params, before, rtol=0, atol=0)
    assert [a.count for a in jv.state.opt_state] == [2, 2]


def test_libsbn_tpu_jit_state_restores_into_the_port(tmp_path):
    """A libsbn_tpu JitVBPI checkpoint (its VBPIState's leaves) restores
    into the port's JitVBPI; one more step from it with the same host draws
    equals libsbn_tpu's (rel 1e-9)."""
    jax_jv = JJitVBPI(vbpi_instance(jl), particle_count=4, seed=0)
    for _ in range(3):
        jax_jv.step()
    path = str(tmp_path / "jit.npz")
    jcheckpoint.save_jit_state(jax_jv, path)
    port = JitVBPI(vbpi_instance(lt, device="cpu"), particle_count=4, seed=0)
    for _ in range(3):
        port.step()  # the same host draws as libsbn_tpu's three steps
    checkpoint.restore_jit_state(port, path)
    np.testing.assert_array_equal(port.state.q_params.numpy(),
                                  np.asarray(jax_jv.state.q_params))
    assert [a.count for a in port.state.opt_state] == [3, 3]
    want = jax_jv.step()
    got = port.step()
    rel_close(float(got["elbo_like"]), float(want["elbo_like"]), 1e-9)
    rel_close(port.state.q_params.numpy(), np.asarray(jax_jv.state.q_params),
              1e-9)
