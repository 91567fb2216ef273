"""The port's parallel layer (parallel/sharding.py, parallel/distributed.py)
against libsbn_tpu's, on the CPU.

* The dp-sharded K1 and K4 wrappers over eight "cpu" devices against the
  port's local calls, bit for bit (each tree is independent), and against
  libsbn_tpu's sharded wrappers on its 8-device mesh in interpret mode, as
  tests/test_pallas.py:172 and :440 run them: K4 at rel 1e-10 in f64; K1
  in f32 at the f32 gates (libsbn_tpu's K1 is f32 only) and in f64 against
  libsbn_tpu's sharded K4 fed the JC69 transition matrices, at rel 1e-10.
* JitVBPI on a global mesh: a two-process gloo job (hello and DS1, f64, 3
  steps, a file:// rendezvous in tmp_path) whose ranks end bit-identical
  and within rel 1e-9 of libsbn_tpu's vbpi_train_step run here on the two
  ranks' samples concatenated in rank order, drawn by libsbn_tpu's host
  samplers seeded seed and seed + 7919; the same job's GP fit on the
  global mesh. JitVBPI on a local mesh of eight "cpu" devices equals the
  unsharded trainer bit for bit.
* GPEngine on an sp mesh: five_taxon over sp = 8 (4 patterns, so padded)
  and sp = 3 against the unsharded fit and libsbn_tpu's sp fit; the
  kernel route's twins over sp = 3; a 600-taxon tree whose 203 patterns
  sp = 8 does not divide, where libsbn_tpu's padding fails.
* The mesh objects and helpers against libsbn_tpu's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.core.tree import RootedTree as JRootedTree
from libsbn_tpu.core.tree import RootedTreeCollection as JRootedTreeCollection
from libsbn_tpu.gp import GPInstance as JGPInstance
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.ops import pruning as jpruning
from libsbn_tpu.ops import pruning_pallas, pruning_pallas_jc
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu.ops import substitution as jsubstitution
from libsbn_tpu.parallel import sharding as jsharding
from libsbn_tpu.vi import jit_step as jstep
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection
from libsbn_tpu_torch.gp import GPInstance
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.ops import pruning_generic, pruning_jc
from libsbn_tpu_torch.parallel import distributed, sharding
from libsbn_tpu_torch.vi import JitVBPI

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
# rtol / atol of the f64 VBPI state and metrics against libsbn_tpu's.
RTOL, ATOL = 1e-9, 1e-10
PROCESS_TIMEOUT_S = 120


def t(a, dt=torch.float64):
    return torch.as_tensor(np.array(a)).to(dt)


def rel_close(got, want, rel, what=""):
    """|got - want| <= rel x the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got)), what
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rel, (what, err)


# -- the dp-sharded kernel wrappers -------------------------------------------


@pytest.fixture(scope="module")
def ds1(data_dir):
    """DS1.subsampled_10 tiled to 16 trees, branch lengths perturbed by a
    seeded U(0.8, 1.2), with the ones slot: schedule, lengths, tips,
    weights, and the JC69 transition matrices (16, N + 1, 1, 4, 4) and
    rate matrix from libsbn_tpu, all numpy f64."""
    tops, bls, ttm = jnewick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    sched = jschedule.schedules_of_topologies(tops)
    B = 16
    bl = np.tile(np.stack(bls), (2, 1))[:B]
    bl = bl * np.random.default_rng(4).uniform(0.8, 1.2, bl.shape)
    bl_p = np.pad(bl, ((0, 0), (0, 1)))
    freqs, evec, ivec, evals = jsubstitution.jc69_eigen(jnp.float64)
    P = jax.vmap(lambda b: jpruning.node_transition_matrices(
        evec, ivec, evals, b, jnp.ones((1,), jnp.float64)))(jnp.asarray(bl_p))
    return {
        "pc": np.tile(np.asarray(sched.post_children), (2, 1, 1))[:B]
        .astype(np.int32),
        "bl_p": bl_p, "root_id": sched.root_id,
        "tips": np.asarray(sp.tip_partials()), "w": np.asarray(sp.weights),
        "P": np.asarray(P), "Q": np.asarray(jsubstitution.jc69_q(jnp.float64)),
        "freqs": np.asarray(freqs),
    }


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_k1_sharded_matches_local_and_jax(ds1, dt):
    """K1's dp wrapper over eight "cpu" devices equals the local call bit
    for bit; f32 against libsbn_tpu's K1 wrapper on its 8-device mesh
    (LLs rtol 1e-5, gradients rtol 2e-2 with atol 1e-3 x the largest), f64
    against libsbn_tpu's sharded K4 fed JC69 matrices at rel 1e-10."""
    r = ds1["root_id"]
    args = (t(ds1["pc"], torch.int32), t(ds1["bl_p"], dt), t(ds1["tips"], dt),
            t(ds1["w"], dt))
    mesh = sharding.make_mesh(8, dp=8, sp=1, devices=CPU8)
    pruning_jc.reset_counters()
    ll, g = pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
        mesh, *args, root_id=r)
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 8
    ll0, g0 = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        *args, root_id=r)
    assert torch.equal(ll, ll0) and torch.equal(g, g0)
    assert ll.dtype == dt and g.shape == (16, r)
    jmesh = jsharding.make_mesh(8, dp=8, sp=1)
    if dt == torch.float32:
        want_ll, want_g = (
            pruning_pallas_jc.log_likelihood_and_branch_gradient_pallas_jc69_sharded(
                jmesh, ds1["pc"], ds1["bl_p"].astype(np.float32),
                ds1["tips"].astype(np.float32), ds1["w"].astype(np.float32),
                root_id=r, interpret=True))
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=2e-2,
                                   atol=1e-3 * np.abs(want_g).max())
        return
    want_ll, want_g = pruning_pallas.log_likelihood_and_branch_gradient_pallas_sharded(
        jmesh, ds1["pc"], ds1["P"], ds1["Q"][None], ds1["tips"], ds1["freqs"],
        ds1["w"], root_id=r, interpret=True)
    rel_close(ll.numpy(), want_ll, 1e-10, "K1 LLs")
    rel_close(g.numpy(), want_g, 1e-10, "K1 gradients")


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_k4_sharded_matches_local_and_jax(ds1, dt):
    """K4's dp wrapper over eight "cpu" devices equals the local call bit
    for bit, and libsbn_tpu's sharded K4 on its 8-device mesh: rel 1e-10
    in f64; in f32, LLs rtol 1e-5 and gradients rtol 2e-2 with atol 1e-3
    x the largest."""
    r = ds1["root_id"]
    np_dt = np.float64 if dt == torch.float64 else np.float32
    P, Q, tips, freqs, w = (ds1[k].astype(np_dt)
                            for k in ("P", "Q", "tips", "freqs", "w"))
    props = np.ones(1, np_dt)
    args = (t(ds1["pc"], torch.int32), t(P, dt), t(Q[None], dt), t(tips, dt),
            t(freqs, dt), t(props, dt), t(w, dt))
    mesh = sharding.make_mesh(8, dp=8, sp=1, devices=CPU8)
    pruning_generic.reset_counters()
    ll, g = pruning_generic.log_likelihood_and_branch_gradient_generic_sharded(
        mesh, *args, root_id=r)
    assert pruning_generic.TWIN_CALLS["ll_grad_generic"] == 8
    ll0, g0 = pruning_generic.log_likelihood_and_branch_gradient_generic(
        *args, root_id=r)
    assert torch.equal(ll, ll0) and torch.equal(g, g0)
    want_ll, want_g = pruning_pallas.log_likelihood_and_branch_gradient_pallas_sharded(
        jsharding.make_mesh(8, dp=8, sp=1), ds1["pc"], P, Q[None], tips,
        freqs, w, root_id=r, props=props, interpret=True)
    if dt == torch.float64:
        rel_close(ll.numpy(), want_ll, 1e-10, "K4 LLs")
        rel_close(g.numpy(), want_g, 1e-10, "K4 gradients")
    else:
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=2e-2,
                                   atol=1e-3 * np.abs(want_g).max())


def test_sharded_wrapper_uneven_batch(ds1):
    """A batch the dp devices do not divide (10 trees over 8) splits into
    pieces that differ by one, in tree order; 3 trees over 8 skip the
    empty pieces. Both equal the local call bit for bit."""
    r = ds1["root_id"]
    mesh = sharding.make_mesh(devices=CPU8)
    for B in (10, 3):
        args = (t(ds1["pc"][:B], torch.int32), t(ds1["bl_p"][:B]),
                t(ds1["tips"]), t(ds1["w"]))
        got = pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
            mesh, *args, root_id=r)
        want = pruning_jc.log_likelihood_and_branch_gradient_jc69(
            *args, root_id=r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- the mesh and its helpers -------------------------------------------------


def test_mesh_shapes_and_errors():
    """make_mesh lays the devices out as libsbn_tpu's does ((dp, sp) in
    row-major order, axis names ("dp", "sp")); asking for more devices
    than there are, or a dp x sp that is not the device count, raises."""
    mesh = sharding.make_mesh(8, dp=2, sp=4, devices=CPU8)
    jmesh = jsharding.make_mesh(8, dp=2, sp=4)
    assert mesh.axis_names == jmesh.axis_names == ("dp", "sp")
    assert mesh.shape == dict(jmesh.shape) == {"dp": 2, "sp": 4}
    assert mesh.devices.shape == jmesh.devices.shape
    assert len(mesh.axis_devices("sp")) == 4 and len(mesh.axis_devices("dp")) == 2
    assert sharding.make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "sp": 1}
    with pytest.raises(ValueError, match="9 devices requested, 8"):
        sharding.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="dp \\* sp"):
        sharding.make_mesh(8, dp=3, sp=2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA devices are present"):
            sharding.make_mesh(devices=["cuda:0"])


def test_sharding_helpers_match_jax():
    """pad_to_multiple equals libsbn_tpu's; particle, pattern and
    replicated shardings split as their names say; shard_particle_batch
    gives each array's pieces in order; from_process_local and
    local_particle_count check their counts."""
    a = np.arange(30.0).reshape(5, 6)
    for axis, m in ((0, 4), (1, 4), (1, 3)):
        got, n = sharding.pad_to_multiple(a, m, axis=axis)
        want, jn = jsharding.pad_to_multiple(a, m, axis=axis)
        assert n == jn and np.array_equal(got, want)
    mesh = sharding.make_mesh(8, dp=2, sp=4, devices=CPU8)
    x = torch.arange(24.0).reshape(4, 6)
    parts = sharding.particle_sharding(mesh).split(x)
    assert [p.shape for p in parts] == [(2, 6), (2, 6)]
    cols = sharding.pattern_sharding(mesh).split(x[:, :4])
    assert torch.equal(torch.cat(cols, dim=-1), x[:, :4]) and len(cols) == 4
    assert len(sharding.replicated(mesh).split(x)) == 8
    (pieces,) = sharding.shard_particle_batch(mesh, x.numpy())
    assert torch.equal(torch.cat(pieces), x)
    sh = sharding.particle_sharding(mesh)
    assert torch.equal(distributed.from_process_local(sh, x.numpy(), 4), x)
    with pytest.raises(ValueError, match="global rows"):
        distributed.from_process_local(sh, x.numpy(), 8)
    assert distributed.local_particle_count(mesh, 10) == 10


@pytest.mark.parametrize("module", ["sharding", "distributed"])
def test_name_table_covers_the_jax_module(module):
    """tests/test_torch_api_names.py's table for parallel.<module> holds
    every public function libsbn_tpu's module defines."""
    import importlib
    import inspect

    from test_torch_api_names import PARALLEL_SURFACE

    jmod = importlib.import_module(f"libsbn_tpu.parallel.{module}")
    defined = {name for name, obj in inspect.getmembers(jmod, callable)
               if getattr(obj, "__module__", None) == jmod.__name__
               and not name.startswith("_")}
    assert defined == set(PARALLEL_SURFACE[f"parallel.{module}"])


def test_initialize_without_a_job(monkeypatch):
    """Without a coordinator and a process count, initialize joins nothing
    and reports a single process (as often as it is called); global_mesh
    is then this process's one-device mesh, not distributed; a partial
    job description raises."""
    for name in ("LIBSBN_COORDINATOR", "LIBSBN_NUM_PROCESSES",
                 "LIBSBN_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(device="cpu") is False
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1} and not mesh.distributed
    assert mesh.first_device == torch.device("cpu")
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize(coordinator_address="file:///nowhere")
    with pytest.raises(ValueError, match="must cover"):
        distributed.global_mesh(dp=2, device="cpu")


def test_global_mesh_without_a_card_raises(monkeypatch):
    """With no device named, global_mesh and initialize take the card:
    without one they raise, naming device="cpu", and never pick the CPU;
    local_device_ids with device="cpu" is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path is not reachable")
    for name in ("LIBSBN_COORDINATOR", "LIBSBN_NUM_PROCESSES",
                 "LIBSBN_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        distributed.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.global_mesh(device="cuda:0")
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        distributed.initialize(f"file://{os.devnull}_never", 2, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed._default_devices(0, [0])
    with pytest.raises(ValueError, match="device is the CPU"):
        distributed._default_devices(0, [0], "cpu")


# -- VBPI on meshes -------------------------------------------------------------


def _instance(package, data_dir, trees, fasta):
    inst = package.UnrootedInstance("parallel")
    inst.read_nexus_file(f"{data_dir}/{trees}")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{data_dir}/{fasta}")
    kw = {"device": "cpu"} if package is libsbn_tpu_torch else {}
    inst.prepare_for_phylo_likelihood(
        package.PhyloModelSpec("JC69", "constant", "strict"), **kw)
    return inst


def test_local_mesh_vbpi_equals_unsharded(data_dir):
    """JitVBPI on a local mesh of eight "cpu" devices (each step's 10
    particles split by K1's wrapper) equals the unsharded trainer bit for
    bit over three step()s and a step_many(2)."""
    kw = dict(particle_count=10, seed=2)
    trees, fasta = "DS1.subsampled_10.t", "DS1.fasta"
    a = JitVBPI(_instance(libsbn_tpu_torch, data_dir, trees, fasta), **kw)
    b = JitVBPI(_instance(libsbn_tpu_torch, data_dir, trees, fasta),
                mesh=sharding.make_mesh(devices=CPU8), **kw)
    for _ in range(3):
        ma, mb = a.step(), b.step()
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    ma, mb = a.step_many(2), b.step_many(2)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert torch.equal(a.state.q_params, b.state.q_params)
    assert torch.equal(a.state.sbn_params, b.state.sbn_params)


def run_ranks(tmp_path, world, extra=(), backend=None):
    """Spawn ``world`` ranks of parallel/multihost_demo.py on the CPU with a
    file:// rendezvous in tmp_path; returns their .npz contents."""
    env = dict(os.environ, LIBSBN_COORDINATOR=f"file://{tmp_path}/store",
               LIBSBN_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "libsbn_tpu_torch.parallel.multihost_demo",
               "--out", str(tmp_path / f"rank{rank}.npz"), "--device", "cpu",
               *extra]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=dict(env, LIBSBN_PROCESS_ID=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "MULTIHOST_OK" in out, out[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _jax_replay(data_dir, trees, fasta, particles, world, steps, seed):
    """libsbn_tpu's vbpi_train_step run here, ``steps`` times from the
    initial state, each on the ranks' samples concatenated in rank order:
    rank r's drawn by a libsbn_tpu JitVBPI seeded seed + 7919 r from the
    current state. Returns (state, metrics per step, samples per rank and
    step)."""
    samplers = [
        jstep.JitVBPI(_instance(libsbn_tpu, data_dir, trees, fasta),
                      particle_count=particles // world, seed=seed + 7919 * r)
        for r in range(world)]
    jv = samplers[0]
    state, metrics, samples = jv.state, [], []
    evec, ivec, evals, freqs, props, Q = jv.model_tensors
    for _ in range(steps):
        drawn = []
        for s in samplers:
            s.state = state
            drawn.append(s._host_sample())
        samples.append(drawn)
        sched5 = tuple(jnp.asarray(np.concatenate([d[0][i] for d in drawn]))
                       for i in range(5))
        rest = [jnp.asarray(np.concatenate([d[i] for d in drawn]))
                for i in range(1, 5)]
        state, m = jstep.vbpi_train_step(
            state, jv.statics, jv.optimizer, sched5, *rest, jnp.asarray(1.0),
            jv.tips, jv.weights, jv.segment_ids, evec, ivec, evals, freqs,
            props, Q)
        metrics.append([float(m["mean_ll"]), float(m["elbo_like"])])
    return state, np.array(metrics), samples


@pytest.mark.parametrize("trees,fasta,particles", [
    ("hello_out.t", "hello.fasta", 8),
    ("DS1.subsampled_10.t", "DS1.fasta", 10),
], ids=["hello", "ds1"])
def test_two_rank_vbpi_matches_jax(tmp_path, data_dir, trees, fasta,
                                   particles):
    """A two-process gloo job, JitVBPI(mesh=global_mesh()) for 3 f64
    steps: both ranks' state, Adam moments and metrics bit-identical; each
    rank's samples those of libsbn_tpu's host sampler seeded seed + 7919 r;
    the state and metrics within rtol 1e-9 / atol 1e-10 of libsbn_tpu's
    step on the concatenated samples. The same job's GP fit on the global
    mesh (each rank the whole fit) equals the one-process fit on both."""
    steps, seed = 3, 0
    ranks = run_ranks(tmp_path, 2, [
        "--trees", f"{data_dir}/{trees}", "--fasta", f"{data_dir}/{fasta}",
        "--particles", str(particles), "--steps", str(steps),
        "--seed", str(seed), "--gp-fasta", f"{data_dir}/five_taxon.fasta",
        "--gp-newick", f"{data_dir}/five_taxon_rooted.nwk"])
    r0, r1 = ranks
    assert str(r0["backend"]) == "gloo" and int(r0["world_size"]) == 2
    for key in r0:
        if key not in ("rank", "post_children", "branch_rep", "reps",
                       "touched", "eps", "launches"):
            assert np.array_equal(r0[key], r1[key]), key
    state, metrics, samples = _jax_replay(data_dir, trees, fasta, particles,
                                          2, steps, seed)
    for rank, got in enumerate(ranks):
        for step in range(steps):
            sched5, branch_rep, reps, touched, eps = samples[step][rank]
            for name, want in (("post_children", sched5[1]),
                               ("branch_rep", branch_rep), ("reps", reps),
                               ("touched", touched), ("eps", eps)):
                assert np.array_equal(got[name][step], want), (rank, name)
    np.testing.assert_allclose(r0["metrics"], metrics, rtol=RTOL, atol=ATOL)
    for name in ("q_params", "sbn_params"):
        np.testing.assert_allclose(r0[name], np.asarray(getattr(state, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    ref = GPInstance()
    ref.read_fasta_file(f"{data_dir}/five_taxon.fasta")
    ref.read_newick_file(f"{data_dir}/five_taxon_rooted.nwk")
    ref.make_engine(device="cpu")
    marginal, _ = ref.get_engine().run_branch_ascent(1e-8, 50)
    assert float(r0["gp_marginal"]) == marginal
    np.testing.assert_array_equal(r0["gp_branch_lengths"],
                                  ref.get_engine().branch_lengths)


def test_distributed_step_many_is_single_process(tmp_path, data_dir):
    """step_many and step_overlapped refuse a distributed mesh (as
    libsbn_tpu's assert one process); a one-rank job's step() equals the
    unsharded trainer's bit for bit (the all-reduces of one rank change
    nothing)."""
    script = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "import libsbn_tpu_torch as lt\n"
        "from libsbn_tpu_torch.parallel import distributed\n"
        "from libsbn_tpu_torch.vi import JitVBPI\n"
        "torch.set_num_threads(1)\n"
        "assert distributed.initialize(%r, 1, 0, device='cpu') is False\n"
        "def inst():\n"
        "    i = lt.UnrootedInstance('x')\n"
        "    i.read_nexus_file(%r); i.process_loaded_trees()\n"
        "    i.train_simple_average(); i.read_fasta_file(%r)\n"
        "    i.prepare_for_phylo_likelihood(lt.PhyloModelSpec(), device='cpu')\n"
        "    return i\n"
        "mesh = distributed.global_mesh(device='cpu')\n"
        "assert mesh.distributed and mesh.world_size == 1\n"
        "a = JitVBPI(inst(), 4, mesh=mesh, seed=1)\n"
        "b = JitVBPI(inst(), 4, seed=1)\n"
        "for what in ('step_many', 'step_overlapped'):\n"
        "    try:\n"
        "        getattr(a, what)(2) if what == 'step_many' else a.step_overlapped()\n"
        "        raise SystemExit(what + ' ran on a distributed mesh')\n"
        "    except RuntimeError as e:\n"
        "        assert 'single-process' in str(e)\n"
        "ma, mb = a.step(), b.step()\n"
        "assert all(torch.equal(ma[k], mb[k]) for k in ma)\n"
        "assert torch.equal(a.state.sbn_params, b.state.sbn_params)\n"
        "assert a.log_f_values(4).shape == (4,)\n"
        "print('ONE_RANK_OK', flush=True)\n"
        "torch.distributed.destroy_process_group()\n"
    ) % (REPO, f"file://{tmp_path}/store1", f"{data_dir}/hello_out.t",
         f"{data_dir}/hello.fasta")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=PROCESS_TIMEOUT_S, cwd=REPO)
    assert out.returncode == 0 and "ONE_RANK_OK" in out.stdout, out.stderr[-3000:]


def test_two_rank_log_f_values_are_global(tmp_path, data_dir):
    """Under a two-rank global mesh log_f_values(8) evaluates 4 particles
    a rank and hands both ranks all 8, in rank order: rank r's are the
    one-process values of a trainer seeded seed + 7919 r."""
    script = (
        "import sys, numpy as np, torch; sys.path.insert(0, %r)\n"
        "import libsbn_tpu_torch as lt\n"
        "from libsbn_tpu_torch.parallel import distributed\n"
        "from libsbn_tpu_torch.vi import JitVBPI\n"
        "torch.set_num_threads(1)\n"
        "assert distributed.initialize(device='cpu')\n"
        "def inst():\n"
        "    i = lt.UnrootedInstance('x')\n"
        "    i.read_nexus_file(%r); i.process_loaded_trees()\n"
        "    i.train_simple_average(); i.read_fasta_file(%r)\n"
        "    i.prepare_for_phylo_likelihood(lt.PhyloModelSpec(), device='cpu')\n"
        "    return i\n"
        "mesh = distributed.global_mesh(device='cpu')\n"
        "got = JitVBPI(inst(), 8, mesh=mesh, seed=3).log_f_values(8)\n"
        "want = np.concatenate([JitVBPI(inst(), 4, seed=3 + 7919 * r)"
        ".log_f_values(4) for r in range(2)])\n"
        "assert np.array_equal(got, want), (got, want)\n"
        "print('LOGF_OK', flush=True)\n"
        "torch.distributed.destroy_process_group()\n"
    ) % (REPO, f"{data_dir}/hello_out.t", f"{data_dir}/hello.fasta")
    env = dict(os.environ, LIBSBN_COORDINATOR=f"file://{tmp_path}/store2",
               LIBSBN_NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], cwd=REPO, text=True,
        env=dict(env, LIBSBN_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=PROCESS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "LOGF_OK" in out, out[-3000:]


# -- GP on an sp mesh -----------------------------------------------------------


def _gp_fit(cls, data_dir, mesh, **kw):
    inst = cls()
    inst.read_fasta_file(f"{data_dir}/five_taxon.fasta")
    inst.read_newick_file(f"{data_dir}/five_taxon_rooted.nwk")
    inst.make_engine(mesh=mesh, **kw)
    eng = inst.get_engine()
    marginal, sweeps = eng.run_branch_ascent(1e-8, 50)
    return marginal, sweeps, np.asarray(eng.branch_lengths), eng


@pytest.mark.parametrize("sp", [8, 3])
def test_gp_sp_mesh_matches_unsharded_and_jax(data_dir, sp):
    """five_taxon's 4 patterns over sp = 8 or 3 "cpu" devices (padded to 8
    or 6 with copies of the last pattern at weight 0): the fit within 1e-9
    of the unsharded fit in the marginal and rtol 1e-9 in the branch
    lengths, the same against libsbn_tpu's fit on its sp = 8 mesh (as
    tests/test_gp.py:343 fits); the likelihood rows after the fit as
    well."""
    mesh = sharding.make_mesh(sp, dp=1, sp=sp, devices=["cpu"] * sp)
    m1, s1, bl1, eng = _gp_fit(GPInstance, data_dir, mesh, device="cpu")
    assert [s.patterns for s in eng._shards] == [-(-4 // sp)] * sp
    assert len({s.device for s in eng._shards}) == 1
    m0, s0, bl0, ref = _gp_fit(GPInstance, data_dir, None, device="cpu")
    assert s1 == s0 and abs(m1 - m0) < 1e-9
    np.testing.assert_allclose(bl1, bl0, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(eng.get_per_gpcsp_log_likelihoods(),
                               ref.get_per_gpcsp_log_likelihoods(),
                               rtol=1e-10)
    mj, _, blj, _ = _gp_fit(JGPInstance, data_dir,
                            jsharding.make_mesh(8, dp=1, sp=8))
    assert abs(m1 - mj) < 1e-9
    np.testing.assert_allclose(bl1, blj, rtol=1e-9, atol=1e-12)


def test_gp_sp_mesh_kernel_route_twins(data_dir):
    """The kernel route's twins (K7 a shard, K8 once a sweep on the
    gathered rows) over sp = 3: the marginal within 1e-7 of the unsharded
    kernel route (f64, the GP gate of BASELINE.md: two golden sections
    agree on the objective, not on the minimiser), K7 populating each
    shard and K8 sweeping once per sweep."""
    from libsbn_tpu_torch.gp import engine_kernels

    mesh = sharding.make_mesh(3, dp=1, sp=3, devices=["cpu"] * 3)
    engine_kernels.reset_counters()
    m1, s1, _, _ = _gp_fit(GPInstance, data_dir, mesh, device="cpu",
                           use_kernels=True)
    calls = dict(engine_kernels.TWIN_CALLS)
    m0, s0, _, _ = _gp_fit(GPInstance, data_dir, None, device="cpu",
                           use_kernels=True)
    assert abs(m1 - m0) < 1e-7
    assert calls["golden_sweep"] == s1
    assert calls["populate_plvs"] % 3 == 0 and calls["populate_plvs"] > 3 * s1


def synthetic_engine(package, taxa, sites, seed=0, **kw):
    """A GP engine of ``package`` over one random rooted tree of ``taxa``
    leaves and a random alignment of ``sites`` columns, from
    default_rng(seed) as tests/test_torch_gp_streamed.py builds them."""
    rng = np.random.default_rng(seed)
    pool = [f"t{i}" for i in range(taxa)]
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        a, b = pool.pop(j), pool.pop(i)
        la, lb = rng.uniform(0.01, 0.2, 2)
        pool.append(f"({b}:{la:.4f},{a}:{lb:.4f})")
    rows = rng.choice(list("ACGT"), size=(taxa, sites))
    if package is libsbn_tpu:
        cls, nwk, aln = JGPInstance, jnewick, JAlignment
        tree, collection = JRootedTree, JRootedTreeCollection
    else:
        cls, nwk, aln = GPInstance, newick, Alignment
        tree, collection = RootedTree, RootedTreeCollection
    tops, bls, ttm = nwk.parse_newick_string(pool[0] + ";")
    inst = cls()
    inst.alignment = aln({f"t{i}": "".join(r) for i, r in enumerate(rows)})
    inst.tree_collection = collection(
        [tree(t, bl) for t, bl in zip(tops, bls)], ttm)
    inst.make_engine(**kw)
    return inst.get_engine()


def test_gp_sp_mesh_padded_on_a_deep_tree():
    """A 600-taxon tree with 203 patterns over sp = 8 (padded to 208): the
    port pads with copies of the last pattern, which keeps the level
    route's per-node log-scales finite, and its fit equals the unsharded
    one; libsbn_tpu pads with all-ones columns, which dwarf the real
    patterns' partials, and its fit on its sp = 8 mesh is not finite
    (the fault ROADMAP queue 3 lists)."""
    ref = synthetic_engine(libsbn_tpu_torch, 600, 203, device="cpu")
    m_ref, sweeps_ref = ref.run_branch_ascent(1e-2, 3)
    mesh = sharding.make_mesh(devices=CPU8, sp=8)
    eng = synthetic_engine(libsbn_tpu_torch, 600, 203, mesh=mesh)
    assert eng.patterns == 203 and eng._shards[0].patterns == 26
    m, sweeps = eng.run_branch_ascent(1e-2, 3)
    assert np.isfinite(m) and sweeps == sweeps_ref
    assert abs(m - m_ref) < 1e-9 * abs(m_ref)
    np.testing.assert_allclose(eng.branch_lengths, ref.branch_lengths,
                               rtol=1e-9, atol=1e-12)
    jeng = synthetic_engine(libsbn_tpu, 600, 203,
                            mesh=jsharding.make_mesh(8, dp=1, sp=8))
    assert jeng.patterns == 208
    assert not np.isfinite(jeng.run_branch_ascent(1e-2, 3)[0])
