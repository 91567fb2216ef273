"""The port's profiling and CPU-baseline helpers (utils/profiling.py,
utils/cpu_baseline.py) against libsbn_tpu's, on the CPU.

* PhaseTimer and device_trace, as tests/test_api.py:223 holds
  libsbn_tpu's: synced phase times, and a trace written into a directory
  (here a Chrome trace that names the annotated span and the work in it).
* cpu_baseline.eval_batch and eval_batch_ll_pk on DS1: bit for bit equal to
  libsbn_tpu.utils.cpu_baseline's (the same native library), and within
  rel 1e-10 of the port's f64 K1 twin (LLs per tree, gradients relative to
  the largest |g|) and of its f64 K5 twin.
"""

import glob
import json

import numpy as np
import pytest
import torch

from libsbn_tpu.utils import cpu_baseline as jcpu_baseline
from libsbn_tpu.utils import profiling as jprofiling
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.ops import pruning, pruning_jc, pruning_vjp, schedule
from libsbn_tpu_torch.ops import substitution
from libsbn_tpu_torch.ops.site_model import weibull_rates
from libsbn_tpu_torch.utils import cpu_baseline, profiling

torch.set_num_threads(1)


def test_profiling_utilities(tmp_path):
    """PhaseTimer accumulates synced phase times; device_trace writes a
    Chrome trace into its directory that names the annotate span and the
    matmul inside it."""
    timer = profiling.PhaseTimer(sync=True)
    x = torch.ones((200, 200))
    for _ in range(3):
        y = timer.time_fn("matmul", lambda: x @ x)
    assert timer.counts["matmul"] == 3
    assert timer.total("matmul") > 0
    assert "matmul" in timer.report()
    with timer.phase("noop", result=y):
        pass
    assert timer.mean("noop") is not None
    assert timer.mean("absent") is None and timer.total("absent") == 0.0
    assert set(timer.totals) == {"matmul", "noop"}

    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir):
        with profiling.annotate("span"):
            x @ x
    traces = glob.glob(f"{logdir}/trace_*.json")
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "span" in names and any("mm" in str(n) for n in names)


@pytest.mark.parametrize("module", ["profiling", "cpu_baseline"])
def test_name_table_covers_the_jax_module(module):
    """tests/test_torch_api_names.py's table for utils.<module> holds every
    public function and class libsbn_tpu's module defines."""
    import importlib
    import inspect

    from test_torch_api_names import PARALLEL_SURFACE

    jmod = importlib.import_module(f"libsbn_tpu.utils.{module}")
    defined = {name for name, obj in inspect.getmembers(jmod, callable)
               if getattr(obj, "__module__", None) == jmod.__name__
               and not name.startswith("_")}
    assert defined == set(PARALLEL_SURFACE[f"utils.{module}"])


def test_phase_timer_report_matches_jax():
    """The same phases give the same report layout as libsbn_tpu's."""
    ours, theirs = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for timer in (ours, theirs):
        for name, seconds in (("b", 0.002), ("a", 0.001), ("b", 0.004)):
            timer.totals[name] = timer.totals.get(name, 0.0) + seconds
            timer.counts[name] = timer.counts.get(name, 0) + 1
    assert ours.report() == theirs.report()
    assert ours.mean("b") == theirs.mean("b") == 0.003


def test_block_until_ready_walks_nested_results():
    """block_until_ready returns its argument, nested tensors and all, and
    accepts results that hold no tensor."""
    out = {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}
    assert profiling.block_until_ready(out) is out
    assert profiling.block_until_ready(None) is None


@pytest.fixture(scope="module")
def ds1(data_dir):
    """DS1.subsampled_10 with branch lengths x U(0.8, 1.2) from a seed, by
    node id with the root and ones slots zero (the baseline's layout, as
    bench.py:848-851 builds it), and the schedule."""
    tops, bls, ttm = newick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    sched = schedule.schedules_of_topologies(tops)
    bl = np.stack(bls) * np.random.default_rng(5).uniform(0.8, 1.2,
                                                          (len(bls), 1))
    bl_node = np.pad(bl, ((0, 0), (0, 1)))
    bl_node[:, sched.root_id] = 0.0
    return {"sched": sched, "bl": bl_node, "tips": sp.tip_partials(),
            "w": sp.weights, "L": sp.tip_partials().shape[0]}


def _eval_args(d):
    s = d["sched"]
    return (s.post_children, s.up_node, s.up_parent, s.up_sibs, d["bl"],
            d["tips"], d["w"], d["L"])


@pytest.mark.parametrize("bits,ll_only", [(64, False), (32, False),
                                          (64, True)])
def test_eval_batch_matches_jax_bit_for_bit(ds1, bits, ll_only):
    """The port's binding gives libsbn_tpu's binding's numbers exactly: the
    same library on the same inputs; CPU tensors are taken as their
    arrays."""
    args = _eval_args(ds1)
    ll, g = cpu_baseline.eval_batch(*args, threads=1, dtype_bits=bits,
                                    ll_only=ll_only)
    jll, jg = jcpu_baseline.eval_batch(*args, threads=1, dtype_bits=bits,
                                       ll_only=ll_only)
    assert np.array_equal(ll, jll) and ll.shape == (10,)
    assert (g is None) == (jg is None) == ll_only
    if not ll_only:
        assert np.array_equal(g, jg)
    tensors = [torch.as_tensor(np.asarray(a)) for a in args[:-1]]
    ll_t, _ = cpu_baseline.eval_batch(*tensors, args[-1], threads=1,
                                      dtype_bits=bits, ll_only=True)
    assert np.array_equal(ll_t, jll)


def test_eval_batch_matches_k1_f64(ds1):
    """At dtype_bits=64 the baseline agrees with the port's f64 K1 (the
    twin here) within rel 1e-10: LLs per tree, gradients relative to the
    largest |g|."""
    ll, g = cpu_baseline.eval_batch(*_eval_args(ds1), threads=1)
    s = ds1["sched"]
    r = s.root_id
    want_ll, want_g = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        torch.as_tensor(s.post_children, dtype=torch.int32),
        torch.as_tensor(ds1["bl"]), torch.as_tensor(ds1["tips"]),
        torch.as_tensor(ds1["w"]), root_id=r)
    np.testing.assert_allclose(ll, want_ll.numpy(), rtol=1e-10, atol=0)
    want_g = want_g.numpy()
    assert g.shape == (10, r + 1)
    assert np.max(np.abs(g[:, :r] - want_g)) <= 1e-10 * np.abs(want_g).max()


def test_eval_batch_ll_pk_matches_jax_and_k5(ds1):
    """eval_batch_ll_pk (GTR + Weibull+4 transition matrices) equals
    libsbn_tpu's binding bit for bit and the port's f64 K5 twin within rel
    1e-10 per tree; shapes it cannot take raise."""
    s = ds1["sched"]
    rates6 = torch.tensor([0.1, 0.2, 0.15, 0.25, 0.2, 0.1], dtype=torch.float64)
    freqs = torch.tensor([0.3, 0.25, 0.2, 0.25], dtype=torch.float64)
    evec, ivec, evals = substitution.gtr_eigen(rates6, freqs)[1:]
    cat_rates, props = weibull_rates(0.7, 4)
    P = pruning.node_transition_matrices(
        evec, ivec, evals, torch.as_tensor(ds1["bl"]), cat_rates)
    args = (s.post_children, P.numpy(), ds1["tips"], ds1["w"],
            props.numpy(), freqs.numpy(), ds1["L"])
    ll = cpu_baseline.eval_batch_ll_pk(*args, threads=1)
    assert np.array_equal(ll, jcpu_baseline.eval_batch_ll_pk(*args, threads=1))
    want = pruning_vjp.log_likelihoods_generic(
        torch.as_tensor(s.post_children, dtype=torch.int32), P,
        torch.as_tensor(ds1["tips"]), freqs, props, torch.as_tensor(ds1["w"]),
        root_id=s.root_id)
    np.testing.assert_allclose(ll, want.numpy(), rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match="props"):
        cpu_baseline.eval_batch_ll_pk(*args[:4], np.ones(3), *args[5:])
    with pytest.raises(ValueError, match="up_node"):
        bad = list(_eval_args(ds1))
        bad[1] = bad[1][:, :-1]
        cpu_baseline.eval_batch(*bad)
