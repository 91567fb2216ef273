"""The port's spans (utils/profiling.py ``annotate``) on the CPU:

* with no profiler running, ``annotate`` returns one shared context that
  does nothing and never calls ``torch.profiler.record_function``; under a
  profiler it records the span;
* an engine call by its packed program (models/unrooted_graph.py on a CPU
  engine, where a Graph calls its function as is) opens
  ``libsbn.engine.call`` and inside it, in order,
  ``libsbn.engine.model_inputs``, ``libsbn.graphs.pack``,
  ``upload_ints`` (only for a schedule object other than the last call's),
  ``upload_floats``, ``replay`` and ``libsbn.engine.clone``, one upload
  span a counted upload; a key's first call opens ``eager``;
* a ``JitVBPI.step_many`` window opens ``libsbn.vbpi.sample``, ``lower``,
  ``pack`` and ``params_copy``, one ``lower_miss`` a cache miss (native
  and Python samplers), and
  ``ARTIFACTS`` counts every lowering as a hit or a miss;
* the outputs are bit for bit the same with the profiler on and off.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libsbn_tpu_torch
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.io import native
from libsbn_tpu_torch.models import unrooted_graph
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.utils import profiling
from libsbn_tpu_torch.vi import jit_step
from libsbn_tpu_torch.vi.jit_step import JitVBPI

torch.set_num_threads(2)

TREES = 4
CALL = "test.call"
ENGINE_ORDER = ["libsbn.engine.model_inputs", "libsbn.graphs.pack",
                "libsbn.graphs.upload_ints", "libsbn.graphs.upload_floats",
                "libsbn.graphs.replay", "libsbn.engine.clone"]


def _spans(prof):
    """[(name, start, end)] of the profiled block's spans named libsbn.* or
    CALL, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith("libsbn.") or e.name == CALL),
                  key=lambda s: s[1])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _calls(spans):
    """The libsbn spans inside each CALL span, in order: [[(name, start,
    end)], ...]."""
    calls = [(s, e) for n, s, e in spans if n == CALL]
    return [[x for x in spans if x[0] != CALL and lo <= x[1] and x[2] <= hi]
            for lo, hi in calls]


def test_annotate_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second
    with first:
        with second:
            pass


def test_annotate_records_under_a_profiler():
    def block():
        with profiling.annotate("libsbn.test"):
            torch.ones(2).sum()

    _, spans = _profiled(block)
    assert [n for n, _, _ in spans] == ["libsbn.test"]


@pytest.fixture(scope="module")
def ds1_gtr(data_dir):
    """A float64 GTR engine on the CPU over DS1.fasta, three schedule
    objects of DS1.100_topologies' first trees (equal arrays), branch
    lengths and parameters."""
    inst = libsbn_tpu_torch.UnrootedInstance("tracing")
    inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    inst.tree_collection.trees = inst.tree_collection.trees[:TREES]
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    sp = SitePattern(inst.alignment, inst.tree_collection.tag_taxon_map)
    scheds = [inst._batched_schedule() for _ in range(3)]
    spec = libsbn_tpu_torch.PhyloModelSpec("GTR", "constant", "strict")
    eng = LikelihoodEngine(sp, spec, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    bl = rng.uniform(0.01, 0.2, (TREES, scheds[0].node_count))
    bl[:, -1] = 0.0
    f64 = torch.float64
    params = {"substitution": {
        "rates": torch.tensor(rng.dirichlet(np.full(6, 20.0)), dtype=f64),
        "frequencies": torch.tensor(rng.dirichlet(np.full(4, 20.0)),
                                    dtype=f64)}}
    return eng, scheds, bl, params


def _engine_calls(graphs, scheds, bl, params):
    """One branch_gradients call a schedule, each inside a CALL span."""
    outs = []
    for sched in scheds:
        with torch.profiler.record_function(CALL):
            outs.append(graphs.branch_gradients(sched, bl, params))
    return outs


def test_engine_call_spans_in_order(ds1_gtr):
    eng, (a, b, c), bl, params = ds1_gtr
    graphs = unrooted_graph.UnrootedGraphs(eng)
    # The key's first call runs eagerly; its second makes the program.
    (first,), spans = _profiled(lambda: _engine_calls(graphs, [a], bl,
                                                      params))
    assert "libsbn.graphs.eager" in [n for n, _, _ in spans]
    assert "libsbn.graphs.replay" not in [n for n, _, _ in spans]
    _engine_calls(graphs, [a], bl, params)
    assert len(graphs.programs) == 1

    uploads = dict(graphs.programs.uploads)
    outs, spans = _profiled(lambda: _engine_calls(graphs, [b, b], bl,
                                                  params))
    calls = _calls(spans)
    assert [[n for n, _, _ in call] for call in calls] == [
        ["libsbn.engine.call"] + ENGINE_ORDER,
        ["libsbn.engine.call"] + [n for n in ENGINE_ORDER
                                  if not n.endswith("ints")]]
    for (_, lo, hi), *call in calls:
        # Inside the call's span, one after another.
        assert all(lo <= s and e <= hi for _, s, e in call)
        assert all(x[2] <= y[1] for x, y in zip(call, call[1:]))
    assert graphs.programs.uploads == {"ints": uploads["ints"] + 1,
                                       "floats": uploads["floats"] + 2}

    _, spans = _profiled(lambda: _engine_calls(graphs, [c], bl, params))
    assert [n for n, _, _ in spans].count("libsbn.graphs.upload_ints") == 1
    assert graphs.programs.uploads["ints"] == uploads["ints"] + 2

    # The profiler changes nothing of what is computed.
    quiet = _engine_calls(graphs, [b], bl, params)[0]
    for got in (first, outs[0], outs[1]):
        for x, y in zip(got, quiet):
            assert torch.equal(x, y)


def _trainer(data_dir, seed):
    inst = libsbn_tpu_torch.UnrootedInstance("tracing")
    inst.read_nexus_file(f"{data_dir}/hello_out.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{data_dir}/hello.fasta")
    inst.prepare_for_phylo_likelihood(libsbn_tpu_torch.PhyloModelSpec(),
                                      device="cpu")
    return JitVBPI(inst, particle_count=4, seed=seed)


@pytest.mark.parametrize("route", ["native", "python"])
def test_step_many_spans_and_artifact_counts(data_dir, monkeypatch, route):
    if route == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    K, P = 3, 4
    traced, quiet = _trainer(data_dir, 5), _trainer(data_dir, 5)
    jit_step.reset_counters()
    got, spans = _profiled(lambda: traced.step_many(K))
    assert traced.last_sampler == route
    names = [n for n, _, _ in spans]
    assert names.count("libsbn.vbpi.sample") == 1
    assert names.count("libsbn.vbpi.lower") == 1
    assert names.count("libsbn.vbpi.pack") == 2  # the draws, the buffers
    # The start parameters' copy (the trainer's first window), then the
    # window's own.
    assert names.count("libsbn.vbpi.params_copy") == 2
    counts = dict(jit_step.ARTIFACTS)
    assert counts["hits"] + counts["misses"] == K * P
    assert counts["misses"] >= 1
    assert names.count("libsbn.vbpi.lower_miss") == counts["misses"]
    # Each miss is lowered inside the window's lowering span.
    (lower,) = [s for s in spans if s[0] == "libsbn.vbpi.lower"]
    assert all(lower[1] <= s <= e <= lower[2] for n, s, e in spans
               if n == "libsbn.vbpi.lower_miss")

    want = quiet.step_many(K)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for x, y in zip(jit_step.step_graph.leaves(traced.state),
                    jit_step.step_graph.leaves(quiet.state)):
        assert torch.equal(x, y)
    jit_step.reset_counters()
    assert jit_step.ARTIFACTS == {"hits": 0, "misses": 0}
