"""The unrooted engine's packed path (models/unrooted_graph.py: what a card
captures and replays as one CUDA graph a call) on the CPU, against the
port's eager calls and against libsbn_tpu's f64 engine.

* ``UnrootedGraphs`` on a CPU engine runs each route's function over its
  packed buffers, as a card's capture does: "ll" (log_likelihoods),
  "bgrad" (branch_gradients) and "phylo" (phylo_gradients) against the
  eager calls bit for bit, for JC69, JC69 + Weibull+4, GTR and GTR +
  Weibull+4, float64 and float32, on DS1.100_topologies trees with branch
  lengths and parameters from a numpy seed; a second call with new inputs
  reads them; a new batch size is a new key, a new schedule object of the
  same shapes (other trees) is not;
* the same inputs through libsbn_tpu's LikelihoodEngine (its scan route
  on the CPU, as tests/test_torch_gtr.py runs it) at f64 rel 1e-10;
* per-tree parameters and rescale=False stay eager: the graphs are never
  consulted for them, and are for every other call.

"rel r" means |got - want| <= r (|want| + max |want|) elementwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.models.engine import LikelihoodEngine as JEngine

from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.models import unrooted_graph
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.models.phylo_model import params_from_numpy

from test_torch_rooted import assert_rel

torch.set_num_threads(2)

TREES = 4  # trees a batch
MODELS = {
    "jc69": ("JC69", "constant"),
    "jc69_weibull": ("JC69", "weibull+4"),
    "gtr": ("GTR", "constant"),
    "gtr_weibull": ("GTR", "weibull+4"),
}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _instance(package, data_dir, first, count):
    """An UnrootedInstance of ``package`` on ``count`` DS1.100_topologies
    trees from the ``first``-th, with DS1.fasta."""
    inst = package.UnrootedInstance("graphs")
    inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    inst.tree_collection.trees = inst.tree_collection.trees[
        first:first + count]
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    return inst


@pytest.fixture(scope="module")
def ds1(data_dir):
    """{(first, count): (port schedule, libsbn_tpu schedule)}, and the two
    packages' site patterns."""
    out, sps = {}, []
    for first, count in ((0, TREES), (TREES, TREES), (0, 3)):
        pi = _instance(libsbn_tpu_torch, data_dir, first, count)
        ji = _instance(libsbn_tpu, data_dir, first, count)
        out[(first, count)] = (pi._batched_schedule(), ji._batched_schedule())
        if not sps:
            sps = [cls(i.alignment, i.tree_collection.tag_taxon_map)
                   for cls, i in ((SitePattern, pi), (JSitePattern, ji))]
    return (out, *sps)


def _inputs(model, sched, seed):
    """(branch lengths (B, N), numpy parameters) from default_rng(seed):
    lengths U(0.01, 0.2) with the root slot 0; GTR exchangeabilities and
    frequencies from Dirichlet(20); a Weibull shape U(0.3, 1.5)."""
    rng = np.random.default_rng(seed)
    B = np.shape(sched.post_children)[0]
    bl = rng.uniform(0.01, 0.2, (B, sched.node_count))
    bl[:, -1] = 0.0
    sub, site = MODELS[model]
    params = {}
    if sub == "GTR":
        params["substitution"] = {
            "rates": rng.dirichlet(np.full(6, 20.0)),
            "frequencies": rng.dirichlet(np.full(4, 20.0))}
    if site != "constant":
        params["site"] = {"shape": rng.uniform(0.3, 1.5)}
    params["clock"] = {"rate": 1.0}
    return bl, params


def _port(params):
    return params_from_numpy(params, "cpu", torch.float64)


def _engine(sp, model, dtype=torch.float64, **kw):
    spec = libsbn_tpu_torch.PhyloModelSpec(*MODELS[model], "strict")
    return LikelihoodEngine(sp, spec, dtype=dtype, device="cpu", **kw)


def _flat(out):
    """A call's outputs as a list of tensors, a dict's in key order."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


def _bit_for_bit(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _calls(eng, graphs):
    """{route: (graph call, eager call)} of the three routes."""
    return {
        "ll": (graphs.log_likelihoods, eng.log_likelihoods),
        "bgrad": (graphs.branch_gradients, eng.branch_gradients),
        "phylo": (graphs.phylo_gradients, eng.phylo_gradients),
    }


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_packed_unrooted_calls_equal_eager(ds1, model, dtype):
    """UnrootedGraphs on the CPU (the function a card captures, over its
    packed buffers) against the eager call, bit for bit, for each route;
    a second call with new lengths and parameters reads them; another
    schedule object of the same shapes (four other trees) reuses the key;
    three trees are a new key, kept from its second call on."""
    scheds, sp, _ = ds1
    eng = _engine(sp, model, DTYPES[dtype])
    graphs = unrooted_graph.UnrootedGraphs(eng)
    sched = scheds[(0, TREES)][0]
    calls = _calls(eng, graphs)
    first = {}
    for seed in (0, 1):
        bl, params = _inputs(model, sched, seed)
        for route, (graph, eager) in calls.items():
            got = graph(sched, bl, _port(params))
            _bit_for_bit(got, eager(sched, bl, _port(params)))
            if seed == 0:
                first[route] = got
            else:
                assert not torch.equal(_flat(got)[0], _flat(first[route])[0])
    assert len(graphs.programs) == len(calls)
    other = scheds[(TREES, TREES)][0]
    assert not np.array_equal(other.post_children, sched.post_children)
    bl, params = _inputs(model, other, 2)
    for graph, eager in calls.values():
        _bit_for_bit(graph(other, bl, _port(params)),
                     eager(other, bl, _port(params)))
    assert len(graphs.programs) == len(calls)
    small = scheds[(0, 3)][0]
    bl, params = _inputs(model, small, 3)
    for n in (0, 1):  # the new key's first call keeps nothing, its second
        _bit_for_bit(graphs.phylo_gradients(small, bl, _port(params)),
                     eng.phylo_gradients(small, bl, _port(params)))
        assert len(graphs.programs) == len(calls) + n
    assert unrooted_graph.COUNTS["replays"] == 0  # no card, no replay


@pytest.mark.parametrize("model", sorted(MODELS))
def test_packed_unrooted_calls_match_jax(ds1, model):
    """The packed routes in f64 against libsbn_tpu's LikelihoodEngine on
    the same seeded inputs: LLs, branch gradients and every key of
    phylo_gradients at rel 1e-10."""
    scheds, sp, jsp = ds1
    sched, jsched = scheds[(0, TREES)]
    bl, params = _inputs(model, sched, 4)
    graphs = unrooted_graph.UnrootedGraphs(_engine(sp, model))
    jeng = JEngine(jsp, libsbn_tpu.PhyloModelSpec(*MODELS[model], "strict"))
    jparams = {g: {k: jnp.asarray(v) for k, v in d.items()}
               for g, d in params.items()}
    assert_rel(graphs.log_likelihoods(sched, bl, _port(params)),
               np.asarray(jeng.log_likelihoods(jsched, bl, jparams)), 1e-10,
               "LLs")
    got = graphs.branch_gradients(sched, bl, _port(params))
    want = jeng.branch_gradients(jsched, bl, jparams)
    for name, a, b in zip(("LLs", "branch gradients"), got, want):
        assert_rel(a, np.asarray(b), 1e-10, name)
    got = graphs.phylo_gradients(sched, bl, _port(params))
    want = jeng.phylo_gradients(jsched, bl, jparams)
    assert set(got) == set(want)
    for key in want:
        assert_rel(got[key], np.asarray(want[key]), 1e-10, key)


class _Refusing:
    """An engine's graphs that count the calls that consult them."""

    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def call(*args, **kw):
            self.calls += 1
            raise LookupError(f"graphs consulted: {name}")

        return call


def test_per_tree_and_no_rescale_stay_eager(ds1):
    """With graphs installed on a CPU engine, shared parameters with
    rescaling consult them for each call; per-tree parameter rows and
    rescale=False never do, and give what they give without graphs."""
    scheds, sp, _ = ds1
    sched = scheds[(0, TREES)][0]
    bl, params = _inputs("gtr_weibull", sched, 5)
    eng = _engine(sp, "gtr_weibull")
    rows = {g: {k: torch.stack([torch.as_tensor(np.asarray(v, np.float64))
                                * (1.0 + 0.01 * i) for i in range(TREES)])
                for k, v in d.items()} for g, d in params.items()}
    rows["substitution"] = {k: v / v.sum(-1, keepdim=True)
                            for k, v in rows["substitution"].items()}
    want_rows = {name: getattr(eng, name)(sched, bl, rows, per_tree=True)
                 for name in ("log_likelihoods", "branch_gradients",
                              "phylo_gradients")}
    eng.rescale = False
    want_scan = {name: getattr(eng, name)(sched, bl, _port(params))
                 for name in want_rows}
    refusing = _Refusing()
    eng.unrooted_graphs = refusing
    for name in want_rows:
        _bit_for_bit(getattr(eng, name)(sched, bl, _port(params)),
                     want_scan[name])
    eng.rescale = True
    for name in want_rows:
        _bit_for_bit(getattr(eng, name)(sched, bl, rows, per_tree=True),
                     want_rows[name])
    assert refusing.calls == 0
    for name in want_rows:
        with pytest.raises(LookupError, match="graphs consulted"):
            getattr(eng, name)(sched, bl, _port(params))
    assert refusing.calls == len(want_rows)


def test_engine_on_cpu_has_no_unrooted_graphs(ds1):
    """cuda_graphs is ignored on the CPU: the engine runs eagerly."""
    eng = _engine(ds1[1], "gtr")
    assert eng.unrooted_graphs is None and eng.graphs is None
