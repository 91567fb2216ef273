"""What the captured keys keep (utils/graphs.py KeyedPrograms and
PackedPrograms), on the CPU, where a Graph calls its function as is over
the same buffers:

* a key's first call keeps no program and its second keeps one, for every
  unrooted route (models/unrooted_graph.py) and rooted route
  (models/rooted_graph.py), each call equal to the eager call bit for bit;
* keys called in turns (A, B, A, B) with new inputs each time equal their
  eager calls bit for bit;
* a replay's int32 copy is skipped for the schedule object of the key's
  last call and taken for a new object with equal arrays, and for a new
  object (other trees) at the address of a freed one;
* the capture policy's rules through each keyed cache (the engines'
  PackedPrograms, a streamed chunk program, ForestGraphs and
  HybridGraphs), over a fake counted function: first call eager and kept
  from the second; a slab key stays eager; the record of keys seen once
  capped at SEEN_CAP, oldest first; a program that raises kept by no key.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import libsbn_tpu_torch
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.gp import engine_kernels, hybrid_graph, streamed_graph
from libsbn_tpu_torch.models import rooted_graph, unrooted_graph
from libsbn_tpu_torch.ops import forest_graph
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.utils import graphs as graphs_mod

from test_torch_rooted_graph import _instances, _port_parts
from test_torch_unrooted_graph import (
    MODELS, _bit_for_bit, _calls, _inputs, _port,
)

torch.set_num_threads(2)

TREES = 4


def _schedules(data_dir):
    """(site patterns, schedules of DS1.100_topologies' trees 0-3 and 4-7)."""
    inst = libsbn_tpu_torch.UnrootedInstance("keys")
    inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    trees = inst.tree_collection.trees
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    sp = SitePattern(inst.alignment, inst.tree_collection.tag_taxon_map)
    out = []
    for first in (0, TREES):
        inst.tree_collection.trees = trees[first:first + TREES]
        out.append(inst._batched_schedule())
    return sp, out


@pytest.fixture(scope="module")
def ds1(data_dir):
    return _schedules(data_dir)


def _engine(sp, model, dtype=torch.float64):
    spec = libsbn_tpu_torch.PhyloModelSpec(*MODELS[model], "strict")
    return LikelihoodEngine(sp, spec, dtype=dtype, device="cpu")


@pytest.mark.parametrize("route", ["ll", "bgrad", "phylo"])
@pytest.mark.parametrize("model", ["jc69_weibull", "gtr"])
def test_unrooted_key_kept_from_its_second_call(ds1, model, route):
    """The route's first call keeps no program (the key is only seen), its
    second keeps one, its third reuses it; each equals the eager call bit
    for bit, at new inputs each call."""
    sp, (sched, _) = ds1
    eng = _engine(sp, model)
    graphs = unrooted_graph.UnrootedGraphs(eng)
    graph, eager = _calls(eng, graphs)[route]
    for n, kept in enumerate((0, 1, 1)):
        bl, params = _inputs(model, sched, n)
        _bit_for_bit(graph(sched, bl, _port(params)),
                     eager(sched, bl, _port(params)))
        assert len(graphs.programs) == kept
        assert len(graphs.programs.seen) == 1 - kept


@pytest.mark.parametrize("route", ["ll", "hand", "autograd"])
def test_rooted_key_kept_from_its_second_call(data_dir, route):
    """The rooted LLs, hand route and autograd route: the first call keeps
    no program, the second keeps one; each equals the eager call bit for
    bit."""
    model = "gtr" if route == "autograd" else "jc69"
    _, pi = _instances(data_dir, model, torch.float64)
    eng = pi.engine
    graphs = rooted_graph.RootedGraphs(eng)
    sched, bounds, ratios, rates = _port_parts(pi, batch=4)
    params = pi.phylo_model_params
    for kept in (0, 1, 1):
        args = (sched, bounds, ratios, rates, params)
        if route == "ll":
            got = graphs.log_likelihoods(*args)
            want = eng.rooted_log_likelihoods(*args, return_parts=True)
        else:
            got = graphs.phylo_gradients(*args, True, route)
            want = (eng._rooted_phylo_gradients_hand(*args, True)
                    if route == "hand" else
                    eng._rooted_phylo_gradients_autograd(*args, True))
        _bit_for_bit(got, want)
        assert len(graphs.programs) == kept
        ratios = ratios.copy()
        ratios[:, :-1] *= 0.99


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_interleaved_keys_equal_eager(ds1, dtype):
    """Two keys of one engine (branch_gradients at 4 and at 3 trees) called
    in turns A, B, A, B, A, B with new lengths each call: each call equals
    the eager call bit for bit, and both keys are kept from their second
    call."""
    sp, (sched, _) = ds1
    small = dataclasses.replace(
        sched, **{f.name: getattr(sched, f.name)[:3]
                  for f in dataclasses.fields(sched)
                  if isinstance(getattr(sched, f.name), np.ndarray)})
    eng = _engine(sp, "jc69_weibull", dtype)
    graphs = unrooted_graph.UnrootedGraphs(eng)
    for n in range(6):
        s = (sched, small)[n % 2]
        bl, params = _inputs("jc69_weibull", s, n)
        _bit_for_bit(graphs.branch_gradients(s, bl, _port(params)),
                     eng.branch_gradients(s, bl, _port(params)))
        assert len(graphs.programs) == min(2, max(0, n - 1))


def test_int_copy_skipped_for_a_repeated_schedule(ds1):
    """After the capture, a call with the last call's schedule object copies
    its floats and not its ints; a new object with equal arrays copies
    both, as does the first object again; every call equals eager."""
    sp, (sched, _) = ds1
    eng = _engine(sp, "jc69")
    graphs = unrooted_graph.UnrootedGraphs(eng)
    uploads = graphs.programs.uploads
    bl, params = _inputs("jc69", sched, 0)
    same = dataclasses.replace(sched)
    steps = [(sched, 1), (sched, 1), (sched, 0), (sched, 0), (same, 1),
             (same, 0), (sched, 1)]
    for s, copied in steps:
        ints, floats = uploads["ints"], uploads["floats"]
        _bit_for_bit(graphs.log_likelihoods(s, bl, _port(params)),
                     eng.log_likelihoods(s, bl, _port(params)))
        assert (uploads["ints"] - ints, uploads["floats"] - floats) == (
            copied, 1)


def test_recycled_address_copies_anew(ds1):
    """A schedule object freed after the key's last call, and a new one
    (other trees) made at its address: the next call copies the new ints
    and equals the eager call bit for bit (an id() in place of the weak
    reference would have replayed the old trees)."""
    sp, (sched, other) = ds1
    eng = _engine(sp, "jc69")
    graphs = unrooted_graph.UnrootedGraphs(eng)
    uploads = graphs.programs.uploads
    bl, params = _inputs("jc69", sched, 0)
    old = dataclasses.replace(sched)
    for _ in range(2):  # the first call and the capture
        graphs.log_likelihoods(old, bl, _port(params))
    address = id(old)
    del old  # freed here: nothing else refers to it
    made = []
    for _ in range(200):
        made.append(dataclasses.replace(other))
        if id(made[-1]) == address:
            break
    new = made[-1]
    assert id(new) == address, "no object was made at the freed address"
    assert not np.array_equal(new.post_children, sched.post_children)
    ints = uploads["ints"]
    _bit_for_bit(graphs.log_likelihoods(new, bl, _port(params)),
                 eng.log_likelihoods(new, bl, _port(params)))
    assert uploads["ints"] == ints + 1


class _Owner:
    """One keyed cache of the port on the CPU, driven through its own entry
    point over a fake counted function f(x) = 2 x, which adds one to the
    "k" or (``slab``) the "k_slab" launch count of the cache's counters, as
    a kernel wrapper does on a card, and raises while ``fail`` is set.
    ``call(i, x)`` runs key i at x and returns f's value there; ``policy``
    is the cache's KeyedPrograms; ``launched()`` f's launches so far."""

    def __init__(self, which, monkeypatch, slab=False):
        self.fail = False
        self.launches = {"k": 0, "k_slab": 0}
        self.name = "k_slab" if slab else "k"

        def counted(x):
            if self.fail:
                raise RuntimeError("capture failed")
            self.launches[self.name] += 1
            return x * 2

        if which == "packed":
            counts = {"captures": 0, "replays": 0, "eager": 0}
            self.policy = progs = graphs_mod.PackedPrograms(
                "cpu", [self.launches], counts)

            def make(ints, floats):
                return lambda: counted(floats[0])

            self.call = lambda i, x: float(progs.run(
                ("key", i), [np.zeros(2, np.int64)], [np.full(3, x)],
                make)[0])
        elif which == "streamed":
            engine_kernels.reset_counters()
            streamed_graph.reset_counters()
            self.launches = engine_kernels.LAUNCHES
            self.name = "populate_plvs" + ("_slab" if slab else "")
            monkeypatch.setattr(streamed_graph, "chunk_obj",
                                lambda u, A, B, w: counted(u))
            eng = SimpleNamespace(device=torch.device("cpu"),
                                  dtype=torch.float64, q=np.ones(3),
                                  branch_lengths=np.ones(3))
            sg = streamed_graph.StreamedGraphs(
                eng, np.zeros((2, 3, 2)), np.zeros((1, 2, 4, 2)),
                np.ones((1, 2)))
            self.policy = sg.programs
            # One chunk: one call of the objective program a pass.
            self.call = lambda i, x: float(sg.obj(np.full(3, x))[0])
        elif which == "forest":
            forest_graph.reset_counters()
            monkeypatch.setattr(forest_graph, "eager",
                                lambda surface, fs, b, *rest: counted(b))
            graphs = forest_graph.ForestGraphs(
                torch.zeros(4, 4, 2), torch.ones(2), device="cpu")
            self.policy = graphs.programs
            fs = object()
            # The key holds the lengths' shape: one shape a key.
            self.call = lambda i, x: float(graphs.run(
                "ll", fs, torch.full((i + 1,), x))[0])
        else:
            hybrid_graph.reset_counters()
            monkeypatch.setattr(hybrid_graph, "hybrid_chunk",
                                lambda *a: counted(a[-1][:, 0].double()))
            f64 = dict(dtype=torch.float64)
            eng = SimpleNamespace(
                device=torch.device("cpu"), dtype=torch.float64,
                plvs={key: torch.zeros((3,) if key.startswith("ls_")
                                       else (3, 4, 2), **f64)
                      for key in hybrid_graph.PLV_KEYS},
                branch_lengths=np.ones(2), q=np.ones(2),
                inverted_sbn_prior=np.ones(2),
                unconditional_node_probabilities=np.ones(3),
                _w=torch.ones(2, **f64), _tensor=torch.as_tensor)
            graphs = hybrid_graph.HybridGraphs(eng)
            self.policy = graphs.programs
            # The key holds the chunk's rows: i + 1 rows, one chunk.
            self.call = lambda i, x: graphs.run(
                np.full((i + 1, 10), int(x), np.int64), 4096)[0]

    def launched(self):
        return self.launches[self.name]


POLICY_CASES = [
    ("packed", "kept"), ("streamed", "kept"), ("forest", "kept"),
    ("hybrid", "kept"),
    # Only the engines' and the streamed programs' functions launch counted
    # kernels with a slab route; the forest and hybrid programs are torch
    # ops and count none.
    ("packed", "slab"), ("streamed", "slab"),
    # The streamed programs are three fixed keys, too few to reach the cap.
    ("packed", "capped"), ("forest", "capped"), ("hybrid", "capped"),
    ("packed", "raises"), ("streamed", "raises"), ("forest", "raises"),
    ("hybrid", "raises"),
]


@pytest.mark.parametrize("owner,rule", POLICY_CASES)
def test_capture_policy(owner, rule, monkeypatch):
    """utils/graphs.py KeyedPrograms' rules through each keyed cache, on the
    CPU, where a kept program is a plain call:

    * kept: a key's first call runs eagerly and keeps nothing; its second
      keeps the program, which its third reuses;
    * slab: a key whose first call launched a slab route is never kept;
    * capped: SEEN_CAP keys called once are remembered, the oldest
      forgotten first: a forgotten key's next call is a first call again
      (not kept), a remembered key's keeps its program;
    * raises: a second call whose program raises keeps nothing, and the key
      starts over: its next call is eager again, the one after kept.

    Every call that returns gives the function's value and counts one
    launch."""
    o = _Owner(owner, monkeypatch, slab=rule == "slab")
    policy = o.policy
    if rule in ("kept", "slab"):
        for n in range(3):
            assert o.call(0, float(n)) == 2 * n
            assert len(policy) == (0 if rule == "slab" else min(n, 1))
        assert o.launched() == 3
        assert policy.counts == {"captures": 0, "replays": 0,
                                 "eager": 3 if rule == "slab" else 1}
        assert list(policy.seen.values()) == ([True] if rule == "slab"
                                              else [])
    elif rule == "capped":
        cap = graphs_mod.SEEN_CAP
        for i in range(cap + 1):
            assert o.call(i, 1.0) == 2
        assert len(policy.seen) == cap and len(policy) == 0
        o.call(0, 1.0)  # forgotten: seen again
        assert len(policy) == 0
        o.call(cap, 1.0)  # remembered: kept
        assert len(policy) == 1
        assert policy.counts["eager"] == cap + 2
        assert o.launched() == cap + 3
    else:
        o.call(0, 1.0)
        o.fail = True
        with pytest.raises(RuntimeError, match="capture failed"):
            o.call(0, 1.0)
        assert len(policy) == 0 and not policy.seen
        o.fail = False
        for n, kept in ((2, 0), (3, 1)):
            assert o.call(0, float(n)) == 2 * n
            assert len(policy) == kept
        assert policy.counts["eager"] == 2 and o.launched() == 3
