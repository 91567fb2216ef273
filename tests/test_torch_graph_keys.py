"""What the engine's captured keys keep (utils/graphs.py PackedPrograms), on
the CPU, where a Graph calls its function as is over the same buffers:

* a key's first call keeps no program and its second keeps one, for every
  unrooted route (models/unrooted_graph.py) and rooted route
  (models/rooted_graph.py), each call equal to the eager call bit for bit;
* keys called in turns (A, B, A, B) with new inputs each time equal their
  eager calls bit for bit;
* a replay's int32 copy is skipped for the schedule object of the key's
  last call and taken for a new object with equal arrays, and for a new
  object (other trees) at the address of a freed one;
* a key whose first call launched a slab route stays eager; the record of
  keys seen once is capped at SEEN_CAP, oldest first.
"""

import dataclasses

import numpy as np
import pytest
import torch

import libsbn_tpu_torch
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.models import rooted_graph, unrooted_graph
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


def _counted_programs(slab):
    """A PackedPrograms on the CPU whose function adds one to the "k" or
    the "k_slab" launch count, as a kernel wrapper does on a card."""
    launches = {"k": 0, "k_slab": 0}
    counts = {"captures": 0, "replays": 0}
    progs = graphs_mod.PackedPrograms("cpu", [launches], counts)

    def make(ints, floats):
        def fn():
            launches["k_slab" if slab else "k"] += 1
            return floats[0] * 2
        return fn

    return progs, make, launches


@pytest.mark.parametrize("slab", [False, True], ids=["on_chip", "slab"])
def test_slab_key_stays_eager(slab):
    """A key whose first call launched a slab route is never kept; any other
    is kept from its second call. Every call returns the function's value."""
    progs, make, launches = _counted_programs(slab)
    for n in range(3):
        x = np.full(3, float(n))
        out = progs.run("key", [np.zeros(2, np.int64)], [x], make)
        assert torch.equal(out, torch.as_tensor(2 * x))
        assert len(progs) == (0 if slab else min(n, 1))
    assert sum(launches.values()) == 3
    assert dict(progs.seen) == ({(("key"), ((2,),), ((3,),)): "eager"}
                                if slab else {})


def test_seen_record_is_capped():
    """SEEN_CAP keys called once are remembered, the oldest forgotten first:
    a forgotten key's next call is a first call again (not kept)."""
    progs, make, _ = _counted_programs(False)
    cap = graphs_mod.SEEN_CAP
    for i in range(cap + 1):
        progs.run(("key", i), [], [np.zeros(1)], make)
    assert len(progs.seen) == cap and len(progs) == 0
    progs.run(("key", 0), [], [np.zeros(1)], make)  # forgotten: seen again
    assert len(progs) == 0
    progs.run(("key", cap), [], [np.zeros(1)], make)  # remembered: kept
    assert len(progs) == 1
