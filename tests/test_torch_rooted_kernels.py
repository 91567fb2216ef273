"""The heights kernels' twins and their route, on the CPU.

The rooted hand route runs the heights sweeps and their adjoint through
ops/heights.py ``forward`` and ``adjoint``: two kernels on a card
(csrc/heights.cu), their twins ``forward_plain`` and ``adjoint_plain`` on
the CPU, in the kernels' order of operations. Here:

* the twins against today's torch functions (node_heights_from_ratios,
  branch_lengths_from_heights, ratio_and_rate_gradients_from_branch_
  gradient and the engine's rounding), f64 and f32 working dtypes: the
  heights and K1's operand bit for bit; the ratio and clock gradients at
  rel 1e-12 in f64 and within one f32 rounding (rel 2**-23) in f32; on
  fluA tiled with perturbed ratios, on random rooted trees over fluA's
  taxa, and on a caterpillar whose depth is the sweep count;
* the kernels' route by tree size (``tree_bytes``): shared memory up to
  SHARED_LIMIT, a slab per tree past it; the engine's rule: the hand
  route with the sweeps runs the twins on the CPU, ``squaring``, the
  autograd route and the rooted LLs the torch functions; the wrappers
  refuse CPU tensors and what no launch can take;
* the engine's hand route on the twins: one forward and one adjoint a
  call, 2 n_iters sweeps, the packed path (models/rooted_graph.py) equal
  to the eager call, and the gradient dict as with today's torch
  functions in the twins' place (LL and model gradients bit for bit).

"rel r" means |got - want| <= r (|want| + max |want|) elementwise.
"""

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.core.topology import Topology
from libsbn_tpu_torch.models import rooted_graph
from libsbn_tpu_torch.ops import heights, schedule

from test_torch_rooted import CLOCK_RATE, _instances, _port_parts, assert_rel
from test_torch_rooted_graph import _random_topology

torch.set_num_threads(2)

DTYPES = {"f64": torch.float64, "f32": torch.float32}
CASES = ("fluA", "random", "caterpillar")


@pytest.fixture(scope="module")
def flua(data_dir):
    """The port's fluA instances (f64 and f32 engines, JC69 and
    Weibull+4), by (model, dtype name)."""
    return {(model, name): _instances(data_dir, model, dtype)[1]
            for model in ("jc69", "weibull")
            for name, dtype in DTYPES.items()}


def _caterpillar(L):
    top = Topology.leaf(0)
    for i in range(1, L):
        top = Topology.join2(top, Topology.leaf(i))
    top.polish()
    return top


def _time_trees(tops, tip_dates, seed):
    """(schedule, bounds, ratios, rates) of rooted topologies over the
    tips: each internal node's bound the largest below it, ratios U(0.2,
    0.8), the root height 5 above its bound, clock rates CLOCK_RATE x
    U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    sched = schedule.schedules_of_topologies(tops)
    B, n, L = len(tops), sched.node_count, sched.leaf_count
    bounds = np.zeros((B, n))
    bounds[:, :L] = tip_dates
    for step in range(sched.post_node.shape[1]):
        for i in range(B):
            kids = [int(k) for k in sched.post_children[i, step] if k < n]
            bounds[i, L + step] = max(bounds[i, k] for k in kids)
    ratios = rng.uniform(0.2, 0.8, (B, L - 1))
    ratios[:, -1] = bounds[:, -1] + 5.0
    rates = CLOCK_RATE * rng.uniform(0.5, 2.0, (B, n - 1))
    return sched, bounds, ratios, rates


def _case(pi, case):
    """A batch over fluA's taxa: fluA x 3 with perturbed ratios, three
    random topologies, or a caterpillar and its copy."""
    if case == "fluA":
        return _port_parts(pi, batch=3)
    L = pi.tree_collection.trees[0].leaf_count()
    tips = pi._time_tree_arrays()[0][0, :L]
    if case == "random":
        rng = np.random.default_rng(11)
        tops = [_random_topology(Topology, L, rng) for _ in range(3)]
    else:
        tops = [_caterpillar(L)] * 2
    return _time_trees(tops, tips, seed=len(case))


def _tensors(sched, bounds, ratios, rates):
    t = torch.as_tensor
    ints = [t(np.asarray(getattr(sched, k))).to(torch.int32) for k in (
        "pre_internal_node", "pre_internal_parent", "parent",
        "post_children")]
    return (t(bounds), t(ratios), t(rates)), ints


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_forward_twin_equals_the_sweeps(flua, case, dtype):
    """forward_plain: the heights of node_heights_from_ratios' sweeps and
    K1's operand as the torch hand route makes it (branch lengths times
    rates, rounded, padded), bit for bit; the caterpillar's sweep count is
    its depth, I."""
    pi = flua[("jc69", "f64")]
    dt = DTYPES[dtype]
    sched, *arrays = _case(pi, case)
    (bounds, ratios, rates), (pn, pp, parent, _) = _tensors(sched, *arrays)
    L, n = sched.leaf_count, sched.node_count
    n_iters = pi.engine._height_iters(sched)
    if case == "caterpillar":
        assert n_iters == n - L - 1
    h_want = heights.node_heights_from_ratios(ratios, bounds, L, pn, pp,
                                              n_iters=n_iters)
    op_want = torch.nn.functional.pad(
        (heights.branch_lengths_from_heights(h_want, parent) * rates).to(dt),
        (0, 2))
    heights.reset_counters()
    h, op = heights.forward_plain(ratios, bounds, rates, parent, L, n_iters,
                                  dt)
    assert h.dtype == torch.float64 and op.dtype == dt
    assert torch.equal(h, h_want)
    assert torch.equal(op, op_want)
    assert heights.SWEEPS == {"forward": n_iters, "adjoint": 0}
    assert heights.TWIN_CALLS == {"forward": 1, "adjoint": 0}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_adjoint_twin_matches_the_hand_adjoint(flua, case, dtype):
    """adjoint_plain against ratio_and_rate_gradients_from_branch_gradient
    with the engine's rounding (the clock summed in float64 under a strict
    clock, then both rounded to the working dtype), at a strict and a
    relaxed clock, from a seeded branch gradient in the working dtype."""
    pi = flua[("jc69", "f64")]
    dt = DTYPES[dtype]
    sched, *arrays = _case(pi, case)
    (bounds, ratios, rates), (pn, pp, parent, pc) = _tensors(sched, *arrays)
    L, n = sched.leaf_count, sched.node_count
    n_iters = pi.engine._height_iters(sched)
    g = torch.as_tensor(np.random.default_rng(7).normal(
        size=(len(bounds), n - 1))).to(dt)
    h = heights.forward_plain(ratios, bounds, rates, parent, L, n_iters,
                              dt)[0]
    dratios, drates, _ = heights.ratio_and_rate_gradients_from_branch_gradient(
        g.to(torch.float64), ratios, bounds, rates, L, pn, pp, parent,
        n_iters, heights=h, post_children=pc)
    rel = 1e-12 if dt == torch.float64 else 2.0**-23
    for strict in (True, False):
        got = heights.adjoint_plain(g, h, ratios, bounds, rates, pc, parent,
                                    L, n_iters, strict)
        clock = drates.sum(-1, keepdim=True) if strict else drates
        for name, a, b in zip(("ratios", "clock"), got, (dratios, clock)):
            assert a.dtype == dt and a.shape == b.shape, name
            assert_rel(a, b.to(dt), rel, f"{name} strict={strict}")


@pytest.mark.parametrize("kernel, nodes, route", [
    ("forward", 137, "forward"),
    ("adjoint", 137, "adjoint"),
    ("adjoint", 2640, "adjoint"),
    ("adjoint", 2641, "adjoint_slab"),
    ("forward", 6455, "forward"),
    ("forward", 6456, "forward_slab"),
])
def test_kernel_route_rule(kernel, nodes, route):
    """A kernel takes a block's shared memory while a tree's per-node
    values fit SHARED_LIMIT (the adjoint up to 2,640 nodes, the forward up
    to 6,455), else the slab route: a slab of B trees' values, each
    tree_bytes long, a multiple of 16."""
    nbytes = heights.tree_bytes(kernel, nodes)
    assert nbytes % 16 == 0
    assert nbytes >= (nodes + 1) * (36 if kernel == "forward" else 88)
    got, slab, stride = heights._scratch(kernel, 3, nodes,
                                         torch.device("cpu"))
    assert (got, stride) == (route, nbytes)
    if route.endswith("_slab"):
        assert slab.dtype == torch.uint8 and slab.numel() == 3 * nbytes
        assert nbytes > heights.SHARED_LIMIT
    else:
        assert slab is None and nbytes <= heights.SHARED_LIMIT


def test_cpu_engine_never_reaches_the_kernels(flua):
    """On the CPU the hand route with the sweeps runs the twins, once each
    a call; with ``squaring`` it, the autograd route and the rooted LLs
    run the torch functions: no heights kernel, no twin; the sweeps
    counted as today."""
    pi = flua[("jc69", "f64")]
    eng = pi.engine
    sched, *arrays = _port_parts(pi, batch=2)
    args = (sched, *arrays, pi.phylo_model_params)
    n_iters = eng._height_iters(sched)
    for method in ("sweeps", "squaring"):
        eng.heights_method = method
        heights.reset_counters()
        eng.rooted_phylo_gradients(*args)
        sweeps = n_iters if method == "sweeps" else heights._squarings(
            n_iters)
        twins = int(method == "sweeps")
        assert heights.SWEEPS == {"forward": sweeps, "adjoint": sweeps}
        assert heights.TWIN_CALLS == {"forward": twins, "adjoint": twins}
    eng.heights_method = "sweeps"
    heights.reset_counters()
    eng._rooted_phylo_gradients_autograd(*args, True)
    eng.rooted_log_likelihoods(*args)
    assert heights.SWEEPS == {"forward": 2 * n_iters, "adjoint": 0}
    assert not any(heights.LAUNCHES.values())
    assert heights.TWIN_CALLS == {"forward": 0, "adjoint": 0}


def test_kernel_wrappers_refuse_what_they_cannot_take(flua):
    """forward_cuda and adjoint_cuda raise on CPU tensors before loading
    anything, and on a negative sweep count or a leaf count out of
    range."""
    pi = flua[("jc69", "f64")]
    sched, *arrays = _port_parts(pi, batch=2)
    (bounds, ratios, rates), (_, _, parent, pc) = _tensors(sched, *arrays)
    L, n = sched.leaf_count, sched.node_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        heights.forward_cuda(ratios, bounds, rates, parent, L, 30,
                             torch.float32)
    g = torch.zeros((2, n - 1), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        heights.adjoint_cuda(g, bounds, ratios, bounds, rates, pc, parent, L,
                             30, True)
    with pytest.raises(ValueError, match="n_iters >= 0"):
        heights.forward_cuda(ratios, bounds, rates, parent, L, -1,
                             torch.float32)
    with pytest.raises(ValueError, match="leaf_count"):
        heights.adjoint_cuda(g, bounds, ratios, bounds, rates, pc, parent, n,
                             30, True)


def _torch_sweeps(monkeypatch):
    """Today's torch functions in the twins' place, as the hand route ran
    them before the kernels: node_heights_from_ratios (each internal
    non-root node's parent scattered in node order), K1's operand as
    branch_lengths_from_heights times the rates, rounded and padded, and
    ratio_and_rate_gradients_from_branch_gradient with the engine's
    rounding."""
    def internal(parent, L, n):
        B = parent.shape[0]
        return (torch.arange(L, n - 1).repeat(B, 1),
                parent[:, L:n - 1].long())

    def forward(ratios, bounds, rates, parent, L, n_iters, dtype):
        n = bounds.shape[1]
        h = heights.node_heights_from_ratios(
            ratios, bounds, L, *internal(parent, L, n), n_iters=n_iters)
        bl = heights.branch_lengths_from_heights(h, parent) * rates
        return h, torch.nn.functional.pad(bl.to(dtype), (0, 2))

    def adjoint(grad, h, ratios, bounds, rates, pc, parent, L, n_iters,
                strict):
        n = bounds.shape[1]
        dratios, drates, _ = (
            heights.ratio_and_rate_gradients_from_branch_gradient(
                grad.to(torch.float64), ratios, bounds, rates, L,
                *internal(parent, L, n), parent, n_iters, heights=h,
                post_children=pc))
        clock = drates.sum(-1, keepdim=True) if strict else drates
        return dratios.to(grad.dtype), clock.to(grad.dtype)

    monkeypatch.setattr(heights, "forward", forward)
    monkeypatch.setattr(heights, "adjoint", adjoint)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", ["jc69", "weibull"])
def test_engine_kernel_route_with_twins(flua, monkeypatch, model, dtype):
    """The CPU's hand route, on the twins, on fluA x 3 at a strict and a
    relaxed clock: one forward and one adjoint a call, n_iters sweeps
    each; the packed path (RootedGraphs on the CPU, what a card captures)
    equal to the eager call bit for bit, with the same counts; against
    today's torch functions in the twins' place (_torch_sweeps): the LL and
    the Weibull shape gradient bit for bit (K1's operand is), the ratio
    and clock gradients at rel 1e-12 in f64 and within one rounding in
    f32."""
    pi = flua[(model, dtype)]
    eng = pi.engine
    dt = DTYPES[dtype]
    sched, *arrays = _port_parts(pi, batch=3)
    args = (sched, *arrays, pi.phylo_model_params)
    n_iters = eng._height_iters(sched)
    graphs = rooted_graph.RootedGraphs(eng)
    rel = 1e-12 if dt == torch.float64 else 2.0**-23
    for strict in (True, False):
        heights.reset_counters()
        got = eng.rooted_phylo_gradients(*args, strict)
        assert heights.TWIN_CALLS == {"forward": 1, "adjoint": 1}
        assert heights.SWEEPS == {"forward": n_iters, "adjoint": n_iters}
        heights.reset_counters()
        packed = graphs.phylo_gradients(*args, strict)
        assert heights.TWIN_CALLS == {"forward": 1, "adjoint": 1}
        assert set(packed) == set(got)
        for key in ("log_likelihood", "ratios_root_height", "clock_model"):
            assert got[key].dtype == dt
        for key in got:
            assert torch.equal(packed[key], got[key]), key
        with monkeypatch.context() as m:
            _torch_sweeps(m)
            heights.reset_counters()
            want = eng.rooted_phylo_gradients(*args, strict)
            assert heights.TWIN_CALLS == {"forward": 0, "adjoint": 0}
        assert set(want) == set(got)
        for key in want:
            if key in ("ratios_root_height", "clock_model"):
                assert_rel(got[key], want[key], rel, key)
            else:
                assert torch.equal(got[key], want[key]), key
