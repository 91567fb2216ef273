"""The rooted engine's fixed-order adjoint, heights_method, schedule cache
and graph packing, in the port against libsbn_tpu and its own eager route.

* ops/heights.py's hand adjoint sums onto parents by gathers over the
  children table (no scatter-add): against the scatter-add version it
  replaces and against libsbn_tpu/ops/heights.py, f64 rel 1e-12, on a batch
  of distinct random topologies over fluA's 69 taxa, both lowerings;
* ``LikelihoodEngine.heights_method`` ("sweeps", "squaring") on the hand
  route against libsbn_tpu's f64 rooted engine on that batch, rel 1e-10;
* the schedule cache (``_sched_dev``): uploaded and checked once per
  schedule object, keyed by device, never served to another schedule
  object, gone with its schedule;
* models/rooted_graph.py's packed path (what a card captures and replays),
  run on the CPU, against the eager call bit for bit: the hand route,
  rooted_log_likelihoods and the autograd route (JC69, Weibull+4, GTR; f64
  and f32), new inputs read on a second call, a new key for a new shape;
  in f64 the autograd route against libsbn_tpu's rooted_phylo_gradients
  at rel 1e-10;
* the GTR model gradients from one eigensystem solve of the shared Q
  expanded to every tree's copy (engine._shared_eigen) against
  libsbn_tpu's, unrooted and rooted, at rel 1e-10.

Every port call runs on the CPU (the kernels' twins). "rel r" means
|got - want| <= r (|want| + max |want|) elementwise.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libsbn_tpu.core.topology import Topology as JTopology
from libsbn_tpu.ops import heights as jheights
from libsbn_tpu.ops import schedule as jschedule

from libsbn_tpu_torch.core.topology import Topology
from libsbn_tpu_torch.models import rooted_graph
from libsbn_tpu_torch.models.phylo_model import substitution_tensors
from libsbn_tpu_torch.ops import heights, pruning_jc, schedule, substitution

from test_torch_rooted import (CLOCK_RATE, _instances, _parts, _port_parts,
                               assert_rel)

torch.set_num_threads(2)

TREES = 4  # distinct topologies of the batch


def _random_topology(cls, L, rng):
    """A rooted binary topology of L leaves from random joins."""
    pool = [cls.leaf(i) for i in range(L)]
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        b, a = pool.pop(j), pool.pop(i)
        pool.append(cls.join2(a, b))
    top = pool[0]
    top.polish()
    return top


def _distinct_batch(tip_dates, trees=TREES, seed=0):
    """``trees`` random topologies over len(tip_dates) taxa (joins from
    default_rng(seed)), as (port schedule, libsbn_tpu schedule), and per
    tree: bounds (the tips' dates, each internal node the largest below
    it), ratios U(0.2, 0.8) with the root height 5 above the largest
    bound, clock rates CLOCK_RATE x U(0.5, 2)."""
    L = len(tip_dates)
    rng = np.random.default_rng(seed)
    tops, jtops, rows = [], [], []
    for _ in range(trees):
        state = rng.bit_generator.state
        tops.append(_random_topology(Topology, L, rng))
        rng.bit_generator.state = state
        jtops.append(_random_topology(JTopology, L, rng))
        sch = schedule.schedule_of_topology(tops[-1])
        n = sch.node_count
        bounds = np.zeros(n)
        bounds[:L] = tip_dates
        for step in range(sch.post_node.shape[0]):
            kids = [int(k) for k in sch.post_children[step] if int(k) < n]
            bounds[int(sch.post_node[step])] = max(bounds[k] for k in kids)
        ratios = rng.uniform(0.2, 0.8, L - 1)
        ratios[-1] = bounds[-1] + 5.0
        rates = CLOCK_RATE * rng.uniform(0.5, 2.0, n - 1)
        rows.append((bounds, ratios, rates))
    sched = schedule.schedules_of_topologies(tops)
    jsched = jschedule.schedules_of_topologies(jtops)
    assert len({tuple(map(tuple, p)) for p in sched.post_children}) == trees
    np.testing.assert_array_equal(sched.post_children, jsched.post_children)
    return (sched, jsched, *(np.stack(x) for x in zip(*rows)))


@pytest.fixture(scope="module")
def fluA_tips(data_dir):
    """fluA's tip dates as node bounds."""
    ji, pi = _instances(data_dir, "jc69")
    return pi._time_tree_arrays()[0][0, :pi.tree_collection.trees[0]
                                     .leaf_count()]


def _scatter_adjoint(g_bl_scaled, ratios, bounds, rates, L, pre_n, pre_p,
                     parent, n_iters, heights_):
    """The scatter-add sweeps adjoint the gathers replace (the port's
    ops/heights.py before them): (dratios, drates)."""
    B, n = bounds.shape
    parent = parent.long()
    bl = heights.branch_lengths_from_heights(heights_, parent)
    g_bl = g_bl_scaled * rates
    g_h = g_bl.new_zeros((B, n)).scatter_add_(1, parent, g_bl)
    g_h[:, :-1] -= g_bl
    b, r_full, parent_full = heights._sweep_operands(ratios, bounds, L, pre_n,
                                                     pre_p)
    diff = torch.gather(heights_, 1, parent) - b[:, :-1]
    mask = torch.zeros((n - 1,), dtype=g_bl.dtype)
    mask[L:] = 1.0
    g_h.scatter_add_(1, parent, mask / torch.where(mask > 0, diff,
                                                   torch.ones_like(diff)))
    w, W = g_h, g_h
    for _ in range(n_iters):
        w = torch.zeros_like(w).scatter_add_(1, parent_full, r_full * w)
        W = W + w
    hp_minus_b = torch.gather(heights_, 1, parent_full) - b
    return (torch.cat([(W * hp_minus_b)[:, L:n - 1], w[:, n - 1:]], dim=1),
            g_bl_scaled * bl)


@pytest.mark.parametrize("method", ["sweeps", "squaring"])
def test_fixed_order_adjoint_matches_scatter_and_jax(fluA_tips, method):
    """The gathers' adjoint (children from post_children, and from the
    parent index when none is given) against the scatter-add version (sweeps)
    and libsbn_tpu's, f64 rel 1e-12, per tree of the distinct batch."""
    sched, jsched, bounds, ratios, rates = _distinct_batch(fluA_tips)
    L, n = sched.leaf_count, sched.node_count
    g = np.random.default_rng(5).normal(size=(TREES, n - 1))
    t = torch.as_tensor
    idx = [t(getattr(sched, k)).long() for k in (
        "pre_internal_node", "pre_internal_parent", "parent")]
    n_iters = n - L - 1
    args = (t(g), t(ratios), t(bounds), t(rates), L, *idx, n_iters)
    got = heights.ratio_and_rate_gradients_from_branch_gradient(
        *args, method=method, post_children=t(sched.post_children))
    derived = heights.ratio_and_rate_gradients_from_branch_gradient(
        *args, method=method)
    for a, b in zip(got, derived):
        assert torch.equal(a, b)
    if method == "sweeps":
        old = _scatter_adjoint(*args[:-1], n_iters, got[2])
        for name, a, b in zip(("dratios", "drates"), got, old):
            assert_rel(a, b, 1e-12, name)
    for i in range(TREES):
        want = jheights.ratio_and_rate_gradients_from_branch_gradient(
            jnp.asarray(g[i]), jnp.asarray(ratios[i]), jnp.asarray(bounds[i]),
            jnp.asarray(rates[i]), L, jsched.pre_internal_node[i],
            jsched.pre_internal_parent[i], jsched.parent[i], n_iters,
            method=method)
        for name, a, b in zip(("dratios", "drates", "heights"), got, want):
            assert_rel(a[i], b, 1e-12, f"tree {i} {name}")


def test_heights_sweeps_equal_the_root_self_gather(fluA_tips):
    """node_heights_from_ratios' sweeps (the root's parent a slot that
    holds the root height, so the gather's backward adds at most two terms
    a node) give the heights of the sweeps with the root its own parent,
    and the same gradient through them, bit for bit on the CPU, on the
    distinct batch."""
    sched, _, bounds, ratios, _ = _distinct_batch(fluA_tips)
    t = torch.as_tensor
    L, n = sched.leaf_count, sched.node_count
    idx = (t(sched.pre_internal_node).long(),
           t(sched.pre_internal_parent).long())
    r = t(ratios).clone().requires_grad_(True)
    got = heights.node_heights_from_ratios(r, t(bounds), L, *idx)
    g = t(np.random.default_rng(6).normal(size=got.shape))
    (dgot,) = torch.autograd.grad((got * g).sum(), r)
    r2 = t(ratios).clone().requires_grad_(True)
    b, r_full, parent_full = heights._sweep_operands(r2, t(bounds), L, *idx)
    h = torch.cat([b[:, :n - 1], r2[:, -1:]], dim=1)
    for _ in range(n - L - 1):
        h = b + r_full * (torch.gather(h, 1, parent_full) - b)
    (dwant,) = torch.autograd.grad((h * g).sum(), r2)
    assert torch.equal(got.detach(), h.detach())
    assert torch.equal(dgot, dwant)


def test_children_table_is_post_children(fluA_tips):
    """children_table(parent) holds each internal node's children as the
    schedule's post_children does (as sets, the ones slot last)."""
    sched = _distinct_batch(fluA_tips)[0]
    got = heights.children_table(torch.as_tensor(sched.parent),
                                 sched.leaf_count).numpy()
    want = np.asarray(sched.post_children)
    np.testing.assert_array_equal(np.sort(got, axis=-1),
                                  np.sort(want, axis=-1))


@pytest.mark.parametrize("method", ["sweeps", "squaring"])
@pytest.mark.parametrize("model", ["jc69", "weibull"])
def test_engine_heights_method_matches_jax(data_dir, fluA_tips, model,
                                           method):
    """The hand route with heights_method set, f64, against libsbn_tpu's
    rooted engine (its autograd route on the CPU) on the distinct batch:
    every gradient key and the LLs at rel 1e-10."""
    ji, pi = _instances(data_dir, model)
    sched, jsched, bounds, ratios, rates = _distinct_batch(fluA_tips)
    eng = pi.engine
    eng.heights_method = method
    got = eng.rooted_phylo_gradients(sched, bounds, ratios, rates,
                                     pi.phylo_model_params)
    want = ji.engine.rooted_phylo_gradients(jsched, bounds, ratios, rates,
                                            ji.phylo_model_params)
    assert set(got) == set(want)
    for key in want:
        assert_rel(got[key], np.asarray(want[key]), 1e-10, key)
    got = eng.rooted_log_likelihoods(sched, bounds, ratios, rates,
                                     pi.phylo_model_params)
    want = ji.engine.rooted_log_likelihoods(jsched, bounds, ratios, rates,
                                            ji.phylo_model_params)
    assert_rel(got, np.asarray(want), 1e-10, "LL + ldj")


def test_unknown_heights_method_raises(data_dir):
    pi = _instances(data_dir, "jc69")[1]
    pi.engine.heights_method = "doubling"
    with pytest.raises(ValueError, match="heights_method"):
        pi.phylo_gradients()


# -- the schedule cache -------------------------------------------------------


def test_schedule_cache_once_per_schedule_object(data_dir, monkeypatch):
    """_sched_dev checks a schedule once and uploads each array once, keyed
    by device and dtype, on the schedule object: a second call serves the
    same tensors, a new schedule object of the same trees gets its own
    (checked again), and the cache dies with its schedule."""
    pi = _instances(data_dir, "jc69")[1]
    eng = pi.engine
    checks = []
    real = pruning_jc.check_schedule
    monkeypatch.setattr(pruning_jc, "check_schedule",
                        lambda *a: checks.append(1) or real(*a))
    sched, bounds, ratios, rates = _port_parts(pi, batch=3)
    params = pi.phylo_model_params
    first = eng.rooted_phylo_gradients(sched, bounds, ratios, rates, params)
    cached = dict(sched._dev_cache)
    assert {k[0] for k in cached if isinstance(k, tuple)} == {
        "post_children", "pre_internal_node", "pre_internal_parent",
        "parent"}
    assert all(k[1] == torch.device("cpu") for k in cached
               if isinstance(k, tuple))
    assert all(x.dtype == torch.int32 for x in cached.values())
    eng.rooted_log_likelihoods(sched, bounds, ratios, rates, params)
    eng.log_likelihoods(sched, np.zeros((3, sched.node_count - 1)), params)
    assert len(checks) == 1
    assert all(sched._dev_cache[k] is v for k, v in cached.items())
    again = _port_parts(pi, batch=3)[0]
    second = eng.rooted_phylo_gradients(again, bounds, ratios, rates, params)
    assert len(checks) == 2
    assert again._dev_cache[("parent", torch.device("cpu"), torch.int32)] \
        is not cached[("parent", torch.device("cpu"), torch.int32)]
    for k in first:
        assert torch.equal(first[k], second[k])
    gone = weakref.ref(cached[("parent", torch.device("cpu"), torch.int32)])
    del sched, cached, again
    gc.collect()
    assert gone() is None


def test_schedule_cache_refuses_bad_schedule_once(data_dir):
    """A schedule that breaks the kernels' assumptions raises at its first
    use, before anything is cached."""
    pi = _instances(data_dir, "jc69")[1]
    sched, bounds, ratios, rates = _port_parts(pi)
    bad = np.array(sched.post_children)
    bad[0, 0, 0] = sched.node_count + 5
    object.__setattr__(sched, "post_children", bad)
    with pytest.raises(ValueError, match="out of range"):
        pi.engine.rooted_log_likelihoods(sched, bounds, ratios, rates,
                                         pi.phylo_model_params)
    assert getattr(sched, "_dev_cache", None) is None


# -- the packed path of models/rooted_graph.py --------------------------------


def _bit_for_bit(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        got, want = [got[k] for k in sorted(want)], [want[k] for k in
                                                     sorted(want)]
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("model", ["jc69", "weibull", "gtr"])
def test_packed_rooted_calls_equal_eager(data_dir, model, dtype):
    """RootedGraphs on the CPU (the function a card captures, over its
    packed buffers) against the eager call, bit for bit: the LL parts, the
    hand route's gradient dict (JC69) and the autograd route's (Weibull+4
    and GTR, against _rooted_phylo_gradients_autograd) at a strict and a
    relaxed clock; in f64 the autograd route against libsbn_tpu's
    rooted_phylo_gradients at rel 1e-10; a second call with new ratios (and
    a new heights_method) read the new inputs; a new batch size is a new
    key."""
    ji, pi = _instances(data_dir, model, dtype)
    eng = pi.engine
    graphs = rooted_graph.RootedGraphs(eng)
    sched, bounds, ratios, rates = _port_parts(pi, batch=4)
    params = pi.phylo_model_params
    args = (sched, bounds, ratios, rates, params)
    want = eng.rooted_log_likelihoods(*args, return_parts=True)
    _bit_for_bit(graphs.log_likelihoods(*args), want)
    if model != "gtr":
        for strict in (True, False):
            _bit_for_bit(graphs.phylo_gradients(*args, strict),
                         eng._rooted_phylo_gradients_hand(*args, strict))
        ratios2 = ratios.copy()
        ratios2[:, :-1] *= 0.99
        eng.heights_method = "squaring"
        args2 = (sched, bounds, ratios2, rates, params)
        got2 = graphs.phylo_gradients(*args2, True)
        _bit_for_bit(got2, eng._rooted_phylo_gradients_hand(*args2, True))
        assert not torch.equal(got2["log_likelihood"],
                               want[0])
    if model != "jc69":
        for strict in (True, False):
            got = graphs.phylo_gradients(*args, strict, "autograd")
            _bit_for_bit(got, eng._rooted_phylo_gradients_autograd(*args,
                                                                   strict))
        ratios2 = ratios.copy()
        ratios2[:, :-1] *= 0.98
        args2 = (sched, bounds, ratios2, rates, params)
        got2 = graphs.phylo_gradients(*args2, True, "autograd")
        _bit_for_bit(got2, eng._rooted_phylo_gradients_autograd(*args2,
                                                                True))
        assert not torch.equal(got2["log_likelihood"], want[0])
        if dtype == torch.float64:
            tops, *_ = _parts(ji, batch=4)
            jgot = ji.engine.rooted_phylo_gradients(
                jschedule.schedules_of_topologies(tops), bounds, ratios2,
                rates, ji.phylo_model_params)
            assert set(got2) == set(jgot)
            for key in jgot:
                assert_rel(got2[key], np.asarray(jgot[key]), 1e-10, key)
    keys = len(graphs.programs)
    small = _port_parts(pi, batch=2)
    for n in (0, 1):  # the new key's first call keeps nothing, its second
        _bit_for_bit(graphs.log_likelihoods(*small, params),
                     eng.rooted_log_likelihoods(*small, params, True))
        assert len(graphs.programs) == keys + n
    assert rooted_graph.COUNTS["replays"] == 0  # no card, no replay


def test_engine_on_cpu_has_no_graphs(data_dir):
    """cuda_graphs is ignored on the CPU: the engine runs eagerly."""
    pi = _instances(data_dir, "jc69")[1]
    assert pi.engine.graphs is None


def test_shared_eigen_gradients_match_jax(data_dir):
    """GTR's model gradients from one host solve of the shared Q's
    eigensystem, expanded to the B per-tree copies that autograd tells
    apart (engine._shared_eigen, expm_transition's eigen), against
    libsbn_tpu's f64 gradients at rel 1e-10: the rooted autograd route's
    substitution_model rows (the GTR of tests/test_torch_rooted.py) and the
    unrooted phylo_gradients on the same trees at seeded branch lengths;
    expm_transition on the expanded solve against B solves of the copies;
    an eigensystem of another count of Qs is refused."""
    ji, pi = _instances(data_dir, "gtr")
    eng = pi.engine
    params = pi.phylo_model_params
    eigen = eng._shared_eigen(params)
    assert [tuple(x.shape) for x in eigen] == [(1, 4), (1, 4, 4), (1, 4, 4)]
    sched, bounds, ratios, rates = _port_parts(pi, batch=3)
    tops, *_ = _parts(ji, batch=3)
    jsched = jschedule.schedules_of_topologies(tops)
    got = eng.rooted_phylo_gradients(sched, bounds, ratios, rates, params)
    want = ji.engine.rooted_phylo_gradients(jsched, bounds, ratios, rates,
                                            ji.phylo_model_params)
    assert got["substitution_model"].shape == (3, 8)
    assert_rel(got["substitution_model"],
               np.asarray(want["substitution_model"]), 1e-10,
               "rooted substitution_model")
    bl = np.random.default_rng(1).uniform(0.001, 0.01, (3, sched.node_count))
    bl[:, -1] = 0.0
    got = eng.phylo_gradients(sched, bl, params)
    want = ji.engine.phylo_gradients(jsched, bl, ji.phylo_model_params)
    for key in ("substitution_model", "branch_lengths", "log_likelihood"):
        assert_rel(got[key], np.asarray(want[key]), 1e-10, key)
    freqs, Q = substitution_tensors(eng.spec, params)
    Qb = Q.expand(3, 4, 4)
    ts = torch.as_tensor(np.random.default_rng(2).uniform(0.0, 0.3, (3, 7)))
    shared = substitution.expm_transition(Qb, freqs, ts, eigen=eigen)
    each = substitution.expm_transition(Qb, freqs, ts)
    np.testing.assert_allclose(shared.numpy(), each.numpy(), rtol=0,
                               atol=1e-15)
    with pytest.raises(ValueError, match="eigensystem of 2 Qs"):
        substitution.expm_transition(
            Qb, freqs, ts, eigen=tuple(torch.cat([x, x]) for x in eigen))
