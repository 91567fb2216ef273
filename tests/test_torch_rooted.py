"""Rooted time trees in the port against libsbn_tpu and the goldens.

* ops/heights.py: the heights fixed point, branch lengths, the hand adjoint
  and the log-det-Jacobian against libsbn_tpu/ops/heights.py (f64, rel
  1e-12, both lowerings), and the adjoint's guard on masked rows;
* the rooted engine through RootedInstance on fluA (JC69, Weibull+4, GTR):
  LL, log-det-Jacobian and every gradient key against libsbn_tpu's f64
  engine on the same inputs (rel 1e-10), and the physher/phylotorch
  goldens (tests/test_rooted_likelihood.py) at their tolerances;
* the hand route (K1 + the adjoint) against the autograd route (K2 + K3
  through the sweeps), f64 and f32; a perturbed batch of four trees; the
  clock gradient against central differences;
* ratio_gradient_of_height_gradient, unrooted_log_likelihoods,
  sample_trees, the rooted simple average and the unconditional subsplit
  probabilities against libsbn_tpu; the dates guards.

Every port call passes device="cpu", where the engine runs the kernels'
plain twins. "rel r" below means |got - want| <= r (|want| + max |want|)
elementwise.
"""

import csv

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import libsbn_tpu as jl
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JSpec
from libsbn_tpu.ops import heights as jheights
from libsbn_tpu.ops import schedule as jschedule

import libsbn_tpu_torch as lt
from libsbn_tpu_torch.models.phylo_model import PhyloModelSpec, params_from_numpy
from libsbn_tpu_torch.ops import heights, pruning_jc, schedule

torch.set_num_threads(2)

PHYSHER_LL = -4777.616349
PHYSHER_JACOBIAN = -9.25135166
PHYSHER_RATIO_GRADIENTS = [
    -0.593654, 6.441290, 11.202945, 5.173924, -0.904631, 2.731402, 3.157131,
    7.082914, 10.305417, 13.988206, 20.709336, 48.897993, 99.164949, 130.205747,
    17.314019, 21.033290, -1.336335, 12.259822, 22.887291, 27.176564, 47.487426,
    3.637276, 12.955169, 15.315953, 83.254605, -3.806996, 105.385095, 4.874023,
    22.754466, 6.036534, 25.651478, 29.535185, 29.598789, 1.817247, 10.598685,
    76.259248, 56.481423, 10.679778, 6.587179, 3.330556, -4.622247, 33.417304,
    63.415767, 188.809515, 23.540875, 17.421076, 1.222568, 22.372012, 34.239511,
    3.486115, 4.098873, 13.200954, 19.726890, 96.808738, 4.240029, 7.414585,
    48.871694, 3.488516, 82.969065, 9.009334, 8.032474, 3.981016, 6.543650,
    53.702423, 37.835952, 2.840831, 7.517186, 19.936861,
]
PHYSHER_WEIBULL_LL = -4618.2062529058
PHYSHER_WEIBULL_SHAPE_GRADIENT = -5.231329
PHYLOTORCH_GTR_LL = -5221.438941335706
PHYLOTORCH_GTR_GRADIENTS = [
    49.06451538, 151.83105912, 26.40235659, -8.25135661,
    75.29759338, 352.56545247, 90.07046995, 30.12301652,
]
GTR_RATES = [0.05, 0.1, 0.15, 0.20, 0.25, 0.25]
GTR_FREQS = [0.1, 0.2, 0.3, 0.4]
CLOCK_RATE = 0.001
# model name -> (substitution, site, parameter overrides as numpy)
MODELS = {
    "jc69": ("JC69", "constant", {}),
    "weibull": ("JC69", "weibull+4", {"site": {"shape": 0.1}}),
    "gtr": ("GTR", "constant", {"substitution": {
        "rates": GTR_RATES, "frequencies": GTR_FREQS}}),
}


def assert_rel(got, want, rel, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _instances(data_dir, model, dtype=torch.float64):
    """(libsbn_tpu instance, port instance) on fluA with dates from the
    taxon names, clock rate 0.001 and the model's parameters."""
    sub, site, overrides = MODELS[model]
    out = []
    for package in (jl, lt):
        inst = package.rooted_instance("fluA")
        inst.read_newick_file(f"{data_dir}/fluA.tree")
        inst.read_fasta_file(f"{data_dir}/fluA.fa")
        inst.parse_dates_from_taxon_names(True)
        inst.set_clock_rates(CLOCK_RATE)
        if package is jl:
            inst.prepare_for_phylo_likelihood(JSpec(sub, site, "strict"))
            for block, values in overrides.items():
                inst.phylo_model_params[block] = {
                    k: jnp.asarray(v) for k, v in values.items()}
        else:
            inst.prepare_for_phylo_likelihood(
                PhyloModelSpec(sub, site, "strict"), device="cpu",
                dtype=dtype)
            for block, values in overrides.items():
                inst.phylo_model_params[block] = params_from_numpy(
                    values, "cpu", torch.float64)
        out.append(inst)
    return out


def _parts(inst, batch=None):
    """(sched, bounds, ratios, rates) of an instance's trees, or of fluA
    tiled to ``batch`` trees with the ratios perturbed by U(0.95, 1.05)
    from default_rng(0) (the JAX bench's flua_rooted_gradients recipe)."""
    bounds, ratios, rates = inst._time_tree_arrays()
    tops = [t.topology for t in inst.tree_collection.trees]
    if batch is not None:
        tops = tops * batch
        bounds, ratios, rates = (np.repeat(x, batch, axis=0)
                                 for x in (bounds, ratios, rates))
        rng = np.random.default_rng(0)
        ratios[:, :-1] = np.clip(
            ratios[:, :-1] * rng.uniform(0.95, 1.05, ratios[:, :-1].shape),
            1e-4, 1 - 1e-4)
    return tops, bounds, ratios, rates


@pytest.fixture(scope="module", params=sorted(MODELS))
def fluA_pair(request, data_dir):
    """The model, both instances, and libsbn_tpu's results on fluA:
    (LL, ldj) and its gradient dict, as numpy."""
    model = request.param
    ji, pi = _instances(data_dir, model)
    tops, bounds, ratios, rates = _parts(ji)
    sched = jschedule.schedules_of_topologies(tops)
    lls, ldjs = ji.engine.rooted_log_likelihoods(
        sched, bounds, ratios, rates, ji.phylo_model_params,
        return_parts=True)
    grads = {k: np.asarray(v) for k, v in ji.phylo_gradients().items()}
    return model, ji, pi, (np.asarray(lls), np.asarray(ldjs)), grads


def _port_parts(pi, batch=None):
    tops, bounds, ratios, rates = _parts(pi, batch)
    return schedule.schedules_of_topologies(tops), bounds, ratios, rates


# -- ops/heights.py -----------------------------------------------------------


def _seeded_time_tree(sch, seed):
    """Seeded bounds and ratios on a schedule's topology (the JAX tests'
    recipe): tip dates U(0, 0.5), ratios U(0.2, 0.8), root height one above
    the largest bound, rates U(0.5, 2)."""
    n, L = sch.node_count, sch.leaf_count
    rng = np.random.default_rng(seed)
    bounds = np.zeros(n)
    bounds[:L] = rng.uniform(0.0, 0.5, L)
    for step in range(sch.post_node.shape[0]):
        kids = [int(k) for k in sch.post_children[step] if int(k) < n]
        bounds[int(sch.post_node[step])] = max(bounds[k] for k in kids)
    ratios = np.clip(rng.uniform(0.2, 0.8, L - 1), 1e-3, 1 - 1e-3)
    ratios[-1] = bounds[-1] + 1.0
    rates = rng.uniform(0.5, 2.0, n - 1)
    g = rng.normal(size=n - 1)
    return bounds, ratios, rates, g


def _fluA_time_tree(data_dir):
    inst = lt.rooted_instance("fluA")
    inst.read_newick_file(f"{data_dir}/fluA.tree")
    inst.parse_dates_from_taxon_names(True)
    tree = inst.tree_collection.trees[0]
    rng = np.random.default_rng(3)
    n = tree.node_count()
    return (tree.topology, tree.node_bounds, tree.height_ratios,
            rng.uniform(0.5, 2.0, n - 1) * CLOCK_RATE, rng.normal(size=n - 1))


@pytest.mark.parametrize("method", ["sweeps", "squaring"])
@pytest.mark.parametrize("case", ["fluA", "seeded"])
def test_heights_functions_match_jax(data_dir, case, method):
    """The four functions of ops/heights.py equal libsbn_tpu's, f64 rel
    1e-12, on fluA's dated tree and on seeded bounds and ratios over the
    fluA topology, at the exact sweep count (32) and past it (37)."""
    top, bounds, ratios, rates, g = _fluA_time_tree(data_dir)
    sch = jschedule.schedule_of_topology(top)
    if case == "seeded":
        bounds, ratios, rates, g = _seeded_time_tree(sch, 1)
    n, L = sch.node_count, sch.leaf_count

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x)).to(dtype)[None]

    pre_n, pre_p, par = (t(x, torch.int64) for x in (
        sch.pre_internal_node, sch.pre_internal_parent, sch.parent))
    for n_iters in (32, 37):
        want_h = jheights.node_heights_from_ratios(
            jnp.asarray(ratios), jnp.asarray(bounds), L,
            sch.pre_internal_node, sch.pre_internal_parent, n_iters=n_iters,
            method=method)
        got_h = heights.node_heights_from_ratios(
            t(ratios), t(bounds), L, pre_n, pre_p, n_iters=n_iters,
            method=method)
        assert_rel(got_h[0], want_h, 1e-12, "heights")
        assert_rel(heights.branch_lengths_from_heights(got_h, par)[0],
                   jheights.branch_lengths_from_heights(want_h, sch.parent),
                   1e-12, "branch lengths")
        assert_rel(heights.log_det_jacobian(got_h, t(bounds), par, L)[0],
                   jheights.log_det_jacobian(want_h, jnp.asarray(bounds),
                                             jnp.asarray(sch.parent), L),
                   1e-12, "log-det-Jacobian")
        want = jheights.ratio_and_rate_gradients_from_branch_gradient(
            jnp.asarray(g), jnp.asarray(ratios), jnp.asarray(bounds),
            jnp.asarray(rates), L, sch.pre_internal_node,
            sch.pre_internal_parent, sch.parent, n_iters, method=method)
        got = heights.ratio_and_rate_gradients_from_branch_gradient(
            t(g), t(ratios), t(bounds), t(rates), L, pre_n, pre_p, par,
            n_iters, method=method)
        for name, a, b in zip(("dratios", "drates", "heights"), got, want):
            assert_rel(a[0], b, 1e-12, name)
    assert got_h.shape == (1, n)


def test_heights_are_batched_per_tree(data_dir):
    """A batch of three seeded trees gives each tree's own results."""
    top = _fluA_time_tree(data_dir)[0]
    sch = schedule.schedule_of_topology(top)
    rows = [_seeded_time_tree(sch, seed) for seed in (1, 2, 3)]
    stack = [torch.as_tensor(np.stack(x)) for x in zip(*rows)]
    idx = [torch.as_tensor(np.stack([x] * 3)).long() for x in (
        sch.pre_internal_node, sch.pre_internal_parent, sch.parent)]
    L = sch.leaf_count
    batch = heights.ratio_and_rate_gradients_from_branch_gradient(
        stack[3], stack[1], stack[0], stack[2], L, *idx, 32)
    for b in range(3):
        one = heights.ratio_and_rate_gradients_from_branch_gradient(
            stack[3][b:b + 1], stack[1][b:b + 1], stack[0][b:b + 1],
            stack[2][b:b + 1], L, *(x[b:b + 1] for x in idx), 32)
        for x, y in zip(batch, one):
            torch.testing.assert_close(x[b], y[0], rtol=1e-14, atol=1e-14)


def test_hand_adjoint_jacobian_guard_no_nan(data_dir):
    """A cherry whose height equals its bound gives its latest leaf a
    zero-length pendant branch: the masked Jacobian rows stay finite (the
    JAX test tests/test_rooted_likelihood.py:224-267), and the results
    equal libsbn_tpu's."""
    sch = jschedule.schedule_of_topology(_fluA_time_tree(data_dir)[0])
    n, L = sch.node_count, sch.leaf_count
    bounds, ratios, rates, g = _seeded_time_tree(sch, 2)
    kids_of = {
        int(sch.post_node[s]): [int(k) for k in sch.post_children[s]
                                if int(k) < n]
        for s in range(sch.post_node.shape[0])
    }
    cherry = next(v for v, ks in kids_of.items() if all(k < L for k in ks))
    ratios[cherry - L] = 0.0
    got = heights.ratio_and_rate_gradients_from_branch_gradient(
        *(torch.as_tensor(x)[None] for x in (g, ratios, bounds, rates)), L,
        *(torch.as_tensor(x).long()[None] for x in (
            sch.pre_internal_node, sch.pre_internal_parent, sch.parent)), 32)
    h = got[2][0].numpy()
    leaf = [k for k in kids_of[cherry] if bounds[k] == bounds[cherry]][0]
    assert h[cherry] == h[leaf]
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    want = jheights.ratio_and_rate_gradients_from_branch_gradient(
        jnp.asarray(g), jnp.asarray(ratios), jnp.asarray(bounds),
        jnp.asarray(rates), L, sch.pre_internal_node,
        sch.pre_internal_parent, sch.parent, 32)
    assert_rel(got[0][0], want[0], 1e-12, "dratios")


def test_height_iters_is_the_depth_and_cached(data_dir):
    """The sweep count is fluA's deepest internal node's depth (32),
    cached on the schedule object; a new schedule computes its own."""
    pi = _instances(data_dir, "jc69")[1]
    sched = pi._batched_schedule()
    assert pi.engine._height_iters(sched) == 32
    assert sched._height_iters_cache == 32
    object.__setattr__(sched, "_height_iters_cache", 5)
    assert pi.engine._height_iters(sched) == 5  # served from the schedule
    assert pi.engine._height_iters(pi._batched_schedule()) == 32


def test_fluA_schedule_passes_check_schedule(data_dir):
    """The kernels assume postorder-linear internal ids; fluA's rooted
    schedule has them (N = 137, L = 69, root 136), and the rooted engine
    checks every schedule on its path: a schedule without them raises."""
    pi = _instances(data_dir, "jc69")[1]
    sched, bounds, ratios, rates = _port_parts(pi)
    assert (sched.node_count, sched.leaf_count, sched.root_id) == (137, 69, 136)
    pruning_jc.check_schedule(sched.post_node, sched.post_children,
                              sched.leaf_count, sched.root_id)
    bad = schedule.BatchedSchedule(**{
        **sched.__dict__, "post_node": sched.post_node[:, ::-1].copy()})
    for call in (pi.engine.rooted_log_likelihoods,
                 pi.engine.rooted_phylo_gradients):
        with pytest.raises(ValueError, match="postorder-linear"):
            call(bad, bounds, ratios, rates, pi.phylo_model_params)


# -- the rooted engine ----------------------------------------------------------


def test_rooted_instance_matches_jax(fluA_pair):
    """LL, ldj and every gradient key of RootedInstance equal libsbn_tpu's
    f64 engine on fluA at rel 1e-10, for JC69 (hand route), Weibull+4
    (hand route and the K2 + K3 shape gradient) and GTR (autograd through
    K5 + K6)."""
    model, ji, pi, (lls, ldjs), want = fluA_pair
    sched, bounds, ratios, rates = _port_parts(pi)
    got_ll, got_ldj = pi.engine.rooted_log_likelihoods(
        sched, bounds, ratios, rates, pi.phylo_model_params,
        return_parts=True)
    assert_rel(got_ll, lls, 1e-10, "LL")
    assert_rel(got_ldj, ldjs, 1e-10, "ldj")
    assert_rel(pi.log_likelihoods(), np.asarray(ji.log_likelihoods()), 1e-10,
               "log_likelihoods()")
    got = pi.phylo_gradients()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].device.type == "cpu"
        assert_rel(got[key], want[key], 1e-10, key)


def test_rooted_instance_goldens(fluA_pair):
    """The physher and phylotorch goldens at their tolerances."""
    model, _, pi, _, _ = fluA_pair
    sched, bounds, ratios, rates = _port_parts(pi)
    lls, ldjs = pi.engine.rooted_log_likelihoods(
        sched, bounds, ratios, rates, pi.phylo_model_params,
        return_parts=True)
    g = pi.phylo_gradients()
    assert abs(float(ldjs[0]) - PHYSHER_JACOBIAN) < 1e-4
    if model == "jc69":
        assert abs(float(lls[0]) - PHYSHER_LL) < 1e-4
        assert abs(float(g["log_likelihood"][0]) - PHYSHER_LL) < 1e-4
        np.testing.assert_allclose(g["ratios_root_height"][0],
                                   PHYSHER_RATIO_GRADIENTS, atol=1e-4)
    elif model == "weibull":
        assert abs(float(lls[0]) - PHYSHER_WEIBULL_LL) < 1e-4
        assert abs(float(g["site_model"][0])
                   - PHYSHER_WEIBULL_SHAPE_GRADIENT) < 1e-3
    else:
        assert abs(float(lls[0]) - PHYLOTORCH_GTR_LL) < 1e-3
        assert abs(float(g["log_likelihood"][0]) - PHYLOTORCH_GTR_LL) < 1e-3
        np.testing.assert_allclose(g["substitution_model"][0],
                                   PHYLOTORCH_GTR_GRADIENTS, atol=1e-3)


@pytest.mark.parametrize("model", ["jc69", "weibull"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hand_route_matches_autograd_route(data_dir, model, dtype):
    """The hand route (K1 + the adjoint of ops/heights.py) equals autograd
    through the sweeps and K2 + K3 on a perturbed batch of four trees: f64
    rel 1e-9; f32 rtol 1e-3, atol 0.1 (tests/test_pallas.py:496-499)."""
    pi = _instances(data_dir, model, dtype)[1]
    args = (*_port_parts(pi, 4), pi.phylo_model_params, True)
    pruning_jc.reset_counters()
    hand = pi.engine._rooted_phylo_gradients_hand(*args)
    assert pruning_jc.TWIN_CALLS["ll_grad_jc69"] == 1
    auto = pi.engine._rooted_phylo_gradients_autograd(*args)
    assert pruning_jc.TWIN_CALLS["ll_dea_jc69"] == (3 if model == "weibull"
                                                     else 1)
    assert sorted(hand) == sorted(auto)
    for key in hand:
        assert hand[key].dtype == (torch.float64 if key == "site_model"
                                   else dtype)
        if dtype == torch.float64:
            assert_rel(hand[key], auto[key], 1e-9, key)
        else:
            np.testing.assert_allclose(hand[key], auto[key], rtol=1e-3,
                                       atol=0.1, err_msg=key)


@pytest.mark.parametrize("model", ["jc69", "gtr"])
def test_perturbed_batch_matches_jax(data_dir, model):
    """Four copies of fluA with perturbed ratios (the bench's recipe):
    LLs, ldjs and gradients per tree equal libsbn_tpu's f64 engine, rel
    1e-10."""
    ji, pi = _instances(data_dir, model)
    tops, bounds, ratios, rates = _parts(ji, 4)
    jsched = jschedule.schedules_of_topologies(tops)
    sched = schedule.schedules_of_topologies(tops)
    lls, ldjs = pi.engine.rooted_log_likelihoods(
        sched, bounds, ratios, rates, pi.phylo_model_params, True)
    want_lls, want_ldjs = ji.engine.rooted_log_likelihoods(
        jsched, bounds, ratios, rates, ji.phylo_model_params, True)
    assert_rel(lls, want_lls, 1e-10, "LL")
    assert_rel(ldjs, want_ldjs, 1e-10, "ldj")
    assert len(set(np.round(lls.numpy(), 6))) == 4  # four distinct trees
    got = pi.engine.rooted_phylo_gradients(sched, bounds, ratios, rates,
                                           pi.phylo_model_params)
    want = ji.engine.rooted_phylo_gradients(jsched, bounds, ratios, rates,
                                            ji.phylo_model_params)
    for key in want:
        assert_rel(got[key], want[key], 1e-10, key)


def test_rescale_off_takes_the_scan_engine(data_dir):
    """rescale=False runs the scan engine on both routes' entry points and
    equals the rescaled result and libsbn_tpu's unrescaled one."""
    ji, pi = _instances(data_dir, "jc69")
    args = _port_parts(pi)
    want = pi.engine.rooted_phylo_gradients(*args, pi.phylo_model_params)
    pi.engine.rescale = False
    pruning_jc.reset_counters()
    got = pi.engine.rooted_phylo_gradients(*args, pi.phylo_model_params)
    assert sum(pruning_jc.TWIN_CALLS.values()) == 0
    for key in want:
        assert_rel(got[key], want[key], 1e-10, key)
    ji.set_rescaling(False)
    assert_rel(pi.log_likelihoods(), ji.log_likelihoods(), 1e-10)


def test_clock_gradients_vs_finite_differences(data_dir):
    """d LL / d clock rate, strict (one rate) and relaxed (per branch),
    against central differences of the port's own LLs, 1e-3 relative."""
    pi = _instances(data_dir, "jc69")[1]
    sched, bounds, ratios, rates = _port_parts(pi)
    params = pi.phylo_model_params
    eng = pi.engine
    eps = 1e-7

    def ll(r):
        return float(eng.rooted_log_likelihoods(sched, bounds, ratios, r,
                                                params, True)[0][0])

    g = eng.rooted_phylo_gradients(sched, bounds, ratios, rates, params)
    fd = (ll(rates + eps) - ll(rates - eps)) / (2 * eps)
    assert abs(float(g["clock_model"][0, 0]) - fd) < 1e-3 * max(1.0, abs(fd))
    relaxed = rates * (np.arange(rates.shape[1]) % 3 + 1.0)
    g = eng.rooted_phylo_gradients(sched, bounds, ratios, relaxed, params,
                                   strict_clock=False)
    assert g["clock_model"].shape == rates.shape
    n = rates.shape[1]
    for j in (0, 1, n // 2, n - 1):
        step = np.zeros_like(rates)
        step[0, j] = eps
        fd = (ll(relaxed + step) - ll(relaxed - step)) / (2 * eps)
        assert abs(float(g["clock_model"][0, j]) - fd) < 1e-3 * max(1.0, abs(fd))


def test_per_tree_still_raises(data_dir):
    pi = _instances(data_dir, "jc69")[1]
    with pytest.raises(NotImplementedError, match="item 5"):
        pi.engine.rooted_log_likelihoods(*_port_parts(pi),
                                         pi.phylo_model_params, per_tree=True)


# -- RootedInstance's other surface ------------------------------------------


def test_ratio_gradient_of_height_gradient(data_dir):
    """J^T g equals libsbn_tpu's and central differences of
    g . heights(ratios), 1e-5 relative."""
    insts = []
    for package in (jl, lt):
        inst = package.rooted_instance("ratio grad")
        inst.read_newick_file(f"{data_dir}/fluA.tree")
        inst.parse_dates_from_taxon_names(True)
        insts.append(inst.tree_collection.trees[0])
    jtree, tree = insts
    L = tree.leaf_count()
    g = np.random.default_rng(5).normal(size=L - 1)
    got = lt.ratio_gradient_of_height_gradient(tree, g, device="cpu")
    assert got.shape == (L - 1,)
    assert_rel(got, jl.ratio_gradient_of_height_gradient(jtree, g), 1e-12)
    sch = schedule.schedule_of_topology(tree.topology)
    eps = 1e-7
    base = np.asarray(tree.height_ratios)
    steps = np.concatenate([np.eye(L - 1), -np.eye(L - 1)]) * eps
    h = heights.node_heights_from_ratios(
        torch.as_tensor(base + steps),
        torch.as_tensor(np.tile(tree.node_bounds, (2 * (L - 1), 1))), L,
        *(torch.as_tensor(np.tile(x, (2 * (L - 1), 1))).long()
          for x in (sch.pre_internal_node, sch.pre_internal_parent)))
    dots = h[:, L:].numpy() @ g
    fd = (dots[:L - 1] - dots[L - 1:]) / (2 * eps)
    np.testing.assert_allclose(got, fd, rtol=1e-5, atol=1e-5)


def test_unrooted_log_likelihoods_match_jax(data_dir):
    """The plain pruning LLs of the trees' branch lengths (no rates, no
    Jacobian), against libsbn_tpu's at rel 1e-10."""
    ji, pi = _instances(data_dir, "jc69")
    assert_rel(pi.unrooted_log_likelihoods(),
               np.asarray(ji.unrooted_log_likelihoods()), 1e-10)


def test_sample_trees_match_jax(data_dir):
    """sample_trees draws libsbn_tpu's rooted topologies for one seed and
    keeps the taxa and dates."""
    insts = []
    for package in (jl, lt):
        inst = package.rooted_instance("sample")
        inst.read_newick_file(f"{data_dir}/five_taxon_rooted_more.nwk")
        inst.set_dates_to_be_constant(False)
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.set_seed(7)
        inst.sample_trees(6)
        insts.append(inst)
    ji, pi = insts
    assert pi.tree_count() == 6
    assert ([t.topology.newick() for t in pi.tree_collection.trees]
            == [t.topology.newick() for t in ji.tree_collection.trees])
    assert pi.tree_collection.tag_date_map == ji.tree_collection.tag_date_map
    assert all(t.node_count() == 9 for t in pi.tree_collection.trees)


def test_rooted_simple_average_golden(data_dir):
    """Simple average over the 20-taxon rooted trees: every normalised SBN
    parameter within 1e-6 of the reference's CSV, and equal to
    libsbn_tpu's."""
    insts = []
    for package in (jl, lt):
        inst = package.rooted_instance("rooted instance")
        inst.read_newick_file(f"{data_dir}/rooted_simple_average.nwk")
        inst.process_loaded_trees()
        inst.train_simple_average()
        insts.append(inst)
    ji, pi = insts
    with open(f"{data_dir}/rooted_simple_average_results.csv") as f:
        correct = {row[0]: float(row[1]) for row in csv.reader(f)}
    got = pi.pretty_indexed_sbn_parameters()
    assert len(got) == len(correct)
    for key, prob in got:
        assert abs(prob - correct[key]) < 1e-6, key
    assert pi.pretty_indexer() == ji.pretty_indexer()
    assert_rel(pi.normalized_sbn_parameters(), ji.normalized_sbn_parameters(),
               1e-12)


def test_unconditional_subsplit_probabilities(data_dir, tmp_path):
    """The reference's golden map (rooted_sbn_instance.hpp:194-216), equal
    to libsbn_tpu's, and its CSV."""
    correct = {
        "0011111000": 0.5, "0111110000": 0.3, "0001011101": 0.2,
        "1100100100": 0.2, "0100000111": 0.1, "0111000001": 0.2,
        "0101000100": 0.2, "1000001001": 0.2, "0010000011": 0.4,
        "0011000001": 0.2, "1000001000": 0.5, "0100000010": 0.2,
        "0100000001": 0.2, "0010000010": 0.2, "0001000001": 0.4,
    }
    probs = []
    for package in (jl, lt):
        inst = package.rooted_instance("rooted instance")
        inst.read_newick_file(f"{data_dir}/five_taxon_rooted_more.nwk")
        inst.process_loaded_trees()
        inst.train_simple_average()
        probs.append({s.to_string(): p for s, p in
                      inst.unconditional_subsplit_probabilities().items()})
    want, got = probs
    assert got.keys() == want.keys() == correct.keys()
    for key, prob in got.items():
        assert abs(prob - correct[key]) < 1e-8, key
        assert abs(prob - want[key]) < 1e-12, key
    path = tmp_path / "probs.csv"
    inst.unconditional_subsplit_probabilities_to_csv(str(path))
    with open(path) as f:
        rows = list(csv.reader(f))
    assert {k: float(v) for k, v in rows} == got
    empty = lt.rooted_instance("empty")
    with pytest.raises(RuntimeError, match="load some trees"):
        empty.unconditional_subsplit_probabilities()


@pytest.mark.parametrize("dates", ["none", "not_initialized"])
def test_time_tree_access_needs_tip_dates(data_dir, dates):
    """Without tip dates, or with dates but no time-tree initialisation
    (parse_dates_from_taxon_names(False) leaves the ratios unset, asserted
    first), the likelihood calls raise the reference's guidance."""
    inst = lt.rooted_instance("guard")
    inst.read_newick_file(f"{data_dir}/fluA.tree")
    inst.read_fasta_file(f"{data_dir}/fluA.fa")
    if dates == "not_initialized":
        inst.parse_dates_from_taxon_names(False)
        trees = inst.tree_collection.trees
        assert all(t.height_ratios is None for t in trees)
        assert all(t.node_bounds is not None for t in trees)
    inst.process_loaded_trees()
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict"), device="cpu")
    for call in (inst.log_likelihoods, inst.phylo_gradients):
        with pytest.raises(RuntimeError, match="tip dates"):
            call()


def test_dates_from_csv_match_taxon_names(data_dir, tmp_path):
    """parse_dates_from_csv with the dates the taxon names carry gives the
    same time trees and LL as parse_dates_from_taxon_names."""
    ref = _instances(data_dir, "jc69")[1]
    tree = ref.tree_collection.trees[0]
    path = tmp_path / "dates.csv"
    with open(path, "w") as f:
        for (leaf, _), taxon in ref.tree_collection.tag_taxon_map.items():
            f.write(f"{taxon},{taxon.rsplit('_', 1)[-1]}\n")
    inst = lt.rooted_instance("csv dates")
    inst.read_newick_file(f"{data_dir}/fluA.tree")
    inst.read_fasta_file(f"{data_dir}/fluA.fa")
    inst.parse_dates_from_csv(str(path), True)
    inst.set_clock_rates(CLOCK_RATE)
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict"), device="cpu")
    np.testing.assert_allclose(inst.tree_collection.trees[0].height_ratios,
                               tree.height_ratios, rtol=1e-12)
    assert_rel(inst.log_likelihoods(), ref.log_likelihoods(), 1e-12)
