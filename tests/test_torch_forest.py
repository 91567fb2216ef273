"""The port's forest mode (libsbn_tpu_torch.ops.forest) against
libsbn_tpu.ops.forest and against the port's own per-tree engine.

Same numpy inputs (data/ files parsed by both packages, branch lengths from
numpy seeds) through both packages, float64 on the CPU (``device="cpu"``):

* every case of tests/test_forest.py, on the port: the forest against the
  per-tree scan engine (ops/pruning.py), the JC69 path against the generic
  path (fused and unfused), the split gradient against the per-tree edge
  gradients aggregated onto splits, the branch ascent, split
  canonicalization across rootings and 69-taxon clade masks;
* against the JAX package directly: every ForestSchedule field and the
  fused up-pass plan equal, LLs and gradients within rel 1e-10, the split
  gradient against jax.value_and_grad at rel 1e-10, a 50-step ascent
  trace at rel 1e-9, forest_stats equal, the public names equal;
* batched (R, n_splits) calls equal R single calls; the bf16-gather
  gradient's error on DS1.100 at float32; numpy inputs default to the card.

The JAX functions run under jax.jit over a closed-over schedule: eagerly,
XLA compiles every per-level op of a call on its own (about 40 s a call on
DS1.100 against about 2 s jitted).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.io import newick as jnewick
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.ops import forest as jforest
from libsbn_tpu.ops import substitution as jsubstitution
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.ops import forest, pruning, schedule, substitution

torch.set_num_threads(1)

F64 = torch.float64
REL = 1e-10  # port vs libsbn_tpu at f64
TRACE_REL = 1e-9  # a 50-step ascent trace
# The largest relative error of the f32 fused gradient with bf16 gathers
# against the f64 gradient on DS1.100 (seed 7 lengths; every entry has
# |g| > 1), as this file measures it on the CPU; bf16 rounding is the
# same on any device. The bench's gradient gate is 2e-2.
BF16_GRAD_REL = 6.785e-4
BF16_GATE = 2e-2

DATASETS = {
    "five_taxon": ("five_taxon_unrooted.nwk", "five_taxon.fasta"),
    "rooted_two": ("hello_rooted_two_trees.nwk", "hello.fasta"),
    "ds1_100": ("DS1.100_topologies.nwk", "DS1.fasta"),
}


class Pair:
    """One dataset through both packages: polished topologies, each
    package's forest, and the (equal) tips and weights as numpy."""

    def __init__(self, data_dir, nwk, fasta):
        jtops, _, jttm = jnewick.parse_newick_file(f"{data_dir}/{nwk}")
        tops, _, ttm = newick.parse_newick_file(f"{data_dir}/{nwk}")
        for t in jtops + tops:
            t.polish()
        self.jtops, self.tops = jtops, tops
        self.jfs, self.fs = jforest.build_forest(jtops), forest.build_forest(tops)
        jsp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/{fasta}"), jttm)
        sp = SitePattern(Alignment.read_fasta(f"{data_dir}/{fasta}"), ttm)
        np.testing.assert_array_equal(sp.tip_partials(), jsp.tip_partials())
        np.testing.assert_array_equal(sp.weights, jsp.weights)
        self.tips, self.w = sp.tip_partials(), sp.weights


_PAIRS = {}


@pytest.fixture(params=sorted(DATASETS))
def pair(request, data_dir):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(data_dir, *DATASETS[request.param])
    return _PAIRS[request.param]


def ds1_pair(data_dir):
    if "ds1_100" not in _PAIRS:
        _PAIRS["ds1_100"] = Pair(data_dir, *DATASETS["ds1_100"])
    return _PAIRS["ds1_100"]


def five_pair(data_dir):
    if "five_taxon" not in _PAIRS:
        _PAIRS["five_taxon"] = Pair(data_dir, *DATASETS["five_taxon"])
    return _PAIRS["five_taxon"]


def lengths(fs, seed=7, lo=0.02, hi=0.2):
    return np.random.default_rng(seed).uniform(lo, hi, fs.n_splits)


def jc_model():
    """The port's JC69 model tensors (freqs, evec, ivec, evals, Q_scaled,
    rates, props) on the CPU in f64."""
    freqs, evec, ivec, evals = substitution.jc69_eigen()
    one = torch.ones(1, dtype=F64)
    return freqs, evec, ivec, evals, substitution.jc69_q()[None], one, one


def generic(fs, bl, tips, w):
    freqs, evec, ivec, evals, Q, rates, props = jc_model()
    return forest.forest_log_likelihoods_and_gradients(
        fs, bl, evec, ivec, evals, Q, tips, freqs, rates, props, w,
        device="cpu")


def jc(fs, bl, tips, w, **kw):
    kw.setdefault("dtype", F64)
    return forest.forest_jc_log_likelihoods_and_gradients(
        fs, bl, tips, w, device="cpu", **kw)


def per_tree(tops, fs, bl_splits, tips, w, chunk=25):
    """(ll (T,), grad (T, N-1)) of every tree through the port's per-tree
    scan engine (ops/pruning.py), JC69, f64, in chunks of trees."""
    freqs, evec, ivec, evals, Q, rates, props = jc_model()
    tips_t, w_t = torch.as_tensor(tips), torch.as_tensor(w)
    lls, grads = [], []
    for i in range(0, len(tops), chunk):
        part = tops[i:i + chunk]
        sched = schedule.schedules_of_topologies(part)
        bl = np.stack([np.concatenate([fs.tree_branch_lengths(t, bl_splits),
                                       [0.0]]) for t in part])
        P = pruning.node_transition_matrices(
            evec, ivec, evals, torch.as_tensor(bl), rates)
        ll, g = pruning.log_likelihood_and_branch_gradient(
            torch.as_tensor(sched.post_children).long(), P, Q, tips_t, freqs,
            props, w_t, root_id=sched.root_id)
        lls.append(ll)
        grads.append(g)
    return torch.cat(lls).numpy(), torch.cat(grads).numpy()


def rel_close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.max(
        np.abs(want)), err_msg=what)


# -- the schedule ----------------------------------------------------------------


def test_schedules_equal_libsbn_tpu(pair):
    """build_forest gives the JAX package's arrays, field by field, dtypes
    included, and the same fused up-pass plan."""
    for f in dataclasses.fields(jforest.ForestSchedule):
        a, b = getattr(pair.jfs, f.name), getattr(pair.fs, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert b == a, f.name
    (jplan, jpos), (plan, pos) = (jforest._fused_up_plan(pair.jfs),
                                  forest._fused_up_plan(pair.fs))
    np.testing.assert_array_equal(pos, jpos)
    assert len(plan) == len(jplan)
    for a, b in zip(plan, jplan):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y)


def test_forest_stats_equal(pair):
    assert forest.forest_stats(pair.fs) == jforest.forest_stats(pair.jfs)


def test_public_names_equal():
    """Every public name defined in libsbn_tpu.ops.forest is defined in the
    port's module, and no other."""
    def names(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__}

    assert names(forest) == names(jforest)
    assert {"ForestSchedule", "build_forest", "forest_stats",
            "forest_branch_ascent"} <= names(forest)
    assert callable(forest._clade_mask)


# -- against libsbn_tpu ------------------------------------------------------------


def test_generic_matches_libsbn_tpu(pair):
    bl = lengths(pair.fs)
    freqs, evec, ivec, evals = jsubstitution.jc69_eigen()
    want = jax.jit(lambda b: jforest.forest_log_likelihoods_and_gradients(
        pair.jfs, b, evec, ivec, evals, jsubstitution.jc69_q()[None],
        jnp.asarray(pair.tips), freqs, jnp.ones(1), jnp.ones(1),
        jnp.asarray(pair.w)))(jnp.asarray(bl))
    got = generic(pair.fs, bl, pair.tips, pair.w)
    rel_close(got[0], want[0], REL, "LLs")
    rel_close(got[1], want[1], REL, "gradients")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_jc_matches_libsbn_tpu(pair, fused):
    bl = lengths(pair.fs, seed=3)
    want = jax.jit(lambda b: jforest.forest_jc_log_likelihoods_and_gradients(
        pair.jfs, b, jnp.asarray(pair.tips), jnp.asarray(pair.w),
        dtype=jnp.float64, fused=fused))(jnp.asarray(bl))
    ll, g = jc(pair.fs, bl, pair.tips, pair.w, fused=fused)
    assert ll.dtype == g.dtype == F64
    rel_close(ll, want[0], REL, "LLs")
    rel_close(g, want[1], REL, "gradients")


def test_split_gradient_matches_value_and_grad(pair):
    """The split gradient by autograd against libsbn_tpu's jax.value_and_grad
    of the same weighted objective (lam from a seed)."""
    bl = lengths(pair.fs, seed=1)
    lam = np.random.default_rng(1).uniform(0.5, 1.5, pair.fs.tree_count)
    want = jax.jit(lambda b: jforest.forest_jc_weighted_ll_and_split_gradient(
        pair.jfs, b, jnp.asarray(pair.tips), jnp.asarray(pair.w),
        lam=jnp.asarray(lam), dtype=jnp.float64))(jnp.asarray(bl))
    ll, g = forest.forest_jc_weighted_ll_and_split_gradient(
        pair.fs, bl, pair.tips, pair.w, lam=lam, dtype=F64, device="cpu")
    assert not g.requires_grad and g.dtype == F64 and g.shape == (pair.fs.n_splits,)
    rel_close(ll, want[0], REL, "LLs")
    rel_close(g, want[1], REL, "split gradient")


def test_ascent_trace_matches_libsbn_tpu(data_dir):
    """50 f64 Adam steps from 0.1 on five_taxon: the objective trace at rel
    1e-9, the lengths and final LLs at rel 1e-9."""
    p = five_pair(data_dir)
    bl0 = np.full(p.fs.n_splits, 0.1)
    jbl, jll, jtrace = jforest.forest_branch_ascent(
        p.jfs, bl0, jnp.asarray(p.tips), jnp.asarray(p.w), steps=50,
        dtype=jnp.float64)
    bl, ll, trace = forest.forest_branch_ascent(
        p.fs, bl0, p.tips, p.w, steps=50, dtype=F64, device="cpu")
    assert trace.shape == (50,)
    rel_close(trace, jtrace, TRACE_REL, "trace")
    rel_close(bl, jbl, TRACE_REL, "lengths")
    rel_close(ll, jll, TRACE_REL, "LLs")


# -- tests/test_forest.py's cases, on the port ----------------------------------------


@pytest.mark.parametrize("name,rtol", [("five_taxon", 1e-9),
                                       ("rooted_two", 1e-9),
                                       ("ds1_100", 1e-8)])
def test_forest_vs_per_tree(data_dir, name, rtol):
    """test_forest.py's _forest_vs_pertree cases (five_taxon, the rooted
    pair, DS1.100): the generic forest against the port's per-tree scan
    engine, tree by tree."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(data_dir, *DATASETS[name])
    p = _PAIRS[name]
    bl = lengths(p.fs)
    ll_f, g_f = generic(p.fs, bl, p.tips, p.w)
    ll_t, g_t = per_tree(p.tops, p.fs, bl, p.tips, p.w)
    np.testing.assert_allclose(ll_f.numpy(), ll_t, rtol=rtol)
    np.testing.assert_allclose(g_f.numpy(), g_t, rtol=rtol, atol=1e-9)
    if name == "five_taxon":
        assert forest.forest_stats(p.fs)["op_sharing"] >= 1.0
    if name == "ds1_100":
        stats = forest.forest_stats(p.fs)
        assert stats["op_sharing"] > 2.0
        assert stats["down_internal_unique"] < 400


@pytest.mark.parametrize("name", ["five_taxon", "ds1_100"])
def test_forest_jc_vs_generic(data_dir, name):
    """test_forest.py's _forest_jc_vs_generic: the matrix-free JC69 path
    (fused and unfused, and LL-only) against the generic path in f64."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(data_dir, *DATASETS[name])
    p = _PAIRS[name]
    bl = lengths(p.fs, seed=3)
    ll_g, g_g = generic(p.fs, bl, p.tips, p.w)
    for fused in (True, False):
        ll_j, g_j = jc(p.fs, bl, p.tips, p.w, fused=fused)
        np.testing.assert_allclose(ll_j.numpy(), ll_g.numpy(), rtol=1e-10)
        np.testing.assert_allclose(g_j.numpy(), g_g.numpy(), rtol=1e-8,
                                   atol=1e-9)
    ll_o, none = jc(p.fs, bl, p.tips, p.w, ll_only=True)
    assert none is None
    np.testing.assert_allclose(ll_o.numpy(), ll_g.numpy(), rtol=1e-10)


def test_forest_weighted_split_gradient(data_dir):
    """test_forest.py's case: one reverse pass through the shared down DAG
    equals aggregating the per-tree edge gradients onto splits."""
    p = five_pair(data_dir)
    rng = np.random.default_rng(1)
    bl = rng.uniform(0.02, 0.2, p.fs.n_splits)
    lam = rng.uniform(0.5, 1.5, p.fs.tree_count)
    ll_w, g_ad = forest.forest_jc_weighted_ll_and_split_gradient(
        p.fs, bl, p.tips, p.w, lam=lam, dtype=F64, device="cpu")
    ll, grad = jc(p.fs, bl, p.tips, p.w)
    np.testing.assert_allclose(ll_w.numpy(), ll.numpy(), rtol=1e-12)
    g_ref = np.zeros(p.fs.n_splits)
    for ti, top in enumerate(p.tops):
        for node in top.postorder():
            if node.id == top.id:
                continue
            sidx = p.fs.split_of_clade[forest._clade_mask(node)]
            g_ref[sidx] += lam[ti] * float(grad[ti, node.id])
    np.testing.assert_allclose(g_ad.numpy(), g_ref, rtol=1e-8, atol=1e-10)


def test_forest_branch_ascent(data_dir):
    """test_forest.py's case: 400 Adam steps improve the summed LL, land
    near a stationary point, and the optimum re-evaluates identically
    through the per-tree engine."""
    p = five_pair(data_dir)
    bl, ll, trace = forest.forest_branch_ascent(
        p.fs, np.full(p.fs.n_splits, 0.1), p.tips, p.w, steps=400, lr=0.05,
        dtype=F64, device="cpu")
    assert float(trace[-1]) > float(trace[0]) + 1.0
    _, g = forest.forest_jc_weighted_ll_and_split_gradient(
        p.fs, bl, p.tips, p.w, dtype=F64)
    assert float(torch.max(torch.abs(g * bl))) < 0.05  # log-space gradient
    ll_t, _ = per_tree(p.tops, p.fs, bl.numpy(), p.tips, p.w)
    np.testing.assert_allclose(ll.numpy(), ll_t, rtol=1e-9)


def test_forest_split_canonicalization_across_rootings():
    """The same unrooted branch in differently-rooted trees shares ONE split
    id, and the two trees get identical likelihoods."""
    nwk = "(t0,t1,(t2,(t3,t4)));\n(t3,t4,(t2,(t0,t1)));\n"
    tops, _, _ = newick.parse_newick_string(nwk)
    for t in tops:
        t.polish()
    fs = forest.build_forest(tops)
    assert fs.n_splits == 8
    m34 = (1 << 3) | (1 << 4)
    full = (1 << 5) - 1
    assert fs.split_of_clade[m34] == fs.split_of_clade[full ^ m34]
    m01 = (1 << 0) | (1 << 1)
    assert fs.split_of_clade[m01] == fs.split_of_clade[full ^ m01]
    bl = np.random.default_rng(3).uniform(0.02, 0.2, fs.n_splits)
    tips = np.random.default_rng(0).dirichlet(
        np.ones(4), size=(5, 20)).transpose(0, 2, 1)
    ll, _ = generic(fs, bl, tips, np.ones(20))
    np.testing.assert_allclose(float(ll[0]), float(ll[1]), rtol=1e-12)


def test_forest_large_taxon_masks(data_dir):
    """fluA's 69-taxon clade masks exceed int64: the schedule keeps Python
    ints and a one-tree forest evaluates as the per-tree engine does."""
    tops, bls, ttm = newick.parse_newick_file(f"{data_dir}/fluA.tree")
    for t in tops:
        t.polish()
    fs = forest.build_forest(tops)
    assert fs.leaf_count == 69
    assert max(fs.split_of_clade) >> 63 > 0
    sp = SitePattern(Alignment.read_fasta(f"{data_dir}/fluA.fa"), ttm)
    bl_splits = fs.branch_lengths_from_tree(tops[0], bls[0])
    ll, grad = jc(fs, bl_splits, sp.tip_partials(), sp.weights)
    ll_t, grad_t = per_tree(tops, fs, bl_splits, sp.tip_partials(), sp.weights)
    np.testing.assert_allclose(ll.numpy(), ll_t, rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), grad_t, rtol=1e-8, atol=1e-9)


# -- batching, precision, devices -----------------------------------------------------


@pytest.mark.parametrize("call", ["jc", "jc_ll_only", "jc_unfused", "generic",
                                  "split_gradient", "ascent"])
def test_batched_equals_single_calls(data_dir, call):
    """bl_splits (R, n_splits) gives the R single calls' results stacked."""
    p = five_pair(data_dir)
    rng = np.random.default_rng(5)
    bls = rng.uniform(0.02, 0.2, (3, p.fs.n_splits))

    def run(bl):
        if call == "jc":
            return jc(p.fs, bl, p.tips, p.w)
        if call == "jc_ll_only":
            return jc(p.fs, bl, p.tips, p.w, ll_only=True)[:1]
        if call == "jc_unfused":
            return jc(p.fs, bl, p.tips, p.w, fused=False)
        if call == "generic":
            return generic(p.fs, bl, p.tips, p.w)
        if call == "split_gradient":
            return forest.forest_jc_weighted_ll_and_split_gradient(
                p.fs, bl, p.tips, p.w, dtype=F64, device="cpu")
        return forest.forest_branch_ascent(p.fs, bl, p.tips, p.w, steps=5,
                                           dtype=F64, device="cpu")

    batched = run(bls)
    singles = [run(b) for b in bls]
    for i, got in enumerate(batched):
        want = torch.stack([s[i] for s in singles])
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(want.abs().max()))


def test_bf16_gather_gradient_error_on_ds1_100(data_dir):
    """The f32 fused gradient with bf16 gathers (Ed and the rolling up block
    stored in bf16 for the gradient phase) against the f64 gradient on
    DS1.100: the largest relative error is BF16_GRAD_REL, inside the 2e-2
    gradient gate; the LLs equal the f32 LLs without bf16 gathers."""
    p = ds1_pair(data_dir)
    bl = lengths(p.fs)
    _, g64 = jc(p.fs, bl, p.tips, p.w)
    ll32, _ = jc(p.fs, bl, p.tips, p.w, dtype=torch.float32)
    llb, gb = jc(p.fs, bl, p.tips, p.w, dtype=torch.float32,
                 gather_dtype=torch.bfloat16)
    assert gb.dtype == torch.float32
    assert torch.equal(llb, ll32)
    g64 = g64.numpy()
    assert np.all(np.abs(g64) > 1.0)
    err = float(np.max(np.abs(gb.double().numpy() - g64) / np.abs(g64)))
    assert err < BF16_GATE
    np.testing.assert_allclose(err, BF16_GRAD_REL, rtol=1e-3)


def test_numpy_inputs_default_to_the_card(data_dir):
    """Without device, numpy inputs compute on the card; without one they
    raise a RuntimeError naming device="cpu". CPU tensors compute where
    they lie."""
    p = five_pair(data_dir)
    bl = lengths(p.fs)
    ll, _ = forest.forest_jc_log_likelihoods_and_gradients(
        p.fs, torch.as_tensor(bl), torch.as_tensor(p.tips),
        torch.as_tensor(p.w), dtype=F64)
    assert ll.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers it")
    for call in (
            lambda: forest.forest_jc_log_likelihoods_and_gradients(
                p.fs, bl, p.tips, p.w),
            lambda: forest.forest_jc_weighted_ll_and_split_gradient(
                p.fs, bl, p.tips, p.w),
            lambda: forest.forest_branch_ascent(p.fs, bl, p.tips, p.w, steps=1),
            lambda: generic_default_device(p.fs, bl, p.tips, p.w)):
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            call()


def generic_default_device(fs, bl, tips, w):
    freqs, evec, ivec, evals, Q, rates, props = jc_model()
    return forest.forest_log_likelihoods_and_gradients(
        fs, bl, evec, ivec, evals, Q, tips, freqs, rates, props, w)


# The same error on the JAX bench's forest lengths (forest_shared_ds1_100:
# the per-split means of DS1.100's lengths, which the file leaves at 1, times
# U(0.8, 1.2) from default_rng(0), R = 8 sets): the largest relative error
# per set, and the entries per set outside the gradient gate (rtol 2e-2,
# atol 0.5). Near-uniform partials make 0.25 See Sue / denom - 1 cancel, so
# bf16 rounding shows; libsbn_tpu gives the same on the CPU. The bench
# gates the first set only.
BENCH_BF16_REL = [0.02086, 0.02311, 0.01748, 0.01842, 0.02357, 0.03006,
                  0.02018, 0.0191]
BENCH_BF16_OUTSIDE = [0, 0, 0, 0, 0, 2, 0, 0]


def test_bf16_gather_gradient_error_on_the_bench_lengths(data_dir):
    p = ds1_pair(data_dir)
    _, bls, _ = newick.parse_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    fs = p.fs
    sums, counts = np.zeros(fs.n_splits), np.zeros(fs.n_splits)
    for top, bl in zip(p.tops, bls):
        for node in top.postorder():
            if node.id != top.id:
                idx = fs.split_of_clade[forest._clade_mask(node)]
                sums[idx] += bl[node.id]
                counts[idx] += 1
    means = sums / np.maximum(counts, 1)
    bl = (means[None] * np.random.default_rng(0).uniform(
        0.8, 1.2, (8, fs.n_splits))).astype(np.float32)
    _, g64 = jc(fs, bl.astype(np.float64), p.tips, p.w)
    _, gb = jc(fs, bl, p.tips, p.w, dtype=torch.float32,
               gather_dtype=torch.bfloat16)
    g64, gap = g64.numpy(), np.abs(gb.double().numpy() - g64.numpy())
    np.testing.assert_allclose(np.max(gap / np.abs(g64), axis=(1, 2)),
                               BENCH_BF16_REL, rtol=2e-3)
    outside = (gap > 0.5 + BF16_GATE * np.abs(g64)).sum(axis=(1, 2))
    assert outside.tolist() == BENCH_BF16_OUTSIDE
    np.testing.assert_allclose(gb[0].double().numpy(), g64[0], rtol=BF16_GATE,
                               atol=0.5)
