"""The port's scale tools (libsbn_tpu_torch/utils/scale_compare.py,
gp_scale.py and forest_scale.py), its forest graphs (ops/forest_graph.py)
and profiling.timed_evals_per_sec on the CPU, held to libsbn_tpu and to the
JAX repository's tools/ on the same numpy inputs (float64 unless named):

* the generators: scale_compare's tree equals libsbn_tpu's built the same
  way (tests/test_scale.py), and gp_scale.make_data writes the bytes of
  tools/gp_scale.make_data;
* scale_compare.run(40, 128, 4): the float64 twin of K1 against the native
  float64 baseline and libsbn_tpu's scan engine at rel 1e-10, the float32
  twin against libsbn_tpu's Pallas JC69 kernel (interpret mode) within the
  float32 gate, and the tool's own gate;
* gp_scale at 12 taxa x 300 sites: both ascents' marginals and sweeps
  against libsbn_tpu's GPInstance, and the tool's gate;
* forest_scale at 50 sampled trees: the same topologies and forest_stats as
  libsbn_tpu's sampler and forest, and the three surfaces against
  libsbn_tpu's jitted ones;
* ForestGraphs on the CPU returns what the eager functions return, and
  each tool's main raises without a card unless given --device cpu.
"""

import importlib.util
import os
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libsbn_tpu import UnrootedInstance as JUnrootedInstance
from libsbn_tpu.core.site_pattern import SitePattern as JSitePattern
from libsbn_tpu.core.topology import Topology as JTopology
from libsbn_tpu.gp.instance import GPInstance as JGPInstance
from libsbn_tpu.io.fasta import Alignment as JAlignment
from libsbn_tpu.models.engine import LikelihoodEngine as JLikelihoodEngine
from libsbn_tpu.models.phylo_model import PhyloModelSpec as JPhyloModelSpec
from libsbn_tpu.models.phylo_model import default_parameters
from libsbn_tpu.ops import forest as jforest
from libsbn_tpu.ops import pruning_pallas_jc
from libsbn_tpu.ops import schedule as jschedule
from libsbn_tpu_torch.ops import forest, forest_graph, pruning_jc
from libsbn_tpu_torch.utils import forest_scale, gp_scale, profiling
from libsbn_tpu_torch.utils import scale_compare

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-10  # the float64 twin against float64 references
GP_REL = 1e-9  # a GP fit's marginal, and the forest surfaces
# The float32 gate (PERF.md §2): LLs (rtol, atol), gradients rtol.
F32_LL = (1e-5, 0.5)
F32_GRAD = 2e-2
BF16_GATE = 2e-2  # tests/test_torch_forest.py's gradient gate for bf16
SMALL = (40, 128, 4)  # taxa, patterns, trees
GP_SMALL = (12, 300)  # taxa, sites
FOREST_TREES = 50


def rel_close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.max(
        np.abs(want)), err_msg=what)


def jax_tree(taxa, rng):
    """tests/test_scale.py's random_unrooted, on libsbn_tpu's Topology."""
    nodes = [JTopology.leaf(i) for i in range(taxa)]
    while len(nodes) > 3:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False), reverse=True)
        a, b = nodes.pop(i), nodes.pop(j)
        nodes.append(JTopology.join2(a, b))
    t = JTopology.join(nodes)
    t.polish()
    return t


def tools_module(name):
    """tools/<name>.py of the JAX repository, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- profiling.timed_evals_per_sec ----------------------------------------------


def test_timed_evals_per_sec_counts_fixed_windows():
    """A warm-up and a sizing call, then `windows` windows of at least 8
    calls each, each ending in a value fetch; the rate is positive."""
    calls = []

    def run():
        calls.append(1)
        return np.ones(3)

    rate = profiling.timed_evals_per_sec(run, 10, windows=2, target_s=1e-6)
    assert rate > 0
    assert len(calls) == 2 + 2 * 8


# -- scale_compare ---------------------------------------------------------------


@pytest.mark.parametrize("taxa", [27, 200])
def test_scale_compare_tree_matches_libsbn_tpu(taxa):
    """The tree from default_rng(0) has libsbn_tpu's schedule."""
    inp = scale_compare.make_inputs(taxa, 8, 2)
    want = jschedule.schedule_of_topology(
        jax_tree(taxa, np.random.default_rng(0)))
    np.testing.assert_array_equal(inp["sched"].post_children,
                                  want.post_children)
    np.testing.assert_array_equal(inp["sched"].up_sibs, want.up_sibs)
    assert inp["sched"].root_id == want.root_id


def test_sweep_straddles_the_onchip_plan():
    """The sweep's third point is the largest tree that fits K1's float32
    K = 1 plan and its fourth the smallest that does not."""
    points = scale_compare.sweep_points()
    assert points[:2] == (27, 200) and points[-1] == 1000
    edge, past = points[2], points[3]
    assert (edge, past) == (433, 434)
    for taxa, fits in ((edge, True), (past, False)):
        S = scale_compare.make_inputs(taxa, 8, 1)["pc"].shape[1]
        plan = pruning_jc.onchip_plan(torch.float32, 1, S, taxa)
        assert (plan is not None) == fits


_RUNS = {}


def small_run():
    if "scale" not in _RUNS:
        _RUNS["scale"] = scale_compare.run(*SMALL, device="cpu",
                                           target_s=1e-3)
    return _RUNS["scale"]


def test_scale_compare_f64_twin_matches_native():
    r = small_run()
    edges = r["inputs"]["sched"].node_count - 1
    rel_close(r["f64"]["ll"], r["native"]["ll"], REL, "LLs")
    rel_close(r["f64"]["grad"], r["native"]["grad"][:, :edges], REL,
              "gradients")
    assert r["route"] == {"f32": "twin", "f64": "twin"}
    assert all(v > 0 for v in r["evals_per_s"].values())


def test_scale_compare_f64_twin_matches_libsbn_tpu_scan_engine():
    r = small_run()
    inp = r["inputs"]
    taxa, _, B = SMALL
    jtop = jax_tree(taxa, np.random.default_rng(0))
    sites = types.SimpleNamespace(tip_partials=lambda: inp["tips"],
                                  weights=inp["w"])
    spec = JPhyloModelSpec("JC69", "constant", "strict")
    eng = JLikelihoodEngine(sites, spec, dtype=jnp.float64)
    lls, grads = eng.branch_gradients(
        jschedule.schedules_of_topologies([jtop] * B), inp["bl"][:, :-1],
        default_parameters(spec))
    rel_close(r["f64"]["ll"], lls, REL, "LLs")
    rel_close(r["f64"]["grad"], grads, REL, "gradients")


def test_scale_compare_f32_twin_matches_libsbn_tpu_pallas():
    r = small_run()
    inp = r["inputs"]
    ll, grad = pruning_pallas_jc.log_likelihood_and_branch_gradient_pallas_jc69(
        inp["pc"], jnp.asarray(inp["bl"], jnp.float32), jnp.asarray(inp["tips"]),
        jnp.asarray(inp["w"]), root_id=inp["sched"].root_id, interpret=True)
    np.testing.assert_allclose(r["f32"]["ll"], np.asarray(ll, np.float64),
                               rtol=F32_LL[0], atol=F32_LL[1])
    np.testing.assert_allclose(r["f32"]["grad"], np.asarray(grad, np.float64),
                               rtol=F32_GRAD, atol=F32_GRAD)


def test_scale_compare_gate_holds():
    r = small_run()
    assert r["gate_native"] < scale_compare.GATE
    assert r["native_finite"] and r["f32_finite"]
    scale_compare.check(r)
    assert any("gate" in line for line in scale_compare.describe(r, "cpu"))


# -- gp_scale --------------------------------------------------------------------


def test_gp_make_data_bytes_equal_the_jax_tool():
    taxa, sites = GP_SMALL
    jtool = tools_module("gp_scale")
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        got = gp_scale.make_data(taxa, sites, a)
        want = jtool.make_data(taxa, sites, b)
        for g, w in zip(got, want):
            assert os.path.basename(g) == os.path.basename(w)
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read()


def test_gp_scale_matches_libsbn_tpu():
    """Both ascents' marginals at rel 1e-9 and their sweeps equal, against
    libsbn_tpu's GPInstance on the same files; the tool's gate holds."""
    taxa, sites = GP_SMALL
    r = gp_scale.run(taxa, sites, torch.float64, device="cpu", timing=False)
    with tempfile.TemporaryDirectory() as tmp:
        tree_path, fasta_path = gp_scale.make_data(taxa, sites, tmp)
        inst = JGPInstance("scale")
        inst.read_newick_file(tree_path)
        inst.read_fasta_file(fasta_path)
        inst.make_engine(dtype=np.float64)
    eng = inst.get_engine()
    assert inst.dag.node_count() == r["dag_nodes"]
    assert eng.patterns == r["patterns"]
    m, it = eng.run_branch_ascent(*gp_scale.FUSED)
    eng.branch_lengths = np.full_like(eng.branch_lengths, 0.1)
    tol, max_iter, chunk = gp_scale.STREAMED
    m2, it2 = eng.run_branch_ascent_streamed(tol, max_iter,
                                             pattern_chunk=chunk,
                                             finalize=False)
    assert r["fused"]["sweeps"] == it
    assert r["streamed"]["sweeps"] == it2
    rel_close(r["fused"]["marginal"], m, GP_REL, "fused marginal")
    rel_close(r["streamed"]["marginal"], m2, GP_REL, "streamed marginal")
    gp_scale.check(r)


# -- forest_scale and the forest graphs ------------------------------------------


def jax_surfaces(fs, bl, tips, w):
    """libsbn_tpu's three surfaces, jitted and vmapped as the JAX tool
    compiles them, at float64."""
    f64 = jnp.float64
    ll = jax.jit(jax.vmap(lambda b: jforest.forest_jc_log_likelihoods_and_gradients(
        fs, b, tips, w, ll_only=True, dtype=f64)[0]))
    full = jax.jit(jax.vmap(lambda b: jforest.forest_jc_log_likelihoods_and_gradients(
        fs, b, tips, w, dtype=f64, gather_dtype=jnp.bfloat16)))
    split = jax.jit(jax.vmap(lambda b: jforest.forest_jc_weighted_ll_and_split_gradient(
        fs, b, tips, w, dtype=f64)))
    b = jnp.asarray(bl)
    return {"LL-only": np.asarray(ll(b)),
            "LL+grad (bf16)": tuple(np.asarray(x) for x in full(b)),
            "LL+split-grad": tuple(np.asarray(x) for x in split(b))}


def test_forest_scale_matches_libsbn_tpu(data_dir):
    """The same sampled topologies and forest_stats as libsbn_tpu (both
    samplers at seed 0), and the three surfaces at rel 1e-9 (the bf16
    gather's gradients within the bf16 gate)."""
    r = forest_scale.run(FOREST_TREES, device="cpu", dtype=torch.float64,
                         timing=False)
    inst = JUnrootedInstance("scale")
    inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.sample_trees(FOREST_TREES)
    jtops = [t.topology for t in inst.tree_collection.trees]
    for t in jtops:
        if t.id < 0:
            t.polish()
    assert [t.newick() for t in jtops] == [t.newick() for t in r["tops"]]
    jfs = jforest.build_forest(jtops)
    assert jforest.forest_stats(jfs) == forest.forest_stats(r["fs"])
    assert jforest.forest_stats(jfs) == r["stats"]
    sp = JSitePattern(JAlignment.read_fasta(f"{data_dir}/DS1.fasta"),
                      inst.tree_collection.tag_taxon_map)
    want = jax_surfaces(jfs, r["bl"], jnp.asarray(sp.tip_partials()),
                        jnp.asarray(sp.weights))
    got = r["outputs"]
    rel_close(got["LL-only"], want["LL-only"], GP_REL, "LLs")
    rel_close(got["LL+split-grad"][0], want["LL+split-grad"][0], GP_REL,
              "split surface LLs")
    rel_close(got["LL+split-grad"][1], want["LL+split-grad"][1], GP_REL,
              "split gradient")
    rel_close(got["LL+grad (bf16)"][0], want["LL+grad (bf16)"][0], GP_REL,
              "LLs with bf16 gathers")
    g, jg = got["LL+grad (bf16)"][1], want["LL+grad (bf16)"][1]
    assert np.max(np.abs(g - jg) / np.abs(jg)) < BF16_GATE
    forest_scale.check(r)
    assert all(v is None for v in r["bit_for_bit"].values())


def test_forest_graphs_on_the_cpu_equal_the_eager_functions(data_dir):
    """Each surface through ForestGraphs (three calls of one key: eager,
    then its program kept and called again, a plain call over the static
    buffer off the card) returns exactly what the eager function returns."""
    from libsbn_tpu_torch.core.site_pattern import SitePattern
    from libsbn_tpu_torch.io import newick
    from libsbn_tpu_torch.io.fasta import Alignment

    tops, _, ttm = newick.parse_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    fs = forest.build_forest(tops[:20])
    sp = SitePattern(Alignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    bl = torch.as_tensor(np.random.default_rng(0).uniform(
        0.02, 0.2, (2, fs.n_splits)).astype(np.float32))
    graphs = forest_graph.ForestGraphs(sp.tip_partials(), sp.weights,
                                       device="cpu")
    tips, w = torch.as_tensor(sp.tip_partials()), torch.as_tensor(sp.weights)
    calls = {
        "ll": lambda: graphs.log_likelihoods(fs, bl),
        "grad": lambda: graphs.log_likelihoods_and_gradients(
            fs, bl, gather_dtype=torch.bfloat16),
        "split": lambda: graphs.weighted_ll_and_split_gradient(fs, bl),
    }
    for surface, call in calls.items():
        want = forest_graph.eager(surface, fs, bl, tips, w,
                                  gather_dtype=torch.bfloat16)
        for _ in range(3):
            assert forest_graph.bit_for_bit(call(), want), surface
    assert len(graphs) == 3  # a program kept a surface
    with pytest.raises(ValueError):
        graphs.run("nope", fs, bl)


# -- entry points ------------------------------------------------------------------


@pytest.mark.parametrize("tool", [scale_compare, gp_scale, forest_scale])
def test_main_needs_a_card_unless_given_cpu(tool):
    """Without a card and without --device cpu, main raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tool.main([])


def test_tools_import_no_jax():
    code = ("import sys, libsbn_tpu_torch.utils.scale_compare, "
            "libsbn_tpu_torch.utils.gp_scale, "
            "libsbn_tpu_torch.utils.forest_scale, "
            "libsbn_tpu_torch.ops.forest_graph; "
            "assert 'jax' not in sys.modules and "
            "'libsbn_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
