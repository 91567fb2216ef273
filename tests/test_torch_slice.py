"""The port's slice as a user drives it, against libsbn_tpu.

The README quick start through both packages' UnrootedInstance, the
parameter bridge between them, the port's independence from JAX, and the
paths that are not ported yet.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import libsbn_tpu
import libsbn_tpu_torch
from libsbn_tpu.models.phylo_model import block_specification as jblock_spec
from libsbn_tpu.models.phylo_model import default_parameters as jdefaults
from libsbn_tpu_torch.models.phylo_model import (
    PhyloModelSpec, block_specification, params_from_numpy,
)
from libsbn_tpu_torch.gp import GPInstance
from libsbn_tpu_torch.gp.engine import GPEngine
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.vi import JitVBPI

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK_STARTS = [
    ("hello.nwk", "hello.fasta", "constant"),
    ("DS1.subsampled_10.t", "DS1.fasta", "constant"),
    ("DS1.100_topologies.nwk", "DS1.fasta", "constant"),
    ("DS1.subsampled_10.t", "DS1.fasta", "weibull+4"),
]


def _instance(package, data_dir, trees, fasta, site):
    inst = package.UnrootedInstance("quick start")
    if trees.endswith(".t"):
        inst.read_nexus_file(f"{data_dir}/{trees}")
    else:
        inst.read_newick_file(f"{data_dir}/{trees}")
    inst.read_fasta_file(f"{data_dir}/{fasta}")
    kw = {"device": "cpu"} if package is libsbn_tpu_torch else {}
    inst.prepare_for_phylo_likelihood(
        package.PhyloModelSpec("JC69", site, "strict"), **kw
    )
    return inst


@pytest.mark.parametrize("trees,fasta,site", QUICK_STARTS)
def test_quick_start_matches_jax(data_dir, trees, fasta, site):
    """log_likelihoods (and phylo_gradients where the slice has them) of
    the port's instance vs libsbn_tpu's, f64 on the CPU: relative error
    <= 1e-10 (gradients: atol 1e-10 x the largest |gradient|)."""
    ref = _instance(libsbn_tpu, data_dir, trees, fasta, site)
    got = _instance(libsbn_tpu_torch, data_dir, trees, fasta, site)
    assert got.tree_count() == ref.tree_count()
    assert got.taxon_names() == ref.taxon_names()
    np.testing.assert_array_equal(
        got.branch_length_matrix(), ref.branch_length_matrix()
    )
    if site != "constant":
        ref.phylo_model_params["site"]["shape"] = jnp.asarray(0.5)
        got.phylo_model_params["site"]["shape"] = torch.tensor(
            0.5, dtype=torch.float64
        )
    lls = got.log_likelihoods()
    assert isinstance(lls, np.ndarray) and lls.dtype == np.float64
    np.testing.assert_allclose(lls, ref.log_likelihoods(), rtol=1e-10)
    if site != "constant":
        return  # Weibull phylo_gradients: tests/test_torch_dea.py
    want = ref.phylo_gradients()
    grads = got.phylo_gradients()
    assert set(grads) == set(want)
    g, wg = grads["branch_lengths"].numpy(), np.asarray(want["branch_lengths"])
    np.testing.assert_allclose(
        grads["log_likelihood"].numpy(), np.asarray(want["log_likelihood"]),
        rtol=1e-10,
    )
    np.testing.assert_allclose(g, wg, rtol=1e-10, atol=1e-10 * np.abs(wg).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("site", ["constant", "weibull+4"])
@pytest.mark.parametrize("sub", ["JC69", "GTR"])
def test_params_from_numpy_round_trip(sub, site, dtype):
    """The JAX package's parameters, as numpy, become the port's dict of
    tensors with the same nesting and values (GTR: {"substitution":
    {"rates", "frequencies"}}, at non-default values), and the block
    specifications agree."""
    spec = PhyloModelSpec(sub, site, "strict")
    jparams = jdefaults(libsbn_tpu.PhyloModelSpec(sub, site, "strict"))
    if sub == "GTR":
        jparams["substitution"] = {
            "rates": jnp.asarray([0.1, 0.2, 0.15, 0.25, 0.2, 0.1]),
            "frequencies": jnp.asarray([0.3, 0.25, 0.2, 0.25]),
        }
    as_numpy = {k: {n: np.asarray(x) for n, x in v.items()}
                for k, v in jparams.items()}
    params = params_from_numpy(as_numpy, "cpu", dtype)
    assert params.keys() == as_numpy.keys()
    for k, v in as_numpy.items():
        assert params[k].keys() == v.keys()
        for n, x in v.items():
            t = params[k][n]
            assert isinstance(t, torch.Tensor) and t.dtype == dtype
            assert t.device.type == "cpu" and t.shape == x.shape
            np.testing.assert_array_equal(t.numpy(), x.astype(t.numpy().dtype))
    assert block_specification(spec).get_map() == jblock_spec(
        libsbn_tpu.PhyloModelSpec(sub, site, "strict")
    ).get_map()


def test_import_leaves_jax_out():
    """Importing the port (and its whole slice) never imports JAX or the
    JAX package: the machine with the card has no JAX."""
    code = (
        "import sys\n"
        "import libsbn_tpu_torch\n"
        "from libsbn_tpu_torch.instance import generic, rooted, unrooted\n"
        "from libsbn_tpu_torch.ops import _kernels, heights, pruning_jc\n"
        "from libsbn_tpu_torch.ops import pruning, pruning_generic, pruning_vjp\n"
        "from libsbn_tpu_torch.ops import substitution, transforms\n"
        "from libsbn_tpu_torch.sbn import gradients, probability, sampling\n"
        "from libsbn_tpu_torch.vi import JitVBPI, jit_step\n"
        "from libsbn_tpu_torch.gp import GPInstance, SubsplitDAG\n"
        "from libsbn_tpu_torch.gp import engine, engine_kernels, quartet\n"
        "from libsbn_tpu_torch.utils import combinatorics\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'libsbn_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def _ds1(data_dir, site="constant"):
    return _instance(libsbn_tpu_torch, data_dir, "DS1.subsampled_10.t",
                     "DS1.fasta", site)


@pytest.mark.parametrize("path", [
    "per_tree", "tree_count_option", "vbpi_mesh", "gp_streamed", "gp_mesh",
    "em",
])
def test_unported_paths_raise(data_dir, path):
    """Paths not on the port yet raise NotImplementedError naming their
    ROADMAP item; none falls back to anything. The per-tree parameters,
    tree_count_option and EM came with item 5: a per-tree call whose
    parameters lack the tree axis, and a parameter matrix with fewer rows
    than trees, raise ValueError; EM runs on the device it is given."""
    if path == "per_tree":
        inst = _ds1(data_dir)
        with pytest.raises(ValueError, match="lead with the 10 trees"):
            inst.engine.log_likelihoods(
                inst._batched_schedule(), inst.branch_length_matrix(),
                inst.phylo_model_params, per_tree=True)
        return
    if path == "tree_count_option":
        inst = _ds1(data_dir)
        inst.prepare_for_phylo_likelihood(
            PhyloModelSpec(), tree_count_option=3, device="cpu")
        assert inst.get_phylo_model_params().shape == (3, 1)
        with pytest.raises(ValueError, match="rows < 10 trees"):
            inst.log_likelihoods()
        return
    if path == "em":
        inst = _ds1(data_dir)
        inst.process_loaded_trees()
        scores = inst.train_expectation_maximization(0.0, 10, device="cpu")
        assert scores.shape == (10,) and np.all(np.diff(scores) > -1e-9)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if path == "vbpi_mesh":
            inst = _ds1(data_dir)
            inst.process_loaded_trees()
            JitVBPI(inst, particle_count=4, mesh=object())
        else:
            inst = GPInstance()
            inst.read_fasta_file(f"{data_dir}/hello.fasta")
            inst.read_newick_file(f"{data_dir}/hello_rooted.nwk")
            if path == "gp_mesh":
                inst.make_engine(mesh=object())
            inst.make_engine(device="cpu")
            inst.get_engine().run_branch_ascent_streamed(1e-6, 10, 16)


def test_cuda_device_is_the_callers_choice(data_dir):
    """An explicit device="cpu" computes on the CPU; the default is the
    card, and without one it raises, naming device="cpu", instead of quietly
    running on the CPU; so does an explicit "cuda"."""
    inst = _ds1(data_dir)
    assert inst.engine.device.type == "cpu"
    assert inst.engine.tips.dtype == torch.float64
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        inst.prepare_for_phylo_likelihood(PhyloModelSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inst.prepare_for_phylo_likelihood(PhyloModelSpec(), device="cuda")
    assert inst.engine.device.type == "cpu"  # the CPU engine stays


@pytest.mark.parametrize("entry", [
    "prepare_for_phylo_likelihood", "LikelihoodEngine", "make_engine",
    "GPEngine",
])
def test_entry_points_default_to_the_card(data_dir, entry):
    """Each of the four entry points, called without device, computes on
    the card; without one it raises a RuntimeError that names device="cpu"
    (tests/test_torch_cuda.py checks where the default lands on a card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py covers it")
    gp = GPInstance()
    gp.read_fasta_file(f"{data_dir}/hello.fasta")
    gp.read_newick_file(f"{data_dir}/hello_rooted.nwk")
    gp.make_engine(device="cpu")
    eng = gp.get_engine()
    inst = libsbn_tpu_torch.UnrootedInstance("default device")
    inst.read_newick_file(f"{data_dir}/hello.nwk")
    inst.read_fasta_file(f"{data_dir}/hello.fasta")
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        if entry == "prepare_for_phylo_likelihood":
            inst.prepare_for_phylo_likelihood(PhyloModelSpec())
        elif entry == "LikelihoodEngine":
            LikelihoodEngine(eng.site_pattern, PhyloModelSpec())
        elif entry == "make_engine":
            gp.make_engine()
        else:
            GPEngine(eng.site_pattern, gp.dag, eng.q,
                     eng.unconditional_node_probabilities,
                     eng.inverted_sbn_prior)
