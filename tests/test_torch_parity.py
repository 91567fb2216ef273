"""The port's parity tier (libsbn_tpu_torch/utils/parity.py) on the CPU,
where its calls run the kernels' plain PyTorch twins in float32:

* every subsystem's checks pass at tools/tpu_parity.py's tolerances;
* the command exits 0 when the checks pass, and 1 on a failure unless
  ``--record`` is given;
* each golden number the tier copies equals the one the JAX side pins:
  bench.py's DS1 goldens, tests/test_rooted_likelihood.py's fluA goldens,
  and the values written into tools/tpu_parity.py's checks (read from its
  source);
* the port's JitVBPI step at float64 on the CPU equals libsbn_tpu's at the
  tier's seed within rel 1e-9, so the JAX side's recorded step is the
  port's too;
* importing the tier imports no JAX.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.utils import parity

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("subsystem", parity.SUBSYSTEMS,
                         ids=[f.__name__ for f in parity.SUBSYSTEMS])
def test_tier_passes_on_the_cpu(subsystem):
    """Each subsystem's checks pass on the CPU (float32, the twins)."""
    checks = subsystem("cpu")
    assert checks
    for c in checks:
        assert c.ok and np.isfinite(c.err), parity.format_check(c)


def test_command_exit_codes(monkeypatch, capsys):
    """main() exits 0 when every check passes; a failing check makes it
    exit 1, and with --record it prints the failure and exits 0."""
    def passing(device):
        return [parity.Check("passes", 0.0, 1.0, True)]

    def failing(device):
        return [parity.Check("fails", 2.0, 1.0, False)]

    monkeypatch.setattr(parity, "SUBSYSTEMS", (passing,))
    assert parity.main(["--device", "cpu"]) == 0
    monkeypatch.setattr(parity, "SUBSYSTEMS", (passing, failing))
    assert parity.main(["--device", "cpu"]) == 1
    assert parity.main(["--device", "cpu", "--record"]) == 0
    out = capsys.readouterr().out
    assert "FAIL fails: max|err|=2.000e+00 (bound 1.0e+00)" in out


def test_ds1_and_flua_goldens_equal_the_jax_sides():
    """bench.py's DS1 goldens and tests/test_rooted_likelihood.py's fluA
    goldens, as the tier copies them."""
    import bench
    import test_rooted_likelihood as rooted

    for name in ("PYBEAGLE_LIKELIHOODS", "PHYSHER_GRADIENTS",
                 "PHYSHER_WEIBULL_LIKELIHOODS"):
        np.testing.assert_array_equal(getattr(parity, name),
                                      getattr(bench, name), err_msg=name)
    for name in ("PHYSHER_LL", "PHYSHER_JACOBIAN", "PHYSHER_RATIO_GRADIENTS"):
        np.testing.assert_array_equal(getattr(parity, name),
                                      getattr(rooted, name), err_msg=name)


def _tpu_parity_values():
    """{check name: golden} of tools/tpu_parity.py's check() calls with
    literal goldens, and its GP hello branch lengths, from its source."""
    with open(os.path.join(ROOT, "tools", "tpu_parity.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "check" and isinstance(node.args[0], ast.Constant)):
            try:
                out[node.args[0].value] = ast.literal_eval(node.args[2])
            except ValueError:
                pass  # a golden imported by name: checked above
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "attr", None)
                == "branch_lengths"):
            out["branch_lengths"] = ast.literal_eval(node.value.args[0])
    return out


def test_tpu_parity_goldens_equal_the_tiers():
    """The values written into tools/tpu_parity.py's checks, and the rooted
    GTR, Weibull and GP inputs, as the tier copies them."""
    jax_side = _tpu_parity_values()
    want = {
        "fluA GTR LL": parity.ROOTED_GTR_LL,
        "fluA GTR substitution gradient (stick space)":
            list(parity.ROOTED_GTR_GRADIENTS),
        "fluA Weibull+4 LL": parity.ROOTED_WEIBULL_LL,
        "fluA Weibull shape gradient": parity.ROOTED_WEIBULL_SHAPE_GRADIENT,
        "GP hello fixed-branch marginal": parity.GP_HELLO,
        "GP five_taxon converged marginal": parity.GP_FIVE_TAXON,
        "VBPI step mean_ll (f32 vs CPU f64)": parity.VBPI_MEAN_LL,
        "VBPI step elbo_like (f32 vs CPU f64)": parity.VBPI_ELBO_LIKE,
        "branch_lengths": parity.GP_HELLO_BL,
    }
    assert {k: jax_side[k] for k in want} == want
    with open(os.path.join(ROOT, "tools", "tpu_parity.py")) as f:
        source = f.read()
    for literal in ("[0.05, 0.1, 0.15, 0.20, 0.25, 0.25]", "[0.1, 0.2, 0.3, "
                    "0.4]", '{"shape": jnp.asarray(0.1, jnp.float32)}',
                    "particle_count=4, seed=0", "step(beta=0.5)",
                    "run_branch_ascent(1e-4, 100)"):
        assert literal in source, literal
    assert parity.ROOTED_GTR_RATES == [0.05, 0.1, 0.15, 0.20, 0.25, 0.25]
    assert parity.ROOTED_GTR_FREQS == [0.1, 0.2, 0.3, 0.4]
    assert parity.ROOTED_WEIBULL_SHAPE == 0.1
    assert (parity.VBPI_PARTICLES, parity.VBPI_SEED, parity.VBPI_BETA) == (
        4, 0, 0.5)


def test_vbpi_step_equals_libsbn_tpu_at_the_tiers_seed(data_dir):
    """The tier's VBPI step at float64 on the CPU, the port's against
    libsbn_tpu's (both sample with numpy's default_rng(seed)): mean_ll and
    elbo_like within rel 1e-9, and both within rel 1e-9 of the recorded
    CPU float64 values the tier's float32 step is held to."""
    import libsbn_tpu
    from libsbn_tpu.vi.jit_step import JitVBPI as JJitVBPI

    from libsbn_tpu_torch.vi.jit_step import JitVBPI

    jinst = libsbn_tpu.UnrootedInstance("parity-vbpi")
    jinst.read_nexus_file(f"{data_dir}/hello_out.t")
    jinst.process_loaded_trees()
    jinst.train_simple_average()
    jinst.read_fasta_file(f"{data_dir}/hello.fasta")
    jinst.prepare_for_phylo_likelihood(
        libsbn_tpu.PhyloModelSpec("JC69", "constant", "strict"))
    want = JJitVBPI(jinst, particle_count=parity.VBPI_PARTICLES,
                    seed=parity.VBPI_SEED).step(beta=parity.VBPI_BETA)
    got = JitVBPI(parity.vbpi_instance("cpu", torch.float64),
                  particle_count=parity.VBPI_PARTICLES, seed=parity.VBPI_SEED,
                  dtype=torch.float64).step(beta=parity.VBPI_BETA)
    for name, recorded in (("mean_ll", parity.VBPI_MEAN_LL),
                           ("elbo_like", parity.VBPI_ELBO_LIKE)):
        g, w = float(got[name]), float(want[name])
        assert abs(g - w) <= 1e-9 * abs(w), (name, g, w)
        assert abs(g - recorded) <= 1e-9 * abs(recorded), (name, g, recorded)


def test_import_leaves_jax_out():
    """The tier imports nothing of JAX (the card's machine has none)."""
    code = ("import sys, libsbn_tpu_torch, libsbn_tpu_torch.utils.parity; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.split('.')[0] == 'libsbn_tpu' "
            "for m in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
