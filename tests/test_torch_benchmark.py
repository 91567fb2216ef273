"""The port's fixed-topology benchmark and command line
(libsbn_tpu_torch.vi.benchmark / vi.cli) against libsbn_tpu's.

``fixed`` on the hello directory (tests/test_benchmark.py:26) for both
optimizers: the same seed gives libsbn_tpu's final ELBO, optimizer trace
and variational sample (rel 1e-9); the results are dicts and lists, as
libsbn_tpu's are. The parser, ``main`` and the programmatic ``benchmark``.
Every port call passes device="cpu". "rel r" below means
|got - want| <= r (|want| + max |want|) elementwise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from libsbn_tpu.vi import benchmark as jbenchmark

from libsbn_tpu_torch.vi import benchmark, cli
from test_torch_vi import refreshed_libsbn_tpu_sampler  # noqa: F401

torch.set_num_threads(2)

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def rel_close(got, want, rel, msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    scale = np.abs(want) + np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= rel * scale), (
        msg, np.max(np.abs(got - want) / scale))


@pytest.fixture()
def hello_data_dir(tmp_path):
    d = tmp_path / "hello"
    d.mkdir()
    shutil.copy(f"{DATA}/hello_out.t", d / "hello_out.t")
    shutil.copy(f"{DATA}/hello.fasta", d / "hello.fasta")
    return str(d)


@pytest.mark.parametrize("optimizer_name", ["simple", "bump"])
def test_benchmark_fixed_matches_libsbn_tpu(hello_data_dir, optimizer_name):
    kw = dict(branch_model_name="split", scalar_model_name="lognormal",
              optimizer_name=optimizer_name, step_count=4, particle_count=3,
              final_elbo_particle_count=50)
    run_details, opt_trace, fitting = benchmark.fixed(
        hello_data_dir, device="cpu", **kw)
    want_details, want_trace, want_fitting = jbenchmark.fixed(
        hello_data_dir, **kw)
    assert isinstance(run_details, dict) and isinstance(opt_trace, list)
    assert set(run_details) == set(want_details)
    assert np.isfinite(run_details["final_elbo"])
    assert run_details["gradient_time"] > 0
    rel_close(run_details["final_elbo"], want_details["final_elbo"], 1e-9)
    assert len(opt_trace) == len(want_trace) == (
        4 if optimizer_name == "bump" else 0)
    if opt_trace:
        rel_close(opt_trace, want_trace, 1e-9, "bump trace")
    assert fitting["vb_sample"].shape == want_fitting["vb_sample"].shape
    rel_close(fitting["vb_sample"], want_fitting["vb_sample"], 1e-9)
    assert [m["variable"] for m in fitting["mcmc"]] == [
        m["variable"] for m in want_fitting["mcmc"]]
    for mine, theirs in zip(fitting["mcmc"], want_fitting["mcmc"]):
        np.testing.assert_array_equal(mine["values"], theirs["values"])


def test_parser_and_main(hello_data_dir, capsys):
    parser = cli.build_parser()
    args = parser.parse_args(["benchmark", "--step-count", "1", "x"])
    assert args.command == "benchmark" and args.step_count == 1
    assert args.data_path == "x" and args.device == "cuda"
    assert parser.prog == "vip-torch"
    assert cli.cli is cli.main
    assert cli.main(["benchmark", "--step-count", "2", "--particle-count",
                     "3", "--device", "cpu", hello_data_dir]) == 0
    assert "final_elbo" in capsys.readouterr().out


def test_programmatic_benchmark(hello_data_dir):
    run_details, _, _ = cli.benchmark(
        hello_data_dir, step_count=1, particle_count=2,
        final_elbo_particle_count=10, device="cpu")
    assert np.isfinite(run_details["final_elbo"])
