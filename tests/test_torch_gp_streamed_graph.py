"""The streamed GP ascent's chunk programs over static buffers
(gp/streamed_graph.py StreamedGraphs), run on the CPU.

On a card ``run_branch_ascent_streamed`` replays captured graphs of its
three chunk programs (statistics, the Newton derivative, the objective),
each over static buffers filled by one copy a chunk call. On the CPU the
same functions run over the same buffers (``_run_streamed(...,
graphed=True)``), so:

* against the port's eager chunk programs (``graphed=False``) on both
  routes (the level route and the K7 twin): marginal, sweeps and branch
  lengths bit for bit, and A and B as the eager route stores them;
* against libsbn_tpu's ``run_branch_ascent_streamed`` with the same
  arguments on five_taxon in chunks of 3, 7 and 16 (its A and B in an
  np.memmap) and on fluA in chunks of 100, at
  tests/test_torch_gp_streamed.py's MARGINAL_ATOL and BL_REL; on fluA the
  branch lengths at FLUA_BL_REL, since libsbn_tpu's own streamed and
  in-memory fits of fluA differ by 3.3e-7 there (edges whose length the
  objective barely fixes), and the same sweep count;
* each program's first call runs eagerly, the K7 twin once a chunk a
  statistics refresh, the buffers' MB recorded, and no memmap file left.
"""

import os

import numpy as np
import pytest
import torch

from libsbn_tpu.gp import GPInstance as JGPInstance
from libsbn_tpu_torch.gp import GPInstance, engine_kernels, streamed_graph

from test_torch_gp_streamed import BL_REL, FIVE, MARGINAL_ATOL, engine

torch.set_num_threads(1)

FLUA = ("fluA.fa", "fluA.tree")
TOL, MAX_ITER = 1e-8, 50
# fluA's branch lengths against libsbn_tpu's: its streamed fit and its
# in-memory Newton fit differ by 3.3e-7 relative (and the port's streamed
# and in-memory fits by 4.7e-7), with marginals within 1e-12.
FLUA_BL_REL = 1e-6
# (files, tol, max_iter, chunk, memmap): five_taxon's 4 patterns in two
# chunks of 3 (the last padded), one of 7, one of 16 in an np.memmap; fluA's
# 238 in three chunks of 100 (the card's check).
CASES = {
    "five_chunk_3": (FIVE, TOL, MAX_ITER, 3, False),
    "five_chunk_7": (FIVE, TOL, MAX_ITER, 7, False),
    "five_chunk_16_memmap": (FIVE, TOL, MAX_ITER, 16, True),
    "flua_chunk_100": (FLUA, 1e-6, 100, 100, False),
}


def streamed(eng, case, tmp_path, graphed=None):
    """(marginal, sweeps, branch lengths) of one streamed fit of ``case``
    from the engine's current lengths: libsbn_tpu's for graphed None, else
    the port's by the chosen route."""
    _, tol, max_iter, chunk, memmap = CASES[case]
    kw = {"memmap_dir": str(tmp_path)} if memmap else {}
    if graphed is None:
        m, sweeps = eng.run_branch_ascent_streamed(tol, max_iter, chunk,
                                                   finalize=False, **kw)
    else:
        m, sweeps = eng._run_streamed(tol, max_iter, chunk, kw.get(
            "memmap_dir"), False, 0.0, graphed=graphed)
    return m, sweeps, np.asarray(eng.branch_lengths).copy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_programs_match_libsbn_tpu(data_dir, tmp_path, case):
    files = CASES[case][0]
    want = streamed(engine(JGPInstance, data_dir, files), case, tmp_path)
    got = streamed(engine(GPInstance, data_dir, files, device="cpu"), case,
                   tmp_path, graphed=True)
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) < MARGINAL_ATOL, (got[0], want[0])
    rel = FLUA_BL_REL if files == FLUA else BL_REL
    np.testing.assert_allclose(got[2], want[2], rtol=rel, atol=1e-12)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["level", "kernel_twins"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_programs_equal_eager(data_dir, tmp_path, case, use_kernels):
    """The programs over static buffers against the eager chunk programs on
    one engine, from random lengths: marginal, sweeps and branch lengths
    bit for bit."""
    eng = engine(GPInstance, data_dir, CASES[case][0], device="cpu",
                 use_kernels=use_kernels)
    bl0 = np.random.default_rng(3).uniform(0.01, 0.3,
                                           eng.branch_lengths.size)
    out = []
    for graphed in (True, False):
        eng.branch_lengths = bl0.copy()
        out.append(streamed(eng, case, tmp_path, graphed=graphed))
    (m1, s1, b1), (m2, s2, b2) = out
    assert (m1, s1) == (m2, s2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_programs_write_the_eager_statistics(data_dir, dtype):
    """One statistics refresh, then one derivative and one objective pass,
    by each route on fluA in chunks of 100: A and B in AB, the marginal,
    phi, dphi and the objective bit for bit, at both dtypes."""
    eng = engine(GPInstance, data_dir, FLUA, device="cpu", use_kernels=True,
                 dtype=dtype)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    tips = np.pad(np.asarray(eng.tips, np_dt), ((0, 0), (0, 0), (0, 62)),
                  mode="edge")
    w = np.concatenate([np.asarray(eng.weights, np_dt), np.zeros(62, np_dt)])
    tips_c = np.ascontiguousarray(np.moveaxis(
        tips.reshape(*tips.shape[:-1], 3, 100), -2, 0))
    w_c = w.reshape(3, 100)
    E = len(eng.e_gpcsp)
    bl = np.random.default_rng(5).uniform(0.01, 0.3, eng.branch_lengths.size)
    u = np.random.default_rng(6).uniform(0.1, 0.99, E)
    got = []
    for cls in (streamed_graph.StreamedGraphs, streamed_graph.StreamedEager):
        AB = np.full((2, E, 300), np.nan, np_dt)
        programs = cls(eng, AB, tips_c, w_c)
        m = programs.refresh(bl)
        got.append((AB, m, *programs.phi(u), programs.obj(u),
                    programs.phi(u * 0.5)[0]))
        programs.close()
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(got[0][0])) and got[0][0].dtype == np_dt


def test_each_program_runs_eagerly_once_then_its_graph(data_dir):
    """On the CPU a Graph is a plain call: each program's first call counts
    as eager and none as a capture or replay; the K7 twin runs once a chunk
    a refresh and K8's never; the buffers' MB is recorded, the pool's 0."""
    eng = engine(GPInstance, data_dir, FLUA, device="cpu", use_kernels=True)
    streamed_graph.reset_counters()
    engine_kernels.reset_counters()
    _, sweeps = eng._run_streamed(1e-6, 100, 100, None, False, 0.0,
                                  graphed=True)
    assert streamed_graph.COUNTS == {"captures": 0, "replays": 0, "eager": 3}
    calls = engine_kernels.TWIN_CALLS
    assert calls["golden_sweep"] == 0
    assert calls["populate_plvs"] % 3 == 0
    assert calls["populate_plvs"] >= 3 * (sweeps + 1)
    assert eng.last_streamed_graphs["pool_mb"] == 0.0
    assert eng.last_streamed_graphs["buffers_mb"] > 0


def test_cuda_graphs_switch_keeps_the_cpu_eager(data_dir):
    """On the CPU run_branch_ascent_streamed keeps the eager chunk
    programs: no graph state is recorded."""
    eng = engine(GPInstance, data_dir, device="cpu")
    streamed_graph.reset_counters()
    eng.run_branch_ascent_streamed(TOL, MAX_ITER, 3, finalize=False)
    assert eng.last_streamed_graphs is None
    assert streamed_graph.COUNTS["eager"] == 0
