"""The port's streamed GP ascent (GPEngine.run_branch_ascent_streamed)
against libsbn_tpu's and against the port's in-memory Newton ascent.

Same data files through both packages, float64 on the CPU (the port's
engines take ``device="cpu"``): tests/test_gp.py's three fits on
five_taxon (in memory, chunk 7, chunk 16 with the statistics in an
np.memmap), each held against libsbn_tpu's streamed ascent with the same
arguments and against the port's in-memory ascent on the level route (the
same Newton sweep): marginals within 1e-9, branch lengths at rel 1e-10.
Also: the kernel route's chunks run the K7 twin, one call a chunk per
statistics refresh, and land on the level route's fit; a chunk's PLVs are
the full-width PLVs' columns; finalize=False leaves the PLVs unpopulated;
no memmap file is left behind.
"""

import os

import numpy as np
import pytest
import torch

from libsbn_tpu.gp import GPInstance as JGPInstance
from libsbn_tpu_torch.core.tree import RootedTree, RootedTreeCollection
from libsbn_tpu_torch.gp import GPInstance, engine_kernels
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment

torch.set_num_threads(1)

FIVE = ("five_taxon.fasta", "five_taxon_rooted.nwk")
TOL, MAX_ITER = 1e-8, 50
MARGINAL_ATOL = 1e-9
BL_REL = 1e-10


def engine(cls, data_dir, files=FIVE, **kw):
    inst = cls()
    inst.read_fasta_file(f"{data_dir}/{files[0]}")
    inst.read_newick_file(f"{data_dir}/{files[1]}")
    inst.make_engine(**kw)
    return inst.get_engine()


def fit(eng, streamed):
    """(marginal, sweeps, branch lengths) of the in-memory ascent
    (streamed None) or the streamed one with ``streamed`` as arguments."""
    if streamed is None:
        m, sweeps = eng.run_branch_ascent(TOL, MAX_ITER)
    else:
        m, sweeps = eng.run_branch_ascent_streamed(TOL, MAX_ITER, **streamed)
    return m, sweeps, np.asarray(eng.branch_lengths).copy()


@pytest.fixture(scope="module")
def in_memory(data_dir):
    """The port's in-memory fit on the level route (the Newton sweep)."""
    return fit(engine(GPInstance, data_dir, device="cpu", use_kernels=False),
               None)


def case(name, tmp_path):
    return {"in_memory": None, "chunk_7": {"pattern_chunk": 7},
            "chunk_16_memmap": {"pattern_chunk": 16,
                                "memmap_dir": str(tmp_path)},
            "chunk_3_memmap": {"pattern_chunk": 3,
                               "memmap_dir": str(tmp_path)}}[name]


@pytest.mark.parametrize("name", ["in_memory", "chunk_7", "chunk_16_memmap",
                                  "chunk_3_memmap"])
def test_streamed_fit_matches_libsbn_tpu(data_dir, tmp_path, in_memory, name):
    """test_gp.py:366's three fits, each against libsbn_tpu with the same
    arguments and against the port's in-memory level-route fit. five_taxon
    has 4 patterns, so chunks 7 and 16 are one padded chunk; chunk 3 makes
    two, the last padded."""
    kw = case(name, tmp_path)
    want = fit(engine(JGPInstance, data_dir), kw)
    got = fit(engine(GPInstance, data_dir, device="cpu"), kw)
    for ref in (want, in_memory):
        assert got[1] == ref[1]
        assert abs(got[0] - ref[0]) < MARGINAL_ATOL, (got[0], ref[0])
        np.testing.assert_allclose(got[2], ref[2], rtol=BL_REL, atol=1e-12)
    if kw and "memmap_dir" in kw:
        assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_kernel_route_chunks_run_k7(data_dir, in_memory, chunk):
    """On the kernel route each chunk populates through K7 (its twin on the
    CPU): one call a chunk per statistics refresh and none of K8, since the
    sweep is the host's Newton. The fit lands on the level route's (the
    log-scales differ, per (node, pattern) against per node, and cancel in
    every statistic the ascent reads)."""
    eng = engine(GPInstance, data_dir, device="cpu", use_kernels=True)
    chunks = -(-eng.patterns // chunk)
    engine_kernels.reset_counters()
    m, sweeps, bl = fit(eng, {"pattern_chunk": chunk, "finalize": False})
    calls = engine_kernels.TWIN_CALLS
    assert calls["golden_sweep"] == 0 and sum(engine_kernels.LAUNCHES.values()) == 0
    assert calls["populate_plvs"] % chunks == 0
    assert calls["populate_plvs"] >= (sweeps + 1) * chunks
    assert sweeps == in_memory[1]
    assert abs(m - in_memory[0]) < MARGINAL_ATOL
    np.testing.assert_allclose(bl, in_memory[2], rtol=BL_REL, atol=1e-12)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["level", "kernels"])
def test_chunk_plvs_are_full_width_columns(data_dir, use_kernels):
    """A chunk's populate (a width of 3, no multiple of 32) gives, on the
    kernel route, the full-width PLVs' columns (per-pattern log-scales) and,
    on the level route, the same rows up to one log-scale per node."""
    eng = engine(GPInstance, data_dir, device="cpu", use_kernels=use_kernels)
    bl = eng._tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size))
    q = eng._tensor(eng.q)
    full = eng._populate(bl, q)
    sl = slice(1, 4)
    part = eng._populate(bl, q, eng._tips[..., sl].contiguous())
    for k in ("p", "phat", "rhat", "r", "rtilde"):
        a, b = part[k], full[k][..., sl]
        if use_kernels:
            la, lb = part["ls_" + k], full["ls_" + k][..., sl]
            np.testing.assert_allclose((a * torch.exp(la)[:, None]).numpy(),
                                       (b * torch.exp(lb)[:, None]).numpy(),
                                       rtol=1e-13, atol=1e-300)
        else:
            # One scale per node and chunk: rows agree up to a factor.
            ratio = a.sum(dim=(1, 2)) / b.sum(dim=(1, 2)).clamp_min(1e-300)
            np.testing.assert_allclose(
                a.numpy(), (b * ratio[:, None, None]).numpy(), rtol=1e-12,
                atol=1e-300)


def test_finalize_false_leaves_plvs_unpopulated(data_dir, in_memory):
    eng = engine(GPInstance, data_dir, device="cpu")
    assert eng.plvs == {}
    m, sweeps, bl = fit(eng, {"pattern_chunk": 7, "finalize": False})
    assert eng.plvs == {}
    assert np.all(np.isneginf(eng.log_marginal_per_site))
    np.testing.assert_allclose(bl, in_memory[2], rtol=BL_REL, atol=1e-12)
    eng.populate_plvs()
    eng.compute_likelihoods()
    assert abs(eng.get_log_marginal_likelihood() - m) < MARGINAL_ATOL


def test_finalize_repopulates_at_full_width(data_dir):
    """finalize=True leaves full-width PLVs and rows whose marginal is the
    streamed fit's."""
    eng = engine(GPInstance, data_dir, device="cpu")
    m, _ = eng.run_branch_ascent_streamed(TOL, MAX_ITER, 7)
    assert eng.plvs["p"].shape[-1] == eng.patterns
    assert eng.log_likelihood_rows.shape[-1] == eng.patterns
    assert abs(eng.get_log_marginal_likelihood() - m) < MARGINAL_ATOL


def test_memmap_removed_when_the_ascent_fails(data_dir, tmp_path):
    """The memmap file goes even when the ascent raises (here: SBN
    parameters that do not cover the DAG's GPCSPs)."""
    eng = engine(GPInstance, data_dir, device="cpu")
    eng.q = eng.q[:1]
    with pytest.raises(IndexError):
        eng.run_branch_ascent_streamed(TOL, MAX_ITER, 7,
                                       memmap_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_flua_three_chunks_meet_the_optimum(data_dir):
    """fluA's 238 patterns in chunks of 100 (three, the last padded), as the
    card's check runs them: the fit (1e-6, 100) within 1e-9 of the port's
    in-memory level-route fit and within 1e-7 of libsbn_tpu's pinned
    optimum -4337.885058592."""
    files = ("fluA.fa", "fluA.tree")
    ref = engine(GPInstance, data_dir, files, device="cpu", use_kernels=False)
    m_ref, _ = ref.run_branch_ascent(1e-6, 100)
    eng = engine(GPInstance, data_dir, files, device="cpu")
    m, sweeps = eng.run_branch_ascent_streamed(1e-6, 100, 100)
    assert abs(m - m_ref) < MARGINAL_ATOL
    assert abs(m - -4337.885058592) < 1e-7
    assert sweeps == 12


@pytest.mark.parametrize("chunk", [0, -3])
def test_pattern_chunk_must_be_positive(data_dir, chunk):
    eng = engine(GPInstance, data_dir, device="cpu")
    with pytest.raises(ValueError, match="pattern_chunk"):
        eng.run_branch_ascent_streamed(TOL, MAX_ITER, chunk)


def synthetic_engine(taxa, sites, seed=0, **kw):
    """A GP engine on the CPU over one random rooted tree of ``taxa``
    leaves (joins and lengths from default_rng(seed)) and a random
    alignment of ``sites`` columns, as tests/test_torch_cuda.py builds it."""
    rng = np.random.default_rng(seed)
    pool = [f"t{i}" for i in range(taxa)]
    while len(pool) > 1:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        a, b = pool.pop(j), pool.pop(i)
        la, lb = rng.uniform(0.01, 0.2, 2)
        pool.append(f"({b}:{la:.4f},{a}:{lb:.4f})")
    tops, bls, ttm = newick.parse_newick_string(pool[0] + ";")
    inst = GPInstance()
    inst.alignment = Alignment({f"t{i}": "".join(row) for i, row in enumerate(
        rng.choice(list("ACGT"), size=(taxa, sites)))})
    inst.tree_collection = RootedTreeCollection(
        [RootedTree(t, bl) for t, bl in zip(tops, bls)], ttm)
    inst.make_engine(device="cpu", **kw)
    return inst.get_engine()


def test_padded_chunk_on_a_deep_tree(data_dir):
    """A 600-taxon tree, 200 patterns in chunks of 64 (the last 56 padded):
    the level route's one log-scale per node must not let the padding
    dwarf the real patterns (all-ones padding gave a marginal of -inf), so
    the streamed fit equals the in-memory one."""
    ref = synthetic_engine(600, 200)
    m_ref, sweeps_ref = ref.run_branch_ascent(1e-2, 3)
    eng = synthetic_engine(600, 200)
    m, sweeps = eng.run_branch_ascent_streamed(1e-2, 3, 64, finalize=False)
    assert np.isfinite(m) and sweeps == sweeps_ref == 3
    assert abs(m - m_ref) < 1e-9 * abs(m_ref)
    np.testing.assert_allclose(eng.branch_lengths, ref.branch_lengths,
                               rtol=BL_REL, atol=1e-12)
