"""The on-chip K7's shared-memory plan and its routing on the CPU.

K7 (gp/engine_kernels.py populate_plvs_cuda, csrc/gp_engine.cu
gp_populate_kernel) runs a lane per (pattern, state) and keeps a tile of up
to 8 patterns' PLVs in shared memory; ``populate_onchip_plan`` takes the
largest tile that fits, and a DAG where not even one pattern fits takes the
slab route. These tests hold the plan to the bytes the CUDA source carves,
written out again here, at the shapes of hello and fluA (the GP bench's
DAG), and at DAGs large enough to be refused; they hold the streams' group
and level offsets, by which the kernel's warps share a level out, to the
levels; and they check that CPU tensors reach only K7's twin. The twin
itself is held against libsbn_tpu in tests/test_torch_gp_kernels.py, the
kernel against the twin on a card in tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.gp import GPInstance, engine_kernels
from libsbn_tpu_torch.gp.engine import _jc69_transition

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
FILES = {"hello": ("hello.fasta", "hello_rooted.nwk"),
         "fluA": ("fluA.fa", "fluA.tree"),
         "two_trees": ("hello.fasta", "hello_rooted_two_trees.nwk"),
         "hybrid": ("7-taxon-slice-of-ds1.fasta",
                    "simplest-hybrid-marginal-all-trees.nwk")}
LIMIT = 232_448  # bytes of shared memory a Hopper block may use


def _cu_populate_onchip_bytes(itemsize, N, E, T_rw, T_lw, R, TP):
    """csrc/gp_engine.cu populate_onchip_bytes, written out again: P and q
    (16 E + E), the tile's PLVs p, PH, rhat, RB (4 (N + 2N + N + 2N) TP)
    and their log-scales ((N + 2N + N + 2N) TP), and in int32 the three
    streams (5 T_rw + 5 T_lw + 2 R) and each stream's group and level
    offsets, reserved at their most (2 (T + 1) each)."""
    values = 16 * E + E + 4 * 6 * N * TP + 6 * N * TP
    ints = 5 * T_rw + 5 * T_lw + 2 * R + 2 * (T_rw + 1) + 2 * (T_lw + 1)
    return itemsize * values + 4 * ints


def _engine(data):
    fasta, nwk = FILES[data]
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{nwk}")
    inst.make_engine(device="cpu", use_kernels=True)
    return inst.get_engine()


def _shapes(eng):
    """(N, E, T_rw, T_lw, R) of an engine's edge streams."""
    st = eng._edge_streams()
    return (st.node_count, eng.dag.gpcsp_count_with_fake(),
            st.rootward.shape[0], st.leafward.shape[0], st.roots.shape[0])


@pytest.fixture(scope="module")
def shapes():
    return {data: _shapes(_engine(data)) for data in ("hello", "fluA")}


def test_flua_shapes(shapes):
    """fluA's DAG as the GP bench builds it: 137 nodes, 137 GPCSPs, 136
    rootward and 136 leafward stream rows, one rootsplit."""
    assert shapes["fluA"] == (137, 137, 136, 136, 1)


# (data, dtype, the tile the plan takes, its bytes): fluA float32 fills a
# warp with 8 patterns in 148,476 bytes; float64 8 patterns would need
# 283 KB, so the plan takes 6 (223,552 bytes); hello fits 8 in either.
PLANS = [("fluA", torch.float32, 8, 148_476), ("fluA", torch.float64, 6, 223_552),
         ("hello", torch.float32, 8, 5_388), ("hello", torch.float64, 8, 10_528)]


@pytest.mark.parametrize("data,dtype,TP,want", PLANS)
def test_plan_takes_the_largest_tile_that_fits(shapes, data, dtype, TP, want):
    itemsize = torch.empty((), dtype=dtype).element_size()
    dims = shapes[data]
    assert _cu_populate_onchip_bytes(itemsize, *dims, TP) == want
    assert engine_kernels.populate_onchip_bytes(itemsize, *dims, TP) == want
    assert engine_kernels.populate_onchip_plan(dtype, *dims) == (TP, want)
    assert want <= LIMIT == engine_kernels.SHARED_LIMIT
    if TP < engine_kernels.POPULATE_TILE:
        assert _cu_populate_onchip_bytes(itemsize, *dims, TP + 1) > LIMIT


def _tree_dims(N):
    """(N, E, T_rw, T_lw, R) of one rooted tree's DAG with N nodes, as
    fluA's: E = N GPCSPs, N - 1 rows in each stream, one rootsplit."""
    return N, N, N - 1, N - 1, 1


# The largest one-tree DAG that still fits one pattern, and the next: a
# pattern takes 30 N values, and P, q, the streams and their offsets 17 N
# values and 14 N int32 more, so float32 fits N <= 952 and float64
# N <= 538.
EDGES = [(torch.float32, 952), (torch.float64, 538)]


@pytest.mark.parametrize("dtype,N", EDGES)
@pytest.mark.parametrize("beyond", [False, True], ids=["last_fit", "refused"])
def test_plan_refuses_a_dag_beyond_one_pattern(dtype, N, beyond):
    itemsize = torch.empty((), dtype=dtype).element_size()
    dims = _tree_dims(N + beyond)
    one = _cu_populate_onchip_bytes(itemsize, *dims, 1)
    plan = engine_kernels.populate_onchip_plan(dtype, *dims)
    if beyond:
        assert plan is None and one > LIMIT
    else:
        assert plan == (1, one) and one <= LIMIT


@pytest.mark.parametrize("data", list(FILES))
def test_stream_groups_follow_the_levels(data):
    """The on-chip K7's warps share a level's destination groups out: every
    group is the rows into one destination in one level and ends at its
    finish flag, every level is a run of whole groups, and the offsets
    cover the stream once; on one tree and on DAGs of several."""
    eng = _engine(data)
    st = eng._edge_streams()
    for rows, groups, levels, schedule in (
            (st.rootward, st.rootward_groups, st.rootward_levels,
             eng.rootward_levels),
            (st.leafward, st.leafward_groups, st.leafward_levels,
             eng.leafward_levels)):
        rows, groups, levels = rows.numpy(), groups.numpy(), levels.numpy()
        assert groups[0] == 0 and groups[-1] == len(rows)
        assert levels[0] == 0 and levels[-1] == len(groups) - 1
        assert len(levels) == len(schedule) + 1
        level_rows = groups[levels]
        assert (np.diff(level_rows) == [len(lv["parent"]) for lv in schedule]).all()
        for a, b in zip(groups[:-1], groups[1:]):
            assert b > a and rows[b - 1, 3] == 1 and not rows[a:b - 1, 3].any()
            assert len(set(rows[a:b, 4])) == 1  # one destination node


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_reach_only_the_twin(dtype):
    """populate_plvs on CPU tensors calls K7's twin, never a kernel of
    either route, and the K7 wrapper refuses CPU tensors before it chooses
    a route."""
    eng = _engine("hello")
    bl = torch.as_tensor(np.random.default_rng(0).uniform(
        0.01, 0.3, eng.branch_lengths.size), dtype=dtype)
    args = (eng._edge_streams(), torch.as_tensor(eng.q, dtype=dtype),
            _jc69_transition(bl).contiguous(), eng._tips.to(dtype))
    engine_kernels.reset_counters()
    plvs = engine_kernels.populate_plvs(*args)
    assert set(plvs) == set(engine_kernels.PLV_KEYS)
    assert all(torch.isfinite(v).all() for v in plvs.values())
    assert engine_kernels.TWIN_CALLS["populate_plvs"] == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine_kernels.populate_plvs_cuda(*args)
    assert not any(engine_kernels.LAUNCHES.values())
