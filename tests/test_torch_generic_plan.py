"""The on-chip K4's, K5's and K6's shared-memory plans and their routing on
the CPU.

K4 (ops/pruning_generic.py ll_grad_generic_cuda, csrc/pruning_generic.cu
generic_ll_grad_kernel), K5 (ops/pruning_vjp.py ll_generic_cuda,
generic_ll_kernel) and K6 (ops/pruning_vjp.py ll_dp_generic_cuda,
generic_dp_kernel) run a lane per (pattern, rate category) and keep a tile
of 32 // K patterns' pruning state in shared memory when
``ll_grad_onchip_plan`` / ``ll_onchip_plan`` / ``dp_onchip_plan`` says it
fits (K5 with W warps a block sharing the tree's matrices), and take their
slab routes otherwise. These tests hold each plan to the bytes the CUDA
source carves, written out again here, at the DS1 shapes the GTR path runs
(27 taxa, 25 combine steps) and on the 256-taxon tree that chip_smoke.py
and tests/test_torch_cuda.py send down the slab routes; and they check
that CPU tensors reach only the twins. The twins themselves are held
against libsbn_tpu in tests/test_torch_generic.py, the kernels against the
twins on a card in tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.io import newick
from libsbn_tpu_torch.io.fasta import Alignment
from libsbn_tpu_torch.ops import (
    pruning_generic, pruning_vjp, schedule, substitution,
)
from libsbn_tpu_torch.ops.site_model import weibull_rates

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
DS1 = (25, 27)  # (S, L) of DS1 and DS1.100_topologies
BIG = (254, 256)  # the synthetic 256-taxon tree


def _cu_dp_onchip_bytes(itemsize, K, S, L):
    """csrc/pruning_generic.cu dp_onchip_bytes, written out again for a tile
    of TP = 32 // K patterns: the tree's matrices (N1 K 16), 4 slot values
    per node for each of the warp's 32 lanes ((S - 1) 4 32), one edge's
    staged uw and M values (2 4K (TP + 1)), freqs and props (4 + K), and
    the int32 schedule row (3S)."""
    N1, TP = L + S + 1, 32 // K
    values = N1 * K * 16 + (S - 1) * 4 * 32 + 2 * 4 * K * (TP + 1) + 4 + K
    return itemsize * values + 4 * 3 * S


def _cu_ll_grad_onchip_bytes(itemsize, K, S, L):
    """csrc/pruning_generic.cu ll_grad_onchip_bytes, written out again for
    a tile of TP = 32 // K patterns: the tree's matrices (N1 K 16), Q
    (K 16), 4 slot values per node for each of the warp's 32 lanes
    ((S - 1) 4 32), the running edge sums of each pattern slot (N1 TP),
    freqs and props (4 + K), and the int32 schedule row (3S)."""
    N1, TP = L + S + 1, 32 // K
    values = N1 * K * 16 + K * 16 + (S - 1) * 4 * 32 + N1 * TP + 4 + K
    return itemsize * values + 4 * 3 * S


def _cu_ll_onchip_bytes(itemsize, K, S, L, W):
    """csrc/pruning_generic.cu ll_onchip_bytes, written out again for W
    warps of a tile of 32 // K patterns each: the tree's matrices (N1 K 16),
    4 slot values per node for each of a warp's 32 lanes, for every warp
    (W (S - 1) 4 32), one LL sum a warp (W), freqs and props (4 + K), and
    the int32 schedule row (3S)."""
    N1 = L + S + 1
    values = N1 * K * 16 + W * (S - 1) * 4 * 32 + W + 4 + K
    return itemsize * values + 4 * 3 * S


def _sm_warps(W, need):
    """Warps of W-warp blocks of ``need`` shared bytes a Hopper SM holds: at
    most 32 blocks and 64 warps, and 233,472 bytes of shared memory of which
    each block reserves 1,024 more."""
    return W * min(32, 64 // W, 233_472 // (need + 1_024))


# (dtype, K, the W K5's plan takes at DS1): the largest W <= 8 whose state
# fits a block and gives an SM at least as many warps as W = 1; at float64
# K = 8 eight warps' E rows would need 251,340 bytes, so seven.
K5_DS1_PLANS = [(torch.float32, 1, 8), (torch.float32, 4, 8),
                (torch.float32, 8, 8), (torch.float64, 1, 8),
                (torch.float64, 4, 8), (torch.float64, 8, 7)]


@pytest.mark.parametrize("dtype,K,W", K5_DS1_PLANS)
def test_k5_plan_fits_ds1(dtype, K, W):
    """At DS1 the plan takes W warps a block in exactly the bytes the source
    carves; more warps would not fit or would give an SM fewer warps than
    one warp a block does."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = _cu_ll_onchip_bytes(itemsize, K, *DS1, W)
    assert pruning_vjp.ll_onchip_bytes(itemsize, K, *DS1, W) == want
    assert pruning_vjp.ll_onchip_plan(dtype, K, *DS1) == (W, want)
    assert want <= pruning_vjp.SHARED_LIMIT
    floor = _sm_warps(1, _cu_ll_onchip_bytes(itemsize, K, *DS1, 1))
    assert _sm_warps(W, want) >= floor
    for more in range(W + 1, pruning_vjp.LL_WARPS + 1):
        need = _cu_ll_onchip_bytes(itemsize, K, *DS1, more)
        assert need > pruning_vjp.SHARED_LIMIT or _sm_warps(more, need) < floor


def test_k5_plan_at_config_2():
    """The JAX bench's config 2 (float32, Weibull+4): 13,568 bytes of
    matrices and 12,288 of E rows a warp; one warp a block gives an SM 8
    warps, W = 8 gives 2 blocks of 8 in 112,236 bytes each."""
    need = pruning_vjp.ll_onchip_bytes(4, 4, *DS1, 8)
    assert pruning_vjp.ll_onchip_plan(torch.float32, 4, *DS1) == (8, need)
    assert need == 112_236
    assert _sm_warps(1, _cu_ll_onchip_bytes(4, 4, *DS1, 1)) == 8
    assert _sm_warps(8, need) == pruning_vjp.sm_warps(8, need) == 16


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_plan_on_the_big_tree(dtype, K):
    """On the 256-taxon tree one warp's E rows take 129,536 bytes at
    float32: float32 K <= 3 fits one warp a block (W = 1) and no more;
    float32 K >= 4 and all of float64 fit no warp and take the slab route."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    one = _cu_ll_onchip_bytes(itemsize, K, *BIG, 1)
    plan = pruning_vjp.ll_onchip_plan(dtype, K, *BIG)
    if dtype == torch.float32 and K <= 3:
        assert plan == (1, one) and one <= pruning_vjp.SHARED_LIMIT
        assert _cu_ll_onchip_bytes(itemsize, K, *BIG, 2) > pruning_vjp.SHARED_LIMIT
    else:
        assert plan is None and one > pruning_vjp.SHARED_LIMIT


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_plan_fits_ds1(dtype, K):
    """At DS1 every (dtype, K <= 8) gets a tile of 32 // K patterns in
    exactly the bytes the source carves, at most 81,964 (float64 K = 8),
    well within the 232,448 a Hopper block may use."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = _cu_ll_grad_onchip_bytes(itemsize, K, *DS1)
    assert pruning_generic.ll_grad_onchip_bytes(itemsize, K, *DS1) == want
    assert pruning_generic.ll_grad_onchip_plan(dtype, K, *DS1) == (32 // K, want)
    assert want <= 81_964 < pruning_generic.SHARED_LIMIT


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_plan_refuses_the_big_tree(dtype, K):
    """On the 256-taxon tree float32 K <= 2 fits on chip; every other
    (dtype, K), float32 Weibull+4 and all of float64 included, takes the
    slab route. K4 needs its running edge sums (N1 (32 // K) values) beside
    K6's state less K6's staging rows, so at float32 K = 3, where K6 still
    fits, it does not."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = _cu_ll_grad_onchip_bytes(itemsize, K, *BIG)
    plan = pruning_generic.ll_grad_onchip_plan(dtype, K, *BIG)
    if dtype == torch.float32 and K <= 2:
        assert plan == (32 // K, want) and want <= pruning_generic.SHARED_LIMIT
    else:
        assert plan is None and want > pruning_generic.SHARED_LIMIT


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_plan_fits_ds1(dtype, K):
    """At DS1 every (dtype, K <= 8) gets a tile of 32 // K patterns in
    exactly the bytes the source carves, at most 81,804 (float64 K = 8), well
    within the 232,448 a Hopper block may use."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = _cu_dp_onchip_bytes(itemsize, K, *DS1)
    assert pruning_vjp.dp_onchip_bytes(itemsize, K, *DS1) == want
    assert pruning_vjp.dp_onchip_plan(dtype, K, *DS1) == (32 // K, want)
    assert want <= 81_804 < pruning_vjp.SHARED_LIMIT


@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_plan_refuses_the_big_tree(dtype, K):
    """On the 256-taxon tree float32 K <= 3 fits on chip; every other
    (dtype, K), float32 Weibull+4 and all of float64 included, takes the
    slab route."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = _cu_dp_onchip_bytes(itemsize, K, *BIG)
    plan = pruning_vjp.dp_onchip_plan(dtype, K, *BIG)
    if dtype == torch.float32 and K <= 3:
        assert plan == (32 // K, want) and want <= pruning_vjp.SHARED_LIMIT
    else:
        assert plan is None and want > pruning_vjp.SHARED_LIMIT


def _hello_inputs(dtype, K):
    tops, bls, ttm = newick.parse_newick_file(f"{DATA}/hello.nwk")
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/hello.fasta"), ttm)
    sched = schedule.schedules_of_topologies(tops)
    bl = torch.as_tensor(np.pad(np.stack(bls), ((0, 0), (0, 1))))
    f64 = dict(dtype=torch.float64)
    freqs = torch.tensor([0.3, 0.25, 0.2, 0.25], **f64)
    Q = substitution.gtr_q(torch.tensor([0.1, 0.2, 0.15, 0.25, 0.2, 0.1], **f64),
                           freqs)
    rates, props = weibull_rates(0.7, K)
    P = substitution.expm_transition(Q, freqs, bl[:, :, None] * rates)
    return (torch.as_tensor(sched.post_children, dtype=torch.int32),
            P.to(dtype).contiguous(), torch.as_tensor(sp.tip_partials()).to(dtype),
            freqs.to(dtype), props.to(dtype), torch.as_tensor(sp.weights).to(dtype),
            sched.root_id)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_cpu_tensors_reach_only_the_twin(dtype, K):
    """The generic LL's backward on CPU tensors calls K6's twin, never a
    kernel of either route, and the K6 wrapper refuses CPU tensors before
    it chooses a route."""
    pc, P, tips, freqs, props, w, r = _hello_inputs(dtype, K)
    pruning_vjp.reset_counters()
    Pg = P.clone().requires_grad_(True)
    ll = pruning_vjp.log_likelihoods_generic(pc, Pg, tips, freqs, props, w,
                                             root_id=r)
    ll.sum().backward()
    assert ll.dtype == dtype and torch.isfinite(Pg.grad).all()
    assert not Pg.grad[:, r:].any()
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 1, "ll_dp_generic": 1}
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_vjp.ll_dp_generic_cuda(pc, P, tips, freqs, props, w, root_id=r)
    assert not any(pruning_vjp.LAUNCHES.values())


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_cpu_tensors_reach_only_the_twin(dtype, K):
    """K4's entry point on CPU tensors calls its twin, never a kernel of
    either route, and the K4 wrapper refuses CPU tensors before it chooses
    a route."""
    pc, P, tips, freqs, props, w, r = _hello_inputs(dtype, K)
    Qs = torch.zeros((K, 4, 4), dtype=dtype)
    pruning_generic.reset_counters()
    ll, grad = pruning_generic.log_likelihood_and_branch_gradient_generic(
        pc, P, Qs, tips, freqs, props, w, root_id=r)
    assert ll.dtype == dtype and grad.shape == (pc.shape[0], r)
    assert torch.isfinite(ll).all() and torch.isfinite(grad).all()
    assert pruning_generic.TWIN_CALLS == {"ll_grad_generic": 1}
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_generic.ll_grad_generic_cuda(pc, P, Qs, tips, freqs, props, w,
                                             root_id=r)
    assert pruning_generic.LAUNCHES == {"ll_grad_generic": 0,
                                        "ll_grad_generic_slab": 0}


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_cpu_tensors_reach_only_the_twin(dtype, K):
    """The generic LL on CPU tensors, without a backward, calls K5's twin
    only, never a kernel of either route, and the K5 wrapper refuses CPU
    tensors before it chooses a route."""
    pc, P, tips, freqs, props, w, r = _hello_inputs(dtype, K)
    pruning_vjp.reset_counters()
    ll = pruning_vjp.log_likelihoods_generic(pc, P, tips, freqs, props, w,
                                             root_id=r)
    assert ll.dtype == dtype and ll.shape == (pc.shape[0],)
    assert torch.isfinite(ll).all()
    assert pruning_vjp.TWIN_CALLS == {"ll_generic": 1, "ll_dp_generic": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        pruning_vjp.ll_generic_cuda(pc, P, tips, freqs, props, w, root_id=r)
    assert pruning_vjp.LAUNCHES == {"ll_generic": 0, "ll_generic_slab": 0,
                                    "ll_dp_generic": 0, "ll_dp_generic_slab": 0}
