"""GTR's eigensystem solved on the host in one NumPy pass
(ops/substitution.py ``gtr_eigen_f64``, which the engine's
``_shared_eigen`` calls) against the torch solve of the same Q
(``gtr_q``, then ``_eigen_of_q``), on the CPU, over seeded (rates,
frequencies) sets and the uniform-rates point, at the working dtypes
float32 and float64:

* Q rounded to the working dtype has the same bits from NumPy and torch;
* P(t) = V diag(e^{lambda t}) V^-1 agrees to 1e-13 at t in {1e-3, 0.1, 1,
  10};
* V diag(lambda) V^-1 gives the rounded Q back to 1e-13 (at float32, the
  reversible Q that the rounded Q and freqs stand for);
* ``_shared_eigen`` returns CPU float64 tensors of shapes (1, 4),
  (1, 4, 4) and (1, 4, 4);
* a GTR engine call's ``libsbn.engine.model_inputs`` span holds no torch
  eigen solve and no torch Q build.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libsbn_tpu_torch
from libsbn_tpu_torch.core.site_pattern import SitePattern
from libsbn_tpu_torch.models import unrooted_graph
from libsbn_tpu_torch.models.engine import LikelihoodEngine
from libsbn_tpu_torch.ops import substitution

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]
NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
TIMES = [1e-3, 0.1, 1.0, 10.0]
SETS = 8


def _parameters(index):
    """(rates (6,), freqs (4,)) float64: seeded set ``index`` < SETS, or
    the uniform-rates point (repeated eigenvalues) at SETS."""
    if index == SETS:
        return np.full(6, 1.0 / 6.0), np.full(4, 0.25)
    rng = np.random.default_rng([index, 22])
    rates = rng.dirichlet(np.ones(6)) * rng.uniform(0.5, 4.0)
    return rates, rng.dirichlet(np.full(4, 2.0))


def _torch_q(rates, freqs, dtype):
    """(Q, freqs) as the torch path rounds them to the working dtype."""
    Q = substitution.gtr_q(torch.from_numpy(rates), torch.from_numpy(freqs))
    return Q.to(dtype), torch.from_numpy(freqs).to(dtype)


def _transition(eigen, t):
    lam, V, Vi = eigen
    return torch.einsum("qij,qj,qjk->qik", V, torch.exp(lam * t), Vi)


cases = pytest.mark.parametrize("dtype", DTYPES)
sets = pytest.mark.parametrize("index", range(SETS + 1))


@cases
@sets
def test_rounded_q_has_torch_bits(index, dtype):
    rates, freqs = _parameters(index)
    want, _ = _torch_q(rates, freqs, dtype)
    got = substitution._gtr_q_host(rates, freqs).astype(NP_DTYPES[dtype])
    assert got.tobytes() == want.numpy().tobytes()


@cases
@sets
def test_transition_matrices_match_the_torch_solve(index, dtype):
    rates, freqs = _parameters(index)
    Q, f = _torch_q(rates, freqs, dtype)
    want = substitution._eigen_of_q(Q.to(torch.float64)[None],
                                    f.to(torch.float64)[None])
    got = substitution.gtr_eigen_f64(rates, freqs, dtype)
    for t in TIMES:
        np.testing.assert_allclose(_transition(got, t).numpy(),
                                   _transition(want, t).numpy(),
                                   rtol=0, atol=1e-13, err_msg=f"t={t}")


def _reversible(Q, freqs):
    """The reversible Q that an eigensystem of Q's symmetrised form stands
    for: Q itself up to f64 rounding, but not the float32-rounded Q, which
    its rounded freqs no longer make exactly reversible (about 1e-8)."""
    sqrt_f = torch.sqrt(freqs)
    S = sqrt_f[:, None] * Q / sqrt_f[None, :]
    S = 0.5 * (S + S.T)
    return S / sqrt_f[:, None] * sqrt_f[None, :]


@cases
@sets
def test_eigensystem_gives_the_rounded_q_back(index, dtype):
    rates, freqs = _parameters(index)
    Q, f = _torch_q(rates, freqs, dtype)
    Q, f = Q.to(torch.float64), f.to(torch.float64)
    lam, V, Vi = substitution.gtr_eigen_f64(rates, freqs, dtype)
    back = substitution.q_from_eigen(V[0], Vi[0], lam[0]).numpy()
    np.testing.assert_allclose(back, _reversible(Q, f).numpy(), rtol=0,
                               atol=1e-13)
    if dtype == torch.float64:
        np.testing.assert_allclose(back, Q.numpy(), rtol=0, atol=1e-13)


@pytest.fixture(scope="module")
def ds1(data_dir):
    """DS1.fasta's site patterns and the schedule of DS1.100_topologies'
    first two trees, with branch lengths."""
    inst = libsbn_tpu_torch.UnrootedInstance("host_eigen")
    inst.read_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    inst.tree_collection.trees = inst.tree_collection.trees[:2]
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    sp = SitePattern(inst.alignment, inst.tree_collection.tag_taxon_map)
    sched = inst._batched_schedule()
    bl = np.random.default_rng(4).uniform(0.01, 0.2, (2, sched.node_count))
    bl[:, -1] = 0.0
    return sp, sched, bl


def _gtr_engine(sp, dtype):
    spec = libsbn_tpu_torch.PhyloModelSpec("GTR", "weibull+4", "strict")
    return LikelihoodEngine(sp, spec, dtype=dtype, device="cpu")


def _params(index=0):
    rates, freqs = _parameters(index)
    return {"substitution": {"rates": torch.from_numpy(rates),
                             "frequencies": torch.from_numpy(freqs)},
            "site": {"shape": torch.tensor(0.5, dtype=torch.float64)}}


@cases
def test_shared_eigen_is_host_f64(ds1, dtype):
    eng = _gtr_engine(ds1[0], dtype)
    eigen = eng._shared_eigen(_params())
    assert [tuple(x.shape) for x in eigen] == [(1, 4), (1, 4, 4), (1, 4, 4)]
    for x in eigen:
        assert x.device.type == "cpu" and x.dtype == torch.float64
        assert x.is_contiguous()
    rates, freqs = _parameters(0)
    for x, y in zip(eigen, substitution.gtr_eigen_f64(rates, freqs, dtype)):
        assert torch.equal(x, y)


def test_model_inputs_span_runs_no_torch_solve(ds1):
    sp, sched, bl = ds1
    graphs = unrooted_graph.UnrootedGraphs(_gtr_engine(sp, torch.float32))
    params = _params()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graphs.branch_gradients(sched, bl, params)
    events = prof.events()
    (span,) = [e.time_range for e in events
               if e.name == "libsbn.engine.model_inputs"]
    inside = [e.name for e in events
              if e.name != "libsbn.engine.model_inputs"
              and span.start <= e.time_range.start
              and e.time_range.end <= span.end]
    # The span records the parameters' copies to the host, and no more.
    assert any(n.startswith("aten::") for n in inside), inside
    assert "aten::linalg_eigh" not in inside
    assert "aten::triu_indices" not in inside
