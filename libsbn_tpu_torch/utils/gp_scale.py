"""Generalized pruning at scale: the counterpart of the JAX package's
tools/gp_scale.py, with the same data, ascents and assertion.

Generates a random tree by sequential joining and a random alignment
(random sequences barely compress, so patterns ~ sites) from
``default_rng(0)``, builds the subsplit DAG with ``GPInstance``, and runs
the fused ascent ``run_branch_ascent(1e-4, 20)`` (on a card: K7 populates,
K8 golden-section sweeps, replays of the phase graphs), then, from lengths
reset to 0.1, the streamed ascent ``run_branch_ascent_streamed(1e-4, 20,
pattern_chunk=512, finalize=False)`` (K7 a chunk, Newton on the host).
Asserts |m - m2| < max(1e-3, 1e-6 |m|), as the JAX tool does.

The JAX tool runs on the CPU by default, where both ascents sweep by
Newton-bisection, so its gate holds a streamed fit to the same fit in
memory. On a card the fused ascent sweeps by K8's golden section, a
different path to the optimum, and neither ascent converges in 20 sweeps
on this noise alignment (a near-flat objective). So on a card the
in-memory Newton ascent (the level route, ``use_kernels=False``) runs as
well, and its gap to the streamed fit is reported beside the JAX tool's.
On a card the streamed ascent replays its chunk programs' CUDA graphs
(gp/streamed_graph.py); it runs again from the same lengths with them off
(``cuda_graphs=False``), must equal that eager run bit for bit, and the
graphs' memory pool is reported.

    python -m libsbn_tpu_torch.utils.gp_scale [taxa] [sites] [--f32]
        [--device cpu]

Defaults 200 taxa x 4,096 sites, float64 (the JAX tool's default;
``--f32`` is the production dtype). Runs on the card unless given
``--device cpu`` (the level route: torch ops and a Newton sweep). Prints
the sizes (the PLV arena as 6 (N + 1) 4 S itemsize), each ascent's
marginal, sweeps and seconds (its first call, as the JAX tool times it),
the K7/K8 route it took (from the launch counters) and, from two more runs
of it from the same lengths, its host ms and device ms (torch.profiler)
with the device's idle share, beside the card's nvidia-smi name and power
limit. Exits non-zero if the assertion fails.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from ..gp import GPInstance, engine_kernels
from .device import DEFAULT_DEVICE, compute_device
from .profiling import format_host_and_device, host_and_device

FUSED = (1e-4, 20)  # run_branch_ascent(tol, max_iter)
STREAMED = (1e-4, 20, 512)  # run_branch_ascent_streamed(tol, max_iter, chunk)
RESET_LENGTH = 0.1


def make_data(taxa: int, sites: int, tmpdir: str, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(taxa)]
    # Random binary tree by sequential joining.
    nodes = [f"{n}:0.05" for n in names]
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.uniform(0.02, 0.1):.4f}")
    newick = nodes[0].rsplit(":", 1)[0] + ";"
    tree_path = f"{tmpdir}/scale.nwk"
    with open(tree_path, "w") as f:
        f.write(newick + "\n")
    fasta_path = f"{tmpdir}/scale.fasta"
    with open(fasta_path, "w") as f:
        for n in names:
            seq = "".join(rng.choice(list("ACGT"), sites))
            f.write(f">{n}\n{seq}\n")
    return tree_path, fasta_path


def route_of(before):
    """The GP kernels launched (and twins called) since ``before`` (a copy
    of engine_kernels.LAUNCHES and TWIN_CALLS), as "K7 on-chip, K8
    on-chip"-style text; "level route" when neither ran."""
    launches, twins = before
    ran = {k: v - launches[k] for k, v in engine_kernels.LAUNCHES.items()
           if v != launches[k]}
    twin = {k: v - twins[k] for k, v in engine_kernels.TWIN_CALLS.items()
            if v != twins[k]}
    names = {"populate_plvs": "K7 on-chip", "populate_plvs_slab": "K7 slab",
             "golden_sweep": "K8 on-chip", "golden_sweep_slab": "K8 slab"}
    parts = [f"{names[k]} x{n}" for k, n in ran.items()]
    parts += [f"{k} twin x{n}" for k, n in twin.items()]
    return ", ".join(parts) or "level route (torch ops, Newton sweep)"


def _counters():
    return dict(engine_kernels.LAUNCHES), dict(engine_kernels.TWIN_CALLS)


def _ascent(eng, kind, cuda_graphs=True):
    """(marginal, sweeps) of one ascent of ``kind`` from float64 lengths of
    RESET_LENGTH. (The JAX tool resets with np.full_like, whose dtype
    follows the last ascent's lengths: after a float32 fused ascent, 0.1
    rounded to float32. Float64 every time makes each ascent start from
    the same lengths, whichever ran before.)"""
    eng.branch_lengths = np.full(np.shape(eng.branch_lengths), RESET_LENGTH)
    if kind == "fused":
        return eng.run_branch_ascent(*FUSED)
    tol, max_iter, chunk = STREAMED
    graphs, eng.cuda_graphs = eng.cuda_graphs, cuda_graphs
    try:
        return eng.run_branch_ascent_streamed(
            tol, max_iter, pattern_chunk=chunk, finalize=False)
    finally:
        eng.cuda_graphs = graphs


def run(taxa=200, sites=4096, dtype=torch.float64, device=DEFAULT_DEVICE,
        timing=True):
    """Build the instance and run both ascents (and, on a card, the
    in-memory Newton ascent, "newton"). Returns a dict of the sizes
    (``patterns``, ``dag_nodes``, ``gpcsps``, ``arena_mb``, ``build_s``)
    and, for each ascent, the ``marginal``, ``sweeps``, ``seconds`` (the
    first run, host clock, synchronised), ``route`` and, with ``timing``,
    profiling.host_and_device's dict of two more runs of the fused and
    the streamed ascent (``times``); ``gap`` is |m - m2|, ``gap_newton``
    the Newton ascent's, and ``bound`` max(1e-3, 1e-6 |m|). On a card also
    "streamed_eager" (the streamed ascent with cuda_graphs=False, timed as
    the streamed one), ``graph_equals_eager`` (marginal, sweeps and
    branch lengths bit for bit) and the streamed graphs' ``pool_mb``."""
    device = compute_device(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    with tempfile.TemporaryDirectory() as tmp:
        tree_path, fasta_path = make_data(taxa, sites, tmp)
        t0 = time.perf_counter()
        inst = GPInstance("scale")
        inst.read_newick_file(tree_path)
        inst.read_fasta_file(fasta_path)
        inst.make_engine(dtype=dtype, device=device)
    eng = inst.get_engine()
    N = inst.dag.node_count()
    S = eng.patterns
    item = torch.empty((), dtype=dtype).element_size()
    out = {"taxa": taxa, "sites": sites, "dtype": dtype, "patterns": S,
           "dag_nodes": N, "gpcsps": inst.dag.gpcsp_count_with_fake(),
           "arena_mb": 6 * (N + 1) * 4 * S * item / 2**20,
           "build_s": time.perf_counter() - t0}
    kinds = ["fused", "streamed"]
    if device.type == "cuda":
        kinds += ["streamed_eager", "newton"]
    for kind in kinds:
        if kind == "newton":
            inst.make_engine(dtype=dtype, device=device, use_kernels=False)
            eng = inst.get_engine()
        how = {"newton": ("fused", True),
               "streamed_eager": ("streamed", False)}.get(kind, (kind, True))
        before = _counters()
        sync()
        t0 = time.perf_counter()
        m, sweeps = _ascent(eng, *how)
        sync()
        res = {"marginal": m, "sweeps": sweeps,
               "seconds": time.perf_counter() - t0, "route": route_of(before),
               "branch_lengths": np.array(eng.branch_lengths, copy=True)}
        if kind == "streamed" and eng.last_streamed_graphs is not None:
            out["pool_mb"] = eng.last_streamed_graphs["pool_mb"]
        if timing and kind != "newton":
            res["times"] = host_and_device(lambda: _ascent(eng, *how), 1)
        out[kind] = res
    if "streamed_eager" in out:
        a, b = out["streamed"], out["streamed_eager"]
        out["graph_equals_eager"] = bool(
            a["marginal"] == b["marginal"] and a["sweeps"] == b["sweeps"]
            and np.array_equal(a["branch_lengths"], b["branch_lengths"]))
    m2 = out["streamed"]["marginal"]
    out["gap"] = abs(out["fused"]["marginal"] - m2)
    out["bound"] = max(1e-3, 1e-6 * abs(out["fused"]["marginal"]))
    if "newton" in out:
        out["gap_newton"] = abs(out["newton"]["marginal"] - m2)
    return out


def check(result, against="fused"):
    """Raise AssertionError unless the streamed marginal agrees with the
    ``against`` ascent's ("fused", the JAX tool's gate; or "newton", the
    in-memory Newton ascent run on a card) within the JAX tool's
    bound."""
    gap = result["gap" if against == "fused" else "gap_newton"]
    if not gap < result["bound"]:
        raise AssertionError(
            f"{result['taxa']} taxa x {result['sites']} sites "
            f"({result['dtype']}): {against} "
            f"{result[against]['marginal']} vs streamed "
            f"{result['streamed']['marginal']}, gap {gap} >= "
            f"{result['bound']}")


def check_graphs(result):
    """Raise AssertionError unless the streamed ascent by its graphs equals
    the eager streamed ascent bit for bit (where both ran: on a card)."""
    if not result.get("graph_equals_eager", True):
        a, b = result["streamed"], result["streamed_eager"]
        raise AssertionError(
            f"streamed ascent by its graphs {a['marginal']!r} in "
            f"{a['sweeps']} sweeps vs eager {b['marginal']!r} in "
            f"{b['sweeps']}; lengths equal: "
            f"{np.array_equal(a['branch_lengths'], b['branch_lengths'])}")


def describe(result, where):
    r = result
    lines = [
        f"taxa={r['taxa']} sites={r['sites']} patterns={r['patterns']} "
        f"dag_nodes={r['dag_nodes']} gpcsps={r['gpcsps']} PLV arena="
        f"{r['arena_mb']:.0f} MB ({str(r['dtype']).split('.')[-1]}); build "
        f"{r['build_s']:.1f}s"]
    for kind in ("fused", "streamed", "streamed_eager", "newton"):
        if kind not in r:
            continue
        a = r[kind]
        extra = (f" (chunk={STREAMED[2]}; device arena "
                 f"{r['arena_mb'] * STREAMED[2] / r['patterns']:.0f} MB)"
                 if kind.startswith("streamed") else "")
        if kind == "streamed" and "pool_mb" in r:
            extra += (f"; CUDA graphs of the chunk programs, their pool "
                      f"{r['pool_mb']:.1f} MB [{where}]")
        lines.append(f"{kind} ascent: marginal={a['marginal']:.4f} "
                     f"sweeps={a['sweeps']} time={a['seconds']:.2f}s{extra}; "
                     f"{a['route']}")
        if "times" in a:
            lines.append(f"  again from the same lengths: "
                         f"{format_host_and_device(a['times'])} [{where}]")
    if "graph_equals_eager" in r:
        lines.append("streamed ascent by its graphs = eager (cuda_graphs="
                     "False): " + ("bit for bit" if r["graph_equals_eager"]
                                   else "DIFFERENT"))
    lines.append(f"|m - m2| = {r['gap']:.3e} (bound {r['bound']:.3e})")
    if "gap_newton" in r:
        lines.append(f"|m_newton - m2| = {r['gap_newton']:.3e} (the "
                     "in-memory Newton ascent against the streamed)")
    return lines


def main(argv=None):
    from ..vi.soak import card_name

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("taxa", nargs="?", type=int, default=200)
    parser.add_argument("sites", nargs="?", type=int, default=4096)
    parser.add_argument("--f32", action="store_true",
                        help="float32 (the production dtype)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)
    device = compute_device(args.device)
    where = card_name() if device.type == "cuda" else "cpu"
    result = run(args.taxa, args.sites,
                 torch.float32 if args.f32 else torch.float64, device)
    for line in describe(result, where):
        print(line)
    try:
        check(result)
        check_graphs(result)
    except AssertionError as err:
        print(f"FAIL {err}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
