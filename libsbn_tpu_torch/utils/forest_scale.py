"""Forest sharing and throughput on an SBN-sampled support: the counterpart
of the JAX package's tools/forest_scale.py, with the same workload.

Trains the simple average on DS1.100_topologies, samples ``n_trees``
topologies from the SBN (the instance's sampler, seed 0), hash-conses them
into a forest (``ops/forest.py build_forest``) and prints its sharing
ratios. Then times the split-keyed surfaces at R = 8 length sets from
``default_rng(0)`` U(0.02, 0.2), float32: the LLs, the LLs with per-tree
branch gradients and bfloat16 gathers, and the LLs with the gradient
summed onto splits. Each runs as one CUDA graph replay a call
(``ops/forest_graph.py``; the JAX tool's jitted programs) and eagerly;
evals/s are R T iterations / seconds by ``profiling.timed_evals_per_sec``,
and each surface's device ms a call and the device's idle share come from
``profiling.host_and_device``.

    python -m libsbn_tpu_torch.utils.forest_scale [n_trees] [--device cpu]

Defaults 1,000 trees. Runs on the card unless given ``--device cpu``
(where the graph and the eager route are the same calls). Every number is
printed beside the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import UnrootedInstance
from ..core.site_pattern import SitePattern
from ..io.fasta import Alignment
from ..ops import forest, forest_graph
from .device import DEFAULT_DEVICE, compute_device
from .profiling import format_host_and_device, host_and_device
from .profiling import timed_evals_per_sec

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")
R = 8  # length sets a call
SURFACES = {  # name: (forest_graph surface, gather dtype)
    "LL-only": ("ll", None),
    "LL+grad (bf16)": ("grad", torch.bfloat16),
    "LL+split-grad": ("split", None),
}


def sampled_topologies(n_trees):
    """(n_trees polished topologies sampled from the simple-average SBN of
    DS1.100_topologies with the sampler's seed 0, the JAX tool's default,
    the tag-taxon map, the sampling seconds)."""
    inst = UnrootedInstance("scale")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.set_seed(0)
    t0 = time.perf_counter()
    inst.sample_trees(n_trees)
    sample_s = time.perf_counter() - t0
    tops = [t.topology for t in inst.tree_collection.trees]
    for t in tops:
        if t.id < 0:
            t.polish()
    return tops, inst.tree_collection.tag_taxon_map, sample_s


def sharing_line(st, fs):
    """The JAX tool's sharing line."""
    return (f"sharing: down {st['down_internal_total']}/"
            f"{st['down_internal_unique']} = "
            f"{st['down_internal_total'] / st['down_internal_unique']:.1f}x, "
            f"up {st['up_total']}/{st['up_unique']} = "
            f"{st['up_total'] / st['up_unique']:.1f}x, "
            f"edges {st['edges_total']}/{st['edges_unique']} = "
            f"{st['edges_total'] / st['edges_unique']:.1f}x, "
            f"splits {fs.n_splits}")


def run(n_trees=1000, device=DEFAULT_DEVICE, dtype=torch.float32,
        timing=True, target_s=2.0):
    """Sample, build and evaluate. Returns a dict of the topologies
    (``tops``), the forest (``fs``), ``stats`` (forest_stats), the
    seconds to ``sample`` and ``build``, the lengths ``bl`` ((R, n_splits)
    numpy, cast to ``dtype``), each surface's ``outputs`` (the graph
    route's second call, float64 numpy) and ``bit_for_bit`` (on the card
    its first, eager, call against its second, a capture and replay; None
    elsewhere, where nothing is captured), and with ``timing`` each
    surface's ``evals_per_s`` by route and ``times``
    (profiling.host_and_device's dict) by route."""
    device = compute_device(device)
    tops, ttm, sample_s = sampled_topologies(n_trees)
    t0 = time.perf_counter()
    fs = forest.build_forest(tops)
    build_s = time.perf_counter() - t0
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/DS1.fasta"), ttm)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    bl_np = np.random.default_rng(0).uniform(
        0.02, 0.2, (R, fs.n_splits)).astype(np_dtype)
    bl = torch.as_tensor(bl_np, device=device)
    graphs = forest_graph.ForestGraphs(sp.tip_partials(np_dtype),
                                       sp.weights.astype(np_dtype), device)
    tips, w = graphs.inputs(dtype)
    out = {"tops": tops, "fs": fs, "stats": forest.forest_stats(fs),
           "sample": sample_s, "build": build_s, "bl": bl_np, "outputs": {},
           "bit_for_bit": {}, "evals_per_s": {}, "times": {}}
    n_evals = R * fs.tree_count
    for name, (surface, gd) in SURFACES.items():
        def graph(surface=surface, gd=gd):
            return graphs.run(surface, fs, bl, dtype, gd)

        def plain(surface=surface, gd=gd):
            return forest_graph.eager(surface, fs, bl, tips, w, dtype, gd)

        first = graph()  # eager: the key's first call
        second = graph()  # on the card a capture and its replay
        out["outputs"][name] = forest_graph.to_numpy(second)
        # Off the card nothing is captured: nothing to compare.
        out["bit_for_bit"][name] = (
            forest_graph.bit_for_bit(first, second)
            if device.type == "cuda" else None)
        if timing:
            out["evals_per_s"][name] = {
                route: timed_evals_per_sec(fn, n_evals, target_s=target_s)
                for route, fn in (("graph", graph), ("eager", plain))}
            out["times"][name] = {route: host_and_device(fn)
                                  for route, fn in (("graph", graph),
                                                    ("eager", plain))}
    return out


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(result):
    """Raise AssertionError unless every surface's LLs and gradients are
    finite and its graph equals its eager call bit for bit."""
    for name, outs in result["outputs"].items():
        if not all(np.all(np.isfinite(x)) for x in _tuple(outs)):
            raise AssertionError(f"forest {name}: non-finite outputs")
        if result["bit_for_bit"][name] is False:
            raise AssertionError(f"forest {name}: the graph differs from the "
                                 "eager call")


def describe(result, where):
    st, fs = result["stats"], result["fs"]
    lines = [f"{st['trees']} SBN-sampled trees: sample "
             f"{result['sample'] * 1e3:.0f} ms, build "
             f"{result['build'] * 1e3:.0f} ms (host)",
             sharing_line(st, fs)]
    for name in result["outputs"]:
        same = {True: "graph = eager bit for bit",
                False: "graph DIFFERS from eager",
                None: "eager (no graph off the card)"}
        lines.append(f"{name}: {same[result['bit_for_bit'][name]]}")
        for route, rate in result["evals_per_s"].get(name, {}).items():
            times = format_host_and_device(result["times"][name][route])
            lines.append(f"  {route}: {rate:,.0f} evals/s; {times} "
                         f"[{where}]")
    return lines


def main(argv=None):
    from ..vi.soak import card_name

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_trees", nargs="?", type=int, default=1000)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)
    device = compute_device(args.device)
    where = card_name() if device.type == "cuda" else "cpu"
    result = run(args.n_trees, device)
    for line in describe(result, where):
        print(line)
    try:
        check(result)
    except AssertionError as err:
        print(f"FAIL {err}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
