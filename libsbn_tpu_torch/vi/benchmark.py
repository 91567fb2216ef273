"""Benchmarking: fit to a fixed-topology MCMC run (reference:
vip/benchmark.py; the counterpart of libsbn_tpu.vi.benchmark).

``fixed`` returns dicts and lists where the reference returns pandas
DataFrames, as libsbn_tpu's does. The Burrito's likelihood engine computes
on ``device`` (the card unless the caller passes device="cpu").
"""

from __future__ import annotations

import os
import timeit

import numpy as np

from ..instance import UnrootedInstance
from ..models.phylo_model import PhyloModelSpec
from ..utils.device import DEFAULT_DEVICE
from .burrito import Burrito


def fixed(
    data_path: str,
    *,
    branch_model_name: str,
    scalar_model_name: str,
    optimizer_name: str,
    step_count: int,
    particle_count: int,
    thread_count: int = 1,
    final_elbo_particle_count: int = 10_000,
    device=DEFAULT_DEVICE,
):
    """Fit a posterior from a fixed MCMC topology sample in
    ``data_path/<name>_out.t`` and ``<name>.fasta``; returns (run_details
    {"gradient_time" s, "final_elbo"}, opt_trace list, fitting_results
    {"vb_sample", "mcmc"})."""
    data_path = os.path.normpath(data_path)
    data_id = os.path.basename(data_path)
    mcmc_nexus_path = os.path.join(data_path, data_id + "_out.t")
    fasta_path = os.path.join(data_path, data_id + ".fasta")
    burn_in_fraction = 0.1
    spec = PhyloModelSpec("JC69", "constant", "strict")

    # Read the MCMC run and get split lengths for mode matching + comparison.
    mcmc_inst = UnrootedInstance("mcmc_inst")
    mcmc_inst.read_nexus_file(mcmc_nexus_path)
    burn_in_count = int(burn_in_fraction * mcmc_inst.tree_count())
    mcmc_inst.tree_collection.erase(0, burn_in_count)
    mcmc_inst.process_loaded_trees()
    ragged = [np.array(a) for a in mcmc_inst.split_lengths()]
    mcmc_split_lengths = [
        {"variable": idx, "values": a} for idx, a in enumerate(ragged)
    ]
    last_sampled_split_lengths = np.array([a[-1] for a in ragged])

    burro = Burrito(
        mcmc_nexus_path=mcmc_nexus_path,
        burn_in_fraction=burn_in_fraction,
        fasta_path=fasta_path,
        phylo_model_specification=spec,
        branch_model_name=branch_model_name,
        scalar_model_name=scalar_model_name,
        optimizer_name=optimizer_name,
        particle_count=particle_count,
        thread_count=thread_count,
        device=device,
    )
    burro.branch_model.mode_match(last_sampled_split_lengths)

    start_time = timeit.default_timer()
    burro.gradient_steps(step_count)
    gradient_time = timeit.default_timer() - start_time
    opt_trace = list(burro.opt.trace)

    fit_sample = burro.branch_model.sample_all(mcmc_inst.tree_count())
    final_elbo = burro.estimate_elbo(particle_count=final_elbo_particle_count)

    run_details = {"gradient_time": gradient_time, "final_elbo": final_elbo}
    fitting_results = {"vb_sample": fit_sample, "mcmc": mcmc_split_lengths}
    return run_details, opt_trace, fitting_results
