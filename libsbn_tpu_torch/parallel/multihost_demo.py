"""One rank of a multi-process VBPI run on torch.distributed.

The counterpart of tools/multihost_demo.py. Each rank joins the job from
LIBSBN_COORDINATOR / LIBSBN_NUM_PROCESSES / LIBSBN_PROCESS_ID
(distributed.initialize), builds the unrooted instance on its device, and
trains ``JitVBPI(mesh=global_mesh())`` for a few steps: each rank samples
its particle_count / world_size particles and the steps combine the ranks'
sums, so the replicated parameters must come out bit-identical on every
rank. Optionally it then fits GP branch lengths with the same global mesh
(every rank the whole fit). It writes what it did to an .npz: the final
state, each step's metrics and host samples (so that one process can
replay the job's steps on the ranks' samples concatenated), the kernel
launch counts and the GP fit. Two ranks on the CPU, from the repo root:

    for r in 0 1; do LIBSBN_COORDINATOR=file:///tmp/lsbn_store \\
      LIBSBN_NUM_PROCESSES=2 LIBSBN_PROCESS_ID=$r python -m \\
      libsbn_tpu_torch.parallel.multihost_demo --device cpu \\
      --out /tmp/rank$r.npz & done

Without ``--device cpu`` each rank computes on a card (and raises without
one). Ranks that share one card pass ``--backend gloo`` (NCCL refuses two
ranks on one GPU).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help=".npz this rank writes")
    p.add_argument("--trees", default=os.path.join(REPO, "data", "hello_out.t"))
    p.add_argument("--fasta", default=os.path.join(REPO, "data", "hello.fasta"))
    p.add_argument("--particles", type=int, default=8,
                   help="the global particle count")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float64")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on a card, gloo on the CPU")
    p.add_argument("--device", default="cuda",
                   help="the rank's device: a card by default (raising "
                        "without one), cpu to run on the CPU")
    p.add_argument("--gp-fasta", default=None)
    p.add_argument("--gp-newick", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    torch.set_num_threads(1)
    import libsbn_tpu_torch as lt
    from libsbn_tpu_torch.gp import GPInstance, engine_kernels
    from libsbn_tpu_torch.ops import pruning_jc
    from libsbn_tpu_torch.parallel import distributed
    from libsbn_tpu_torch.vi import JitVBPI

    distributed.initialize(backend=args.backend, device=args.device)
    mesh = distributed.global_mesh(device=args.device)
    dtype = getattr(torch, args.dtype)
    inst = lt.UnrootedInstance("multihost")
    inst.read_nexus_file(args.trees)
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(args.fasta)
    inst.prepare_for_phylo_likelihood(
        lt.PhyloModelSpec("JC69", "constant", "strict"),
        device=mesh.first_device, dtype=dtype)
    pruning_jc.reset_counters()
    engine_kernels.reset_counters()
    jv = JitVBPI(inst, particle_count=args.particles, mesh=mesh,
                 seed=args.seed, dtype=dtype)
    init_q = jv.state.q_params.cpu().numpy()
    init_sbn = jv.state.sbn_params.cpu().numpy()
    metrics, batches = [], []
    for _ in range(args.steps):
        m = jv.step()
        metrics.append([float(m["mean_ll"]), float(m["elbo_like"])])
        batches.append(jv.last_batch)
    out = {
        "rank": mesh.rank, "world_size": mesh.world_size,
        "backend": torch.distributed.get_backend(),
        "device": str(mesh.first_device), "metrics": np.array(metrics),
        "init_q_params": init_q, "init_sbn_params": init_sbn,
        "q_params": jv.state.q_params.cpu().numpy(),
        "sbn_params": jv.state.sbn_params.cpu().numpy(),
    }
    for group, st in zip(("q", "sbn"), jv.state.opt_state):
        out[f"adam_{group}_mu"] = st.mu.cpu().numpy()
        out[f"adam_{group}_nu"] = st.nu.cpu().numpy()
        out[f"adam_{group}_count"] = int(st.count)
    for i, name in enumerate(("post_children", "branch_rep", "reps",
                              "touched")):
        out[name] = np.stack([ints[i] for ints, _ in batches])
    out["eps"] = np.stack([eps for _, eps in batches])
    if args.gp_fasta:
        gp = GPInstance()
        gp.read_fasta_file(args.gp_fasta)
        gp.read_newick_file(args.gp_newick)
        gp.make_engine(mesh=mesh, dtype=dtype)
        marginal, sweeps = gp.get_engine().run_branch_ascent(1e-8, 50)
        out.update(gp_marginal=marginal, gp_sweeps=sweeps,
                   gp_branch_lengths=gp.get_engine().branch_lengths)
    torch.distributed.barrier()
    out["launches"] = json.dumps({**pruning_jc.LAUNCHES,
                                  **engine_kernels.LAUNCHES})
    out["twin_calls"] = json.dumps({**pruning_jc.TWIN_CALLS,
                                    **engine_kernels.TWIN_CALLS})
    np.savez(args.out, **out)
    checksum = float(np.sum(out["sbn_params"], dtype=np.float64))
    print(f"MULTIHOST_OK rank={mesh.rank} world={mesh.world_size} "
          f"backend={out['backend']} device={out['device']} "
          f"checksum={checksum!r}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
