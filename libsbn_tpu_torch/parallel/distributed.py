"""Multi-process execution on torch.distributed: process-group set-up,
meshes whose dp axis spans the ranks, and process-local batches.

The counterpart of libsbn_tpu/parallel/distributed.py, with the same
names. The reference is strictly single-process (SURVEY.md §2.9: a thread
pool over BEAGLE instances); the JAX package scales out as SPMD, with XLA
inserting the collectives. Here the scale-out model is the same and the
collectives are explicit:

  * every rank runs the same program on its own device(s);
  * the particle/tree axis ("dp") shards across the ranks: each rank
    samples its local slice of the global batch, and the VBPI step
    all-reduces the gradient sums and gathers the per-particle terms that
    every rank needs (vi/jit_step.py ``vbpi_train_step``);
  * the pattern axis ("sp") shards within a rank.

Device rule: a rank computes on a card unless the caller passes
``device="cpu"``; without a card the default raises, as every entry point
of the port does (utils/device.py).

Backend rule, explicit and never silent: ``backend=None`` takes "nccl" when
the rank's device is a card and "gloo" on the CPU. A caller may pass
"gloo" for ranks that share one card (NCCL refuses two ranks on one GPU);
gloo then moves the CUDA tensors of each collective through the host.
Nothing catches an NCCL failure to carry on with gloo.

Collectives gather by all-reduce: each rank writes its rows into a zeroed
buffer of the global batch and the buffer is summed (x + 0 = x exactly),
since gloo documents ``all_reduce`` for CUDA tensors and not
``all_gather``. A ring all-reduce hands every rank the same bits, so the
replicated parameters stay bit-identical across ranks; against one process,
sums over ranks add in another order (rel 1e-9 in f64, not bit for bit).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DEFAULT_DEVICE, compute_device
from .sharding import Mesh, Sharding

# This process's devices, as initialize() chose them (one process group per
# process, so this is process state, as torch.distributed's own is).
_LOCAL_DEVICES: list = []


def _default_devices(rank: int, local_device_ids=None, device=DEFAULT_DEVICE):
    """The rank's devices: the cards ``local_device_ids``, else the card
    ``device`` names (by default the card ``rank % device_count``), or the
    CPU when ``device`` is "cpu". Without a card a CUDA device raises
    (utils/device.py compute_device); nothing falls back to the CPU."""
    device = compute_device(device)
    if device.type == "cpu":
        if local_device_ids is not None:
            raise ValueError(f"local_device_ids={local_device_ids} name "
                             "cards, but device is the CPU")
        return [device]
    if local_device_ids is not None:
        return [torch.device("cuda", int(i)) for i in local_device_ids]
    if device.index is not None:
        return [device]
    return [torch.device("cuda", rank % torch.cuda.device_count())]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
    device=DEFAULT_DEVICE,
) -> bool:
    """Join a torch.distributed job.

    Arguments default to LIBSBN_COORDINATOR / LIBSBN_NUM_PROCESSES /
    LIBSBN_PROCESS_ID. The coordinator address is a torch init method
    ("tcp://host:port" or "file:///path"); a bare "host:port" means tcp.
    Without an address and a process count this is a single-process run
    and nothing is initialized. backend: None for the rule in the module
    docstring, or "nccl" / "gloo". device: the rank's card by default
    (``rank % device_count``, or local_device_ids), "cpu" to run the rank
    on the CPU; without a card the default raises. Returns True if the job
    has more than one process. May be called again: it then reports the
    job it joined."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "LIBSBN_COORDINATOR")
    if num_processes is None and "LIBSBN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LIBSBN_NUM_PROCESSES"])
    if process_id is None and "LIBSBN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LIBSBN_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a distributed job needs a coordinator address, a process count "
            f"and a process id, got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    devices = _default_devices(process_id, local_device_ids, device)
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and devices[0].type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id))
    _LOCAL_DEVICES[:] = devices
    return dist.get_world_size() > 1


def global_mesh(dp: Optional[int] = None, sp: int = 1,
                hybrid: bool = False, device=DEFAULT_DEVICE) -> Mesh:
    """A (dp, sp) mesh over all devices in the job, dp spanning the ranks
    (every rank calls this with the same arguments; sp lies within a
    rank's devices). Without a process group it is this process's mesh.
    ``hybrid`` is accepted for the JAX package's signature and changes
    nothing: its second network tier (DCN between TPU slices) has no
    counterpart among the ranks of one host. device: where a process
    without initialize()'s devices computes, the card by default and "cpu"
    only when asked; without a card the default raises."""
    del hybrid
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        local = list(_LOCAL_DEVICES) or _default_devices(rank, None, device)
    else:
        world, rank, local = 1, 0, _default_devices(0, None, device)
    n = world * len(local)
    if dp is None:
        dp = n // sp
    if dp * sp != n or dp % world or (dp // world) * sp != len(local):
        raise ValueError(
            f"dp * sp = {dp} * {sp} must cover the job's {n} devices, dp "
            f"spanning its {world} ranks of {len(local)} devices each")
    rows = dp // world
    return Mesh([local[i * sp:(i + 1) * sp] for i in range(rows)],
                world_size=world, rank=rank, distributed=dist.is_initialized())


def local_particle_count(mesh: Mesh, global_count: int) -> int:
    """This process's share of a dp-sharded particle axis."""
    if global_count % mesh.world_size:
        raise ValueError(f"global particle count {global_count} must divide "
                         f"evenly over {mesh.world_size} processes")
    return global_count // mesh.world_size


def from_process_local(sharding: Sharding, local_rows, global_rows: int):
    """This process's rows of a dp-sharded global batch, as a tensor on
    the mesh's first device. torch has no global array object: each rank
    holds its own rows, and the collectives of the step combine them."""
    local_rows = torch.as_tensor(np.asarray(local_rows))
    if local_rows.shape[0] * sharding.mesh.world_size != global_rows:
        raise ValueError(
            f"{local_rows.shape[0]} local rows x {sharding.mesh.world_size} "
            f"processes != {global_rows} global rows")
    return local_rows.to(sharding.mesh.first_device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks of a distributed mesh, in place; any other
    mesh leaves it as it is. Returns x."""
    if mesh.distributed:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``local`` (n, ...), concatenated in rank order:
    (world_size n, ...) on every rank, bit for bit (an all-reduce of a
    zeroed buffer holding this rank's rows at its offset). Any other mesh
    returns ``local``."""
    if not mesh.distributed:
        return local
    n = local.shape[0]
    out = local.new_zeros((mesh.world_size * n,) + tuple(local.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = local
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out
