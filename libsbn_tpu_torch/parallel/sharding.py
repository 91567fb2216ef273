"""Device meshes and sharding for multi-device scaling.

The counterpart of libsbn_tpu/parallel/sharding.py, with the same names.
The reference's only parallelism is a thread pool fanning trees over BEAGLE
instances (fat_beagle.hpp:119-149); the JAX package replaces it with SPMD
over a jax.sharding Mesh. PyTorch has no global array and no compiler that
partitions a program, so here a mesh is a small object of its own and the
split is explicit:

  * ``Mesh``: a (dp, sp) grid of this process's torch devices, with the
    axis names ("dp", "sp"). A mesh from ``make_mesh`` lives in one
    process; one from ``distributed.global_mesh`` spans the ranks of a
    torch.distributed job along dp, and holds this rank's row(s) of the
    grid. A device may repeat: eight "cpu" entries stand in for eight
    devices, as the JAX tests use eight virtual host devices, and two
    entries of one card run two shards on it in turn;
  * "dp": data parallel over particles or trees (the FatBeagleParallelize
    axis): each shard is an independent batch of trees;
  * "sp": sequence parallel over site patterns (per-pattern terms dotted
    with pattern weights add up across shards, gp_engine.cpp:213-220).

A ``Sharding`` is a split rule, which tensor axis is cut over which mesh
axis; ``map_shards`` is the analog of ``jax.shard_map`` with the split axis
in and out: it cuts the sharded arguments, moves each piece and a copy of
the replicated arguments to its device, calls the function there, and
concatenates the results on the mesh's first device in shard order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

AXIS_NAMES = ("dp", "sp")


class Mesh:
    """A (dp, sp) grid of torch devices.

    devices: the local grid, an array of torch.device of shape
    (local dp, sp). A mesh that spans ``world_size`` torch.distributed
    ranks along dp (``distributed``; from ``distributed.global_mesh``)
    holds rank ``rank``'s rows; ``shape`` counts the whole job."""

    axis_names = AXIS_NAMES

    def __init__(self, devices, *, world_size: int = 1, rank: int = 0,
                 distributed: bool = False):
        names = np.asarray(devices, dtype=object)
        if names.ndim != 2 or names.size == 0:
            raise ValueError(f"a mesh needs a non-empty (dp, sp) grid of "
                             f"devices, got shape {names.shape}")
        self.devices = np.empty(names.shape, dtype=object)
        for index in np.ndindex(names.shape):
            self.devices[index] = torch.device(names[index])
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.distributed = bool(distributed)

    @property
    def shape(self):
        """{axis name: size} over the whole job."""
        return {"dp": self.devices.shape[0] * self.world_size,
                "sp": self.devices.shape[1]}

    @property
    def first_device(self) -> torch.device:
        """Where results are gathered and replicated state lives."""
        return self.devices[0, 0]

    def axis_devices(self, axis: Optional[str]):
        """This process's devices along ``axis`` ("dp": the first column,
        "sp": the first row), or every device of the grid for None."""
        if axis is None:
            return list(self.devices.ravel())
        if axis not in AXIS_NAMES:
            raise ValueError(f"mesh axis must be one of {AXIS_NAMES}, got "
                             f"{axis!r}")
        return list(self.devices[:, 0] if axis == "dp" else self.devices[0, :])

    def __repr__(self):
        where = (f", rank {self.rank} of {self.world_size}"
                 if self.distributed else "")
        return (f"Mesh({self.shape}, devices "
                f"{[str(d) for d in self.devices.ravel()]}{where})")


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a Mesh; anything else raises TypeError naming
    it."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a libsbn_tpu_torch.parallel.sharding."
                        f"Mesh, got {type(mesh).__name__}")
    return mesh


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    sp: int = 1,
    devices=None,
) -> Mesh:
    """A (dp, sp) mesh over the first n devices: ``devices`` (names or
    torch.devices, which may repeat), by default the visible cards.
    Asking for more devices than there are raises."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is present; pass devices= "
                               "(for example [\"cpu\"] * 8)")
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"device {d} requested, but "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are present")
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"{n_devices} devices requested, {len(devices)} "
                         "available")
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp * sp = {dp} * {sp} != {n_devices} devices")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


class Sharding(NamedTuple):
    """Cut tensor axis ``axis`` over mesh axis ``mesh_axis`` (one piece per
    device along it, in order); ``axis`` None replicates onto every device
    of the grid."""

    mesh: Mesh
    axis: Optional[int]
    mesh_axis: Optional[str]

    @property
    def devices(self):
        return self.mesh.axis_devices(self.mesh_axis)

    def split(self, x):
        """The pieces of ``x`` (a tensor or numpy array), each on its
        device; ``torch.tensor_split`` sizes, so an axis the device count
        does not divide gives pieces that differ by one."""
        x = torch.as_tensor(x)
        devices = self.devices
        if self.axis is None:
            return [x.to(d) for d in devices]
        pieces = torch.tensor_split(x, len(devices), dim=self.axis)
        return [p.to(d) for p, d in zip(pieces, devices)]


def particle_sharding(mesh: Mesh) -> Sharding:
    """Shard axis 0 (particles/trees) over dp; replicate the rest."""
    return Sharding(mesh, 0, "dp")


def pattern_sharding(mesh: Mesh, pattern_axis: int = -1) -> Sharding:
    """Shard the pattern axis (by default the last) over sp."""
    return Sharding(mesh, pattern_axis, "sp")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None, None)


def shard_particle_batch(mesh: Mesh, *arrays):
    """Each array with axis 0 split over dp: a tuple with, per array, the
    list of its pieces on their devices."""
    sh = particle_sharding(mesh)
    return tuple(sh.split(np.asarray(a)) for a in arrays)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis to a multiple (with copies of the edge entry); returns
    (padded, original_size)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - n)
    return np.pad(array, pad, mode="edge"), n


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def map_shards(sharding: Sharding, fn, sharded, replicated_args=(), **kwargs):
    """fn(*pieces, *replicated_args, **kwargs) on each device of
    ``sharding``, every tensor argument moved to that device; fn returns a
    tuple of tensors sharded like its inputs, and the pieces come back
    concatenated along ``sharding.axis`` on the mesh's first device, in
    shard order. Devices whose piece is empty are skipped. Every shard is
    launched before any result is moved, so devices run concurrently."""
    pieces = [sharding.split(x) for x in sharded]
    outs = []
    for i, device in enumerate(sharding.devices):
        args = [p[i] for p in pieces]
        if args[0].shape[sharding.axis] == 0:
            continue
        outs.append(fn(*args, *(_to(r, device) for r in replicated_args),
                       **{k: _to(v, device) for k, v in kwargs.items()}))
    first = sharding.mesh.first_device
    return tuple(torch.cat([o[j].to(first) for o in outs], dim=sharding.axis)
                 for j in range(len(outs[0])))
