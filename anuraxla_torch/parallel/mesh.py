"""Device mesh and the two collectives — the port of
``anuraxla/parallel/mesh.py``.

JAX's mesh spans the local devices and the processes of a job, and its
collectives are ``psum`` / ``pmax`` over the ``data`` axis. The port keeps
both levels:

- in process, a mesh holds a list of *shard devices*, row-major over
  (data, model). A device may repeat: eight CPU shards stand in for the JAX
  suite's eight virtual CPU devices, and four shards on ``cuda:0`` drive the
  sharded code on one card. Each shard runs its own part of the work, on its
  device, in shard order;
- across processes, the mesh carries the ``torch.distributed`` group (when
  one is initialized, ``parallel.multihost``): every process holds the same
  number of local shards, and global data shard ``g`` is local shard
  ``g - rank * local_data`` of process ``rank``.

:func:`psum` / :func:`pmax` do all the reducing. They combine the local
shards' tensors in shard order on the mesh's first device, then, where the
mesh has a process group, ``all_reduce`` across processes on that device.
:func:`all_gather` concatenates shard outputs the same way. Every sharded
function of ``parallel`` is written against these, so in-process shards and
cross-process ranks run the same code.

Inputs of the sharded functions are the GLOBAL arrays, held alike by every
process (as the JAX package's ``make_array_from_callback`` needs them); each
process computes only its own shards' rows.

The default shard devices are the visible cards for a ``cuda`` mesh and one
CPU shard for a ``cpu`` mesh; :func:`set_default_devices` replaces them (the
counterpart of ``jax_num_cpu_devices``), for the devices' type it names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_DEFAULT_DEVICES: Optional[List[torch.device]] = None


def set_default_devices(devices: Optional[Sequence] = None) -> None:
    """Shard devices for :func:`make_mesh` of their type when it is given no
    ``devices`` (e.g. ``["cpu"] * 8``, ``["cuda:0"] * 4``); None restores the
    visible devices."""
    global _DEFAULT_DEVICES
    _DEFAULT_DEVICES = None if devices is None else [torch.device(d) for d in devices]


def _default_devices(device=None) -> List[torch.device]:
    """The default shard devices of a ``device``-type mesh (default: cuda
    where a card is visible, else cpu)."""
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        kind = torch.device(device).type
    if _DEFAULT_DEVICES is not None and all(d.type == kind for d in _DEFAULT_DEVICES):
        return list(_DEFAULT_DEVICES)
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh: this process's shard devices (row-major
    over data x model), the global axis sizes, and the process group."""

    devices: Tuple[torch.device, ...]
    shape: dict  # {"data": global data shards, "model": model shards}
    group: Optional[object] = None  # torch.distributed group; None: one process
    rank: int = 0
    world: int = 1

    @property
    def local_data(self) -> int:
        return len(self.devices) // self.shape["model"]

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each local data shard (its model row's head)."""
        m = self.shape["model"]
        return [self.devices[i * m] for i in range(self.local_data)]

    def model_devices(self, i: int) -> List[torch.device]:
        m = self.shape["model"]
        return list(self.devices[i * m : (i + 1) * m])

    def local_slices(self, n: int) -> List[Tuple[int, int]]:
        """(start, stop) rows of each local data shard in an axis of ``n``
        (a multiple of the data axis)."""
        nd = self.shape["data"]
        if n % nd:
            raise ValueError(f"{n} rows do not split evenly over the data axis ({nd} shards)")
        s = n // nd
        first = self.rank * self.local_data
        return [((first + i) * s, (first + i + 1) * s) for i in range(self.local_data)]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    model_axis: int = 1,
    devices: Optional[Sequence] = None,
    device=None,
    local: bool = False,
) -> Mesh:
    """('data', 'model') mesh over the local shard devices (``devices``, else
    the default shard devices of ``device``'s type) and, when
    ``torch.distributed`` is initialized and ``local`` is False, every
    process of the job. ``local=True`` gives this process's shards alone,
    with no group: a process-local encode over its own inputs.

    model_axis=1 gives pure data parallelism; model_axis>1 splits the dense
    bottleneck's output columns over that many shards of each data row."""
    devs = [torch.device(d) for d in devices] if devices is not None else _default_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"requested {n_devices} devices but only {len(devs)} available")
        devs = devs[:n_devices]
    n = len(devs)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    group, rank, world = None, 0, 1
    if dist.is_initialized() and not local:
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return Mesh(tuple(devs), {"data": world * n // model_axis, "model": model_axis}, group, rank, world)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Pad ``axis`` with zeros to a multiple (shards must be even).
    Returns (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width), n


def shard_along(x, mesh: Mesh, axis: int = 0, dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The global array ``x`` (numpy or tensor) padded with zeros (False) on
    ``axis`` to a multiple of the data axis -> this process's data shards,
    each on its data shard's device."""
    x = torch.as_tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    rem = (-x.shape[axis]) % mesh.shape["data"]
    if rem:
        shape = list(x.shape)
        shape[axis] = rem
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return [x.narrow(axis, a, b - a).to(dev) for (a, b), dev in
            zip(mesh.local_slices(x.shape[axis]), mesh.data_devices)]


def _reduce(parts: Sequence[torch.Tensor], mesh: Mesh, op: Callable, dist_op) -> torch.Tensor:
    dev = mesh.devices[0]
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = op(acc, p.to(dev))
    if mesh.group is not None:
        acc = acc.clone() if acc is parts[0] else acc  # never reduce into the caller's tensor
        dist.all_reduce(acc, op=dist_op, group=mesh.group)
    return acc


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of one tensor per local shard, over every shard of the mesh, on its first device."""
    return _reduce(parts, mesh, torch.add, dist.ReduceOp.SUM)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise max of one tensor per local shard, over every shard of the mesh."""
    return _reduce(parts, mesh, torch.maximum, dist.ReduceOp.MAX)


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """One tensor per local shard (equal shapes on every process) ->
    their concatenation along ``dim`` in global shard order, on the mesh's
    first device of every process."""
    dev = mesh.devices[0]
    local = torch.cat([p.to(dev) for p in parts], dim=dim) if len(parts) > 1 else parts[0].to(dev)
    if mesh.group is None:
        return local
    is_bool = local.dtype == torch.bool  # masks travel as bytes
    local = (local.to(torch.uint8) if is_bool else local).contiguous()
    out = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(out, local, group=mesh.group)
    out = torch.cat(out, dim=dim)
    return out.bool() if is_bool else out


def batch_sharded(fn: Callable, mesh: Mesh, batch_size: Optional[int] = None) -> Callable:
    """``fn(shard, rows) -> out`` over a batch split on axis 0 — the port of
    ``jit_batch_sharded``: ``run(x)`` gives each local data shard its even
    slice of the global batch ``x`` (``fn`` moves it to
    ``mesh.data_devices[shard]`` and computes there), and concatenates the
    outputs in shard order on the mesh's first device (every process gets
    the whole batch's). Validates batch divisibility when batch_size is
    given."""
    if batch_size is not None and batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide by the data axis ({mesh.shape['data']} devices)"
        )

    def run(x):
        return all_gather([fn(i, x[a:b]) for i, (a, b) in enumerate(mesh.local_slices(x.shape[0]))], mesh)

    return run
