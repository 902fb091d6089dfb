"""Multi-process data parallelism for fleet-scale encoding and fitting — the
port of ``anuraxla/parallel/multihost.py``, on ``torch.distributed``.

The design keeps cross-process traffic near zero, as the reference's does:

- each process decodes and encodes only its shard of the WAV list
  (round-robin, deterministic: no coordination beyond the process group);
- encode stays process-local (the session's shards are this process's
  devices);
- only the fits' moments cross processes: the ``psum``'d counts, sums and
  Gram matrices and the gathered scalar pools of ``parallel.fit`` (a few MB
  once a fit).

One process per card: NCCL refuses two ranks on one GPU, so give each
process its own card (``CUDA_VISIBLE_DEVICES``). On a single process every
helper degrades to the local mesh.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from anuraxla_torch.parallel.mesh import Mesh, make_mesh

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """``torch.distributed.init_process_group`` — NCCL for a cuda mesh, gloo
    for the CPU (``device``'s type; default: cuda where a card is visible) —
    at ``tcp://<coordinator_address>`` with the given world size and rank.
    With no arguments it joins a group only where the standard launcher's
    variables (RANK, WORLD_SIZE, MASTER_ADDR; MASTER_PORT too) are set, and
    otherwise returns False: the single-process no-op. Returns True when a
    multi-process group was joined."""
    kind = torch.device(device).type if device is not None else ("cuda" if torch.cuda.is_available() else "cpu")
    backend = "nccl" if kind == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        if not all(v in os.environ for v in LAUNCHER_VARS):
            return False
        dist.init_process_group(backend, init_method="env://")
        return dist.get_world_size() > 1
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(model_axis: int = 1, *, device=None) -> Mesh:
    """('data', 'model') mesh over every process of the job (identical to
    ``make_mesh`` on one process): the psums of ``parallel.fit`` run within
    a process first, then across."""
    return make_mesh(model_axis=model_axis, device=device)


def shard_paths_for_host(
    paths: Sequence[Path],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """Deterministic round-robin shard of a file list: process i takes
    paths[i::n]. Disjoint, covering and balanced to within one file; every
    process computes its shard from the same sorted list, with no messages."""
    live = dist.is_initialized()
    i = (dist.get_rank() if live else 0) if process_index is None else process_index
    n = (dist.get_world_size() if live else 1) if process_count is None else process_count
    if n <= 1:
        return list(paths)
    return list(paths)[i::n]
