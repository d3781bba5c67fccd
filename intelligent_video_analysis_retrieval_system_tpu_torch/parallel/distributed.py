"""Process groups and corpus sharding plans across processes.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel/
distributed.py`` over ``torch.distributed``: every process joins one process
group, the mesh spans every rank's devices (``mesh.create_mesh``), and the
sharded search (``sharded_search.py``) runs unchanged, its merge gathering
each rank's candidates over the group.

Data placement: each process holds only the rows of its own shards.
:func:`host_row_range` says which global rows those are (the searcher's
padded layout: ``n_dev * TILE_N``-row granules split evenly over the mesh
axis), and :func:`make_global_sharded_array` lays this process's chunk on
its shards, so no process ever holds the global corpus.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..ops.topk import TILE_N
from .mesh import Mesh, _rank_world
from .sharded_search import ShardedRows, _ceil_to, _zeros

__all__ = [
    "initialize_distributed",
    "is_multi_host",
    "host_row_range",
    "make_global_sharded_array",
]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict[str, Any]:
    """Join the process group (idempotent, argument or environment driven).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` it joins over TCP; with none it reads ``torchrun``'s
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) and does nothing in a single process. The group runs
    over NCCL where CUDA is visible and over gloo for CPU ranks. A second
    call returns the group's topology unchanged."""
    dist = torch.distributed
    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if coordinator_address:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id))
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1 and os.environ.get("MASTER_ADDR"):
            dist.init_process_group(backend, init_method="env://")
    rank, world = _rank_world()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": local,
        "global_devices": local * world,
    }


def is_multi_host() -> bool:
    dist = torch.distributed
    return dist.is_initialized() and dist.get_world_size() > 1


def host_row_range(n_rows: int, mesh: Mesh, axis: str = "index") -> tuple[int, int]:
    """[start, end) of the global rows this process's shards own.

    Rows pad to ``n_dev * TILE_N`` and split evenly over ``axis`` (the
    searcher's layout); a process owns the union of its shards, which must
    be contiguous in the mesh's order."""
    n_dev = mesh.shape[axis]
    rows_per_dev = _ceil_to(max(n_rows, 1), n_dev * TILE_N) // n_dev
    mine = mesh.local_shards(axis)[0]
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            f"this process's shards are not contiguous in the mesh's order ({mine}); "
            "build the mesh rank by rank (create_mesh does) before sharding rows")
    start = mine[0] * rows_per_dev
    end = min((mine[-1] + 1) * rows_per_dev, n_rows)
    return (min(start, n_rows), end)


def make_global_sharded_array(
    local_rows: np.ndarray | torch.Tensor,
    n_global_rows: int,
    mesh: Mesh,
    axis: str = "index",
    dtype: torch.dtype | str | None = None,
) -> ShardedRows:
    """This process's shards of a global row-sharded tensor, from its chunk.

    ``local_rows`` must be exactly this process's :func:`host_row_range`
    slice; the shards pad with zero rows past ``n_global_rows``."""
    start, end = host_row_range(n_global_rows, mesh, axis)
    if len(local_rows) != end - start:
        raise ValueError(f"{len(local_rows)} local rows for the range [{start}, {end})")
    if isinstance(local_rows, np.ndarray):
        local_rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    n_pad = _ceil_to(max(n_global_rows, 1), mesh.shape[axis] * TILE_N)
    out = _zeros(mesh, axis, n_pad, tuple(local_rows.shape[1:]), dtype or local_rows.dtype)
    out.write(start, local_rows)
    return out
