"""Device mesh construction and topology helpers.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel/mesh.py``.
:class:`Mesh` stands in for ``jax.sharding.Mesh``: a numpy object array of
``torch.device`` entries laid out over named axes, ``shape`` a name -> size
mapping (``mesh.shape["index"]`` reads as in JAX) and, for a mesh that spans
the ranks of a ``torch.distributed`` process group, the rank that owns each
entry (``process_ids``).

A mesh holds either CUDA devices or the CPU, never both. ``devices=None``
means every visible CUDA device and raises where there is none: a mesh
never falls back to the CPU. An explicit ``devices`` list may name one
device more than once, which lays several logical shards on it (the
counterpart of JAX's ``xla_force_host_platform_device_count``): the CPU
tests use ``["cpu"] * 8``, one card ``["cuda:0"] * 4``.

In a process group of several ranks each rank passes its own devices (or
takes its visible CUDA devices); the mesh lays every rank's devices out
rank by rank, the process-contiguous order of JAX's default device list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["MeshSpec", "Mesh", "create_mesh", "device_info"]


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh layout.

    Axes used across the framework:
    - ``data``  — batch sharding for embedding throughput (DP)
    - ``index`` — row sharding of the search database
    - ``model`` — tensor-parallel sharding of tower weights (training)
    """

    axis_names: tuple[str, ...] = ("data", "index")
    shape: tuple[int, ...] | None = None  # None -> (1, ..., n_devices)

    def resolve_shape(self, n_devices: int) -> tuple[int, ...]:
        if self.shape is not None:
            total = int(np.prod(self.shape))
            if total != n_devices:
                raise ValueError(
                    f"mesh shape {self.shape} needs {total} devices, "
                    f"have {n_devices}"
                )
            return tuple(self.shape)
        return (1,) * (len(self.axis_names) - 1) + (n_devices,)


def _rank_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Devices laid out over named axes (``jax.sharding.Mesh``'s role).

    ``devices`` is a numpy object array of ``torch.device``; ``process_ids``
    an int array of the same shape naming the rank that owns each entry
    (all 0 in one process). Rows shard over one axis: the shards along it
    are the devices at coordinate 0 of every other axis
    (:meth:`axis_devices`)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: np.ndarray | None = None) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        types = {torch.device(d).type for d in devices.flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds CUDA devices or the CPU, not both: {sorted(types)}")
        if types - {"cuda", "cpu"}:
            raise ValueError(f"unsupported mesh device type {sorted(types)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.process_ids = (np.zeros(devices.shape, np.int64) if process_ids is None
                            else np.asarray(process_ids, np.int64).reshape(devices.shape))

    def axis_devices(self, axis: str) -> list[tuple[torch.device, int]]:
        """(device, owning rank) of each position along ``axis``, at
        coordinate 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0 for j in range(len(self.axis_names)))
        return [(torch.device(d), int(p)) for d, p in
                zip(self.devices[index].tolist(), self.process_ids[index].tolist())]

    def local_shards(self, axis: str) -> tuple[list[int], list[torch.device]]:
        """Positions along ``axis`` that this process owns, and their devices."""
        rank = _rank_world()[0]
        owned = [(i, d) for i, (d, r) in enumerate(self.axis_devices(axis)) if r == rank]
        return [i for i, _ in owned], [d for _, d in owned]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device(d: torch.device | str) -> torch.device:
    """``torch.device`` with the index a CUDA device stands for."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def create_mesh(
    spec: MeshSpec | None = None,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """Build a Mesh over every visible CUDA device (or an explicit list).

    ``devices=None`` raises where no CUDA device is visible; a list may
    repeat a device (logical shards on one device) and must not mix the CPU
    with CUDA devices. In a process group of several ranks, ``devices`` is
    this rank's own list and the mesh spans every rank's (all ranks call
    this together)."""
    spec = spec or MeshSpec()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_mesh: no CUDA device is visible; pass devices=[...] "
                "(e.g. ['cpu'] * 8) for a mesh on the CPU")
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        local = [_device(d) for d in devices]
    if not local:
        raise ValueError("create_mesh: no devices")
    rank, world = _rank_world()
    owners = [rank] * len(local)
    if world > 1:
        gathered: list[Any] = [None] * world
        torch.distributed.all_gather_object(gathered, [str(d) for d in local])
        local = [torch.device(d) for names in gathered for d in names]
        owners = [r for r, names in enumerate(gathered) for _ in names]
    shape = spec.resolve_shape(len(local))
    arr = np.empty(len(local), dtype=object)
    arr[:] = local
    return Mesh(arr.reshape(shape), spec.axis_names,
                np.asarray(owners, np.int64).reshape(shape))


def device_info() -> dict[str, Any]:
    """Host-visible device topology summary (for /api/stats and logs)."""
    rank, world = _rank_world()
    if torch.cuda.is_available():
        backend = "cuda"
        devs = [{"id": i, "platform": "cuda", "kind": torch.cuda.get_device_name(i),
                 "process_index": rank} for i in range(torch.cuda.device_count())]
    else:
        backend = "cpu"
        devs = [{"id": 0, "platform": "cpu", "kind": "cpu", "process_index": rank}]
    return {
        "backend": backend,
        "num_devices": len(devs) * world,
        "num_local_devices": len(devs),
        "process_index": rank,
        "num_processes": world,
        "devices": devs,
    }
