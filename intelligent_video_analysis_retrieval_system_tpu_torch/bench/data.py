"""Benchmark rows, made on the device from a seed.

A 1M x 768 bf16 database is 1.5 GB and the 10M x 768 int8 one 7.7 GB:
they are filled on the device in chunks of 524,288 rows from an explicit
``torch.Generator``, never uploaded. The numbers are PyTorch's, not the JAX
bench's (the two generators differ): benchmark data needs no parity, and
the tests make their rows with numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import native
from ..index.container import ContainerStats

__all__ = ["GEN_ROWS", "gen_db_bf16", "gen_db_int8", "synthetic_record", "MemoryContainer"]

GEN_ROWS = 524_288


def gen_db_bf16(n_pad: int, dim: int, seed: int, device: torch.device) -> torch.Tensor:
    """(n_pad, dim) bf16 rows, standard normal then L2-normalized in f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty((n_pad, dim), dtype=torch.bfloat16, device=device)
    for s in range(0, n_pad, GEN_ROWS):
        e = min(s + GEN_ROWS, n_pad)
        c = torch.randn((e - s, dim), generator=gen, device=device)
        c /= torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-12)
        buf[s:e].copy_(c)
    return buf


def gen_db_int8(n_pad: int, dim: int, seed: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_pad, dim) int8 rows uniform in [-127, 127] and (n_pad,) f32 row
    scales uniform in [0.9, 1.1] / 127."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty((n_pad, dim), dtype=torch.int8, device=device)
    for s in range(0, n_pad, GEN_ROWS):
        e = min(s + GEN_ROWS, n_pad)
        buf[s:e].copy_(torch.randint(-127, 128, (e - s, dim), generator=gen, device=device,
                                     dtype=torch.int8))
    gen_s = torch.Generator(device=device).manual_seed(seed + 1)
    scales = (torch.rand((n_pad,), generator=gen_s, device=device) * 0.2 + 0.9) / 127.0
    return buf, scales


def synthetic_record(i: int) -> dict:
    """Keyframe metadata of row i: 1000 keyframes per video, one per second."""
    return {"folder": f"video_{i // 1000:04d}", "image": f"{i % 1000:06d}.jpg",
            "frame_id": (i % 1000) * 25, "row_id": i, "pts_time": float(i % 1000),
            "fps": 25.0}


class MemoryContainer:
    """The read interface of ``index.container.IndexContainer`` over bf16
    rows held in host memory, with :func:`synthetic_record` metadata: what
    ``UnifiedIndex.attach_container`` needs to serve rows that never were a
    file, and the container's ``ann`` group held in memory (``put_ann``,
    ``get_ann``, ``update_ann_attrs``, ``drop_ann``: writes need ``mode``
    "a" or "w", ``drop_ann`` and ``update_ann_attrs`` do nothing in "r", as
    in the container). ``path`` names where the index may keep its sidecars
    (None: no sidecars)."""

    dtype = "bfloat16"
    num_thumbnails = 0
    num_images = 0

    def __init__(self, bits: np.ndarray, path: Path | None = None, mode: str = "r") -> None:
        self._bits = bits
        self.dim = bits.shape[1]
        self.path = path
        self.mode = mode
        self._ann: tuple[dict, dict] | None = None

    @property
    def num_rows(self) -> int:
        return len(self._bits)

    num_metadata = num_rows

    def read_embeddings(self, start: int = 0, end: int | None = None,
                        as_float32: bool = False) -> np.ndarray:
        block = self._bits[start:end]
        return native.bf16_to_f32(block) if as_float32 else block

    def iter_metadata(self):
        return (synthetic_record(i) for i in range(self.num_rows))

    def get_metadata(self, row_id: int) -> dict:
        return synthetic_record(row_id)

    def deleted_rows(self) -> set:
        return set()

    def put_ann(self, arrays: dict, attrs: dict) -> None:
        if self.mode == "r":
            raise PermissionError("container opened read-only")
        self._ann = ({k: np.array(v) for k, v in arrays.items()}, dict(attrs))

    def update_ann_attrs(self, attrs: dict) -> None:
        if self._ann is not None and self.mode != "r":
            self._ann[1].update(attrs)

    def get_ann(self) -> tuple[dict, dict] | None:
        if self._ann is None:
            return None
        arrays, attrs = self._ann
        return {k: v.copy() for k, v in arrays.items()}, dict(attrs)

    def drop_ann(self) -> None:
        if self.mode != "r":
            self._ann = None

    def stats(self) -> ContainerStats:
        return ContainerStats(path="<memory>", num_rows=self.num_rows, dim=self.dim,
                              dtype=self.dtype, num_thumbnails=0, num_images=0,
                              num_metadata=self.num_rows, file_bytes=0, journal_files=0)

    def close(self) -> None:
        pass
