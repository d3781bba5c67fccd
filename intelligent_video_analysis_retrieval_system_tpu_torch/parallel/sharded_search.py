"""Sharded top-k search: a sweep per shard, then one merge.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel/
sharded_search.py``. The rows shard over a mesh axis (``N_pad / n`` rows a
shard, resident on the shard's device); every shard runs the single-device
exact search over its rows (:func:`ops.topk.topk_search`, kernel B1 on a
card; :func:`ops.quant.topk_search_int8`, kernel B2, for int8 rows); the
``(B, k)`` scores and global ids of every shard gather onto the mesh's
first device, shard-major, and one lowest-position-first selection
(:func:`ops.topk.topk_lowest_index_first`, the tie order of ``lax.top_k``)
gives the answer: on a tie the lower shard wins, then the lower local rank,
as in the JAX merge. A shard that holds no live row contributes ``k``
slots of -inf, so padding never wins.

Shards on one device are views of one buffer (no copy per shard); shards on
distinct devices are tensors of their own, each searched under its device.
A mesh that spans the ranks of a process group holds only this rank's
shards (:class:`ShardedRows`): the merge gathers them locally, then
all-gathers the ``(local shards, B, k)`` candidates over the group and runs
the same selection, so every rank returns the same answer.

What has no counterpart, and why: the JAX module's compile caches
(``_searcher_cache``, ``_int8_searcher_cache``, ``_append_updater``, the
``_MESHES`` weak registry and ``mesh_cache_key``) exist only to keep one
``jit`` program per shape; eager torch compiles nothing, and the kernels'
own launch plans are per call. The padding of the query batch to
``bucket_b`` happens inside each shard's sweep (``ops.topk.pad_queries``),
and ``k`` runs at ``bucket_k(k)`` and is sliced, as in JAX.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..ops.quant import quantize_rows_int8, topk_search_int8
from ..ops.topk import TILE_N, TopKResult, bucket_k, topk_lowest_index_first, topk_search
from .mesh import Mesh

__all__ = ["ShardedRows", "place_rows", "sharded_topk", "sharded_topk_int8",
           "ShardedIndexSearcher"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedRows:
    """This process's shards of a row-sharded ``(n_pad, ...)`` tensor.

    ``shards[i]`` holds rows ``[positions[i] * shard_rows, (positions[i] +
    1) * shard_rows)`` on its shard's device; ``buffer`` is the one tensor
    they view where every local shard sits on one device."""

    def __init__(self, shards: Sequence[torch.Tensor], positions: Sequence[int],
                 n_shards: int, buffer: torch.Tensor | None = None) -> None:
        self.shards = list(shards)
        self.positions = list(positions)
        self.n_shards = int(n_shards)
        self.buffer = buffer

    @property
    def shard_rows(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.shard_rows * self.n_shards, *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def offset(self, i: int) -> int:
        """Global row id of local shard ``i``'s first row."""
        return self.positions[i] * self.shard_rows

    def write(self, start: int, rows: torch.Tensor | np.ndarray) -> None:
        """Copy ``rows`` into global rows ``[start, start + len(rows))``:
        each local shard takes its overlap (a range may straddle shards;
        rows owned by other ranks are skipped)."""
        m = len(rows)
        sr = self.shard_rows
        for i, shard in enumerate(self.shards):
            lo, hi = max(start, self.offset(i)), min(start + m, self.offset(i) + sr)
            if lo >= hi:
                continue
            part = rows[lo - start:hi - start]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            shard[lo - self.offset(i):hi - self.offset(i)].copy_(part)

    def read(self, end: int) -> torch.Tensor:
        """Global rows ``[0, end)`` on the CPU (every shard must be local)."""
        if len(self.shards) != self.n_shards:
            raise RuntimeError("the rows span processes: no rank holds all of them")
        return torch.cat([s.cpu() for s in self.shards])[:end]


def _zeros(mesh: Mesh, axis: str, n_pad: int, tail: tuple[int, ...],
           dtype: torch.dtype) -> ShardedRows:
    """Zero shards of ``(n_pad, *tail)`` over ``axis``: one buffer where the
    local shards are contiguous on one device, a tensor a shard otherwise."""
    n_dev = mesh.shape[axis]
    sr = n_pad // n_dev
    positions, devices = mesh.local_shards(axis)
    if len(set(devices)) == 1 and positions == list(range(positions[0],
                                                           positions[0] + len(positions))):
        buf = torch.zeros((sr * len(positions), *tail), dtype=dtype, device=devices[0])
        return ShardedRows([buf[j * sr:(j + 1) * sr] for j in range(len(positions))],
                           positions, n_dev, buf)
    return ShardedRows([torch.zeros((sr, *tail), dtype=dtype, device=d) for d in devices],
                       positions, n_dev)


def place_rows(mesh: Mesh, x: torch.Tensor | np.ndarray, n_pad: int, axis: str = "index",
               dtype: torch.dtype | None = None) -> ShardedRows:
    """Lay the global rows ``x`` (``len(x) <= n_pad``; zero below ``n_pad``)
    over ``axis``, this process's shards only. A tensor of exactly ``n_pad``
    rows of ``dtype`` on the one device every shard of the mesh sits on is
    adopted as it is: the shards are views of it."""
    n_dev = mesh.shape[axis]
    if n_pad % (n_dev * TILE_N):
        raise ValueError(f"{n_pad} rows do not split into {n_dev} shards of TILE_N multiples")
    if isinstance(x, np.ndarray):
        if dtype is None:
            dtype = torch.from_numpy(x[:0]).dtype
    else:
        dtype = dtype or x.dtype
        positions, devices = mesh.local_shards(axis)
        if (x.shape[0] == n_pad and x.dtype == dtype and len(positions) == n_dev
                and set(devices) == {x.device} and x.is_contiguous()):
            sr = n_pad // n_dev
            return ShardedRows([x[i * sr:(i + 1) * sr] for i in range(n_dev)],
                               list(range(n_dev)), n_dev, x)
    out = _zeros(mesh, axis, n_pad, tuple(x.shape[1:]), dtype)
    out.write(0, x)
    return out


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def gather_ranks(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the first axis in rank order
    (the mesh's shard order: ranks own contiguous positions), on ``t``'s
    device; the ranks' first sizes may differ. Over gloo the exchange goes
    through the CPU, over NCCL through ``t``'s device."""
    dist = torch.distributed
    dev = t.device if dist.get_backend() == "nccl" else torch.device("cpu")
    world = dist.get_world_size()
    size = torch.tensor([t.shape[0]], device=dev)
    sizes = [torch.empty_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(v) for v in sizes]
    local = torch.zeros((max(sizes), *t.shape[1:]), dtype=t.dtype, device=dev)
    local[:t.shape[0]] = t
    out = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(out, local)
    return torch.cat([o[:n] for o, n in zip(out, sizes)]).to(t.device)


def _merge(parts: list[tuple[torch.Tensor, torch.Tensor] | None], k_local: int, k: int,
           b: int, device: torch.device, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather every local shard's ``(B, <= k_local)`` scores and global ids
    onto ``device`` (an empty or short shard pads with -inf slots, id -1),
    all-gather across ranks where the mesh spans several, lay them out
    shard-major and keep the top ``k``, lowest position first."""
    scores, ids = [], []
    for part in parts:
        s = torch.full((b, k_local), float("-inf"), device=device)
        i = torch.full((b, k_local), -1, dtype=torch.int64, device=device)
        if part is not None:
            w = part[0].shape[1]
            s[:, :w] = part[0].to(device)
            i[:, :w] = part[1].to(device)
        scores.append(s)
        ids.append(i)
    all_s, all_i = torch.stack(scores), torch.stack(ids)       # (n_local, B, k_local)
    if len(set(mesh.process_ids.flat)) > 1:
        all_s, all_i = gather_ranks(all_s), gather_ranks(all_i)
    n = all_s.shape[0]
    flat_s = all_s.permute(1, 0, 2).reshape(b, n * k_local)
    flat_i = all_i.permute(1, 0, 2).reshape(b, n * k_local)
    top_s, pos = topk_lowest_index_first(flat_s, min(k, n * k_local))
    return top_s, torch.gather(flat_i, 1, pos)


def _local_valid(n_valid: int, offset: int, shard_rows: int) -> int:
    # rows of this shard that are live; the sweep masks the rest before the
    # local selection, so an all-padding shard never crowds out real hits
    return min(max(int(n_valid) - offset, 0), shard_rows)


# ---------------------------------------------------------------------------
# searches
# ---------------------------------------------------------------------------


def sharded_topk(
    mesh: Mesh,
    x_sharded: ShardedRows,
    q: torch.Tensor,
    k: int,
    n_valid: int,
    deleted_sharded: ShardedRows | None = None,
) -> TopKResult:
    """Exact top-k over row-sharded bf16/f32 rows: :func:`ops.topk.
    topk_search` per shard (kernel B1 on a card), then the merge. ``q`` is
    ``(B, D)`` (cast to the rows' dtype); the result lives on the first
    local shard's device, the same on every rank."""
    b = int(q.shape[0])
    k_run = bucket_k(int(k))
    sr = x_sharded.shard_rows
    k_local = min(k_run, sr)
    parts: list[tuple[torch.Tensor, torch.Tensor] | None] = []
    for i, shard in enumerate(x_sharded.shards):
        off = x_sharded.offset(i)
        valid = _local_valid(n_valid, off, sr)
        if valid == 0:
            parts.append(None)
            continue
        dead = None if deleted_sharded is None else deleted_sharded.shards[i]
        res = topk_search(shard, q.to(shard.device, shard.dtype), k_local, n_valid=valid,
                          deleted=dead)
        parts.append((res.scores, res.indices + off))
    scores, ids = _merge(parts, k_local, k_run, b, x_sharded.shards[0].device, mesh)
    return TopKResult(scores[:, :k], ids[:, :k])


def sharded_topk_int8(
    mesh: Mesh,
    x_i8_sharded: ShardedRows,
    scales_sharded: ShardedRows,
    q: torch.Tensor,
    k: int,
    n_valid: int,
    deleted_sharded: ShardedRows | None = None,
) -> TopKResult:
    """Top-k over row-sharded int8 rows and their ``(shard_rows,)`` f32
    scales: :func:`ops.quant.topk_search_int8` per shard (kernel B2 on a
    card) under the integer metric, then the merge. Each shard's live range
    goes to the sweep as its ``n_valid``, which masks padding before the
    chunk maxima: the role of the JAX reference path's folding of padding
    into the tombstones."""
    b = int(q.shape[0])
    k_run = bucket_k(int(k))
    sr = x_i8_sharded.shard_rows
    k_local = min(k_run, sr)
    parts: list[tuple[torch.Tensor, torch.Tensor] | None] = []
    for i, shard in enumerate(x_i8_sharded.shards):
        off = x_i8_sharded.offset(i)
        valid = _local_valid(n_valid, off, sr)
        if valid == 0:
            parts.append(None)
            continue
        dead = None if deleted_sharded is None else deleted_sharded.shards[i]
        res = topk_search_int8(shard, scales_sharded.shards[i],
                               q.to(shard.device, torch.float32), k_local, n_valid=valid,
                               deleted=dead)
        parts.append((res.scores, res.indices + off))
    scores, ids = _merge(parts, k_local, k_run, b, x_i8_sharded.shards[0].device, mesh)
    return TopKResult(scores[:, :k], ids[:, :k])


# in-place appends are checked against the capacity in steps of this many
# rows, as the JAX searcher's fixed-size update chunks are
_APPEND_STEP = 256


class ShardedIndexSearcher:
    """Holds a row-sharded database and serves merged top-k.

    The device backend of ``UnifiedIndex`` on a mesh: rows pad to
    ``n_devices * TILE_N`` and shard evenly; merged results equal the
    single-device search's (int8: bit for bit). ``dtype`` is the rows'
    compute dtype for :meth:`load`; :meth:`load_int8` holds int8 rows and
    per-row f32 scales."""

    def __init__(self, mesh: Mesh, axis: str = "index",
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.n_valid = 0
        self._x: ShardedRows | None = None
        self._scales: ShardedRows | None = None   # (shard_rows,) f32, int8 mode
        self._dead: ShardedRows | None = None     # (shard_rows, 1) int8 tombstones
        self._deleted: set[int] = set()
        self._ann = None   # parallel.sharded_ann.ShardedIVF while active

    @property
    def n_devices(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def capacity(self) -> int:
        return 0 if self._x is None else int(self._x.shape[0])

    @property
    def device(self) -> torch.device:
        """The first local shard's device: where merged results land."""
        return self.mesh.local_shards(self.axis)[1][0]

    def _n_pad(self, n: int) -> int:
        return _ceil_to(max(n, 1), self.n_devices * TILE_N)

    def load(self, x: torch.Tensor | np.ndarray, deleted_rows: set[int] | None = None,
             n_rows: int | None = None) -> None:
        """Shard ``(N, D)`` rows (``n_rows`` live where ``x`` is already
        padded) over the mesh axis, in ``dtype``."""
        n = len(x) if n_rows is None else int(n_rows)
        n_pad = self._n_pad(n)
        if len(x) > n_pad:
            x = x[:n]
        self._x = place_rows(self.mesh, x, n_pad, self.axis, self.dtype)
        self._scales = None
        self.n_valid = n
        self._ann = None   # shard_rows changed: local bucket ids are stale
        self.set_deleted(deleted_rows or set())

    def load_int8(self, rows_i8: np.ndarray, scales: np.ndarray,
                  deleted_rows: set[int] | None = None) -> None:
        """Shard int8 rows and their per-row scales together (the capacity
        mode: half the bytes of bf16 per shard)."""
        n = len(rows_i8)
        n_pad = self._n_pad(n)
        self._x = place_rows(self.mesh, np.asarray(rows_i8, np.int8), n_pad, self.axis)
        self._scales = place_rows(self.mesh, np.asarray(scales, np.float32).reshape(-1),
                                  n_pad, self.axis)
        self.n_valid = n
        self._ann = None
        self.set_deleted(deleted_rows or set())

    def set_deleted(self, deleted_rows: set[int]) -> None:
        """Install (or clear) the tombstone mask, sharded like the rows."""
        self._deleted = set(deleted_rows)
        if not self._deleted:
            self._dead = None
            return
        assert self._x is not None
        mask = np.zeros((self.capacity, 1), np.int8)
        rows = np.fromiter((r for r in self._deleted if 0 <= r < self.capacity), np.int64)
        mask[rows, 0] = 1
        self._dead = place_rows(self.mesh, mask, self.capacity, self.axis)

    def _live_tombstones(self) -> set[int] | None:
        return {r for r in self._deleted if r < self.n_valid} or None

    def append(self, rows: np.ndarray) -> None:
        """Append rows: copied in place into the owning shard or shards while
        the padded capacity allows, else a re-shard that carries the
        tombstones across. int8 rows are quantized here (symmetric max-abs
        scale) and appended by :meth:`append_quantized`."""
        if self._x is None:
            self.load(rows)
            return
        if self._scales is not None:
            self.append_quantized(*quantize_rows_int8(np.asarray(rows, np.float32)))
            return
        m = len(rows)
        if self.n_valid + _ceil_to(max(m, 1), _APPEND_STEP) <= self.capacity:
            self._x.write(self.n_valid, torch.from_numpy(
                np.ascontiguousarray(rows, np.float32)).to(self.dtype))
            # the rows past n_valid + m stay zero and masked by n_valid; the
            # tombstones are all below n_valid
            self.n_valid += m
            return
        current = self._x.read(self.n_valid).float().numpy()
        self.load(np.concatenate([current, np.asarray(rows, np.float32)]),
                  deleted_rows=self._live_tombstones())

    def append_quantized(self, rows_i8: np.ndarray, scales: np.ndarray) -> None:
        """Append pre-quantized int8 rows and their scales (int8 mode only):
        in place while the capacity allows, else a re-shard carrying the
        tombstones."""
        assert self._scales is not None, "append_quantized needs int8 mode"
        m = len(rows_i8)
        if m == 0:
            return
        if self.n_valid + _ceil_to(m, _APPEND_STEP) <= self.capacity:
            self._x.write(self.n_valid, np.asarray(rows_i8, np.int8))
            self._scales.write(self.n_valid, np.asarray(scales, np.float32).reshape(-1))
            self.n_valid += m
            return
        cur_q = self._x.read(self.n_valid).numpy()
        cur_s = self._scales.read(self.n_valid).numpy()
        self.load_int8(np.concatenate([cur_q, np.asarray(rows_i8, np.int8)]),
                       np.concatenate([cur_s, np.asarray(scales, np.float32).reshape(-1)]),
                       deleted_rows=self._live_tombstones())

    # -- ANN (the sharded IVF latency mode, parallel.sharded_ann) ---------------

    @property
    def ann_active(self) -> bool:
        return self._ann is not None

    def set_ann(self, state) -> None:
        """Partition a global ``ops.ann.IVFState`` over this mesh and
        activate :meth:`search_ann` (see ``parallel.sharded_ann``)."""
        from .sharded_ann import make_sharded_ivf

        assert self._x is not None, "no database loaded"
        self._ann = make_sharded_ivf(self.mesh, self.axis, state, self._x.shard_rows)

    def clear_ann(self) -> None:
        self._ann = None

    def update_ann_tail(self, tail_ids: np.ndarray, tail_count: int) -> None:
        """Re-partition only the tail (appends since the build live there)."""
        from .sharded_ann import retarget_tail

        assert self._ann is not None
        self._ann = retarget_tail(self._ann, self.mesh, self.axis, tail_ids, tail_count)

    def search_ann(self, q: np.ndarray, k: int, nprobe: int = 32) -> TopKResult:
        """Approximate merged top-k through the partitioned IVF; equal to
        the single-device ``ops.ann.ivf_topk`` with the same state."""
        from .sharded_ann import sharded_ivf_topk

        assert self._ann is not None, "no ANN structure set"
        k = min(k, max(self.n_valid, 1))
        qd = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(q), np.float32))
        return sharded_ivf_topk(self.mesh, self._x, self._ann, qd.to(self.device), k,
                                nprobe=nprobe, n_valid=self.n_valid,
                                deleted_sharded=self._dead, scales_sharded=self._scales)

    def search(self, q: np.ndarray, k: int) -> TopKResult:
        assert self._x is not None, "no database loaded"
        k = min(k, max(self.n_valid, 1))
        qd = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(q), np.float32))
        if self._scales is not None:
            return sharded_topk_int8(self.mesh, self._x, self._scales, qd, k, self.n_valid,
                                     deleted_sharded=self._dead)
        return sharded_topk(self.mesh, self._x, qd, k, self.n_valid, deleted_sharded=self._dead)

    def stats(self) -> dict[str, Any]:
        return {
            "devices": self.n_devices,
            "axis": self.axis,
            "quantized": self._scales is not None,
            "n_valid": self.n_valid,
            "padded_rows": self.capacity,
            "rows_per_device": self.capacity // self.n_devices,
            "ann_active": self._ann is not None,
        }
