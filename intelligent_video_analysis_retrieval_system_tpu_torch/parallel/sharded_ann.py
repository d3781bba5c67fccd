"""Sharded IVF: the ANN latency mode over the row-sharded corpus.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel/
sharded_ann.py``, over the port's :mod:`ops.ann` helpers of the same names:

    the k-means centroids are global (one copy on each shard's device);
    the bucket id tables are partitioned by owning shard (rows shard by row
        id, so each shard's table holds about 1/n of the global one);
    every shard: the same probe selection (q @ C^T), a gather of ITS members
        of the probed buckets and of its part of the tail, the exact top-k
        over those candidates (the single-device searcher's scorers);
    then the dense sharded path's merge (``sharded_search._merge``).

The union of the shards' candidates is exactly the single-device IVF's
candidate set for the same ``IVFState`` (every bucket slot and tail entry
lives on one shard) and the per-candidate metric is shared code, so the
sharded answer equals ``ops.ann.ivf_topk``'s (int8 bit for bit), and at
``nprobe == nlist`` the dense sweep's.

:func:`build_ivf_sharded` builds the global state over row shards without
an unsharded copy of the corpus: k-means' sample rows gather onto the first
shard's device in row order, every shard assigns its own rows to the
centroids, the assignments concatenate in shard order onto that device, and
the capacity bucketing runs there. Assignment is per row, so the state is
the single-device ``build_ivf``'s over the same rows. Where the shards span
the ranks of a process group, the sample rows and the assignments are
all-gathered, and every rank builds the same state.

The JAX module's compile caches (``_sharded_ivf_searcher_cache``,
``_zeros_mask``) have no counterpart: nothing is compiled, and a missing
tombstone mask is simply not applied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.ann import (
    _SEL_CHUNK,
    TAIL_MAX,
    IVFBuildReport,
    IVFState,
    _assign,
    _bucket_b_ann,
    _ceil_to,
    _max_program_b,
    _probe_candidates,
    _probe_candidates_batched,
    _rows_f32,
    _topk_over_candidates_float,
    _topk_over_candidates_int8,
    _topk_over_union_float,
    _topk_over_union_int8,
    build_ivf_from,
)
from ..ops.topk import TopKResult, bucket_k
from .mesh import Mesh
from .sharded_search import ShardedRows, _local_valid, _merge, gather_ranks

__all__ = ["ShardedIVF", "partition_ivf_host", "make_sharded_ivf", "retarget_tail",
           "sharded_ivf_topk", "build_ivf_sharded"]


class ShardedIVF(NamedTuple):
    """A global IVF partitioned over this process's shards.

    Bucket and tail entries hold LOCAL row ids (global id - shard offset),
    -1 for an empty slot; shapes are the same on every shard."""

    centroids: tuple       # per local shard: (nlist, d) f32 on its device
    bucket_ids: tuple      # per local shard: (nlist, cap_local) int32
    tail_ids: tuple        # per local shard: (tail_max,) int32
    tail_counts: tuple     # per local shard: live tail entries (host ints)
    positions: tuple       # the local shards' positions on the mesh axis
    shard_rows: int        # rows per shard (padded corpus / n_dev)
    ann_rows: int          # corpus rows covered by the source IVFState


def partition_ivf_host(
    bucket_ids: np.ndarray,
    tail_ids: np.ndarray,
    tail_count: int,
    n_dev: int,
    shard_rows: int,
    tail_max: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition a global IVF id table by owning shard (pure numpy).

    Returns ``(tables, tails, tail_counts)``: ``tables`` (n_dev, nlist,
    cap_local) of LOCAL ids (-1 padded; members keep their within-bucket
    order, the build's centroid-similarity order), ``tails`` (n_dev,
    tail_max) and ``tail_counts`` (n_dev,). Every live global id appears
    exactly once across the shards' tables and tails."""
    nlist, cap = bucket_ids.shape
    if tail_max is None:
        tail_max = TAIL_MAX
    ids = np.asarray(bucket_ids, np.int64)
    owner = np.where(ids >= 0, ids // shard_rows, -1)
    counts = np.stack(
        [(owner == s).sum(axis=1) for s in range(n_dev)]
    ) if nlist else np.zeros((n_dev, 0), np.int64)
    cap_local = int(counts.max()) if counts.size else 1
    cap_local = _ceil_to(max(cap_local, 1), _SEL_CHUNK)
    tables = np.full((n_dev, nlist, cap_local), -1, np.int32)
    width = min(cap, cap_local)
    for s in range(n_dev):
        m = owner == s
        local = np.where(m, ids - s * shard_rows, -1).astype(np.int32)
        # a stable sort on ~membership compacts members to the front in
        # their build order
        order = np.argsort(~m, axis=1, kind="stable")
        tables[s, :, :width] = np.take_along_axis(local, order, axis=1)[:, :width]
    tails, tail_counts = _partition_tail(tail_ids, tail_count, n_dev, shard_rows, tail_max)
    return tables, tails, tail_counts


def _partition_tail(
    tail_ids: np.ndarray,
    tail_count: int,
    n_dev: int,
    shard_rows: int,
    tail_max: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Split the global tail id list by owning shard (LOCAL ids, -1 pad).
    The global tail is capped at ``TAIL_MAX``, the per-shard capacity, so
    even a pile-up on one shard fits; the raise is a defensive invariant."""
    t = np.asarray(tail_ids[:tail_count], np.int64)
    towner = t // shard_rows
    tails = np.full((n_dev, tail_max), -1, np.int32)
    tail_counts = np.zeros((n_dev,), np.int32)
    for s in range(n_dev):
        mine = (t[towner == s] - s * shard_rows).astype(np.int32)
        if mine.size > tail_max:
            raise OverflowError(f"sharded IVF tail overflow: {mine.size} > {tail_max}")
        tails[s, :mine.size] = mine
        tail_counts[s] = mine.size
    return tails, tail_counts


def make_sharded_ivf(mesh: Mesh, axis: str, state: IVFState, shard_rows: int) -> ShardedIVF:
    """Partition a global ``IVFState`` and place this process's parts on
    their shards' devices (one centroid copy per distinct device)."""
    n_dev = mesh.shape[axis]
    tables, tails, tail_counts = partition_ivf_host(
        state.bucket_ids.cpu().numpy().astype(np.int32),
        state.tail_ids.cpu().numpy().astype(np.int32),
        int(state.tail_count), n_dev, shard_rows)
    positions, devices = mesh.local_shards(axis)
    cents: dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in cents:
            cents[d] = state.centroids.to(d, torch.float32)
    return ShardedIVF(
        centroids=tuple(cents[d] for d in devices),
        bucket_ids=tuple(torch.from_numpy(tables[p]).to(d) for p, d in zip(positions, devices)),
        tail_ids=tuple(torch.from_numpy(tails[p]).to(d) for p, d in zip(positions, devices)),
        tail_counts=tuple(int(tail_counts[p]) for p in positions),
        positions=tuple(positions),
        shard_rows=int(shard_rows),
        ann_rows=int(state.ann_rows),
    )


def retarget_tail(sivf: ShardedIVF, mesh: Mesh, axis: str,
                  tail_ids: np.ndarray, tail_count: int) -> ShardedIVF:
    """Re-partition only the tail (post-build appends land there); the
    bucket tables and centroids are kept as they are."""
    n_dev = mesh.shape[axis]
    tail_max = int(sivf.tail_ids[0].shape[0])
    tails, tail_counts = _partition_tail(np.asarray(tail_ids), tail_count, n_dev,
                                         sivf.shard_rows, tail_max)
    return sivf._replace(
        tail_ids=tuple(torch.from_numpy(tails[p]).to(t.device)
                       for p, t in zip(sivf.positions, sivf.tail_ids)),
        tail_counts=tuple(int(tail_counts[p]) for p in sivf.positions),
    )


def _shard_search(x_shard, scales_shard, sivf: ShardedIVF, i: int, qf, k: int,
                  nprobe: int, local_valid: int, dead) -> TopKResult:
    """One shard's part: the single-device searcher's candidate program
    over this shard's buckets and tail (B=1 per query, else the union)."""
    args = (sivf.centroids[i], sivf.bucket_ids[i], sivf.tail_ids[i], sivf.tail_counts[i],
            qf, local_valid, nprobe)
    if qf.shape[0] > 1:
        cand, valid, own = _probe_candidates_batched(*args)
        if dead is not None:
            valid = valid & (dead.reshape(-1)[torch.where(valid, cand, 0)] == 0)
        if scales_shard is not None:
            return _topk_over_union_int8(x_shard, scales_shard, qf, cand, valid, own, k)
        return _topk_over_union_float(x_shard, qf, cand, valid, own, k, local_valid, dead)
    cand, valid = _probe_candidates(*args)
    if dead is not None:
        valid = valid & (dead.reshape(-1)[torch.where(valid, cand, 0)] == 0)
    if scales_shard is not None:
        return _topk_over_candidates_int8(x_shard, scales_shard, qf, cand, valid, k)
    return _topk_over_candidates_float(x_shard, qf, cand, valid, k, local_valid, dead)


def sharded_ivf_topk(
    mesh: Mesh,
    x_sharded: ShardedRows,
    sivf: ShardedIVF,
    q: torch.Tensor,
    k: int,
    nprobe: int = 32,
    n_valid: int | None = None,
    deleted_sharded: ShardedRows | None = None,
    scales_sharded: ShardedRows | None = None,
) -> TopKResult:
    """Approximate merged top-k over a row-sharded corpus.

    ``x_sharded`` / ``scales_sharded`` / ``deleted_sharded`` are the shards
    ``sharded_search`` uses; the answer equals the single-device
    ``ops.ann.ivf_topk`` over the unsharded corpus with the same source
    ``IVFState``. The batch pads to a power of two from 1 and k runs at
    ``bucket_k`` (B=1 the per-query searcher, B>1 the batched union one);
    batches above the memory-derived program cap (``_max_program_b`` over
    the per-shard ``cap_local``) run as slices. Indices are int64 global
    row ids (-1 where a score is -inf)."""
    b = int(q.shape[0])
    n_live = int(x_sharded.shape[0]) if n_valid is None else int(n_valid)
    dev0 = x_sharded.shards[0].device
    if n_live == 0:
        return TopKResult(torch.full((b, 0), float("-inf"), device=dev0),
                          torch.zeros((b, 0), dtype=torch.int64, device=dev0))
    nlist, cap_local = (int(v) for v in sivf.bucket_ids[0].shape)
    nprobe = int(min(max(nprobe, 1), nlist))
    prog_b = _max_program_b(nlist, cap_local, int(x_sharded.shape[1]), nprobe,
                            x_sharded.shards[0].element_size())
    if b > prog_b:
        parts = [sharded_ivf_topk(mesh, x_sharded, sivf, q[s:s + prog_b], k, nprobe=nprobe,
                                  n_valid=n_valid, deleted_sharded=deleted_sharded,
                                  scales_sharded=scales_sharded)
                 for s in range(0, b, prog_b)]
        return TopKResult(torch.cat([p.scores for p in parts]),
                          torch.cat([p.indices for p in parts]))
    k = min(k, n_live)
    b_pad = _bucket_b_ann(b)
    k_run = min(bucket_k(k), n_live)
    sr = x_sharded.shard_rows
    results = []
    for i, shard in enumerate(x_sharded.shards):
        off = x_sharded.offset(i)
        qf = q.to(shard.device, torch.float32)
        if b_pad != b:
            qf = torch.cat([qf, qf.new_zeros((b_pad - b, qf.shape[1]))])
        local = _shard_search(
            shard, None if scales_sharded is None else scales_sharded.shards[i], sivf, i, qf,
            k_run, nprobe, _local_valid(n_live, off, sr),
            None if deleted_sharded is None else deleted_sharded.shards[i])
        gids = torch.where(torch.isfinite(local.scores), local.indices + off, -1)
        results.append((local.scores, gids))
    scores, ids = _merge(results, results[0][0].shape[1], k_run, b_pad, dev0, mesh)
    return TopKResult(scores[:b, :k], ids[:b, :k])


def build_ivf_sharded(
    x_sharded: ShardedRows,
    n_rows: int,
    scales_sharded: ShardedRows | None = None,
    **build_kwargs,
) -> tuple[IVFState, IVFBuildReport]:
    """``ops.ann.build_ivf`` over row shards (module docstring): the sample
    gathers onto the first shard's device in row order, each shard assigns
    its own live rows, the bucketing runs on the first device; across the
    ranks of a process group every rank calls this together."""
    spans = len(x_sharded.shards) != x_sharded.n_shards
    dev0 = x_sharded.shards[0].device
    sr = x_sharded.shard_rows
    n = int(n_rows)

    def scales(i: int):
        return None if scales_sharded is None else scales_sharded.shards[i]

    def sample_rows(idx: np.ndarray) -> torch.Tensor:
        parts = [torch.zeros((0, int(x_sharded.shape[1])), device=dev0)]
        for i, shard in enumerate(x_sharded.shards):
            off = x_sharded.offset(i)
            mine = idx[(idx >= off) & (idx < off + sr)] - off
            if mine.size:
                parts.append(_rows_f32(shard, scales(i), mine).to(dev0))
        rows = torch.cat(parts)
        return gather_ranks(rows) if spans else rows

    def assign(centroids: torch.Tensor, a_top: int):
        cs, ss = [], []
        for i, shard in enumerate(x_sharded.shards):
            c, s = _assign(shard, scales(i), centroids.to(shard.device),
                           _local_valid(n, x_sharded.offset(i), sr), a_top)
            cs.append(c.to(dev0))
            ss.append(s.to(dev0))
        c, s = torch.cat(cs), torch.cat(ss)
        return (gather_ranks(c), gather_ranks(s)) if spans else (c, s)

    return build_ivf_from(sample_rows, assign, n, int(x_sharded.shape[0]), dev0, **build_kwargs)
