"""IVF approximate search over the flat row buffer of the index.

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/ann.py``
with the same structure and the same answers (the JAX module is plain
``jnp`` by design: gathers, batched matrix products and sorts, no Pallas
kernel, so this one is torch operations on the caller's device):

- **Buckets hold row ids, not rows.** The searchable corpus stays the one
  flat ``(cap, d)`` buffer the exact search uses (``ops.topk`` /
  ``ops.quant``); the IVF adds a ``(nlist, bucket_cap)`` id table (-1 =
  empty slot), a ``(nlist, d)`` f32 centroid matrix and a small "tail" id
  list. Tombstones and ``n_valid`` mask ids as the exact search does.
- **The build runs on the device of the rows**: spherical k-means on a
  gathered sample, chunked assignment sweeps, and capacity bucketing by
  a lexicographic (cluster, -similarity, row) sort per spill round. Rows
  that overflow their nearest cluster spill to their 2nd..A-th nearest;
  the rare leftovers go to the tail, which also takes post-build appends.
  Every live row is in exactly one bucket slot or the tail, so probing all
  ``nlist`` clusters is exact.
- **Search** = probe selection ``q @ C^T`` + top-``nprobe``; candidate
  gather + scoring (phase A in f32 sums of storage-dtype products, phase B
  an f32 rescore of the selected 128-candidate blocks for float rows; the
  exact integer metric of ``ops.quant`` for int8 rows); chunk-max
  two-phase selection. B=1 runs the per-query searcher; B>1 the batched
  union searcher (the batch's probed buckets dedup into one shared
  candidate set, one gather, one product), whose per-query results equal
  B=1's (own-probe masking).

Every top-k and every sort with a tie goes lowest index first, as
``lax.top_k`` and the reference's sorts do (``ops.topk.
topk_lowest_index_first``): a probe tie changes which buckets are scanned.
The Lloyd step accumulates by ``index_put_(accumulate=True)`` in row order,
which is deterministic on a card (``index_add_`` there uses atomics), so
two builds from the same rows and seed are equal bit for bit. The float
scores use full-f32 products: ``torch.backends.cuda.matmul.allow_tf32``
must stay False (the default), as the reference's phase B is
``Precision.HIGHEST``.

Approximation contract: results are exact within the probed candidate
set; recall is set by ``nprobe`` / ``nlist`` and measured per corpus
(``UnifiedIndex.tune_nprobe``).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from .quant import _quantize_q
from .topk import TopKResult, bucket_k, topk_lowest_index_first

__all__ = [
    "IVFState",
    "IVFBuildReport",
    "build_ivf",
    "build_ivf_from",
    "ivf_topk",
    "tail_append",
    "default_nlist",
    "TAIL_MAX",
]

# Dynamic tail capacity: spill leftovers + post-build appends live here and
# are always scanned (shared across the batch). When appends outgrow it the
# caller rebuilds (UnifiedIndex serves dense until then).
TAIL_MAX = 8192
# Selection chunk for the search's two-phase top-k (ops.topk.CHUNK).
_SEL_CHUNK = 128
# Max in-program query batch (the effective bound is also memory-derived,
# see _max_program_b); larger batches run as slices.
_MAX_PROGRAM_B = 16
# Budget for the batched searcher's union candidate gather, in storage bytes
# (min(B*nprobe, nlist) * cap * d * dtype bytes). The value was sized for a
# 16 GB accelerator next to a 7.7 GB 10M int8 corpus; the f32 products here
# widen the gathered rows block by block (_SCORE_ELEMS), so the transient
# beyond the gather stays bounded.
_GATHER_BUDGET = int(os.environ.get("IVARS_ANN_GATHER_BUDGET", 1_600_000_000))
# Row chunk of the build's assignment sweeps: bounds the (chunk, nlist) f32
# score block.
_ASSIGN_CHUNK = 16_384
# f32 elements of gathered candidate rows widened per scoring step (256 MB)
_SCORE_ELEMS = 1 << 26


class IVFState(NamedTuple):
    """IVF structure over an external flat row buffer, on its device."""

    centroids: torch.Tensor    # (nlist, d) f32, unit-norm
    bucket_ids: torch.Tensor   # (nlist, bucket_cap) int32 row ids, -1 = empty
    tail_ids: torch.Tensor     # (TAIL_MAX,) int32 row ids, -1 = empty
    tail_count: int            # live tail entries (host: the search never syncs)
    ann_rows: int              # corpus rows the buckets cover (rows past it must
                               # be tail-appended or trigger a rebuild)


class IVFBuildReport(NamedTuple):
    nlist: int
    bucket_cap: int
    leftover: int              # rows that fell through to the tail
    kmeans_iters: int
    sample_rows: int


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _max_program_b(nlist: int, cap: int, d: int, nprobe: int, row_bytes: int) -> int:
    """Largest power-of-two in-program batch whose union candidate gather
    (min(B*nprobe, nlist) * cap * d * row_bytes) fits ``_GATHER_BUDGET``
    (never above ``_MAX_PROGRAM_B``)."""
    b = 1
    while b < _MAX_PROGRAM_B:
        nxt = b * 2
        if min(nxt * nprobe, nlist) * cap * d * row_bytes > _GATHER_BUDGET:
            break
        b = nxt
    return b


def _bucket_b_ann(b: int) -> int:
    """Power-of-two query-batch bucket from 1 (not ``ops.topk.bucket_b``,
    whose floor is 8: the candidate gather is per query, so padding one
    query to 8 would pull 8x the candidate bytes)."""
    return 1 << (max(b, 1) - 1).bit_length()


def default_nlist(n_rows: int) -> int:
    """~4*sqrt(N) rounded to a power of two, clamped to [64, 16384]."""
    if n_rows <= 0:
        return 64
    target = 4.0 * float(n_rows) ** 0.5
    p = 1 << max(6, int(round(np.log2(max(target, 64.0)))))
    return int(min(max(p, 64), 16384))


# ---------------------------------------------------------------------------
# Build: spherical k-means + capacity bucketing, on the rows' device
# ---------------------------------------------------------------------------


def _rows_f32(x: torch.Tensor, x_scales: torch.Tensor | None, ids) -> torch.Tensor:
    """x[ids] as f32 rows (dequantized for int8 corpora)."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=x.device)
    rows = x[ids].float()
    if x_scales is not None:
        rows = rows * x_scales.reshape(-1)[ids][:, None]
    return rows


def _topk_low(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_lowest_index_first` at ``torch.topk``'s cost where the
    top ``k + 1`` scores of a row hold no tie (a row with one takes the
    stable sort). One host read per call: the build's, never the search's."""
    if s.shape[1] <= k:
        return topk_lowest_index_first(s, k)
    vals, idx = torch.topk(s, k + 1, dim=1)
    tied = (vals[:, 1:] == vals[:, :-1]).any(dim=1)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].contiguous()
    if bool(tied.any()):
        rows = torch.nonzero(tied).reshape(-1)
        vals[rows], idx[rows] = topk_lowest_index_first(s[rows], k)
    return vals, idx


def _kmeans_step(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd step over the sample: assign, then accumulate rows and
    counts per cluster, each cluster's sum in row order as the reference's
    scatter-add sums. On a card ``index_put_(accumulate=True)`` does that
    (a stable sort of the ids, then each run in order; ``index_add_``
    there uses atomics); on the CPU ``index_add_`` does (``index_put_``
    there splits the rows over threads)."""
    assign = torch.argmax(x @ centroids.T, dim=1)
    if x.device.type == "cpu":
        acc = torch.zeros_like(centroids).index_add_(0, assign, x)
    else:
        acc = torch.zeros_like(centroids).index_put_((assign,), x, accumulate=True)
    counts = torch.bincount(assign, minlength=centroids.shape[0])
    return acc, counts


def _kmeans_finish(acc, counts, reseed_rows) -> torch.Tensor:
    """Mean + re-normalize, empty clusters re-seeded from the given rows."""
    empty = (counts == 0)[:, None]
    mean = torch.where(empty, reseed_rows, acc / torch.clamp(counts, min=1)[:, None])
    norms = torch.clamp(torch.sqrt(torch.sum(mean * mean, dim=1, keepdim=True)), min=1e-12)
    return mean / norms


def _spherical_kmeans(sample: torch.Tensor, nlist: int, iters: int, seed: int) -> torch.Tensor:
    """Unit-norm centroids by Lloyd's on the unit sphere over a (S, d) f32
    sample of unit rows; empty clusters re-seed from random sample rows
    (numpy draws, identical to the reference's)."""
    rng = np.random.default_rng(seed)
    n = int(sample.shape[0])
    init = rng.choice(n, size=nlist, replace=n < nlist)
    centroids = sample[torch.as_tensor(init, device=sample.device)]
    for _ in range(max(iters, 1)):
        acc, counts = _kmeans_step(sample, centroids)
        reseed = sample[torch.as_tensor(rng.choice(n, size=nlist), device=sample.device)]
        centroids = _kmeans_finish(acc, counts, reseed)
    return centroids


def _assign(x, x_scales, centroids, n_rows: int, a_top: int):
    """Top-``a_top`` nearest centroids (ids, similarities) of every row,
    chunk by chunk over the corpus."""
    n_pad = int(x.shape[0])
    choice_c = torch.zeros((n_pad, a_top), dtype=torch.int64, device=x.device)
    choice_s = torch.zeros((n_pad, a_top), dtype=torch.float32, device=x.device)
    xs = None if x_scales is None else x_scales.reshape(-1)
    for s in range(0, n_rows, _ASSIGN_CHUNK):
        e = min(s + _ASSIGN_CHUNK, n_rows)
        chunk = x[s:e].float()
        if xs is not None:
            chunk = chunk * xs[s:e, None]
        sims, ids = _topk_low(chunk @ centroids.T, a_top)
        choice_c[s:e], choice_s[s:e] = ids, sims
    return choice_c, choice_s


def _bucket_pass(bucket_flat, placed, fill, choice_c, choice_s, n_rows: int,
                 nlist: int, cap: int):
    """One spill round of capacity bucketing: this round's unplaced rows
    sort by (cluster, -similarity, row) (stable sorts, last key first), and
    within each cluster's segment the first ``cap - fill`` rows take slots
    (the rows most similar to the centroid stay in their home bucket)."""
    n_pad = choice_c.shape[0]
    dev = choice_c.device
    row = torch.arange(n_pad, device=dev)
    active = (~placed) & (row < n_rows)
    c_key = torch.where(active, choice_c, nlist)
    neg_s = torch.where(active, -choice_s, float("inf"))
    order = torch.argsort(neg_s, stable=True)
    order = order[torch.argsort(c_key[order], stable=True)]
    c_sorted = c_key[order]
    seg_start = torch.searchsorted(c_sorted, torch.arange(nlist, device=dev))
    in_active = c_sorted < nlist
    c_safe = torch.clamp(c_sorted, max=nlist - 1)
    pos = row - seg_start[c_safe]
    slot = fill[c_safe] + pos
    ok = in_active & (slot < cap)
    flat = torch.where(ok, c_safe * cap + slot, nlist * cap)      # dump slot
    bucket_flat[flat] = torch.where(ok, order, -1).to(torch.int32)
    took = torch.zeros_like(placed)
    took[order] = ok
    placed = placed | took
    fill = fill + torch.bincount(c_safe[ok], minlength=nlist)
    return bucket_flat, placed, fill


def _leftovers(placed: torch.Tensor, n_rows: int, tail_max: int) -> tuple[torch.Tensor, int]:
    """Unplaced live rows, ascending, in a (tail_max,) id list, and their count."""
    active = ~placed[:n_rows]
    rows = torch.nonzero(active).reshape(-1)
    count = int(rows.shape[0])
    ids = torch.full((tail_max,), -1, dtype=torch.int32, device=placed.device)
    m = min(count, tail_max)
    ids[:m] = rows[:m].to(torch.int32)
    return ids, count


def build_ivf(
    x: torch.Tensor,
    n_rows: int | None = None,
    x_scales: torch.Tensor | None = None,
    nlist: int | None = None,
    bucket_cap: int | None = None,
    cap_factor: float = 1.5,
    spill_rounds: int = 4,
    kmeans_iters: int = 10,
    sample_per_list: int = 128,
    seed: int = 0,
) -> tuple[IVFState, IVFBuildReport]:
    """Build the IVF structure over the flat row buffer ``x``, on its device.

    ``x`` is the same tensor the dense search paths use: (cap, d) float rows
    (bf16/f32, L2-normalized) or int8 rows with ``x_scales`` (norm folded
    into the scale, as ``index.unified`` stores them). ``n_rows`` = live
    rows (defaults to all). Only O(nlist) scalars reach the host.
    """
    n_pad_src = int(x.shape[0])
    n = n_pad_src if n_rows is None else int(n_rows)
    assert 0 < n <= n_pad_src, f"n_rows {n} out of range"
    return build_ivf_from(lambda idx: _rows_f32(x, x_scales, idx),
                          lambda c, a_top: _assign(x, x_scales, c, n, a_top),
                          n, n_pad_src, x.device, nlist=nlist, bucket_cap=bucket_cap,
                          cap_factor=cap_factor, spill_rounds=spill_rounds,
                          kmeans_iters=kmeans_iters, sample_per_list=sample_per_list,
                          seed=seed)


def build_ivf_from(
    sample_rows: Callable[[np.ndarray], torch.Tensor],
    assign: Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]],
    n: int,
    n_pad_src: int,
    device: torch.device,
    nlist: int | None = None,
    bucket_cap: int | None = None,
    cap_factor: float = 1.5,
    spill_rounds: int = 4,
    kmeans_iters: int = 10,
    sample_per_list: int = 128,
    seed: int = 0,
) -> tuple[IVFState, IVFBuildReport]:
    """:func:`build_ivf` over rows reached through two callables:
    ``sample_rows(ids)`` gives the f32 rows of the sorted ids on ``device``
    (k-means runs there) and ``assign(centroids, a_top)`` the top-``a_top``
    centroid ids and similarities of every row, ``(n_pad_src, a_top)`` on
    ``device``. The bucketing runs on ``device``. ``parallel.sharded_ann``
    builds over row shards this way."""
    if nlist is None:
        nlist = default_nlist(n)
    nlist = int(min(nlist, max(64, n)))
    if bucket_cap is None:
        bucket_cap = _ceil_to(max(int(cap_factor * n / nlist), _SEL_CHUNK), _SEL_CHUNK)
    assert bucket_cap % _SEL_CHUNK == 0

    # --- k-means on a gathered subsample -----------------------------------
    sample_n = int(min(n, max(sample_per_list * nlist, 4096)))
    rng = np.random.default_rng(seed)
    idx = (np.arange(n) if sample_n >= n
           else np.sort(rng.choice(n, size=sample_n, replace=False)))
    sample = sample_rows(idx)
    centroids = _spherical_kmeans(sample, nlist, kmeans_iters, seed)
    del sample

    # --- full-corpus top-A assignment (chunked sweeps) ----------------------
    a_top = int(min(spill_rounds, nlist))
    choice_c, choice_s = assign(centroids, a_top)

    # --- capacity bucketing with spill (sort passes) ------------------------
    def _bucket(cap: int):
        bucket_flat = torch.full((nlist * cap + 1,), -1, dtype=torch.int32, device=device)
        placed = torch.zeros((n_pad_src,), dtype=torch.bool, device=device)
        fill = torch.zeros((nlist,), dtype=torch.int64, device=device)
        for a in range(a_top):
            bucket_flat, placed, fill = _bucket_pass(
                bucket_flat, placed, fill, choice_c[:, a], choice_s[:, a], n, nlist, cap)
        tail_ids, count = _leftovers(placed, n, TAIL_MAX)
        return bucket_flat, tail_ids, count

    bucket_flat, tail_ids, leftover = _bucket(bucket_cap)
    if leftover > TAIL_MAX:
        # capacity too tight for this distribution: widen and re-bucket
        bucket_cap = _ceil_to(bucket_cap * 2, _SEL_CHUNK)
        bucket_flat, tail_ids, leftover = _bucket(bucket_cap)
        if leftover > TAIL_MAX:
            raise ValueError(f"{leftover} leftover rows exceed tail capacity even at "
                             f"bucket_cap={bucket_cap}; raise cap_factor")

    state = IVFState(
        centroids=centroids,
        bucket_ids=bucket_flat[:-1].reshape(nlist, bucket_cap),
        tail_ids=tail_ids,
        tail_count=min(leftover, TAIL_MAX),
        ann_rows=n,
    )
    report = IVFBuildReport(nlist=nlist, bucket_cap=bucket_cap, leftover=leftover,
                            kmeans_iters=kmeans_iters, sample_rows=sample_n)
    return state, report


def tail_append(state: IVFState, row_ids) -> IVFState:
    """Register appended corpus rows in the always-scanned tail.

    Returns the updated state (the given one is unchanged), or raises
    ``OverflowError`` when the tail is full (the caller rebuilds, serving
    dense search meanwhile)."""
    ids = np.asarray(row_ids, np.int32).reshape(-1)
    if ids.size == 0:
        return state
    count = int(state.tail_count)
    if count + ids.size > TAIL_MAX:
        raise OverflowError(f"IVF tail full ({count}+{ids.size} > {TAIL_MAX}); rebuild")
    tail = state.tail_ids.clone()
    tail[count:count + ids.size] = torch.from_numpy(ids).to(tail.device)
    return state._replace(tail_ids=tail, tail_count=count + int(ids.size),
                          ann_rows=max(state.ann_rows, int(ids.max()) + 1))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _select_blocks(scores: torch.Tensor, cand: torch.Tensor, k: int):
    """Chunk-max block selection over (B, n_cand) scores. Returns the
    winning blocks' selection scores (B, kc*CH), their candidate ids, and
    their flat positions into the (B, n_cand) input: a caller that rescores
    must gather every phase-A mask (the union searcher's ``own``) through
    those positions, or rows masked out of selection re-enter at rescore.

    Exactness: every true top-k element lives in some 128-chunk; the top-k
    chunks by max contain all of them, so a top-k over the selected blocks
    is exact."""
    b_pad, n_cand = scores.shape
    assert n_cand % _SEL_CHUNK == 0
    num_chunks = n_cand // _SEL_CHUNK
    k_chunks = min(k, num_chunks)
    cm = scores.reshape(b_pad, num_chunks, _SEL_CHUNK).amax(dim=2)
    _, cid = topk_lowest_index_first(cm, k_chunks)                    # (B, kc)
    flat_pos = (cid[:, :, None] * _SEL_CHUNK
                + torch.arange(_SEL_CHUNK, device=scores.device)[None, None, :]
                ).reshape(b_pad, k_chunks * _SEL_CHUNK)
    flat = torch.gather(scores, 1, flat_pos)
    block_cand = torch.gather(cand, 1, flat_pos)
    return flat, block_cand, flat_pos


def _products(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``q[b] . f32(x[ids[b, c]])`` for (B, C) ids, or ``q[b] . f32(x[ids[c]])``
    for shared (C,) ids: f32 sums of products of the f32 values of the rows,
    widened a block of candidates at a time (bounds the f32 transient)."""
    shared = ids.dim() == 1
    c = ids.shape[-1]
    out = torch.empty((q.shape[0], c), dtype=torch.float32, device=q.device)
    step = max(_SEL_CHUNK, _SCORE_ELEMS // max(x.shape[1] * (1 if shared else q.shape[0]), 1))
    for s in range(0, c, step):
        e = min(s + step, c)
        if shared:
            out[:, s:e] = q @ x[ids[s:e]].float().T
        else:
            out[:, s:e] = torch.einsum("bd,bcd->bc", q, x[ids[:, s:e]].float())
    return out


def _probe_candidates(centroids, bucket_ids, tail_ids, tail_count: int, qf, n_valid: int,
                      nprobe: int):
    """Probe selection + per-query candidate ids (B, nprobe*cap + tail) and
    their range mask."""
    b_pad = qf.shape[0]
    cap = bucket_ids.shape[1]
    tail_max = tail_ids.shape[0]
    _, probes = topk_lowest_index_first(qf @ centroids.T, nprobe)   # (B, nprobe)
    cand = bucket_ids[probes].reshape(b_pad, nprobe * cap)
    tids = torch.where(torch.arange(tail_max, device=qf.device) < tail_count, tail_ids, -1)
    cand = torch.cat([cand, tids[None].expand(b_pad, tail_max)], dim=1).long()
    valid = (cand >= 0) & (cand < n_valid)
    return cand, valid


def _top(scores: torch.Tensor, block_cand: torch.Tensor, k: int) -> TopKResult:
    top_s, pos = topk_lowest_index_first(scores, min(k, scores.shape[1]))
    return TopKResult(top_s, torch.gather(block_cand, 1, pos))


def _topk_over_candidates_int8(x_i8, x_scales, qf, cand, valid, k: int) -> TopKResult:
    """Exact int8-metric top-k over explicit candidate ids; ``valid``
    includes range and tombstone checks. The integer dot is exact in f32
    (every partial sum is an integer below 2^24), so scores equal the dense
    int8 metric (``ops.quant``) bit for bit."""
    safe = torch.where(valid, cand, 0)
    q_i8, q_scales = _quantize_q(qf)
    int_dot = _products(q_i8.float(), x_i8, safe)                     # (B, n_cand)
    scores = int_dot * x_scales.reshape(-1)[safe] * q_scales[:, None]
    scores = scores.masked_fill(~valid, float("-inf"))
    flat, block_cand, _ = _select_blocks(scores, cand, k)
    return _top(flat, block_cand, k)


def _rescore_blocks(x, qf, block_cand, bvalid, deleted, k: int) -> TopKResult:
    """Phase B: an f32 rescore of the selected blocks, masked, then top-k."""
    bsafe = torch.where(bvalid, block_cand, 0)
    if deleted is not None:
        bvalid = bvalid & (deleted.reshape(-1)[bsafe] == 0)
    rescored = _products(qf, x, bsafe).masked_fill(~bvalid, float("-inf"))
    return _top(rescored, block_cand, k)


def _topk_over_candidates_float(x, qf, cand, valid, k: int, n_valid: int, deleted):
    """Two-phase float top-k over explicit candidate ids. Phase A scores in
    f32 sums of products of the storage-dtype rows and the query rounded to
    the storage dtype; phase B rescores the selected blocks in f32 with the
    f32 query. ``valid`` is the phase-A mask; ``n_valid``/``deleted``
    re-derive it for phase B (every candidate of a query's row came from
    its own probes)."""
    safe = torch.where(valid, cand, 0)
    approx = _products(qf.to(x.dtype).float(), x, safe).masked_fill(~valid, float("-inf"))
    _, block_cand, _ = _select_blocks(approx, cand, k)
    bvalid = (block_cand >= 0) & (block_cand < n_valid)
    return _rescore_blocks(x, qf, block_cand, bvalid, deleted, k)


def _dedup_probes(probes: torch.Tensor, nlist: int, u_slots: int) -> torch.Tensor:
    """Union-dedup the batch's probed bucket ids into ``u_slots`` static
    slots (sentinel ``nlist`` marks empty/duplicate slots): sort the flat
    probe ids and mark duplicates by neighbour equality, then a stable sort
    by (is_dup, id) compacts the unique ids to the front. ``u_slots =
    min(B*nprobe, nlist)`` bounds the unique count."""
    ids_sorted = torch.sort(probes.reshape(-1)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int64, device=probes.device),
                     (ids_sorted[1:] == ids_sorted[:-1]).long()])
    order = torch.argsort(dup, stable=True)
    dup_s, ids_unique_first = dup[order], ids_sorted[order]
    return torch.where(dup_s[:u_slots] == 0, ids_unique_first[:u_slots], nlist)


def _probe_candidates_batched(centroids, bucket_ids, tail_ids, tail_count: int, qf,
                              n_valid: int, nprobe: int):
    """Union probe selection. Returns ``(cand, valid, own)``: the shared
    (n_cand,) candidate ids (the batch's probed buckets, deduped into static
    slots, then the tail), their range mask, and the (B, n_cand) per-query
    own-probe membership that restores B=1's candidate sets."""
    b_pad = qf.shape[0]
    nlist, cap = bucket_ids.shape
    tail_max = tail_ids.shape[0]
    dev = qf.device
    u_slots = min(b_pad * nprobe, nlist)
    _, probes = topk_lowest_index_first(qf @ centroids.T, nprobe)   # (B, nprobe)
    u_ids = _dedup_probes(probes, nlist, u_slots)                     # (u_slots,)
    u_safe = torch.clamp(u_ids, max=nlist - 1)
    bids = torch.where((u_ids < nlist)[:, None], bucket_ids[u_safe], -1)
    tids = torch.where(torch.arange(tail_max, device=dev) < tail_count, tail_ids, -1)
    cand = torch.cat([bids.reshape(-1), tids]).long()
    valid = (cand >= 0) & (cand < n_valid)
    own_u = (probes[:, :, None] == u_ids[None, None, :]).any(dim=1)  # (B, u_slots)
    own = torch.cat([own_u[:, :, None].expand(b_pad, u_slots, cap).reshape(b_pad, -1),
                     torch.ones((b_pad, tail_max), dtype=torch.bool, device=dev)], dim=1)
    return cand, valid, own


def _topk_over_union_int8(x_i8, x_scales, qf, cand, valid, own, k: int) -> TopKResult:
    """int8-metric top-k over the shared union candidate set: one product of
    the (B, d) queries with the union rows; ``own`` masks each query down to
    its own probed buckets before selection."""
    safe = torch.where(valid, cand, 0)
    q_i8, q_scales = _quantize_q(qf)
    int_dot = _products(q_i8.float(), x_i8, safe)                     # (B, n_cand)
    scores = int_dot * x_scales.reshape(-1)[safe][None, :] * q_scales[:, None]
    scores = scores.masked_fill(~(valid[None, :] & own), float("-inf"))
    flat, block_cand, _ = _select_blocks(scores, cand[None].expand_as(scores), k)
    return _top(flat, block_cand, k)


def _topk_over_union_float(x, qf, cand, valid, own, k: int, n_valid: int, deleted):
    """Two-phase float top-k over the shared union candidate set (phase A:
    one product over the union rows; phase B as the per-query searcher)."""
    safe = torch.where(valid, cand, 0)
    approx = _products(qf.to(x.dtype).float(), x, safe)
    approx = approx.masked_fill(~(valid[None, :] & own), float("-inf"))
    _, block_cand, flat_pos = _select_blocks(approx, cand[None].expand_as(approx), k)
    # phase B carries every phase-A mask: own-probe membership does not
    # re-derive from the ids (selected chunks can straddle buckets, and -inf
    # filler chunks hold other queries' rows), so it is gathered
    bown = torch.gather(own, 1, flat_pos)
    bvalid = (block_cand >= 0) & (block_cand < n_valid) & bown
    return _rescore_blocks(x, qf, block_cand, bvalid, deleted, k)


def _search(x, x_scales, state: IVFState, qf, k: int, nprobe: int, n_valid: int, deleted):
    """One program: per-query (B=1) or batched union searcher."""
    args = (state.centroids, state.bucket_ids, state.tail_ids, state.tail_count, qf, n_valid,
            nprobe)
    if qf.shape[0] == 1:
        cand, valid = _probe_candidates(*args)
        if deleted is not None:
            valid = valid & (deleted.reshape(-1)[torch.where(valid, cand, 0)] == 0)
        if x_scales is not None:
            return _topk_over_candidates_int8(x, x_scales, qf, cand, valid, k)
        return _topk_over_candidates_float(x, qf, cand, valid, k, n_valid, deleted)
    cand, valid, own = _probe_candidates_batched(*args)
    if deleted is not None:
        valid = valid & (deleted.reshape(-1)[torch.where(valid, cand, 0)] == 0)
    if x_scales is not None:
        return _topk_over_union_int8(x, x_scales, qf, cand, valid, own, k)
    return _topk_over_union_float(x, qf, cand, valid, own, k, n_valid, deleted)


def ivf_topk(
    x: torch.Tensor,
    state: IVFState,
    q: torch.Tensor,
    k: int,
    nprobe: int = 32,
    n_valid: int | None = None,
    deleted: torch.Tensor | None = None,
    x_scales: torch.Tensor | None = None,
) -> TopKResult:
    """Approximate top-k via IVF probing over the flat row buffer ``x``.

    ``x`` / ``x_scales`` / ``deleted`` are the same tensors the dense path
    uses (``ops.topk.topk_search`` / ``ops.quant.topk_search_int8``); pass
    ``x_scales`` for int8 corpora. ``nprobe == nlist`` probes every bucket
    and (with the always-scanned tail) is exact. The batch pads to a power
    of two from 1 and k runs at ``ops.topk.bucket_k``, as the reference's
    compiled programs do; B=1 runs the per-query searcher, B>1 the batched
    union searcher (per-query results equal B=1's). Batches above the
    memory-derived program cap run as slices. Indices are int64.
    ``ivf_topk.calls`` counts the searcher runs.
    """
    b = int(q.shape[0])
    n_live = int(x.shape[0]) if n_valid is None else int(n_valid)
    if n_live == 0:
        return TopKResult(torch.full((b, 0), float("-inf"), device=x.device),
                          torch.zeros((b, 0), dtype=torch.int64, device=x.device))
    nlist, cap = int(state.bucket_ids.shape[0]), int(state.bucket_ids.shape[1])
    nprobe = int(min(max(nprobe, 1), nlist))
    prog_b = _max_program_b(nlist, cap, int(x.shape[1]), nprobe, x.element_size())
    if b > prog_b:
        parts = [ivf_topk(x, state, q[s:s + prog_b], k, nprobe=nprobe, n_valid=n_valid,
                          deleted=deleted, x_scales=x_scales)
                 for s in range(0, b, prog_b)]
        return TopKResult(torch.cat([p.scores for p in parts]),
                          torch.cat([p.indices for p in parts]))
    k = min(k, n_live)
    b_pad = _bucket_b_ann(b)
    qf = q.to(x.device, torch.float32)
    if b_pad != b:
        qf = torch.cat([qf, qf.new_zeros((b_pad - b, qf.shape[1]))])
    k_run = min(bucket_k(k), n_live)
    res = _search(x, x_scales, state, qf, k_run, nprobe, n_live, deleted)
    ivf_topk.calls += 1
    return TopKResult(res.scores[:b, :k], res.indices[:b, :k])


ivf_topk.calls = 0
