"""Exact top-k inner-product search: chunk-max sweep + candidate rescore.

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/topk.py``
with the same two-phase contract:

1. **Chunk-max sweep (kernel B1, ``csrc/chunk_max.cu``).** Score every row
   of the database ``X (N_pad, D)`` against the queries and keep only the
   maximum of each ``CHUNK``-row group: an ``(N_pad/CHUNK, B)`` f32 matrix.
   The full ``(N, B)`` score matrix never reaches device memory. Rows at or
   past the runtime ``n_valid`` and tombstoned rows are -inf BEFORE the
   maximum, so a dead row never lifts its chunk.
2. **Candidate rescore (plain torch).** Take the top-``k`` chunks per
   query; their union provably holds the exact top-``k`` (fewer than ``k``
   scores exceed the k-th, so at most ``k-1`` chunks beat the chunk that
   holds it). Gather those ``k*CHUNK`` rows, rescore in f32, top-k.

The search runs at ``bucket_k(k)`` and slices the exact prefix, and the
query batch pads to ``bucket_b(B)``, as in the reference.

Dispatch depends only on where the tensors live: on the CPU the sweep runs
its plain torch version (:func:`chunk_max_plain`); on a CUDA device it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernels

__all__ = [
    "TopKResult",
    "CHUNK",
    "TILE_N",
    "pad_database",
    "bucket_b",
    "bucket_k",
    "pad_queries",
    "topk_search",
    "topk_exact_reference",
    "topk_masked_reference",
    "cosine_topk",
    "chunk_max_sweep",
    "chunk_max_plain",
    "chunk_max_plan",
    "topk_lowest_index_first",
]

# rows reduced to one max per query; bounds the rescore at k*128 rows
CHUNK = 128
# database rows are padded to a multiple of this at upload
TILE_N = 2048
# query rows pad to at least this many
_Q_PAD = 8
# rows scored per step by the plain sweep (bounds its f32 temporaries)
_PLAIN_ROWS = 131_072


class TopKResult(NamedTuple):
    scores: torch.Tensor   # (B, k) f32, descending
    indices: torch.Tensor  # (B, k) int64 row ids into the database


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_database(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad rows to a multiple of TILE_N (done once at index load)."""
    n = x.shape[0]
    n_pad = _ceil_to(max(n, TILE_N), TILE_N)
    if n_pad == n:
        return x
    return torch.cat([x, x.new_zeros((n_pad - n, x.shape[1]))], dim=0)


def bucket_b(b: int) -> int:
    """Query-batch bucket: next power of two in [8, 128], then multiples
    of 32 (the reference's ``bucket_b``)."""
    if b <= _Q_PAD:
        return _Q_PAD
    if b > 128:
        return _ceil_to(b, 32)
    return 1 << (b - 1).bit_length()


def bucket_k(k: int) -> int:
    """k bucket: next power of two >= max(k, 8). The search runs at the
    bucketed k and slices; the top-k prefix of a top-k_run is exact."""
    return 1 << (max(k, 8) - 1).bit_length()


def pad_queries(q: torch.Tensor) -> torch.Tensor:
    b = q.shape[0]
    b_pad = bucket_b(b)
    if b_pad == b:
        return q
    return torch.cat([q, q.new_zeros((b_pad - b, q.shape[1]))], dim=0)


def topk_lowest_index_first(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, equal scores in ascending index order
    (the order ``lax.top_k`` returns; ``torch.topk`` leaves it unspecified):
    a stable descending sort, cut at ``k``."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Phase 1: kernel B1 and its plain version
# ---------------------------------------------------------------------------


def _dead_flat(deleted: torch.Tensor | None, n_pad: int) -> torch.Tensor | None:
    """(N,) or (N_pad, 1) tombstones -> contiguous (N_pad,) int8."""
    if deleted is None:
        return None
    dead = deleted.reshape(-1).to(torch.int8)
    if dead.shape[0] < n_pad:
        dead = torch.cat([dead, dead.new_zeros(n_pad - dead.shape[0])])
    return dead[:n_pad].contiguous()


def chunk_max_plain(
    x: torch.Tensor, q: torch.Tensor, n_valid: int,
    deleted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch chunk-max: (N_pad/CHUNK, B) f32. The kernel's oracle."""
    n_pad = x.shape[0]
    dead = _dead_flat(deleted, n_pad)
    qf = q.float()
    out = torch.empty((n_pad // CHUNK, q.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, n_pad, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, n_pad)
        scores = x[s:e].float() @ qf.T                       # (rows, B) f32
        row = torch.arange(s, e, device=x.device)
        alive = row < n_valid
        if dead is not None:
            alive &= dead[s:e] == 0
        scores = scores.masked_fill(~alive[:, None], float("-inf"))
        out[s // CHUNK:e // CHUNK] = scores.reshape(-1, CHUNK, q.shape[0]).amax(1)
    return out


# kernel B1's bf16 launch (csrc/chunk_max.cu `plan_bf16`, which computes the
# same): a ring of stages of 128 rows x 64 columns, the query group staged
# for the block's life, shared memory per block and per multiprocessor
_STAGE_BYTES = CHUNK * 64 * 2
_MAX_STAGES, _MIN_STAGES = 8, 2
_SMEM_BLOCK, _SMEM_SM = 232_448, 233_472
_CONSUMER_WARPS = 8


def chunk_max_plan(n_pad: int, d: int, b_pad: int, sm_count: int = 132) -> dict:
    """How kernel B1 sweeps ``n_pad`` bf16 rows of width ``d`` for ``b_pad``
    queries on a card of ``sm_count`` multiprocessors (the C entry point asks
    the device; 132 is an H100's): the query ``group`` each block stages in
    shared memory once (the largest of 64, 32, 16, 8 dividing ``b_pad`` that
    leaves room for two ring stages), ``groups`` = sweeps of the rows, ring
    ``stages`` of 16 KB, ``blocks_per_sm`` (two where each still gets four
    stages), ``blocks`` along the chunks per group and ``smem_bytes`` of
    dynamic shared memory per block. Raises ValueError where ``d`` is too
    wide for any group."""
    if n_pad <= 0 or n_pad % CHUNK or d <= 0 or d % 8 or b_pad <= 0 or b_pad % 8 \
            or sm_count <= 0:
        raise ValueError(f"chunk_max_plan: n_pad={n_pad}, d={d}, b_pad={b_pad}, "
                         f"sm_count={sm_count}")
    n_kb = -(-d // 64)

    def fixed(group: int) -> int:
        # alignment slack, query tiles, two buffers of the warps' maxima, barriers
        return 1024 + n_kb * group * 128 + 2 * _CONSUMER_WARPS * group * 4 + 256

    group = next((g for g in (64, 32, 16, 8)
                  if b_pad % g == 0 and fixed(g) + _MIN_STAGES * _STAGE_BYTES <= _SMEM_BLOCK),
                 None)
    if group is None:
        raise ValueError(f"chunk_max_plan: rows of {d} are too wide for kernel B1's "
                         "shared memory")
    fit2 = max(0, (_SMEM_SM // 2 - 1024 - fixed(group)) // _STAGE_BYTES)
    per_sm = 2 if fit2 >= 4 else 1
    stages = min(_MAX_STAGES, fit2 if per_sm == 2 else (_SMEM_BLOCK - fixed(group)) // _STAGE_BYTES)
    groups = b_pad // group
    blocks = min(n_pad // CHUNK, max(1, -(-(sm_count * per_sm) // groups)))
    return {"group": group, "groups": groups, "stages": stages, "blocks_per_sm": per_sm,
            "blocks": blocks, "smem_bytes": fixed(group) + stages * _STAGE_BYTES}


def chunk_max_sweep(
    x: torch.Tensor, q: torch.Tensor, n_valid: int,
    deleted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Phase-1 maxima, (N_pad/CHUNK, B) f32, for rows ``x`` padded to a
    TILE_N multiple and queries ``q`` of the same dtype.

    CPU tensors take :func:`chunk_max_plain`. CUDA tensors launch kernel B1
    (``csrc/chunk_max.cu``; bf16 as :func:`chunk_max_plan` says) on
    PyTorch's current stream; the count of those launches is
    ``chunk_max_sweep.launches``.
    """
    n_pad, d = x.shape
    if n_pad % TILE_N != 0:
        raise ValueError(f"x rows {n_pad} not a TILE_N={TILE_N} multiple")
    if q.dtype != x.dtype or q.shape[1] != d:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    b = q.shape[0]
    if x.device.type == "cpu":
        return chunk_max_plain(x, q, n_valid, deleted)
    if x.device.type != "cuda" or q.device != x.device:
        raise ValueError(f"chunk_max_sweep: x on {x.device}, q on {q.device}")
    codes = {torch.bfloat16: 0, torch.float32: 1}
    if x.dtype not in codes:
        raise TypeError(f"chunk_max_sweep: unsupported dtype {x.dtype}")
    if (d * x.element_size()) % 16 != 0:
        raise ValueError(f"chunk_max_sweep: row of {d} x {x.dtype} is not a "
                         "multiple of 16 bytes")
    x = x.contiguous()
    if x.data_ptr() % 16 != 0:
        raise ValueError("chunk_max_sweep: x is not 16-byte aligned")
    q_p = pad_queries(q).contiguous()
    if x.dtype == torch.bfloat16:
        chunk_max_plan(n_pad, d, q_p.shape[0])   # raises where d does not fit
    if q_p.data_ptr() % 16 != 0:  # a view at an odd offset: a fresh copy aligns
        q_p = q_p.clone()
    dead = _dead_flat(deleted, n_pad)
    if dead is not None and dead.device != x.device:
        raise ValueError("chunk_max_sweep: tombstones on another device")
    out = torch.empty((n_pad // CHUNK, q_p.shape[0]), dtype=torch.float32,
                      device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):
        rc = lib.ivars_chunk_max(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q_p.data_ptr()),
            ctypes.c_void_p(dead.data_ptr() if dead is not None else None),
            ctypes.c_void_p(out.data_ptr()), n_pad, d, q_p.shape[0],
            int(n_valid), codes[x.dtype], kernels.stream_of(x),
        )
    kernels.check_launch(rc, "chunk_max")
    chunk_max_sweep.launches += 1
    return out[:, :b]


chunk_max_sweep.launches = 0


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def topk_search(
    x: torch.Tensor,
    q: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    deleted: torch.Tensor | None = None,
) -> TopKResult:
    """Exact top-k inner-product search of queries ``q`` over rows of ``x``.

    Inputs should be L2-normalized for cosine semantics. ``x`` may be
    pre-padded to a TILE_N multiple (pass ``n_valid`` = live rows);
    otherwise it is padded here. ``deleted``: optional (N,) or (N_pad, 1)
    int8 tombstones; rows with a nonzero entry never appear in results.
    Phase 1 is :func:`chunk_max_sweep` (kernel B1 on a card).
    """
    b = q.shape[0]
    n_live = int(x.shape[0]) if n_valid is None else int(n_valid)
    if n_live == 0:
        return TopKResult(
            torch.full((b, 0), float("-inf"), device=q.device),
            torch.zeros((b, 0), dtype=torch.int64, device=q.device),
        )
    k = min(k, n_live)
    x_p = x if x.shape[0] % TILE_N == 0 else pad_database(x)
    n_pad = x_p.shape[0]
    dead = _dead_flat(deleted, n_pad)
    # run at the bucketed k, slice the exact top-k prefix (see bucket_k)
    k_run = min(bucket_k(k), n_live)
    k_chunks = min(k_run, n_pad // CHUNK)

    chunk_max = chunk_max_sweep(x_p, q, n_live, dead)            # (NC, b)
    chunk_ids = torch.topk(chunk_max.T, k_chunks, dim=1).indices  # (b, kc)
    row_ids = (
        chunk_ids[:, :, None] * CHUNK
        + torch.arange(CHUNK, device=x_p.device)[None, None, :]
    ).reshape(b, k_chunks * CHUNK)
    valid = row_ids < n_live
    if dead is not None:
        valid &= dead[row_ids] == 0
    cand = x_p[torch.where(valid, row_ids, 0)]                   # (b, kcC, D)
    scores = torch.einsum("bd,bcd->bc", q.float(), cand.float())
    scores = scores.masked_fill(~valid, float("-inf"))
    top_scores, pos = torch.topk(scores, min(k_run, scores.shape[1]), dim=1)
    top_ids = torch.gather(row_ids, 1, pos)
    return TopKResult(top_scores[:, :k], top_ids[:, :k])


def topk_exact_reference(x: torch.Tensor, q: torch.Tensor, k: int) -> TopKResult:
    """Oracle: full f32 score matrix + top-k."""
    scores = q.float() @ x.float().T
    top_scores, top_ids = torch.topk(scores, min(k, x.shape[0]), dim=1)
    return TopKResult(top_scores, top_ids)


def topk_masked_reference(
    x: torch.Tensor,
    q: torch.Tensor,
    k: int,
    n_valid: int,
    deleted: torch.Tensor | None = None,
) -> TopKResult:
    """Oracle with a live-row count and optional tombstones: dead rows are
    -inf BEFORE selection."""
    scores = q.float() @ x.float().T
    alive = torch.arange(x.shape[0], device=x.device)[None, :] < n_valid
    if deleted is not None:
        alive = alive & (deleted.reshape(-1)[None, :] == 0)
    scores = scores.masked_fill(~alive, float("-inf"))
    top_scores, top_ids = torch.topk(scores, min(k, x.shape[0]), dim=1)
    return TopKResult(top_scores, top_ids)


def cosine_topk(x: torch.Tensor, q: torch.Tensor, k: int, **kwargs) -> TopKResult:
    """Convenience: L2-normalize both sides then exact top-k."""
    from .normalize import l2_normalize

    return topk_search(l2_normalize(x), l2_normalize(q), k, **kwargs)
