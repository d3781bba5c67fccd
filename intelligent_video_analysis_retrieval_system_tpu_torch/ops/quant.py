"""Int8-quantized similarity search: the int8 capacity mode, half the
device bytes per row of bf16 (10M x 768 rows = 7.7 GB).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/quant.py``
with the same scheme and the same results, bit for bit:

- database rows quantize symmetrically per row, ``x_i8 = round(x / s)``
  with ``s = max|x| / 127`` (:func:`quantize_rows_int8`, numpy, at write
  time); queries quantize the same way per query row at search time
  (:func:`symmetric_int8`, torch: f32, ``max(|x|, eps) / 127.0``, a divide,
  round half to even, clip);
- phase 1 (kernel B2, ``csrc/int8_sweep.cu``): int8 rows x int8 queries
  accumulate in int32, ``(float)acc * s_row``, rows past ``n_valid`` and
  tombstoned rows at -inf, max per 128-row chunk. The per-query scale is
  left out: chunk selection does not change under a positive scale;
- phase 2 (plain torch): gather the rows of the top-``k`` chunks, rescore
  them in f32 with the SAME quantized query, ``(int_dot * s_row) * s_q``.

Exactness: every product is at most 127^2 and a 768-term sum stays below
2^24, so the integer dot is exact in int32 and in f32 whatever the order of
summation; the only roundings are the two scale multiplies, done in the
same order everywhere. Equal scores come back in the order ``lax.top_k``
gives them, lowest index first (:func:`ops.topk.topk_lowest_index_first`;
``torch.topk`` orders ties otherwise, and int8 rows tie exactly whenever
near-duplicate keyframes quantize to the same row).

Dispatch, by where the tensors live:

- ``use_pallas=None`` (the index's call): a CPU tensor takes
  :func:`int8_reference`, the full score matrix, as the JAX package does on
  the CPU; a CUDA tensor takes the two-phase search with kernel B2.
- ``use_pallas=True`` on the CPU: the two-phase search with B2's plain
  version (:func:`int8_chunk_max_plain`), which is what the JAX package
  runs with its Pallas kernel in interpret mode.
- On a CUDA tensor phase 1 always launches B2. The JAX package has a
  second phase-1 backend, a plain int8 matmul (``backend="xla"``, its
  default only because its TPU compiler lowered the int8 kernel slowly on
  v5e); that finding has no counterpart on Hopper, and a plain phase 1 on
  the card would be a fallback, so the port has one phase 1.
  ``use_pallas=False`` on a CUDA tensor raises.

``w8a8_dense`` (the int8 tower layers) is not here: it comes with the W8A8
change.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .topk import (
    _PLAIN_ROWS,
    CHUNK,
    TILE_N,
    TopKResult,
    _dead_flat,
    bucket_k,
    pad_queries,
    topk_lowest_index_first,
)

__all__ = [
    "symmetric_int8",
    "quantize_rows_int8",
    "dequantize_rows_int8",
    "pad_rows_int8",
    "int8_chunk_max_sweep",
    "int8_chunk_max_plain",
    "topk_search_int8",
    "int8_reference",
]

# queries one B2 launch scores; larger batches sweep the rows again
_SWEEP_QUERIES = 64
# f32 elements of gathered candidate rows rescored per step (256 MB)
_RESCORE_ELEMS = 1 << 26


def symmetric_int8(x: torch.Tensor, dim: int, eps: float = 1e-12):
    """Symmetric per-slice int8 quantization: ``scale = max(max|x|, eps) /
    127`` along ``dim`` (kept), values ``clip(round(x / scale), -127, 127)``.
    Operation for operation the JAX ``symmetric_int8``."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) f32 -> (int8 rows, f32 per-row scales): the numpy twin of
    :func:`symmetric_int8` for host-side row storage."""
    x = np.asarray(x, np.float32)
    scales = np.maximum(np.abs(x).max(axis=-1), 1e-12) / 127.0
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def dequantize_rows_int8(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scales, np.float32)[:, None]


def _quantize_q(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 query quantization -> (int8 (B, D), f32 (B,))."""
    q_i8, qs = symmetric_int8(q, dim=-1)
    return q_i8, qs[..., 0]


def pad_rows_int8(x_i8: np.ndarray, scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad int8 rows and their scales to a multiple of TILE_N."""
    n = x_i8.shape[0]
    n_pad = -(-max(n, TILE_N) // TILE_N) * TILE_N
    if n_pad == n:
        return x_i8, scales
    xp = np.zeros((n_pad, x_i8.shape[1]), np.int8)
    xp[:n] = x_i8
    sp = np.zeros((n_pad,), np.float32)
    sp[:n] = scales
    return xp, sp


# ---------------------------------------------------------------------------
# Phase 1: kernel B2 and its plain version
# ---------------------------------------------------------------------------


def int8_chunk_max_plain(
    x_i8: torch.Tensor, x_scales: torch.Tensor, q_i8: torch.Tensor, n_valid: int,
    deleted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch B2: (N_pad/CHUNK, B) f32 chunk maxima of
    ``(x_i8 . q_i8) * s_row``. The f32 matmul of int8 values is exact (every
    partial sum is an integer below 2^24), so this equals the kernel bit
    for bit."""
    n_pad = x_i8.shape[0]
    b = q_i8.shape[0]
    dead = _dead_flat(deleted, n_pad)
    xs = x_scales.reshape(-1)
    qf = q_i8.float()
    out = torch.empty((n_pad // CHUNK, b), dtype=torch.float32, device=x_i8.device)
    for s in range(0, n_pad, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, n_pad)
        scores = (x_i8[s:e].float() @ qf.T) * xs[s:e, None]    # (rows, B) f32
        alive = torch.arange(s, e, device=x_i8.device) < n_valid
        if dead is not None:
            alive &= dead[s:e] == 0
        scores = scores.masked_fill(~alive[:, None], float("-inf"))
        out[s // CHUNK:e // CHUNK] = scores.reshape(-1, CHUNK, b).amax(1)
    return out


def int8_chunk_max_sweep(
    x_i8: torch.Tensor, x_scales: torch.Tensor, q_i8: torch.Tensor, n_valid: int,
    deleted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Phase-1 maxima, (N_pad/CHUNK, B) f32, for int8 rows ``x_i8`` padded
    to a TILE_N multiple, their f32 scales and int8 queries ``q_i8``.

    CPU tensors take :func:`int8_chunk_max_plain`. CUDA tensors launch kernel
    B2 (``csrc/int8_sweep.cu``) on PyTorch's current stream, once per 64
    queries of the padded batch; the count of those launches is
    ``int8_chunk_max_sweep.launches``.
    """
    n_pad, d = x_i8.shape
    if n_pad % TILE_N != 0:
        raise ValueError(f"x rows {n_pad} not a TILE_N={TILE_N} multiple")
    if x_i8.dtype != torch.int8 or q_i8.dtype != torch.int8 or q_i8.shape[1] != d:
        raise ValueError(f"want int8 rows and queries of one width, got x "
                         f"{tuple(x_i8.shape)} {x_i8.dtype}, q {tuple(q_i8.shape)} "
                         f"{q_i8.dtype}")
    xs = x_scales.reshape(-1)
    if xs.shape[0] != n_pad or xs.dtype != torch.float32:
        raise ValueError(f"x_scales {tuple(x_scales.shape)} {x_scales.dtype}: want "
                         f"{n_pad} float32 row scales")
    b = q_i8.shape[0]
    if x_i8.device.type == "cpu":
        return int8_chunk_max_plain(x_i8, xs, q_i8, n_valid, deleted)
    if x_i8.device.type != "cuda" or {q_i8.device, xs.device} != {x_i8.device}:
        raise ValueError(f"int8_chunk_max_sweep: x on {x_i8.device}, q on "
                         f"{q_i8.device}, scales on {xs.device}")
    if d % 16 != 0:
        raise ValueError(f"int8_chunk_max_sweep: row of {d} int8 is not a multiple "
                         "of 16 bytes")
    x_i8 = x_i8.contiguous()
    if x_i8.data_ptr() % 16 != 0:
        raise ValueError("int8_chunk_max_sweep: x is not 16-byte aligned")
    xs = xs.contiguous()
    q_p = pad_queries(q_i8).contiguous()
    if q_p.data_ptr() % 16 != 0:  # a view at an odd offset: a fresh copy aligns
        q_p = q_p.clone()
    dead = _dead_flat(deleted, n_pad)
    if dead is not None and dead.device != x_i8.device:
        raise ValueError("int8_chunk_max_sweep: tombstones on another device")
    b_pad = q_p.shape[0]
    out = torch.empty((n_pad // CHUNK, b_pad), dtype=torch.float32, device=x_i8.device)
    lib = kernels.load()
    with torch.cuda.device(x_i8.device):
        stream = kernels.stream_of(x_i8)
        for q0 in range(0, b_pad, _SWEEP_QUERIES):
            nq = min(_SWEEP_QUERIES, b_pad - q0)
            rc = lib.ivars_int8_chunk_max(
                ctypes.c_void_p(x_i8.data_ptr()), ctypes.c_void_p(xs.data_ptr()),
                ctypes.c_void_p(q_p.data_ptr() + q0 * d),
                ctypes.c_void_p(dead.data_ptr() if dead is not None else None),
                ctypes.c_void_p(out.data_ptr() + q0 * out.element_size()),
                n_pad, d, nq, b_pad, int(n_valid), stream,
            )
            kernels.check_launch(rc, "int8_chunk_max")
            int8_chunk_max_sweep.launches += 1
    return out[:, :b]


int8_chunk_max_sweep.launches = 0


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _rescore(x_i8, x_scales, q_i8, q_scales, row_ids, valid) -> torch.Tensor:
    """Phase 2: ``(q_i8 . x_i8[row]) * s_row * s_q`` for every candidate,
    -inf where ``valid`` is False. The candidate rows are gathered and
    widened to f32 a few queries at a time, bounding the temporary."""
    b, c = row_ids.shape
    safe = torch.where(valid, row_ids, 0)
    qf = q_i8.float()
    int_dot = torch.empty((b, c), dtype=torch.float32, device=x_i8.device)
    step = max(1, _RESCORE_ELEMS // max(c * x_i8.shape[1], 1))
    for s in range(0, b, step):
        e = min(s + step, b)
        int_dot[s:e] = torch.einsum("bd,bcd->bc", qf[s:e], x_i8[safe[s:e]].float())
    scores = int_dot * x_scales[safe] * q_scales[:, None]
    return scores.masked_fill(~valid, float("-inf"))


def topk_search_int8(
    x_i8: torch.Tensor,
    x_scales: torch.Tensor,
    q: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    deleted: torch.Tensor | None = None,
    use_pallas: bool | None = None,
) -> TopKResult:
    """Top-k over an int8-quantized database (module docstring).

    ``q`` is full precision, (B, D), and is quantized per row here.
    ``x_i8`` (N_pad, D) int8 padded to a TILE_N multiple with its ``(N_pad,)``
    f32 scales, for the two-phase search; ``deleted`` optional (N,) or
    (N_pad, 1) int8 tombstones.
    """
    b = q.shape[0]
    n_live = int(x_i8.shape[0]) if n_valid is None else int(n_valid)
    if n_live == 0:
        return TopKResult(
            torch.full((b, 0), float("-inf"), device=q.device),
            torch.zeros((b, 0), dtype=torch.int64, device=q.device),
        )
    k = min(k, n_live)
    on_card = x_i8.device.type != "cpu"
    if use_pallas is None:
        use_pallas = on_card
    if not use_pallas:
        if on_card:
            raise ValueError("use_pallas=False: a CUDA tensor always runs the "
                             "two-phase search with kernel B2")
        return int8_reference(x_i8[:n_live], x_scales.reshape(-1)[:n_live], q, k, deleted)

    n_pad = x_i8.shape[0]
    if n_pad % TILE_N != 0:
        raise ValueError("pad with pad_rows_int8 first")
    xs = x_scales.reshape(-1).float()
    dead = _dead_flat(deleted, n_pad)
    # run at the bucketed k, slice the exact top-k prefix (ops.topk.bucket_k)
    k_run = min(bucket_k(k), n_live)
    k_chunks = min(k_run, n_pad // CHUNK)
    # ONE quantized query for both phases: with one integer metric the
    # chunk-containment guarantee holds with no ulp slack
    q_i8, q_scales = _quantize_q(q)
    chunk_max = int8_chunk_max_sweep(x_i8, xs, q_i8, n_live, dead)   # (NC, b)
    _, chunk_ids = topk_lowest_index_first(chunk_max.T, k_chunks)     # (b, kc)
    row_ids = (
        chunk_ids[:, :, None] * CHUNK
        + torch.arange(CHUNK, device=x_i8.device)[None, None, :]
    ).reshape(b, k_chunks * CHUNK)
    valid = row_ids < n_live
    if dead is not None:
        valid &= dead[row_ids] == 0
    scores = _rescore(x_i8, xs, q_i8, q_scales, row_ids, valid)
    top_scores, pos = topk_lowest_index_first(scores, min(k_run, scores.shape[1]))
    top_ids = torch.gather(row_ids, 1, pos)
    return TopKResult(top_scores[:, :k], top_ids[:, :k])


def int8_reference(
    x_i8: torch.Tensor,
    x_scales: torch.Tensor,
    q: torch.Tensor,
    k: int,
    deleted: torch.Tensor | None = None,
) -> TopKResult:
    """Oracle under the same quantized metric: every row scored, top-k with
    ties lowest row first (the JAX ``_int8_reference``). Runs over blocks of
    rows with a running top-k, so it holds 10M rows on a card."""
    q_i8, q_scales = _quantize_q(q)
    qf = q_i8.float()
    n = x_i8.shape[0]
    k = min(k, n)
    xs = x_scales.reshape(-1)
    mask = None if deleted is None else deleted.reshape(-1)[:n]
    best_s = torch.full((q.shape[0], 0), float("-inf"), device=x_i8.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=x_i8.device)
    for s in range(0, n, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, n)
        scores = (qf @ x_i8[s:e].float().T) * xs[None, s:e] * q_scales[:, None]
        if mask is not None:
            scores = scores.masked_fill(mask[None, s:e] != 0, float("-inf"))
        vals, idx = topk_lowest_index_first(scores, k)
        # the running list holds only lower rows and comes first, so a
        # stable merge keeps ties in row order
        vals, pos = topk_lowest_index_first(torch.cat([best_s, vals], 1), k)
        best_i = torch.gather(torch.cat([best_i, idx + s], 1), 1, pos)
        best_s = vals
    return TopKResult(best_s, best_i)
