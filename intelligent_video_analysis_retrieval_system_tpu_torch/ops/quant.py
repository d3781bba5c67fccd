"""Int8-quantized similarity search: the int8 capacity mode, half the
device bytes per row of bf16 (10M x 768 rows = 7.7 GB).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/quant.py``
with the same scheme and the same results, bit for bit:

- database rows quantize symmetrically per row, ``x_i8 = round(x / s)``
  with ``s = max|x| / 127`` (:func:`quantize_rows_int8`, numpy, at write
  time); queries quantize the same way per query row at search time
  (:func:`symmetric_int8`, torch: f32, ``max(|x|, eps) / 127.0``, a divide,
  round half to even, clip);
- phase 1 (kernel B2, ``csrc/int8_sweep.cu``, one sweep of the rows per
  query group of :func:`int8_sweep_plan`): int8 rows x int8 queries
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

``w8a8_dense`` is the dense layer of the W8A8 towers (``models.clip``):
int8 activations times int8 per-output-channel weights, accumulated in
int32 by ``torch._int_mm`` (a library product, as the JAX package leaves
its int8 ``dot_general`` to XLA: no Pallas kernel to port), then
dequantized. Quant and dequant are plain torch operations.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from . import kernels
from .topk import (
    _CONSUMER_WARPS,
    _PLAIN_ROWS,
    _SMEM_BLOCK,
    _SMEM_SM,
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
    "int8_sweep_plan",
    "topk_search_int8",
    "int8_reference",
    "quantize_weight_int8",
    "w8a8_dense",
]

# f32 elements of gathered candidate rows rescored per step (256 MB)
_RESCORE_ELEMS = 1 << 26


def symmetric_int8(x: torch.Tensor, dim: int, eps: float = 1e-12):
    """Symmetric per-slice int8 quantization: ``scale = max(max|x|, eps) /
    127`` along ``dim`` (kept), values ``clip(round(x / scale), -127, 127)``.
    Operation for operation the JAX ``symmetric_int8``. The divisor is a
    tensor on ``x``'s device: CUDA divides by a Python scalar as a multiply
    by its reciprocal, one ulp off for some rows, and the scale must be the
    same bits on the card as on the CPU."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=eps)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight_int8(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear`` weight ``(out, in)`` -> (int8 ``(out, in)``, f32 ``(out,)``
    per-output-channel scales), quantized from the f32 parameter. The JAX
    kernel is ``(in, out)`` and takes its scale along axis 0: the same
    maxima, the same bits."""
    w8, w_scale = symmetric_int8(weight.detach().float(), dim=1)
    return w8, w_scale[:, 0]


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _int_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``x8 (M, K) . w8 (N, K)^T`` in int32 through ``torch._int_mm``. Its
    CUDA route takes M > 16 and K, N multiples of 8: other shapes are padded
    with zero rows and columns (which add nothing to an integer sum) and the
    result is sliced. Every dot product is exact: at most 4096 * 127^2 <
    2^31 at the towers' widths."""
    m, k = x8.shape
    n = w8.shape[0]
    mp, kp, np_ = max(m, 17), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        x8 = torch.nn.functional.pad(x8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w8 = torch.nn.functional.pad(w8, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(x8.contiguous(), w8.t())
    w8a8_dense.calls += 1
    return acc[:m, :n]


def w8a8_dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    a_scale: torch.Tensor | float | None = None,
    qweight: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Dense layer in int8 (the JAX ``w8a8_dense``): activation quant x
    per-output-channel weight quant -> int32 accumulate -> dequant.

    ``x`` (..., in); ``weight`` the f32 ``(out, in)`` parameter, quantized
    here unless ``qweight`` gives its :func:`quantize_weight_int8` (the
    towers cache it per parameter version). ``a_scale`` None: dynamic
    per-token scales (:func:`symmetric_int8` over the features); else the
    calibrated static scale (``models.calibrate``), clamped to at least
    1e-12, out-of-range activations saturating at +-127. The scale is moved
    to ``x``'s device: CUDA divides by a CPU scalar as a multiply by its
    reciprocal, which is not the CPU's quotient. The result is
    ``((float)acc * x_scale) * w_scale + bias`` in f32, cast to
    ``out_dtype`` (default ``x.dtype``), operation for operation the JAX
    expression run eagerly. ``w8a8_dense.calls`` counts the ``_int_mm``
    products."""
    w8, w_scale = qweight if qweight is not None else quantize_weight_int8(weight)
    lead = x.shape[:-1]
    x_f = x.reshape(-1, x.shape[-1]).float()
    if a_scale is None:
        x8, x_scale = symmetric_int8(x_f, dim=-1)              # (M, 1)
    else:
        x_scale = torch.clamp(
            torch.as_tensor(a_scale, dtype=torch.float32, device=x.device), min=1e-12)
        x8 = torch.clamp(torch.round(x_f / x_scale), -127, 127).to(torch.int8)
    out = _int_mm(x8, w8).float() * x_scale * w_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or x.dtype).reshape(*lead, w8.shape[0])


w8a8_dense.calls = 0


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


# kernel B2's launches (csrc/int8_sweep.cu `max_group` and `plan_for`, which
# compute the same): a ring of stages of 128 rows x 128 int8 columns and the
# query tiles staged for the block's life, within B1's shared-memory limits
_I8_STAGE_BYTES = CHUNK * 128
_I8_MIN_STAGES, _I8_MAX_STAGES = 4, 8
_I8_WIDTHS = (256, 128, 64, 32, 16, 8)


def _i8_fixed_bytes(width: int, d: int) -> int:
    # alignment slack, query tiles, two buffers of the warps' maxima, barriers
    return 1024 + -(-d // 128) * width * 128 + 2 * _CONSUMER_WARPS * width * 4 + 256


def int8_sweep_plan(b_pad: int, d: int) -> list[dict]:
    """The launches of kernel B2 for ``b_pad`` queries (a multiple of 8) over
    int8 rows of width ``d``, one sweep of every row each, in order: the
    first query ``q0`` and ``group`` of queries of each, the ``width`` of its
    query tiles (the power of two at or above the group; rows past the group
    are zeros), ring ``stages`` of 16 KB, ``blocks_per_sm`` and
    ``smem_bytes`` of dynamic shared memory per block.

    A group is the largest multiple of 8 that is at most 256, at most the
    queries left, and whose tiles and a ring of 4 stages fit in a block's
    shared memory (256 queries at ``d`` = 512, 128 at 768): 512 queries at
    ``d`` = 512 are two sweeps, 8 one. Two blocks a multiprocessor where the
    width is at most 64 and each still gets 4 stages. Raises ValueError
    where ``d`` is too wide for a group of 8."""
    if b_pad <= 0 or b_pad % 8 or d <= 0 or d % 16:
        raise ValueError(f"int8_sweep_plan: b_pad={b_pad}, d={d}")
    fits = [w for w in _I8_WIDTHS
            if _i8_fixed_bytes(w, d) + _I8_MIN_STAGES * _I8_STAGE_BYTES <= _SMEM_BLOCK]
    if not fits:
        raise ValueError(f"int8_sweep_plan: rows of {d} int8 are too wide for kernel B2's "
                         "shared memory")
    launches = []
    for q0 in range(0, b_pad, fits[0]):
        group = min(fits[0], b_pad - q0)
        width = 1 << max(3, (group - 1).bit_length())
        fixed = _i8_fixed_bytes(width, d)
        fit2 = max(0, (_SMEM_SM // 2 - 1024 - fixed) // _I8_STAGE_BYTES)
        per_sm = 2 if width <= 64 and fit2 >= _I8_MIN_STAGES else 1
        stages = min(_I8_MAX_STAGES,
                     fit2 if per_sm == 2 else (_SMEM_BLOCK - fixed) // _I8_STAGE_BYTES)
        launches.append({"q0": q0, "group": group, "width": width, "stages": stages,
                         "blocks_per_sm": per_sm, "smem_bytes": fixed + stages * _I8_STAGE_BYTES})
    return launches


def int8_chunk_max_sweep(
    x_i8: torch.Tensor, x_scales: torch.Tensor, q_i8: torch.Tensor, n_valid: int,
    deleted: torch.Tensor | None = None,
) -> torch.Tensor:
    """Phase-1 maxima, (N_pad/CHUNK, B) f32, for int8 rows ``x_i8`` padded
    to a TILE_N multiple, their f32 scales and int8 queries ``q_i8``.

    CPU tensors take :func:`int8_chunk_max_plain`. CUDA tensors launch kernel
    B2 (``csrc/int8_sweep.cu``) on PyTorch's current stream, once per query
    group of :func:`int8_sweep_plan` for the padded batch; the count of those
    launches is ``int8_chunk_max_sweep.launches``, and the largest group of
    the last call on a card ``int8_chunk_max_sweep.group``.
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
    plan = int8_sweep_plan(b_pad, d)
    # every launch reads `width` query rows: zeros past the batch
    rows = plan[-1]["q0"] + plan[-1]["width"]
    if rows > b_pad:
        q_p = torch.cat([q_p, q_p.new_zeros((rows - b_pad, d))])
    out = torch.empty((n_pad // CHUNK, b_pad), dtype=torch.float32, device=x_i8.device)
    lib = kernels.load()
    with torch.cuda.device(x_i8.device):
        stream = kernels.stream_of(x_i8)
        for launch in plan:
            q0 = launch["q0"]
            rc = lib.ivars_int8_chunk_max(
                ctypes.c_void_p(x_i8.data_ptr()), ctypes.c_void_p(xs.data_ptr()),
                ctypes.c_void_p(q_p.data_ptr() + q0 * d),
                ctypes.c_void_p(dead.data_ptr() if dead is not None else None),
                ctypes.c_void_p(out.data_ptr() + q0 * out.element_size()),
                n_pad, d, launch["group"], b_pad, int(n_valid), stream,
            )
            kernels.check_launch(rc, "int8_chunk_max")
            int8_chunk_max_sweep.launches += 1
    int8_chunk_max_sweep.group = plan[0]["group"]
    return out[:, :b]


int8_chunk_max_sweep.launches = 0
int8_chunk_max_sweep.group = 0


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
    (N_pad, 1) int8 tombstones. The two-phase search records the spans
    ``quant.phase1`` (counting B2's ``launches``; on a card noting the
    largest query ``group`` they ran) and ``quant.phase2``.
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
    with trace.span("quant.phase1") as phase1:
        launches = int8_chunk_max_sweep.launches
        # ONE quantized query for both phases: with one integer metric the
        # chunk-containment guarantee holds with no ulp slack
        q_i8, q_scales = _quantize_q(q)
        chunk_max = int8_chunk_max_sweep(x_i8, xs, q_i8, n_live, dead)   # (NC, b)
        launched = int8_chunk_max_sweep.launches - launches
        trace.count("launches", launched)
        if launched:
            phase1.note(group=int8_chunk_max_sweep.group)
    with trace.span("quant.phase2"):
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
