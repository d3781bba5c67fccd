"""Exact top-k by inner product, every row scored, in blocks of rows with a
running top-k, so that it holds a card's index beside the index itself.
The order among equal scores is left open: the numbers of :mod:`.compare`
read only scores.

- :func:`float_topk`: float32 queries against bf16 or f32 rows widened
  exactly to float32.
- :func:`int8_topk`: the int8 capacity metric, ``(q8 . x8) * s_row * s_q``,
  the query quantized per row (``s_q = max(max|q|, 1e-12) / 127``, values
  rounded half to even and clipped to +-127), the integer product taken in
  float32, where every partial sum is an integer below 2^24 and so exact.
- :func:`quantize_rows`: a row quantizer of any width (the int4 control).
"""

from __future__ import annotations

import torch

from .clip import exact_f32

ROWS = 1 << 18


def _merge(best_s, best_i, vals, idx, k):
    s, pos = torch.topk(torch.cat([best_s, vals], 1), k, dim=1)
    return s, torch.gather(torch.cat([best_i, idx], 1), 1, pos)


def _topk(score_block, n: int, nq: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    best_s = torch.full((nq, 0), float("-inf"), device=device)
    best_i = torch.zeros((nq, 0), dtype=torch.int64, device=device)
    with exact_f32():
        for s in range(0, n, ROWS):
            e = min(s + ROWS, n)
            scores = score_block(s, e)
            vals, idx = torch.topk(scores, min(k, e - s), dim=1)
            best_s, best_i = _merge(best_s, best_i, vals, idx + s, min(k, e))
    return best_s, best_i


def float_topk(rows: torch.Tensor, n: int, q: torch.Tensor, k: int):
    """(scores (B, k) f32, ids (B, k) int64) of f32 queries ``q`` over
    ``rows[:n]``."""
    qf = q.float()
    return _topk(lambda s, e: qf @ rows[s:e].float().T, n, len(q), k, q.device)


def float_scores(rows: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, m) f32 scores of query b against rows ``ids[b]``."""
    with exact_f32():
        return torch.einsum("bd,bmd->bm", q.float(), rows[ids].float())


def quantize_rows(x: torch.Tensor, levels: int = 127) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization to integers in [-levels, levels]:
    (values as f32, (B, 1) scales)."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12)
    scale = amax / amax.new_full((), float(levels))
    return torch.clamp(torch.round(x / scale), -levels, levels), scale


def int8_topk(rows8: torch.Tensor, scales: torch.Tensor, n: int, q: torch.Tensor, k: int,
              row_levels: int = 127, q_levels: int = 127):
    """(scores, ids) under the int8 metric of f32 queries ``q`` (already
    L2-normalized) over ``rows8[:n]`` with f32 ``scales``. ``row_levels`` /
    ``q_levels`` below 127 requantize the rows and the queries coarser (the
    control)."""
    qv, qs = quantize_rows(q, q_levels)
    xs = scales.reshape(-1)
    step = 127 // row_levels

    def block(s, e):
        x = rows8[s:e].float()
        sc = xs[s:e]
        if row_levels != 127:
            x = torch.clamp(torch.round(x / step), -row_levels, row_levels)
            sc = sc * step
        return (qv @ x.T) * sc[None, :] * qs

    return _topk(block, n, len(q), k, q.device)


def int8_scores(rows8: torch.Tensor, scales: torch.Tensor, q: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """(B, m) int8-metric scores of query b against rows ``ids[b]``."""
    qv, qs = quantize_rows(q, 127)
    with exact_f32():
        dot = torch.einsum("bd,bmd->bm", qv, rows8[ids].float())
    return dot * scales.reshape(-1)[ids] * qs
