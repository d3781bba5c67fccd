"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the operations and bytes of the work, from shapes alone.

A roofline share is the least time the chip could take for the work, the
larger of operations over the peak rate and bytes over the memory rate,
divided by the time the work took. Bytes count each input once and each
output once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Mapping

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    return max(ops / peak, nbytes / HBM_BYTES)


def _block_flops(tokens: int, d: int, f: int, t: int) -> float:
    """One pre-LN block over ``tokens`` rows in sequences of ``t``: the four
    projections, the two MLP products and attention's two products."""
    return 2 * tokens * (4 * d * d + 2 * d * f) + 4 * tokens * t * d


def tower_flops(c: Mapping, batch: int, tokens: int, projection: int, patch_in: int = 0) -> float:
    """Operations of a transformer tower of config ``c`` over ``batch``
    sequences of ``tokens`` (the patch product when ``patch_in`` > 0, one
    pooled projection a sequence)."""
    d, f = c["hidden_size"], c["intermediate_size"]
    rows = batch * tokens
    ops = c["num_hidden_layers"] * _block_flops(rows, d, f, tokens)
    ops += 2 * batch * (tokens - 1) * patch_in * d
    return ops + 2 * batch * d * projection


def tower_weight_bytes(c: Mapping, elem: int = 2) -> float:
    d, f = c["hidden_size"], c["intermediate_size"]
    return c["num_hidden_layers"] * (4 * d * d + 2 * d * f) * elem


def text_tower(cfg: Mapping, requests: int) -> tuple[float, float]:
    """(ops, bytes) of the text tower over ``requests`` queries at the full
    context (the tower is defined over all its positions)."""
    t = cfg["text_config"]
    return (tower_flops(t, requests, t["max_position_embeddings"], cfg["projection_dim"]),
            tower_weight_bytes(t))


def vision_tower(cfg: Mapping, images: int) -> tuple[float, float]:
    """(ops, bytes) of the vision tower over ``images`` uint8 keyframes."""
    v = cfg["vision_config"]
    p = v["patch_size"]
    tokens = (v["image_size"] // p) ** 2 + 1
    ops = tower_flops(v, images, tokens, cfg["projection_dim"], patch_in=3 * p * p)
    nbytes = tower_weight_bytes(v) + images * v["image_size"] ** 2 * 3
    return ops, nbytes


def sweep(rows: int, dim: int, queries: int, elem: int) -> tuple[float, float]:
    """(ops, bytes) of scoring ``queries`` against every row once: the rows
    read once (int8 rows with their f32 scales), the products."""
    extra = 4 if elem == 1 else 0
    return 2.0 * rows * dim * queries, float(rows) * (dim * elem + extra)


def mha_bytes(batch: int, tokens: int, dim: int, elem: int = 2) -> float:
    """Kernel B3's bytes: q, k and v read once, the output written once."""
    return 4.0 * batch * tokens * dim * elem


def mha_flops(batch: int, tokens: int, dim: int) -> float:
    return 4.0 * batch * tokens * tokens * dim
