"""Operations and bytes of the SigLIP vision tower, from shapes alone, at
the peaks of :mod:`perfbench.roofline`.

Unlike CLIP's tower (``roofline.tower_flops``), every token is a patch: the
patch product runs over all of them, there is no class token and no
projection, and the MAP head adds its k and v projections over every token,
its probe's attention and its MLP on one row an image.
"""

from __future__ import annotations

from typing import Mapping

from .roofline import _block_flops, bound_s, mha_bytes, mha_flops, tower_weight_bytes

__all__ = ["b3_bound_s", "head_flops", "vision_flops", "vision_tower"]


def head_flops(d: int, f: int, images: int, tokens: int) -> float:
    """The MAP head over ``images`` sequences of ``tokens``: k and v over
    every token, the probe's q, attention's two products, out_proj and the
    MLP on one row an image."""
    return (4.0 * images * tokens * d * d + 2.0 * d * d + 4.0 * images * tokens * d
            + 2.0 * images * d * d + 4.0 * images * d * f)


def vision_flops(v: Mapping, images: int, tokens: int | None = None) -> float:
    """Operations of the vision tower over ``images`` keyframes of
    ``tokens`` tokens (the config's patches when None)."""
    d, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    t = tokens if tokens is not None else (v["image_size"] // p) ** 2
    rows = images * t
    ops = v["num_hidden_layers"] * _block_flops(rows, d, f, t)
    ops += 2.0 * rows * 3 * p * p * d
    return ops + head_flops(d, f, images, t)


def vision_tower(cfg: Mapping, images: int, tokens: int | None = None) -> tuple[float, float]:
    """(ops, bytes) of the vision tower over ``images`` uint8 keyframes: the
    blocks' and the head's weights in bf16 read once, the pixels once."""
    v = cfg["vision_config"]
    d, f = v["hidden_size"], v["intermediate_size"]
    nbytes = tower_weight_bytes(v) + (4 * d * d + 2 * d * f) * 2 + images * v["image_size"] ** 2 * 3
    return vision_flops(v, images, tokens), nbytes


def b3_bound_s(batch: int, tokens: int, dim: int) -> float:
    """Kernel B3's least time at one launch's shape: the larger of its two
    products at the bf16 peak and q, k, v and the output once at the
    memory's peak."""
    return bound_s(mha_flops(batch, tokens, dim), mha_bytes(batch, tokens, dim))
