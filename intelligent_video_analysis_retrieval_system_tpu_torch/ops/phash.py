"""DCT perceptual hashing over whole batches (port of ``ops/phash.py``).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/phash.py``:
grayscale -> 32x32 resize -> 2D DCT-II (two products with the orthonormal
basis) -> the top-left 8x8 low-frequency block -> bit = coefficient above
the median of all 64 (DC included, ``imagehash.phash``'s semantics).
Hashes are (B, 64) uint8 bit arrays. Torch operations, no kernel.

The median is the mean of the two middle values, rounded as ``jnp.median``
rounds it (``(low + high) * 0.5`` in f32). ``torch.median`` returns the
lower of the two: where the two middle coefficients are neighbouring floats
whose mean rounds up to the upper one, that flips the upper one's bit, so
the port sorts and averages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .preprocess import resize_bilinear
from .quality import rgb_to_gray

__all__ = ["perceptual_hash", "hamming_distance", "phash_dedup_mask"]

_HASH_DIM = 32
_LOW_FREQ = 8


@functools.lru_cache(maxsize=4)
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis matrix (n, n): X = C @ x @ C^T."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    basis = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    basis[0] *= 1.0 / np.sqrt(2.0)
    return (basis * np.sqrt(2.0 / n)).astype(np.float32)


def _bits_above_median(low: torch.Tensor) -> torch.Tensor:
    """(B, 2m) coefficients -> (B, 2m) uint8: above the row's median, the
    mean of its two middle values."""
    m = low.shape[1] // 2
    ordered = torch.sort(low, dim=1).values
    med = (ordered[:, m - 1:m] + ordered[:, m:m + 1]) * 0.5
    return (low > med).to(torch.uint8)


def _phash_bits(gray32: torch.Tensor) -> torch.Tensor:
    c = torch.from_numpy(_dct_basis(_HASH_DIM)).to(gray32.device)
    coeffs = torch.einsum("ij,bjk,lk->bil", c, gray32, c)
    low = coeffs[:, :_LOW_FREQ, :_LOW_FREQ].reshape(-1, _LOW_FREQ * _LOW_FREQ)
    return _bits_above_median(low)


def perceptual_hash(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels in [0, 255] -> (B, 64) uint8 bits."""
    gray = rgb_to_gray(images)[..., None]
    gray32 = resize_bilinear(gray, _HASH_DIM, _HASH_DIM)[..., 0]
    return _phash_bits(gray32)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances: a (M, 64), b (N, 64) bits -> (M, N) int32."""
    diff = a.to(torch.int32)[:, None, :] ^ b.to(torch.int32)[None, :, :]
    return diff.sum(dim=-1, dtype=torch.int32)


def phash_dedup_mask(hashes, threshold: int = 5) -> np.ndarray:
    """Sequential prefilter on the host: drop a frame whose hash is within
    ``threshold`` bits of the previously *kept* frame. Returns a numpy keep
    mask."""
    h = hashes.cpu().numpy() if isinstance(hashes, torch.Tensor) else np.asarray(hashes)
    n = len(h)
    keep = np.ones(n, dtype=bool)
    if n == 0:
        return keep
    last = h[0]
    for i in range(1, n):
        if int(np.sum(h[i] != last)) <= threshold:
            keep[i] = False
        else:
            last = h[i]
    return keep
