"""Image preprocessing for the CLIP tower: resize, crop, normalize (NHWC).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/preprocess.py``.
Resizing is two matmuls against separable interpolation matrices (built
on the host by the same construction as the reference's
``_interp_matrix``); normalization is one elementwise expression. The embedder calls these as
plain torch, as the reference calls them with ``use_pallas=False``; the
fused normalize kernel (B5) is ported in a later change.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
    "resize_bilinear",
    "center_crop",
    "normalize_images",
    "preprocess_images",
]

# OpenAI CLIP normalization constants
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _interp_matrix(out_size: int, in_size: int, method: str,
                   antialias: bool) -> np.ndarray:
    """Dense (out, in) interpolation matrix, half-pixel centers, PIL-style
    antialias when downscaling (same construction as the reference)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    radius = 1.0 if method == "bilinear" else 2.0
    scale = in_size / out_size
    width = max(scale, 1.0) if antialias else 1.0
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    idx = np.arange(in_size)
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        x = (idx - src) / width
        if method == "bilinear":
            w = np.maximum(0.0, 1.0 - np.abs(x))
        else:  # Keys cubic, a = -0.5 (PIL's BICUBIC)
            a, ax = -0.5, np.abs(x)
            ax2, ax3 = ax * ax, ax * ax * ax
            w = np.where(
                ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
                np.where(ax < 2.0,
                         a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
            )
        w = w * (np.abs(idx - src) <= radius * width + 1e-9)
        total = w.sum()
        if total <= 0:
            w[int(round(min(max(src, 0), in_size - 1)))] = 1.0
            total = 1.0
        mat[o] = w / total
    return mat


def resize_bilinear(
    images: torch.Tensor,
    out_h: int,
    out_w: int,
    method: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """Batched separable resize (B, H, W, C) -> (B, out_h, out_w, C), f32.
    ``method`` in {"bilinear", "bicubic"}; antialiased by default."""
    _, h, w, _ = images.shape
    dev = images.device
    a_h = torch.from_numpy(_interp_matrix(out_h, h, method, antialias)).to(dev)
    a_w = torch.from_numpy(_interp_matrix(out_w, w, method, antialias)).to(dev)
    x = images.float()
    x = torch.einsum("oh,bhwc->bowc", a_h, x)
    return torch.einsum("pw,bowc->bopc", a_w, x)


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    """Center-crop (B, H, W, C) to (B, size, size, C)."""
    _, h, w, _ = images.shape
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return images[:, top:top + size, left:left + size, :]


def normalize_images(
    images: torch.Tensor,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, W, 3) pixel values in [0, 255] -> normalized ``dtype`` NHWC."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(dtype)


def preprocess_images(
    images: torch.Tensor,
    image_size: int = 224,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Resize the shortest side (bicubic, antialiased) -> center crop ->
    normalize. (B, H, W, 3) in [0, 255] -> (B, size, size, 3) ``dtype``."""
    _, h, w, _ = images.shape
    if h <= w:
        new_h, new_w = image_size, max(image_size, round(w * image_size / h))
    else:
        new_h, new_w = max(image_size, round(h * image_size / w)), image_size
    x = resize_bilinear(images, new_h, new_w, method="bicubic", antialias=True)
    x = center_crop(x, image_size)
    return normalize_images(x, dtype=dtype)
