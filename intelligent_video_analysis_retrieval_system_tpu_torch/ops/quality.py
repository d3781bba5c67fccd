"""Keyframe quality metrics over whole batches (port of ``ops/quality.py``).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/quality.py``:
the variance of the Laplacian (sharpness) and a Sobel-magnitude edge
density per image, and the keep mask that drops the worst percentile of
each. Torch operations, no kernel of their own (the reference's are jitted
``jnp``).

The 3x3 filters are written as shifted f32 sums over ``(B, H, W)`` rather
than ``torch.nn.functional.conv2d``: on a card that call goes to cuDNN in
TF32 (``torch.backends.cudnn.allow_tf32`` is True by default), which moves
the scores by tenths of a percent. A shifted sum is also cross-correlation,
as ``lax.conv_general_dilated`` is, so the Sobel kernels keep the
reference's orientation. Every tap is 0, +-1, +-2 or -4, so each product is
exact.
"""

from __future__ import annotations

import torch

__all__ = [
    "rgb_to_gray",
    "laplacian_blur_scores",
    "edge_density_scores",
    "quality_metrics",
    "adaptive_quality_mask",
]

# cv2.cvtColor BGR->GRAY uses ITU-R BT.601; the input is RGB.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)

_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = tuple(zip(*_SOBEL_X))


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) float32 luminance."""
    x = images.float()
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=x.device)
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def _conv3x3(gray: torch.Tensor, kernel: tuple) -> torch.Tensor:
    """Valid-mode 3x3 cross-correlation over (B, H, W) -> (B, H-2, W-2)."""
    _, h, w = gray.shape
    out = None
    for a, row in enumerate(kernel):
        for b, tap in enumerate(row):
            if tap == 0.0:
                continue
            term = gray[:, a:a + h - 2, b:b + w - 2]
            term = term if tap == 1.0 else term * tap
            out = term if out is None else out + term
    return out


def laplacian_blur_scores(images: torch.Tensor) -> torch.Tensor:
    """Variance of the Laplacian per image (higher = sharper), the
    statistic of ``cv2.Laplacian(gray, CV_64F).var()``."""
    lap = _conv3x3(rgb_to_gray(images), _LAPLACIAN)
    mean = lap.mean(dim=(1, 2), keepdim=True)
    return ((lap - mean) ** 2).mean(dim=(1, 2))


def edge_density_scores(
    images: torch.Tensor, low: float = 50.0, high: float = 150.0
) -> torch.Tensor:
    """Fraction of pixels with strong gradients: Sobel magnitude at or above
    ``high`` counts 1, in ``[low, high)`` 0.5 (the reference's stand-in for
    Canny's hysteresis), below 0."""
    gray = rgb_to_gray(images)
    gx = _conv3x3(gray, _SOBEL_X)
    gy = _conv3x3(gray, _SOBEL_Y)
    mag = torch.sqrt(gx * gx + gy * gy)
    strong = (mag >= high).float()
    weak = ((mag >= low) & (mag < high)).float()
    return (strong + 0.5 * weak).mean(dim=(1, 2))


def quality_metrics(images: torch.Tensor) -> dict[str, torch.Tensor]:
    """Both metrics of (B, H, W, 3) pixels in [0, 255]."""
    return {
        "blur": laplacian_blur_scores(images),
        "edges": edge_density_scores(images),
    }


def adaptive_quality_mask(
    blur: torch.Tensor,
    edges: torch.Tensor,
    blur_drop_percentile: float = 10.0,
    edge_drop_percentile: float = 10.0,
) -> torch.Tensor:
    """Keep mask: a frame survives if it is at or above the p-th percentile
    (linear interpolation, as ``jnp.percentile``) of BOTH metrics."""
    blur_thr = torch.quantile(blur.float(), blur_drop_percentile / 100.0)
    edge_thr = torch.quantile(edges.float(), edge_drop_percentile / 100.0)
    return (blur >= blur_thr) & (edges >= edge_thr)
