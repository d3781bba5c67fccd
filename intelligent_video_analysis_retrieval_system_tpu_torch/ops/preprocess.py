"""Image preprocessing for the vision towers: resize, crop, normalize (NHWC).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/preprocess.py``.
Resizing is two matmuls against separable interpolation matrices (built
on the host by the same construction as the reference's
``_interp_matrix``). Normalization is kernel B5 (``csrc/normalize.cu``):
:func:`normalize_images` dispatches only on where the tensor lives, a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version
:func:`normalize_images_reference`. Both compute what the TPU kernel
computes, in its order of operations (multiply by the f32 reciprocals of
255 and of std), and agree bit for bit.

The JAX callers pass ``use_pallas=False`` because XLA fuses the elementwise
chain inside their one jitted program anyway. Eager PyTorch runs the chain
as five launches with four round trips through device memory, so the port
has one normalize on the card, the kernel, and no ``use_pallas`` /
``interpret`` arguments.

Each tower family brings its processor's constants (``CLIPConfig`` and
``SiglipConfig``'s ``image_mean``, ``image_std`` and ``center_crop``): CLIP
resizes the shortest side and crops the center with OpenAI's mean and std,
SigLIP resizes straight to the square input with mean and std 0.5.
:func:`fit_image` is the same resize on the host, for decoded files.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

__all__ = [
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
    "resize_bilinear",
    "center_crop",
    "fit_image",
    "normalize_images",
    "normalize_images_reference",
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


def _normalize_constants(mean: tuple, std: tuple) -> tuple[np.ndarray, np.ndarray]:
    """f32 mean and f32 reciprocal of std (the reciprocal taken in double
    and rounded once, as the TPU kernel's inlined immediates are)."""
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("normalize_images: mean and std must have 3 channels")
    m = np.asarray(mean, np.float64).astype(np.float32)
    inv_s = (1.0 / np.asarray(std, np.float64)).astype(np.float32)
    return m, inv_s


def normalize_images_reference(
    images: torch.Tensor,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of kernel B5, with its arithmetic: ``(x * (1/255) -
    mean_c) * (1/std_c)`` in f32, three roundings, then one to ``dtype``."""
    m, inv_s = _normalize_constants(mean, std)
    dev = images.device
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=dev)
    x = images.float() * inv255
    x = x - torch.from_numpy(m).to(dev)
    return (x * torch.from_numpy(inv_s).to(dev)).to(dtype)


_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _normalize_kernel(images: torch.Tensor, mean: tuple, std: tuple,
                      dtype: torch.dtype) -> torch.Tensor:
    if images.dtype not in _IN_CODES:
        raise TypeError(f"normalize_images: input dtype {images.dtype} "
                        "(the kernel takes uint8 and float32)")
    if dtype not in _OUT_CODES:
        raise TypeError(f"normalize_images: output dtype {dtype} "
                        "(the kernel writes bfloat16 and float32)")
    if images.ndim < 1 or images.shape[-1] != 3 or images.numel() == 0:
        raise ValueError(f"normalize_images: shape {tuple(images.shape)} "
                         "(channels last, 3 of them, not empty)")
    m, inv_s = _normalize_constants(mean, std)
    images = images.contiguous()
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    lib = kernels.load()
    with torch.cuda.device(images.device):
        rc = lib.ivars_normalize(
            ctypes.c_void_p(images.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            images.numel(), _IN_CODES[images.dtype], _OUT_CODES[dtype],
            float(m[0]), float(m[1]), float(m[2]),
            float(inv_s[0]), float(inv_s[1]), float(inv_s[2]),
            kernels.stream_of(images),
        )
    kernels.check_launch(rc, "normalize")
    normalize_images.launches += 1
    return out


def normalize_images(
    images: torch.Tensor,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, W, 3) pixel values in [0, 255] -> normalized ``dtype`` NHWC.

    Kernel B5 on a card (uint8 or float32 in, bfloat16 or float32 out;
    count in ``normalize_images.launches``), the plain version on the CPU."""
    if images.device.type == "cpu":
        return normalize_images_reference(images, mean, std, dtype)
    if images.device.type != "cuda":
        raise ValueError(f"normalize_images: unsupported device {images.device}")
    return _normalize_kernel(images, mean, std, dtype)


normalize_images.launches = 0


def _resized_shape(h: int, w: int, size: int, crop: bool) -> tuple[int, int]:
    """(height, width) before the crop: the shortest side to ``size`` where
    the processor crops, else the square itself."""
    if not crop:
        return size, size
    if h <= w:
        return size, max(size, round(w * size / h))
    return max(size, round(h * size / w)), size


def preprocess_images(
    images: torch.Tensor,
    image_size: int = 224,
    dtype: torch.dtype = torch.bfloat16,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    crop: bool = True,
) -> torch.Tensor:
    """Resize (bicubic, antialiased) -> center crop -> normalize. (B, H, W,
    3) in [0, 255] -> (B, size, size, 3) ``dtype``. ``crop``: the shortest
    side to ``image_size``, then the center (CLIP); else straight to the
    square (SigLIP)."""
    _, h, w, _ = images.shape
    new_h, new_w = _resized_shape(h, w, image_size, crop)
    x = resize_bilinear(images, new_h, new_w, method="bicubic", antialias=True)
    x = center_crop(x, image_size)
    return normalize_images(x, mean, std, dtype=dtype)


def fit_image(img, size: int, crop: bool = True):
    """A PIL image resized (bicubic) as :func:`preprocess_images` resizes on
    the device, then center-cropped to ``size`` x ``size``."""
    from PIL import Image

    w, h = img.size
    nh, nw = _resized_shape(h, w, size, crop)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))
