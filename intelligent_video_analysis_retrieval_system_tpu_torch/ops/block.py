"""Fused LayerNorm + MLP residual half-block for the ViT towers (kernel B4).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/block.py``.
The second half of every pre-LN transformer block is

    x + fc2(act(fc1(LN(x))))

which eager PyTorch runs as a chain of launches (LN, GEMM, activation,
GEMM, add) with the ``(B, T, 4D)`` hidden activation written to and read
back from device memory between the two products. :func:`fused_ln_mlp`
runs the whole half-block in one kernel (``csrc/ln_mlp.cu``: bf16 on the
tensor cores, f32 on the CUDA cores); the hidden activation never reaches
device memory.

Rounding points, shared by the kernel and its plain version
:func:`fused_ln_mlp_reference`: LN statistics (two passes, biased variance),
``rsqrt(var + eps)`` and the affine in f32, the LN output rounded to
``x.dtype``; fc1 accumulated in f32, ``+ b1`` in f32, rounded to
``x.dtype``; the activation evaluated in ``x.dtype``; fc2 accumulated in f32
onto ``x_f32 + b2``; one rounding at the end.

Weights are taken as ``nn.Linear`` holds them, ``w1 = fc1.weight`` of shape
``(H, D)`` and ``w2 = fc2.weight`` of shape ``(D, H)`` (the JAX function
takes the transposed Flax layout), so nothing is transposed per call.

Dispatch depends only on where ``x`` lives: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Forward only, as the
TPU kernel is: ``models.clip.TransformerBlock`` takes its unfused modules
whenever autograd is recording.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels

__all__ = [
    "ACTIVATIONS",
    "activation",
    "fused_ln_mlp",
    "fused_ln_mlp_reference",
    "supports_fused_ln_mlp",
]

ACTIVATIONS = ("quick_gelu", "gelu", "gelu_tanh")

# the kernel keeps the (tokens, D) f32 accumulator in registers
_MAX_D = 1024


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # the logistic spelled out with constants of x's dtype, as the TPU
    # kernel has it: every step rounds to x.dtype
    one = torch.ones((), dtype=x.dtype, device=x.device)
    c = torch.full((), 1.702, dtype=x.dtype, device=x.device)
    return x / (one + torch.exp(-c * x))


def activation(name: str):
    """The half-block's activation by name, evaluated in its argument's
    dtype: ``quick_gelu`` (CLIP), ``gelu`` (erf; HF ViT/DINO), ``gelu_tanh``."""
    if name == "quick_gelu":
        return _quick_gelu
    if name == "gelu":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def supports_fused_ln_mlp(d: int, hidden: int, act: str) -> bool:
    """Shape/act gate of the JAX package (``d % 128 == 0``,
    ``hidden % 256 == 0``, a known activation), and ``d <= 1024``: this
    kernel's accumulator tile lives in registers."""
    return act in ACTIVATIONS and d % 128 == 0 and hidden % 256 == 0 and d <= _MAX_D


def fused_ln_mlp_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    act: str = "quick_gelu",
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of kernel B4 with its rounding points (see the module
    docstring). The products of values of ``x.dtype`` are taken in f32, as
    the tensor cores accumulate them."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    ln = ((xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    pre = (ln.float() @ w1.to(dt).float().T + b1.float()).to(dt)
    a = activation(act)(pre)
    return (xf + b2.float() + a.float() @ w2.to(dt).float().T).to(dt)


_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _ln_mlp_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps) -> torch.Tensor:
    d = x.shape[-1]
    hidden = w1.shape[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_ln_mlp: unsupported dtype {x.dtype}")
    if not supports_fused_ln_mlp(d, hidden, act):
        raise ValueError(f"fused_ln_mlp: d={d}, hidden={hidden}, act={act!r} "
                         f"(needs d % 128 == 0, d <= {_MAX_D}, hidden % 256 == 0, "
                         f"act in {ACTIVATIONS})")
    if x.numel() == 0:
        raise ValueError("fused_ln_mlp: empty input")
    tensors = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_ln_mlp: arguments on different devices")
    x = x.contiguous()
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    g, beta, fb1, fb2 = (t.float().contiguous() for t in (ln_scale, ln_bias, b1, b2))
    out = torch.empty_like(x)
    lib = kernels.load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(x.device):
        rc = lib.ivars_ln_mlp(
            ptr(x.data_ptr()), ptr(g.data_ptr()), ptr(beta.data_ptr()),
            ptr(w1.data_ptr()), ptr(fb1.data_ptr()), ptr(w2.data_ptr()),
            ptr(fb2.data_ptr()), ptr(out.data_ptr()),
            x.numel() // d, d, hidden, float(eps), ACTIVATIONS.index(act),
            _DTYPE_CODES[x.dtype], kernels.stream_of(x),
        )
    kernels.check_launch(rc, "ln_mlp")
    fused_ln_mlp.launches += 1
    return out


def fused_ln_mlp(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    act: str = "quick_gelu",
    eps: float = 1e-5,
) -> torch.Tensor:
    """``x + fc2(act(fc1(LN(x))))`` per token, the hidden activation never
    in device memory.

    ``x``: ``(..., D)``; ``w1``: ``(H, D)`` and ``w2``: ``(D, H)``
    (``nn.Linear`` layout), cast to ``x.dtype`` if they are not in it;
    ``ln_scale``, ``ln_bias``, ``b1``, ``b2`` are used in f32. Kernel B4 on
    a card (count in ``fused_ln_mlp.launches``), the plain version on the
    CPU. Not differentiable.
    """
    d = x.shape[-1]
    if (w1.ndim != 2 or w1.shape[1] != d or w2.shape != (d, w1.shape[0])
            or ln_scale.shape != (d,) or ln_bias.shape != (d,)
            or b1.shape != (w1.shape[0],) or b2.shape != (d,)):
        raise ValueError(
            f"fused_ln_mlp: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: unsupported device {x.device}")
    return _ln_mlp_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, act, eps)


fused_ln_mlp.launches = 0
