"""Fused multi-head attention for the ViT towers (kernel B3).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/attention.py``.
:func:`fused_mha` takes the separate q/k/v projections ``(B, T, D)`` and
returns ``(B, T, D)``, with no mask. Per head: ``softmax(q.k^T * dh^-1/2)``
in f32, the weights rounded to the input dtype, ``. v`` accumulated in f32.
Heads are sliced by column offset inside the kernel (``csrc/mha.cu``: bf16
on the tensor cores, f32 on the CUDA cores), so no head transpose reaches
device memory.

Dispatch depends only on where the tensors live: CPU tensors take the plain
:func:`_einsum_attention`; CUDA tensors launch the kernel or raise. The
backward is the plain einsum recomputed from q, k, v, as the reference's
custom VJP does (the TPU kernel has no backward either).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

__all__ = ["fused_mha", "fused_mha_qkv"]

# per-block shared memory an H100 grants (227 KB)
_MAX_SMEM = 232_448


def _einsum_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain formulation of the kernel's math (f32 scores and softmax,
    weights and output in the input dtype)."""
    b, t, d = q.shape
    head_dim = d // num_heads
    scale = head_dim ** -0.5

    def split(x):
        return x.reshape(b, t, num_heads, head_dim)

    qm, km, vm = split(q * scale), split(k), split(v)
    scores = torch.einsum("bqhd,bkhd->bhqk", qm.float(), km.float())
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), vm.float())
    return out.to(q.dtype).reshape(b, t, d)


def _mha_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    b, t, d = q.shape
    codes = {torch.bfloat16: 0, torch.float32: 1}
    if q.dtype not in codes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_mha: unsupported dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_mha: shapes {q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_mha: q, k, v on different devices")
    head_dim = d // num_heads
    if d % num_heads or head_dim > 128:
        raise ValueError(f"fused_mha: head dim {d}/{num_heads} must be whole "
                         "and at most 128")
    lib = kernels.load()
    smem = lib.ivars_mha_smem_bytes(t, head_dim, codes[q.dtype])
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_mha: T={t} needs {smem} B of shared memory "
                         f"(limit {_MAX_SMEM})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.ivars_mha_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, t, d, num_heads, codes[q.dtype], kernels.stream_of(q),
        )
    kernels.check_launch(rc, "mha_fwd")
    fused_mha.launches += 1
    return out


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return _einsum_attention(q, k, v, num_heads)
        if q.device.type != "cuda":
            raise ValueError(f"fused_mha: unsupported device {q.device}")
        return _mha_kernel(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        # einsum recompute (the reference's _fused_mha_bwd): residuals are
        # q, k, v only; no (T, T) weights are saved by the forward
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = _einsum_attention(qd, kd, vd, ctx.num_heads)
            gq, gk, gv = torch.autograd.grad(out, (qd, kd, vd), g)
        return gq, gk, gv, None


def fused_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """(B, T, D) q/k/v projections -> (B, T, D) attention output (no mask).

    Forward: kernel B3 on a card (count in ``fused_mha.launches``), the
    plain einsum on the CPU. Differentiable through the einsum recompute.
    """
    return _FusedMHA.apply(q, k, v, num_heads)


fused_mha.launches = 0


def fused_mha_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Compatibility wrapper: (B, T, 3D) fused QKV -> (B, T, D)."""
    d = qkv.shape[-1] // 3
    return fused_mha(
        qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads
    )
