"""Fused multi-head attention for the ViT towers (kernel B3).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ops/attention.py``.
:func:`fused_mha` takes the separate q/k/v projections ``(B, T, D)`` and
returns ``(B, T, D)``, with no mask. Per head: ``softmax(q.k^T * dh^-1/2)``
in f32, the weights rounded to the input dtype, ``. v`` accumulated in f32.
Heads are sliced by column offset inside the kernel (``csrc/mha.cu``: bf16
on the tensor cores with K/V of a head staged once per image and the scores
kept in registers, or past 272 keys two passes on ``wgmma`` over a TMA ring;
f32 on the CUDA cores), so no head transpose reaches device memory.
:func:`mha_plan` says which bf16 variant a shape takes. The bf16 kernels read
only 16-byte aligned inputs with heads a multiple of 8 wide: the wrapper
copies a view at an odd offset and pads other heads with zero columns
(:func:`_pad_heads`), which no tower of the port needs.

Dispatch depends only on where the tensors live: CPU tensors take the plain
:func:`_einsum_attention`; CUDA tensors launch the kernel or raise. The
backward is the plain einsum recomputed from q, k, v, as the reference's
custom VJP does (the TPU kernel has no backward either).

Spans (:mod:`..trace`): ``attn.b3`` (``batch``, ``tokens``, ``dim``,
``heads``, and the ``variant`` the launch takes as the library names it: a
bf16 variant of :func:`mha_plan`, or ``f32``) around each launch of the
kernel, so a reader of the device trace has each launch's shape.
"""

from __future__ import annotations

import ctypes

import torch

from .. import trace
from . import kernels

__all__ = ["fused_mha", "fused_mha_qkv", "mha_plan"]

# per-block shared memory an H100 grants (227 KB)
_MAX_SMEM = 232_448

# keys the bf16 kernel's register-resident score tile takes (136 registers
# a thread); longer sequences take a two-pass variant
_MAX_REG_KEYS = 272
# the two-pass `wgmma` variant: query rows an item (three warpgroups of 64),
# keys a score tile, keys and stages of its ring, warps a block
_WG_ROWS = 192
_WG_KEYS = 64
_WG_STAGE_KEYS = 128
_WG_STAGES = 2
_WG_WARPS = 13
# ivars_mha_variant's codes
_VARIANTS = ("registers", "wgmma", "f32")


def mha_plan(t: int, head_dim: int, blocks: int = 1, sm_count: int = 132) -> dict:
    """Which bf16 variant of ``csrc/mha.cu`` runs a sequence of ``t`` tokens
    (chosen as the C entry point does, by ``t`` alone; on the card the
    library's own answer, ``ivars_mha_variant``, is what the ``attn.b3`` span
    names, and the card tests hold the two together) and what it needs:
    ``head_dim``, the width the kernel runs each head at (the given one padded
    to a multiple of 8, as :func:`fused_mha` pads it); ``registers`` (one
    block per head and image, scores in ``frags`` accumulator fragments of 8
    keys) up to 272 padded keys; beyond, ``wgmma`` (persistent blocks walking
    ``blocks_per_head`` items of 192 query rows per head and image, two
    passes over ring stages of 128 keys loaded by TMA); ``smem_bytes`` of
    dynamic shared memory per block (``registers``: K and V rows of the head
    padded to a multiple of 32, plus 8; ``wgmma``: two buffers of the block's
    Q and the ring, in boxes of 64 columns); ``warps`` per block for a launch
    of ``blocks`` = heads x images on a card of ``sm_count`` multiprocessors
    (the C entry point asks the device for its count; 132 is an H100's): one
    per 16-row query tile up to eight, four where the long register tile
    meets a grid more than two blocks a multiprocessor deep; ``wgmma`` three
    warpgroups and a producer warp."""
    if t <= 0 or not 0 < head_dim <= 128 or blocks <= 0 or sm_count <= 0:
        raise ValueError(f"mha_plan: t={t}, head_dim={head_dim}, blocks={blocks}, "
                         f"sm_count={sm_count}")
    width = -(-head_dim // 8) * 8
    t_pad = -(-t // 16) * 16
    if t_pad > _MAX_REG_KEYS:
        # two buffers of Q (64 rows x 64 columns a box, three warpgroups) and
        # the ring (K and V of 128 keys a stage), 1 KB of alignment, barriers
        boxes = 1 if width <= 64 else 2
        smem = (1024 + boxes * (2 * 3 * 64 * 128 + _WG_STAGES * 2 * _WG_STAGE_KEYS * 128)
                + 8 * (2 * _WG_STAGES + 4))
        return {"variant": "wgmma", "head_dim": width, "frags": _WG_KEYS // 8,
                "blocks_per_head": -(-t // _WG_ROWS), "warps": _WG_WARPS, "smem_bytes": smem}
    ld = -(-width // 32) * 32 + 8
    frags = 8 if t_pad <= 64 else 16 if t_pad <= 128 else _MAX_REG_KEYS // 8
    warps = 4 if t_pad > 128 and blocks > 2 * sm_count else min(t_pad // 16, 8)
    return {"variant": "registers", "head_dim": width, "frags": frags, "blocks_per_head": 1,
            "warps": warps, "smem_bytes": 2 * t_pad * ld * 2}


def _einsum_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain formulation of the kernel's math (f32 scores and softmax,
    weights and output in the input dtype); ``scale`` is ``head_dim ** -0.5``
    unless given (heads padded wider keep their true one)."""
    b, t, d = q.shape
    head_dim = d // num_heads
    if scale is None:
        scale = head_dim ** -0.5

    def split(x):
        return x.reshape(b, t, num_heads, head_dim)

    qm, km, vm = split(q * scale), split(k), split(v)
    scores = torch.einsum("bqhd,bkhd->bhqk", qm.float(), km.float())
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), vm.float())
    return out.to(q.dtype).reshape(b, t, d)


def _pad_heads(x: torch.Tensor, num_heads: int, width: int) -> torch.Tensor:
    """(B, T, heads x dh) -> (B, T, heads x ``width``): each head's columns
    padded with zeros to ``width``, or cut back to it where it is narrower."""
    b, t, d = x.shape
    heads = torch.nn.functional.pad(x.reshape(b, t, num_heads, d // num_heads),
                                    (0, width - d // num_heads))
    return heads.reshape(b, t, num_heads * width)


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
    code, bf16 = codes[q.dtype], q.dtype == torch.bfloat16
    # the bf16 kernels' contract (csrc/mha.cu): heads a multiple of 8 wide
    # (zero columns added, the true head dim kept for the scale) and data on
    # a 16-byte boundary (a view at an odd offset: a fresh copy aligns)
    width = -(-head_dim // 8) * 8 if bf16 else head_dim

    def ready(x):
        x = x.contiguous()
        if width != head_dim:
            return _pad_heads(x, num_heads, width)
        return x.clone() if bf16 and x.data_ptr() % 16 else x

    q, k, v = ready(q), ready(k), ready(v)
    out = torch.empty_like(q)
    smem = lib.ivars_mha_smem_bytes(t, width, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_mha: T={t} needs {smem} B of shared memory "
                         f"(limit {_MAX_SMEM})")
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, out)]
    # the kernel the launch below takes, as the library chooses it
    variant = _VARIANTS[lib.ivars_mha_variant(b, t, num_heads * width, num_heads, code)]
    with trace.span("attn.b3", batch=b, tokens=t, dim=d, heads=num_heads,
                    variant=variant), torch.cuda.device(q.device):
        rc = lib.ivars_mha_fwd(*ptrs, b, t, num_heads * width, num_heads, head_dim, code,
                               kernels.stream_of(q))
    kernels.check_launch(rc, "mha_fwd")
    fused_mha.launches += 1
    return out if width == head_dim else _pad_heads(out, num_heads, head_dim)


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
