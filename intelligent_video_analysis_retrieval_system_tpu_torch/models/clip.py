"""CLIP text + vision towers as PyTorch modules.

Port of ``intelligent_video_analysis_retrieval_system_tpu/models/clip.py``
(pre-LN ViT tower + causal text transformer, QuickGELU). Numerics follow the
Flax modules:

- parameters stay f32; every matmul runs in the model ``dtype`` (the f32
  weights cast at use, as ``nn.Dense(dtype=...)`` does); LayerNorm takes
  its statistics in f32 and casts its output to ``dtype``;
- ``precision="highest"`` is the f32 parity mode (explicit einsum
  attention with an f32 softmax); ``"default"`` is the throughput mode;
- unmasked attention (the vision tower) in throughput mode runs the fused
  kernel B3 (:func:`ops.attention.fused_mha`) when the activations live on
  a CUDA device, as the reference takes its Pallas kernel on a TPU; on the
  CPU it runs the same einsum the reference runs off-TPU;
- ``fused_mlp=True`` (off by default, as in the reference) runs the second
  half of every block, ``x + fc2(act(fc1(LN(x))))``, through the fused
  kernel B4 (:func:`ops.block.fused_ln_mlp`) in throughput mode, where the
  shapes pass :func:`ops.block.supports_fused_ln_mlp`. The parameters are
  the same modules either way, so one state dict serves both;
- ``w8a8=True`` runs every dense layer of the transformer blocks (q, k, v,
  out and the two MLP layers) in int8 (:func:`ops.quant.w8a8_dense`), the
  weights quantized per output channel from the f32 parameters, the
  activations per token; ``w8a8_static=True`` reads one calibrated scale per
  dense input instead (``models.calibrate``). A W8A8 block never takes
  ``fused_mlp``, as in the reference. Each W8A8 layer can record the
  ``max|x|`` of its input on the device (``models.calibrate`` turns it on),
  the reference's ``act_stats`` collection;
- ``int8_attn=True`` computes unmasked attention (the vision tower) with
  int8 QK^T and PV products; masked attention (the text tower) keeps the
  standard path, as in the reference.

Module and parameter names follow HF ``transformers.CLIPModel``'s state
dict, so ``models.convert`` maps between this port, HF checkpoints and the
Flax tree without renaming tables. The towers return the pooled hidden
state; :class:`CLIPModel` applies the projections (``text_projection``,
``visual_projection``), as HF does.

``remat=True`` runs every transformer block through activation
checkpointing (``torch.utils.checkpoint``, the reference's
``nn.remat(TransformerBlock)``) while autograd records: the block's
activations are recomputed in the backward pass, so B3 runs twice per layer
and step. Under ``no_grad`` or ``inference_mode`` it is the plain loop.
:func:`attention`, :func:`patch_embed` and :func:`run_blocks` are the
towers' pieces that ``parallel.train`` calls on each tensor-parallel shard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, ClassVar, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_mha
from ..ops.block import activation, fused_ln_mlp, supports_fused_ln_mlp
from ..ops.preprocess import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..ops.quant import quantize_weight_int8, symmetric_int8, w8a8_dense

__all__ = [
    "CLIPVisionConfig",
    "CLIPTextConfig",
    "CLIPConfig",
    "quick_gelu",
    "MultiHeadAttention",
    "TransformerBlock",
    "Transformer",
    "CLIPVisionTower",
    "CLIPTextTower",
    "CLIPModel",
    "attention",
    "patch_embed",
    "run_blocks",
]


# ---------------------------------------------------------------------------
# Configs (same fields and presets as the reference)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    projection_dim: int = 768

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        """Tokens through the blocks per image: the class token and the patches."""
        return self.num_patches + 1


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 768


@dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    logit_scale_init: float = 2.6592  # ln(1/0.07), CLIP's published init
    # HF CLIPImageProcessor: shortest side to the input size, center crop,
    # OpenAI's mean and std
    image_mean: ClassVar[tuple] = CLIP_IMAGE_MEAN
    image_std: ClassVar[tuple] = CLIP_IMAGE_STD
    center_crop: ClassVar[bool] = True

    @classmethod
    def vit_l_14(cls) -> "CLIPConfig":
        """openai/clip-vit-large-patch14."""
        return cls()

    @classmethod
    def vit_b_32(cls) -> "CLIPConfig":
        """openai/clip-vit-base-patch32."""
        return cls(
            vision=CLIPVisionConfig(
                patch_size=32, hidden_size=768, num_layers=12, num_heads=12,
                projection_dim=512,
            ),
            text=CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8,
                                projection_dim=512),
        )

    @classmethod
    def tiny_test(cls) -> "CLIPConfig":
        """Small config for unit tests."""
        return cls(
            vision=CLIPVisionConfig(
                image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                num_heads=4, projection_dim=32,
            ),
            text=CLIPTextConfig(
                vocab_size=512, max_length=16, hidden_size=48, num_layers=2,
                num_heads=4, projection_dim=32,
            ),
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class _CastCache:
    """Compute-dtype copies of f32 parameters, made once per parameter
    version. Numerically the same as casting at every use (the cast is
    deterministic); it spares the casts on every inference call. With
    autograd on, the cast is taken fresh so gradients reach the f32
    parameter."""

    def __init__(self) -> None:
        self._hits: dict[str, tuple[tuple, torch.Tensor]] = {}

    def get(self, name: str, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if p.dtype == dtype:
            return p
        if torch.is_grad_enabled() and p.requires_grad:
            return p.to(dtype)
        key = (dtype, p._version, p.data_ptr(), p.device)
        hit = self._hits.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(dtype))
            self._hits[name] = hit
        return hit[1]


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters and compute in the input's dtype
    (Flax ``nn.Dense(dtype=...)`` semantics).

    ``w8a8``: the layer runs :func:`ops.quant.w8a8_dense` instead, its int8
    weight and scales quantized from the f32 parameter and cached by the
    rule of :class:`_CastCache` (the parameter's version, pointer and
    device; never from the compute-dtype copy). ``w8a8_static``: the input
    is quantized with ``act_scale`` (a 0-d f32 tensor set by
    ``models.calibrate.set_act_scales``; the reference's placeholder 1/127
    until then). While ``recording`` (``models.calibrate.record_act_stats``)
    every call folds ``max|x|`` in f32 into ``amax``, a 0-d tensor on the
    device, with no sync to the host."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 w8a8: bool = False, w8a8_static: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self._cast = _CastCache()
        self.w8a8 = w8a8
        self.w8a8_static = w8a8_static
        self.act_scale: torch.Tensor | None = None
        self.recording = False
        self.amax: torch.Tensor | None = None
        self._q: tuple[tuple, tuple[torch.Tensor, torch.Tensor]] | None = None

    def _qweight(self) -> tuple[torch.Tensor, torch.Tensor]:
        p = self.weight
        # an inference tensor keeps no version counter (nor can it change
        # outside inference mode)
        key = (None if p.is_inference() else p._version, p.data_ptr(), p.device)
        if self._q is None or self._q[0] != key:
            self._q = (key, quantize_weight_int8(p))
        return self._q[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w8a8:
            if self.recording:
                amax = x.detach().float().abs().amax()
                self.amax = amax if self.amax is None else torch.maximum(self.amax, amax)
            a_scale = None
            if self.w8a8_static:
                a_scale = self.act_scale if self.act_scale is not None else 1.0 / 127.0
            return w8a8_dense(x, self.weight, self.bias, out_dtype=x.dtype,
                              a_scale=a_scale, qweight=self._qweight())
        w = self._cast.get("weight", self.weight, x.dtype)
        b = None if self.bias is None else self._cast.get("bias", self.bias, x.dtype)
        return F.linear(x, w, b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics and f32 affine, output in the input's
    dtype (Flax ``nn.LayerNorm(dtype=...)`` with f32 params)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


def _int_bmm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Batched product of int8-valued tensors, exact, as f32: an f32 ``bmm``
    with full-precision f32 products forced (TF32 would round the operands).
    Every partial sum is an integer below 2^24 (at most 64 * 127^2 for QK^T
    at head width 64, 257 * 127^2 for PV at 257 tokens), so f32 holds it
    exactly in any order of summation: the integers of an int8 x int8 ->
    int32 product, which torch has no batched op for."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.bmm(a8.float(), b8.float())
    finally:
        torch.set_float32_matmul_precision(prev)


class MultiHeadAttention(nn.Module):
    """Self-attention with HF names (``q_proj``/``k_proj``/``v_proj``/
    ``out_proj``) and the reference's modes: the HIGHEST-parity einsum, the
    throughput einsum, fused kernel B3 for unmasked attention on a CUDA
    device, and int8 attention (``int8_attn``, unmasked only). ``w8a8``
    makes the four projections W8A8 layers."""

    def __init__(self, dim: int, num_heads: int, precision: str = "default",
                 fused_attn: bool = True, w8a8: bool = False,
                 w8a8_static: bool = False, int8_attn: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.precision = precision
        self.fused_attn = fused_attn
        self.int8_attn = int8_attn
        self.q_proj = Dense(dim, dim, w8a8=w8a8, w8a8_static=w8a8_static)
        self.k_proj = Dense(dim, dim, w8a8=w8a8, w8a8_static=w8a8_static)
        self.v_proj = Dense(dim, dim, w8a8=w8a8, w8a8_static=w8a8_static)
        self.out_proj = Dense(dim, dim, w8a8=w8a8, w8a8_static=w8a8_static)

    def _int8_attention(self, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
        """The reference's int8 attention: Q (scaled by dh^-1/2) and K
        quantized per token, V per (head, column); softmax in f32; the
        probabilities quantized with the fixed scale 1/127."""
        b, t, d = q.shape
        h = self.num_heads
        head_dim = d // h

        def merge(y):
            return y.reshape(b, t, h, head_dim).transpose(1, 2).reshape(b * h, t, head_dim)

        qm, km, vm = merge(q), merge(k), merge(v)
        q8, qs = symmetric_int8(qm * head_dim ** -0.5, dim=-1)    # (bh, t, 1)
        k8, ks = symmetric_int8(km, dim=-1)                        # (bh, t, 1)
        logits = _int_bmm(q8, k8.transpose(1, 2)) * qs * ks.transpose(1, 2)
        weights = torch.softmax(logits, dim=-1)
        p8 = torch.round(weights * 127.0).to(torch.int8)
        v8, vs = symmetric_int8(vm, dim=1)                         # (bh, 1, hd)
        out = _int_bmm(p8, v8) * (vs * (1.0 / 127.0))
        return out.to(q.dtype).reshape(b, h, t, head_dim).transpose(1, 2).reshape(b, t, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.int8_attn and mask is None:
            return self.out_proj(self._int8_attention(q, k, v))
        return self.out_proj(attention(q, k, v, self.num_heads, mask, self.precision,
                                       self.fused_attn))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              mask: torch.Tensor | None = None, precision: str = "default",
              fused_attn: bool = True) -> torch.Tensor:
    """(B, T, D) q/k/v projections -> (B, T, D) attention output, before
    ``out_proj``: kernel B3 for unmasked throughput-mode attention on a
    CUDA device (with ``fused_attn``), else the reference's einsums."""
    b, t, d = q.shape
    h = num_heads
    head_dim = d // h
    scale = head_dim ** -0.5
    if fused_attn and mask is None and precision != "highest" and q.device.type == "cuda":
        return fused_mha(q, k, v, h)
    if precision == "highest":
        # parity mode: f32 logits (+ mask), f32 softmax
        qh, kh, vh = (y.reshape(b, t, h, head_dim) for y in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * scale, kh).float()
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    else:
        # throughput mode: (B*H, T, T) batched GEMMs, logits in the model
        # dtype, f32 softmax
        def merge(y):
            return y.reshape(b, t, h, head_dim).transpose(1, 2).reshape(b * h, t, head_dim)

        logits = torch.bmm(merge(q) * scale, merge(k).transpose(1, 2))
        if mask is not None:
            logits = logits + mask.reshape(1, t, t).to(logits.dtype)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.bmm(weights, merge(v))
        out = out.reshape(b, h, t, head_dim).transpose(1, 2)
    return out.reshape(b, t, d)


def _activation(name: str):
    """The unfused chain's activation by name (the reference's
    ``_activation``): CLIP's sigmoid form of QuickGELU, else the fused
    half-block's own (``gelu``: exact, HF ViT/DINO's default; ``gelu_tanh``)."""
    return quick_gelu if name == "quick_gelu" else activation(name)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str = "quick_gelu",
                 w8a8: bool = False, w8a8_static: bool = False) -> None:
        super().__init__()
        self.act = _activation(act)
        self.fc1 = Dense(dim, hidden, w8a8=w8a8, w8a8_static=w8a8_static)
        self.fc2 = Dense(hidden, dim, w8a8=w8a8, w8a8_static=w8a8_static)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN residual block, HF ``CLIPEncoderLayer`` names: attention, then
    the MLP half (LN -> fc1 -> act -> fc2 -> residual), either as the
    unfused chain or, with ``fused_mlp``, through kernel B4. ``mlp_dim`` is
    the MLP's width (CLIP and DINO: ``dim * mlp_ratio``; SigLIP's 4,304 is
    no multiple of its 1,152)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 precision: str = "default", act: str = "quick_gelu",
                 ln_eps: float = 1e-5, fused_attn: bool = True,
                 fused_mlp: bool = False, w8a8: bool = False,
                 w8a8_static: bool = False, int8_attn: bool = False) -> None:
        super().__init__()
        self.act = act
        self.layer_norm1 = LayerNorm(dim, eps=ln_eps)
        self.self_attn = MultiHeadAttention(dim, num_heads, precision, fused_attn,
                                            w8a8=w8a8, w8a8_static=w8a8_static,
                                            int8_attn=int8_attn)
        self.layer_norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = _MLP(dim, mlp_dim, act, w8a8=w8a8, w8a8_static=w8a8_static)
        # the reference's gate: opt-in, throughput mode, shapes the kernel
        # takes; a W8A8 block returns before it
        self.fused_mlp = (fused_mlp and not w8a8 and precision != "highest"
                          and supports_fused_ln_mlp(dim, mlp_dim, act))

    def _fused_mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        # the weights in the compute dtype come from the Dense layers' own
        # caches, in nn.Linear's layout, which is the one the kernel reads
        ln, fc1, fc2 = self.layer_norm2, self.mlp.fc1, self.mlp.fc2
        return fused_ln_mlp(
            x, ln.weight, ln.bias,
            fc1._cast.get("weight", fc1.weight, x.dtype), fc1.bias,
            fc2._cast.get("weight", fc2.weight, x.dtype), fc2.bias,
            act=self.act, eps=ln.eps,
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        # the kernel is forward only (the TPU kernel has no backward either):
        # whenever autograd is recording, the unfused modules run
        if self.fused_mlp and not torch.is_grad_enabled():
            return self._fused_mlp_half(x)
        return x + self.mlp(self.layer_norm2(x))


def run_blocks(blocks: Sequence[Callable], x: torch.Tensor, mask: torch.Tensor | None,
               remat: bool) -> torch.Tensor:
    """``x = block(x, mask)`` for each block in turn; with ``remat``, while
    autograd records, each block runs under activation checkpointing, so
    the backward pass recomputes its activations (B3 included) instead of
    keeping them."""
    for block in blocks:
        if remat and torch.is_grad_enabled():
            # the blocks draw no random numbers: no RNG state to replay
            x = checkpoint(block, x, mask, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, mask)
    return x


class Transformer(nn.Module):
    """A stack of blocks under HF's ``encoder.layers`` name."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, mlp_dim: int,
                 precision: str = "default", fused_attn: bool = True,
                 remat: bool = False, act: str = "quick_gelu",
                 ln_eps: float = 1e-5, fused_mlp: bool = False, w8a8: bool = False,
                 w8a8_static: bool = False, int8_attn: bool = False) -> None:
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_dim, precision, act=act,
                             ln_eps=ln_eps, fused_attn=fused_attn,
                             fused_mlp=fused_mlp, w8a8=w8a8,
                             w8a8_static=w8a8_static, int8_attn=int8_attn)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        return run_blocks(self.layers, x, mask, self.remat)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


class _PatchEmbed(nn.Module):
    """Stride == kernel patch conv as reshape + one GEMM (the reference's
    ``_PatchEmbedMatmul``), holding HF's conv weight ``(D, 3, p, p)``. A
    matmul also keeps cuDNN's TF32 convolutions out of the f32 mode.
    ``bias``: HF ViT's projection has one (DINO), CLIP's has none."""

    def __init__(self, hidden: int, patch: int, bias: bool = False) -> None:
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(hidden, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(hidden)) if bias else None
        self._cast = _CastCache()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = patch_embed(pixels, self._cast.get("weight", self.weight, pixels.dtype))
        if self.bias is None:
            return x
        return x + self._cast.get("bias", self.bias, pixels.dtype)


def patch_embed(pixels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels x HF's conv weight ``(D, 3, p, p)`` (in the
    pixels' dtype) -> (B, patches, D), without bias. As the stride-p
    convolution without padding, rows and columns past the last whole patch
    are dropped (SigLIP's 384 px are 27 patches of 14 and 6 px)."""
    p = weight.shape[-1]
    b, h, w, c = pixels.shape                       # NHWC
    gh, gw = h // p, w // p
    x = pixels[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    # (D, c, p, p) -> (p, p, c, D): the (p_h, p_w, c) order of the patch
    return x @ weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig) -> None:
        super().__init__()
        self.patch_embedding = _PatchEmbed(cfg.hidden_size, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size)


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) normalized pixels -> (B, hidden) pooled CLS state
    (post-LN, before ``visual_projection``)."""

    def __init__(self, cfg: CLIPVisionConfig, precision: str = "default",
                 fused_attn: bool = True, fused_mlp: bool = False, w8a8: bool = False,
                 w8a8_static: bool = False, int8_attn: bool = False,
                 remat: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=1e-5)  # HF's spelling
        self.encoder = Transformer(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.hidden_size * cfg.mlp_ratio, precision, fused_attn,
                                   remat=remat, fused_mlp=fused_mlp, w8a8=w8a8,
                                   w8a8_static=w8a8_static, int8_attn=int8_attn)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = self.embeddings
        x = emb.patch_embedding(pixels.to(dtype))                   # (B, P, D)
        cls = emb.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight.to(dtype)[None]
        x = self.encoder(self.pre_layrnorm(x))
        return self.post_layernorm(x[:, 0])


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class CLIPTextTower(nn.Module):
    """(B, T) token ids -> (B, hidden) state at the EOT token (causal
    transformer, final LN, before ``text_projection``)."""

    def __init__(self, cfg: CLIPTextConfig, precision: str = "default",
                 fused_attn: bool = True, fused_mlp: bool = False, w8a8: bool = False,
                 w8a8_static: bool = False, int8_attn: bool = False,
                 remat: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = Transformer(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.hidden_size * cfg.mlp_ratio, precision, fused_attn,
                                   remat=remat, fused_mlp=fused_mlp, w8a8=w8a8,
                                   w8a8_static=w8a8_static, int8_attn=int8_attn)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, token_ids: torch.Tensor, dtype: torch.dtype,
                eot_positions: torch.Tensor | None = None) -> torch.Tensor:
        emb = self.embeddings
        t = token_ids.shape[1]
        x = emb.token_embedding.weight[token_ids.long()].to(dtype)
        x = x + emb.position_embedding.weight[:t].to(dtype)[None]
        # causal mask, additive -inf above the diagonal
        mask = torch.triu(
            torch.full((t, t), float("-inf"), device=x.device), diagonal=1
        )[None, None]
        x = self.final_layer_norm(self.encoder(x, mask))
        if eot_positions is None:
            eot_positions = token_ids.argmax(dim=-1)   # EOT has the largest id
        return x[torch.arange(x.shape[0], device=x.device), eot_positions.long()]


class CLIPModel(nn.Module):
    """Both towers, their projections and the logit scale, with HF-CLIP
    state-dict names. ``dtype`` is the compute dtype; parameters are f32."""

    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32,
                 precision: str = "default", fused_attn: bool = True,
                 remat: bool = False, w8a8: bool = False, w8a8_static: bool = False,
                 int8_attn: bool = False, fused_mlp: bool = False) -> None:
        super().__init__()
        if precision not in ("default", "highest"):
            raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
        self.config = config
        self.dtype = dtype
        self.precision = precision
        self.fused_mlp = fused_mlp
        self.w8a8 = w8a8
        self.w8a8_static = w8a8_static
        self.int8_attn = int8_attn
        flags = dict(w8a8=w8a8, w8a8_static=w8a8_static, int8_attn=int8_attn, remat=remat)
        self.vision_model = CLIPVisionTower(config.vision, precision, fused_attn,
                                            fused_mlp, **flags)
        self.text_model = CLIPTextTower(config.text, precision, fused_attn,
                                        fused_mlp, **flags)
        self.visual_projection = Dense(config.vision.hidden_size,
                                       config.vision.projection_dim, bias=False)
        self.text_projection = Dense(config.text.hidden_size,
                                     config.text.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(config.logit_scale_init))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, projection_dim), unnormalized, in ``dtype``."""
        return self.visual_projection(self.vision_model(pixels, self.dtype))

    def encode_text(self, token_ids: torch.Tensor,
                    eot_positions: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T) -> (B, projection_dim), unnormalized, in ``dtype``."""
        return self.text_projection(
            self.text_model(token_ids, self.dtype, eot_positions))

    def forward(self, pixels: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
        """Contrastive logits (image x text)."""
        img = self.encode_image(pixels)
        txt = self.encode_text(token_ids)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T
