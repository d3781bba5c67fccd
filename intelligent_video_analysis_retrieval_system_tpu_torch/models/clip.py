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
  the same modules either way, so one state dict serves both.

Module and parameter names follow HF ``transformers.CLIPModel``'s state
dict, so ``models.convert`` maps between this port, HF checkpoints and the
Flax tree without renaming tables. The towers return the pooled hidden
state; :class:`CLIPModel` applies the projections (``text_projection``,
``visual_projection``), as HF does.

Left out for now (a later change ports them): W8A8 dense layers, int8
attention and rematerialization. Asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_mha
from ..ops.block import activation, fused_ln_mlp, supports_fused_ln_mlp

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
]

_LATER = {
    "w8a8": "W8A8 dense layers are ported with the int8 tower modes in a later change",
    "int8_attn": "int8 attention is ported with the W8A8 modes in a later change",
    "remat": "rematerialization is ported with training in a later change",
}


def _refuse(**flags: bool) -> None:
    for name, on in flags.items():
        if on:
            raise NotImplementedError(_LATER[name])


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
    (Flax ``nn.Dense(dtype=...)`` semantics)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self._cast = _CastCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class MultiHeadAttention(nn.Module):
    """Self-attention with HF names (``q_proj``/``k_proj``/``v_proj``/
    ``out_proj``) and the reference's three modes: the HIGHEST-parity
    einsum, the throughput einsum, and fused kernel B3 for unmasked
    attention on a CUDA device."""

    def __init__(self, dim: int, num_heads: int, precision: str = "default",
                 fused_attn: bool = True, w8a8: bool = False,
                 int8_attn: bool = False) -> None:
        super().__init__()
        _refuse(w8a8=w8a8, int8_attn=int8_attn)
        self.num_heads = num_heads
        self.precision = precision
        self.fused_attn = fused_attn
        self.q_proj = Dense(dim, dim)
        self.k_proj = Dense(dim, dim)
        self.v_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        head_dim = d // h
        scale = head_dim ** -0.5
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if (self.fused_attn and mask is None and self.precision != "highest"
                and x.device.type == "cuda"):
            return self.out_proj(fused_mha(q, k, v, h))
        if self.precision == "highest":
            # parity mode: f32 logits (+ mask), f32 softmax
            qh, kh, vh = (y.reshape(b, t, h, head_dim) for y in (q, k, v))
            logits = torch.einsum("bqhd,bkhd->bhqk", qh * scale, kh).float()
            if mask is not None:
                logits = logits + mask
            weights = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
        else:
            # throughput mode: (B*H, T, T) batched GEMMs, logits in the
            # model dtype, f32 softmax
            def merge(y):
                return y.reshape(b, t, h, head_dim).transpose(1, 2).reshape(
                    b * h, t, head_dim)

            logits = torch.bmm(merge(q) * scale, merge(k).transpose(1, 2))
            if mask is not None:
                logits = logits + mask.reshape(1, t, t).to(logits.dtype)
            weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            out = torch.bmm(weights, merge(v))
            out = out.reshape(b, h, t, head_dim).transpose(1, 2)
        return self.out_proj(out.reshape(b, t, d))


def _activation(name: str):
    """The unfused chain's activation by name (the reference's
    ``_activation``): CLIP's sigmoid form of QuickGELU, else the fused
    half-block's own (``gelu``: exact, HF ViT/DINO's default; ``gelu_tanh``)."""
    return quick_gelu if name == "quick_gelu" else activation(name)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str = "quick_gelu") -> None:
        super().__init__()
        self.act = _activation(act)
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN residual block, HF ``CLIPEncoderLayer`` names: attention, then
    the MLP half (LN -> fc1 -> act -> fc2 -> residual), either as the
    unfused chain or, with ``fused_mlp``, through kernel B4."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 precision: str = "default", act: str = "quick_gelu",
                 ln_eps: float = 1e-5, fused_attn: bool = True,
                 fused_mlp: bool = False, w8a8: bool = False,
                 int8_attn: bool = False) -> None:
        super().__init__()
        _refuse(w8a8=w8a8, int8_attn=int8_attn)
        self.act = act
        self.layer_norm1 = LayerNorm(dim, eps=ln_eps)
        self.self_attn = MultiHeadAttention(dim, num_heads, precision, fused_attn)
        self.layer_norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = _MLP(dim, dim * mlp_ratio, act)
        # the reference's gate: opt-in, throughput mode, shapes the kernel takes
        self.fused_mlp = (fused_mlp and precision != "highest"
                          and supports_fused_ln_mlp(dim, dim * mlp_ratio, act))

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


class Transformer(nn.Module):
    """A stack of blocks under HF's ``encoder.layers`` name."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, mlp_ratio: int,
                 precision: str = "default", fused_attn: bool = True,
                 remat: bool = False, act: str = "quick_gelu",
                 ln_eps: float = 1e-5, fused_mlp: bool = False) -> None:
        super().__init__()
        _refuse(remat=remat)
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, precision, act=act,
                             ln_eps=ln_eps, fused_attn=fused_attn,
                             fused_mlp=fused_mlp)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


class _PatchEmbed(nn.Module):
    """Stride == kernel patch conv as reshape + one GEMM (the reference's
    ``_PatchEmbedMatmul``), holding HF's conv weight ``(D, 3, p, p)``. A
    matmul also keeps cuDNN's TF32 convolutions out of the f32 mode."""

    def __init__(self, hidden: int, patch: int) -> None:
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(hidden, 3, patch, patch))
        self._cast = _CastCache()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = pixels.shape                       # NHWC
        x = pixels.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        # (D, c, p, p) -> (p, p, c, D): the (p_h, p_w, c) order of the patch
        wt = self._cast.get("weight", self.weight, pixels.dtype)
        return x @ wt.permute(2, 3, 1, 0).reshape(p * p * c, -1)


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
                 fused_attn: bool = True, fused_mlp: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=1e-5)  # HF's spelling
        self.encoder = Transformer(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.mlp_ratio, precision, fused_attn,
                                   fused_mlp=fused_mlp)
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
                 fused_attn: bool = True, fused_mlp: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = Transformer(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.mlp_ratio, precision, fused_attn,
                                   fused_mlp=fused_mlp)
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
        _refuse(remat=remat, w8a8=w8a8 or w8a8_static, int8_attn=int8_attn)
        if precision not in ("default", "highest"):
            raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
        self.config = config
        self.dtype = dtype
        self.precision = precision
        self.fused_mlp = fused_mlp
        self.vision_model = CLIPVisionTower(config.vision, precision, fused_attn,
                                            fused_mlp)
        self.text_model = CLIPTextTower(config.text, precision, fused_attn,
                                        fused_mlp)
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
