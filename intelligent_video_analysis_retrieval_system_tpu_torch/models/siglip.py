"""SigLIP towers as PyTorch modules (``google/siglip-so400m-patch14-384``).

Zhai et al., "Sigmoid Loss for Language Image Pre-Training"
(arXiv:2303.15343), at the shape of Alabdulmohsin et al., "Getting ViT in
Shape" (arXiv:2305.13035); the equations of HF ``modeling_siglip``. The JAX
package has no SigLIP: the plain reference the tests hold these modules to
is ``perfbench/reference/siglip.py``.

- Vision: a patch convolution with a bias, learned positions, no class
  token and no pre-LayerNorm; pre-LN blocks with GELU-tanh and LayerNorm eps
  1e-6; ``post_layernorm`` over every token; then the MAP head: a learned
  ``probe`` attends over all tokens (HF ``nn.MultiheadAttention``'s
  ``in_proj_weight`` / ``in_proj_bias`` / ``out_proj``), ``h = a +
  mlp(LN(a))``, and the embedding is ``h[:, 0]``, with no projection.
- Text: token and position embeddings, the same blocks with no mask (SigLIP
  pads every text to its 64 positions and passes no attention mask), the
  final LayerNorm, the state at the last position, then ``head`` (a Linear
  with a bias).
- Scores: ``image @ text.T * exp(logit_scale) + logit_bias``.

The blocks are :class:`models.clip.Transformer` at the explicit MLP width
(4,304 over 1,152, no whole ratio), so in throughput mode both towers'
self-attention takes kernel B3 on a card: the vision tower at 729 tokens
(B3's two-pass ``wgmma`` variant), the text tower at 64, both at head dim
72 (padded to 80 and 96 inside the kernels). The MAP head is plain ``torch`` in the
compute dtype: one query over the tokens needs no kernel; its k and v
projections over every token are one GEMM on the compute-dtype copy of the
packed ``in_proj_weight``, as :class:`models.clip.Dense` runs its own. No
SigLIP mode has int8 layers: W8A8 and ``int8_attn`` raise ``ValueError``.

Module and parameter names are HF ``SiglipModel``'s, so its
``state_dict()`` loads as it is (``models.convert``). Config fields keep the
names the embedder reads of CLIP's (``projection_dim``, ``max_length``).
Spans (:mod:`..trace`): ``embed.pool`` (``images``, ``tokens``) around the
MAP head.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from .. import trace
from .clip import Dense, LayerNorm, Transformer, _CastCache, _MLP, _PatchEmbed

__all__ = ["SIGLIP_IMAGE_MEAN", "SIGLIP_IMAGE_STD", "SiglipConfig", "SiglipModel",
           "SiglipTextConfig", "SiglipTextTower", "SiglipVisionConfig", "SiglipVisionTower"]

# SiglipImageProcessor: rescale to [0, 1], then mean and std 0.5
SIGLIP_IMAGE_MEAN = (0.5, 0.5, 0.5)
SIGLIP_IMAGE_STD = (0.5, 0.5, 0.5)
_ACT = "gelu_tanh"    # HF's gelu_pytorch_tanh


@dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        """Tokens through the blocks per image: the patches alone."""
        return self.num_patches

    @property
    def projection_dim(self) -> int:
        """The embedding's width: the MAP head's output, unprojected."""
        return self.hidden_size


@dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    max_length: int = 64
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    ln_eps: float = 1e-6

    @property
    def projection_dim(self) -> int:
        """The embedding's width: ``head`` maps hidden to hidden."""
        return self.hidden_size


@dataclass(frozen=True)
class SiglipConfig:
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    text: SiglipTextConfig = field(default_factory=SiglipTextConfig)
    # the paper's initialization: t' = log 10, b = -10
    logit_scale_init: float = math.log(10.0)
    logit_bias_init: float = -10.0
    # SiglipImageProcessor: bicubic resize straight to the square, no crop
    image_mean: ClassVar[tuple] = SIGLIP_IMAGE_MEAN
    image_std: ClassVar[tuple] = SIGLIP_IMAGE_STD
    center_crop: ClassVar[bool] = False

    @classmethod
    def so400m_patch14_384(cls) -> "SiglipConfig":
        """google/siglip-so400m-patch14-384."""
        return cls()

    @classmethod
    def tiny_test(cls) -> "SiglipConfig":
        """Small config for unit tests: as in the published one, the MLP
        width is no multiple of the hidden size and the image no whole
        number of patches (38 px: 4 patches of 8 and 6 px)."""
        return cls(
            vision=SiglipVisionConfig(image_size=38, patch_size=8, hidden_size=48,
                                      intermediate_size=136, num_layers=2, num_heads=4),
            text=SiglipTextConfig(vocab_size=512, max_length=16, hidden_size=48,
                                  intermediate_size=136, num_layers=2, num_heads=4),
        )


def _encoder(cfg, precision: str, fused_attn: bool, fused_mlp: bool) -> Transformer:
    return Transformer(cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                       precision, fused_attn, act=_ACT, ln_eps=cfg.ln_eps, fused_mlp=fused_mlp)


class _ProbeAttention(nn.Module):
    """One query over every token, HF ``nn.MultiheadAttention``'s names: the
    packed q/k/v projection ``in_proj_weight`` (3D, D) and ``in_proj_bias``,
    then ``out_proj``. Logits in the compute dtype, softmax in f32, as
    :func:`models.clip.attention`'s throughput mode."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Dense(dim, dim)
        self._cast = _CastCache()

    def forward(self, probe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        w = self._cast.get("in_proj_weight", self.in_proj_weight, x.dtype)
        bias = self._cast.get("in_proj_bias", self.in_proj_bias, x.dtype)
        q = F.linear(probe.reshape(1, d), w[:d], bias[:d]).reshape(h, dh)
        kv = F.linear(x, w[d:], bias[d:])                      # (B, T, 2D)
        k, v = kv[..., :d].reshape(b, t, h, dh), kv[..., d:].reshape(b, t, h, dh)
        logits = torch.einsum("hd,bthd->bht", q * dh ** -0.5, k)
        weights = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bht,bthd->bhd", weights, v).reshape(b, 1, d))


class _MAPHead(nn.Module):
    """Multihead attention pooling (HF ``SiglipMultiheadAttentionPoolingHead``)."""

    def __init__(self, cfg: SiglipVisionConfig) -> None:
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.attention = _ProbeAttention(cfg.hidden_size, cfg.num_heads)
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, _ACT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attention(self.probe.to(x.dtype), x)
        return (a + self.mlp(self.layernorm(a)))[:, 0]


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig) -> None:
        super().__init__()
        self.patch_embedding = _PatchEmbed(cfg.hidden_size, cfg.patch_size, bias=True)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size)


class SiglipVisionTower(nn.Module):
    """(B, H, W, 3) normalized pixels -> (B, hidden) MAP-pooled embeddings."""

    def __init__(self, cfg: SiglipVisionConfig, precision: str = "default",
                 fused_attn: bool = True, fused_mlp: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.encoder = _encoder(cfg, precision, fused_attn, fused_mlp)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.head = _MAPHead(cfg)

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = self.embeddings
        x = emb.patch_embedding(pixels.to(dtype))                   # (B, P, D)
        x = x + emb.position_embedding.weight.to(dtype)[None]
        x = self.post_layernorm(self.encoder(x))
        with trace.span("embed.pool", images=x.shape[0], tokens=x.shape[1]):
            return self.head(x)


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipTextConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class SiglipTextTower(nn.Module):
    """(B, T) token ids -> (B, hidden): unmasked blocks, the final LN, the
    last position's state through ``head``."""

    def __init__(self, cfg: SiglipTextConfig, precision: str = "default",
                 fused_attn: bool = True, fused_mlp: bool = False) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _encoder(cfg, precision, fused_attn, fused_mlp)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.head = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, token_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = self.embeddings
        t = token_ids.shape[1]
        x = emb.token_embedding.weight[token_ids.long()].to(dtype)
        x = x + emb.position_embedding.weight[:t].to(dtype)[None]
        x = self.final_layer_norm(self.encoder(x))
        return self.head(x[:, -1])


class SiglipModel(nn.Module):
    """Both towers, ``logit_scale`` and ``logit_bias``, with HF-SigLIP
    state-dict names. ``dtype`` is the compute dtype; parameters are f32.
    The keywords are :class:`models.clip.CLIPModel`'s, so the embedder
    builds either family alike."""

    def __init__(self, config: SiglipConfig, dtype: torch.dtype = torch.float32,
                 precision: str = "default", fused_attn: bool = True,
                 w8a8: bool = False, w8a8_static: bool = False, int8_attn: bool = False,
                 fused_mlp: bool = False) -> None:
        super().__init__()
        if precision not in ("default", "highest"):
            raise ValueError(f"precision must be 'default' or 'highest', got {precision!r}")
        if w8a8 or w8a8_static or int8_attn:
            raise ValueError("SigLIP has no int8 mode: W8A8 and int8_attn are CLIP's only")
        self.config = config
        self.dtype = dtype
        self.precision = precision
        self.vision_model = SiglipVisionTower(config.vision, precision, fused_attn, fused_mlp)
        self.text_model = SiglipTextTower(config.text, precision, fused_attn, fused_mlp)
        self.logit_scale = nn.Parameter(torch.full((1,), config.logit_scale_init))
        self.logit_bias = nn.Parameter(torch.full((1,), config.logit_bias_init))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, hidden), unnormalized, in ``dtype``."""
        return self.vision_model(pixels, self.dtype)

    def encode_text(self, token_ids: torch.Tensor,
                    eot_positions: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T) -> (B, hidden), unnormalized, in ``dtype``. The state at
        the last position is pooled, so ``eot_positions`` is not read."""
        return self.text_model(token_ids, self.dtype)

    def forward(self, pixels: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
        """Sigmoid-loss logits (image x text)."""
        img = self.encode_image(pixels)
        txt = self.encode_text(token_ids)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        return img @ txt.T * self.logit_scale.exp() + self.logit_bias
