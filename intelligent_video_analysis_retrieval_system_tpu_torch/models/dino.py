"""DINO ViT tower, the keyframe-dedup encoder (port of ``models/dino.py``).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/models/dino.py``:
``facebook/dino-vits16``, a plain pre-LN ViT (exact-erf GELU, LayerNorm eps
1e-6, a patch projection with a bias, no pre-LN, no projection head) whose
CLS state after the final LayerNorm is the feature. The blocks are the
port's :class:`models.clip.Transformer` (``act="gelu"``), so in bf16 with
no mask attention runs kernel B3 on a card, as CLIP's vision tower does.

The state dict carries HF ``transformers.ViTModel`` names (with
``add_pooling_layer=False``): a checkpoint's ``state_dict()`` loads as it
is, and :meth:`DINOTower.state_dict` gives those names back. Inside, the
blocks keep the CLIP modules' names; two hooks rename between the two, by
the table :data:`HF_LAYER_NAMES`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from .clip import LayerNorm, Transformer, _PatchEmbed

__all__ = ["DINO_IMAGE_MEAN", "DINO_IMAGE_STD", "DINOConfig", "DINOTower",
           "HF_LAYER_NAMES", "hf_name", "own_name"]

# ImageNet normalization (HF ViTImageProcessor defaults for DINO).
DINO_IMAGE_MEAN = (0.485, 0.456, 0.406)
DINO_IMAGE_STD = (0.229, 0.224, 0.225)

# a block's module names: the port's CLIP block -> HF ViTLayer
HF_LAYER_NAMES = {
    "layer_norm1": "layernorm_before",
    "self_attn.q_proj": "attention.attention.query",
    "self_attn.k_proj": "attention.attention.key",
    "self_attn.v_proj": "attention.attention.value",
    "self_attn.out_proj": "attention.output.dense",
    "layer_norm2": "layernorm_after",
    "mlp.fc1": "intermediate.dense",
    "mlp.fc2": "output.dense",
}
_OWN_LAYER_NAMES = {v: k for k, v in HF_LAYER_NAMES.items()}
_OWN_KEY = re.compile(r"^(.*)encoder\.layers\.(\d+)\.(.+)\.(weight|bias)$")
_HF_KEY = re.compile(r"^(.*)encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$")


def hf_name(key: str) -> str:
    """The HF ViTModel name of a state-dict key of the port's blocks."""
    m = _OWN_KEY.match(key)
    if m is None or m.group(3) not in HF_LAYER_NAMES:
        return key
    pre, i, mod, kind = m.groups()
    return f"{pre}encoder.layer.{i}.{HF_LAYER_NAMES[mod]}.{kind}"


def own_name(key: str) -> str:
    """The port's name of an HF ViTModel block key (others unchanged)."""
    m = _HF_KEY.match(key)
    if m is None or m.group(3) not in _OWN_LAYER_NAMES:
        return key
    pre, i, mod, kind = m.groups()
    return f"{pre}encoder.layers.{i}.{_OWN_LAYER_NAMES[mod]}.{kind}"


@dataclass(frozen=True)
class DINOConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 384     # ViT-S
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    ln_eps: float = 1e-6

    @classmethod
    def vit_s_16(cls) -> "DINOConfig":
        """facebook/dino-vits16 (the reference's model)."""
        return cls()

    @classmethod
    def tiny_test(cls) -> "DINOConfig":
        return cls(image_size=32, patch_size=8, hidden_size=48, num_layers=2,
                   num_heads=4)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _ViTEmbeddings(nn.Module):
    def __init__(self, cfg: DINOConfig) -> None:
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, cfg.hidden_size))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = _PatchEmbed(cfg.hidden_size, cfg.patch_size,
                                                       bias=True)


def _to_hf_names(module, state_dict, prefix, local_metadata) -> None:
    for key in list(state_dict):   # pop and put back in order: the order is kept
        state_dict[hf_name(key)] = state_dict.pop(key)


def _to_own_names(module, state_dict, prefix, local_metadata, strict, missing_keys,
                  unexpected_keys, error_msgs) -> None:
    for key in list(state_dict):
        state_dict[own_name(key)] = state_dict.pop(key)


class DINOTower(nn.Module):
    """(B, H, W, 3) normalized pixels -> (B, hidden) CLS embeddings in
    ``dtype`` (parameters stay f32, as in the CLIP towers)."""

    def __init__(self, config: DINOConfig, dtype: torch.dtype = torch.float32,
                 precision: str = "default", fused_attn: bool = True) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = _ViTEmbeddings(config)
        self.encoder = Transformer(config.num_layers, config.hidden_size, config.num_heads,
                                   config.hidden_size * config.mlp_ratio, precision,
                                   fused_attn, act="gelu", ln_eps=config.ln_eps)
        self.layernorm = LayerNorm(config.hidden_size, eps=config.ln_eps)
        self.register_state_dict_post_hook(_to_hf_names)
        self.register_load_state_dict_pre_hook(_to_own_names)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        x = emb.patch_embeddings.projection(pixels.to(self.dtype))     # (B, P, D)
        cls = emb.cls_token.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embeddings.to(self.dtype)
        x = self.encoder(x)
        # the final LayerNorm is per token: the CLS row's is the reference's
        # LayerNorm of every token, then the CLS row
        return self.layernorm(x[:, 0])
