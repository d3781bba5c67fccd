"""The CLIP towers as published (Radford et al., arXiv:2103.00020; HF
``CLIPModel``), in float32 with TF32 off, over a state dict in HF names.

Pre-LN transformer blocks with QuickGELU (``x * sigmoid(1.702 x)``) and
LayerNorm eps 1e-5. Text: token and position embeddings, a causal mask,
the final LayerNorm, the state at EOT, ``text_projection``. Vision: the
patch convolution without bias, the class token, position embeddings,
``pre_layrnorm``, the blocks, ``post_layernorm`` of the class token,
``visual_projection``. Pixels are uint8 and normalized here with OpenAI's
mean and std. Every tower runs in blocks of rows so that it fits beside the
cell's data.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch
import torch.nn.functional as F

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
EPS = 1e-5


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ln(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], EPS)


def _dense(x, sd, name, bias=True):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"] if bias else None)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per row (last axis) that
    maps the row's largest magnitude to the format's 448."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_dense(x, sd, name, bias=True):
    """A dense layer with its input and weight rounded to float8 e4m3 (per
    token, per output channel), the product and bias in float32."""
    return F.linear(_fp8(x), _fp8(sd[f"{name}.weight"]), sd[f"{name}.bias"] if bias else None)


def _block(x, sd, name, heads, mask, dense=_dense):
    b, t, d = x.shape
    dh = d // heads
    h = _ln(x, sd, f"{name}.layer_norm1")

    def split(y):
        return y.reshape(b, t, heads, dh).transpose(1, 2)

    q = split(dense(h, sd, f"{name}.self_attn.q_proj")) * dh ** -0.5
    k = split(dense(h, sd, f"{name}.self_attn.k_proj"))
    v = split(dense(h, sd, f"{name}.self_attn.v_proj"))
    logits = q @ k.transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    a = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
    x = x + dense(a, sd, f"{name}.self_attn.out_proj")
    h = dense(_ln(x, sd, f"{name}.layer_norm2"), sd, f"{name}.mlp.fc1")
    h = h * torch.sigmoid(1.702 * h)
    return x + dense(h, sd, f"{name}.mlp.fc2")


def _f32(sd: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items() if k.startswith(prefix)}


@torch.no_grad()
def text_embed(sd: Mapping[str, torch.Tensor], cfg: Mapping, tokens: torch.Tensor,
               eot: torch.Tensor, block: int = 64) -> torch.Tensor:
    """(B, T) token ids, (B,) EOT positions -> (B, projection) f32, unnormalized."""
    tc = cfg["text_config"]
    w = _f32(sd, "text_")
    layers = tc["num_hidden_layers"]
    outs = []
    with exact_f32():
        for s in range(0, len(tokens), block):
            ids, pos = tokens[s:s + block], eot[s:s + block]
            t = ids.shape[1]
            x = w["text_model.embeddings.token_embedding.weight"][ids]
            x = x + w["text_model.embeddings.position_embedding.weight"][:t][None]
            mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
            for i in range(layers):
                x = _block(x, w, f"text_model.encoder.layers.{i}",
                           tc["num_attention_heads"], mask)
            x = _ln(x, w, "text_model.final_layer_norm")
            pooled = x[torch.arange(len(ids), device=x.device), pos]
            outs.append(F.linear(pooled, w["text_projection.weight"]))
    return torch.cat(outs)


@torch.no_grad()
def image_embed(sd: Mapping[str, torch.Tensor], cfg: Mapping, pixels: torch.Tensor,
                block: int = 32, dense=_dense) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, projection) f32, unnormalized; ``dense``
    computes the blocks' dense layers."""
    vc = cfg["vision_config"]
    w = _f32(sd, "vis")
    p = vc["patch_size"]
    mean = torch.tensor(MEAN, device=pixels.device)
    std = torch.tensor(STD, device=pixels.device)
    outs = []
    with exact_f32():
        for s in range(0, len(pixels), block):
            x = (pixels[s:s + block].float() / 255.0 - mean) / std
            x = F.conv2d(x.permute(0, 3, 1, 2),
                         w["vision_model.embeddings.patch_embedding.weight"], stride=p)
            x = x.flatten(2).transpose(1, 2)                          # (b, patches, D)
            cls = w["vision_model.embeddings.class_embedding"].expand(len(x), 1, -1)
            x = torch.cat([cls, x], 1) + w["vision_model.embeddings.position_embedding.weight"]
            x = _ln(x, w, "vision_model.pre_layrnorm")
            for i in range(vc["num_hidden_layers"]):
                x = _block(x, w, f"vision_model.encoder.layers.{i}",
                           vc["num_attention_heads"], None, dense)
            pooled = _ln(x[:, 0], w, "vision_model.post_layernorm")
            outs.append(F.linear(pooled, w["visual_projection.weight"]))
    return torch.cat(outs)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
