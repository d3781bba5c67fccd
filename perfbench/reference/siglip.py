"""The SigLIP towers as published (Zhai et al., arXiv:2303.15343; HF
``SiglipModel``, ``google/siglip-so400m-patch14-384``), in float32 with
TF32 off, over a state dict in HF names.

Pre-LN blocks ``h = x + attn(LN1(x)); y = h + fc2(gelu_tanh(fc1(LN2(h))))``
with biases on q, k, v and out, scale ``dh^-1/2``, softmax in float32 and
LayerNorm eps 1e-6.

- Vision: the patch convolution with its bias, the learned positions (no
  class token, no pre-LayerNorm), the blocks, ``post_layernorm`` over every
  token, then the MAP head: the ``probe`` attends over all tokens through
  ``in_proj_weight`` / ``in_proj_bias`` and ``out_proj``, ``h = a +
  mlp(LN(a))``, and the embedding is ``h[:, 0]``.
- Text: token and position embeddings, the blocks with no mask,
  ``final_layer_norm``, the last position's state through ``head``.
- Scores: ``image @ text.T * exp(logit_scale) + logit_bias`` of the
  normalized embeddings.

Departures from HF, none of them in the arithmetic: pixels come as uint8 at
the input size and are normalized here with mean and std 0.5 (HF's
processor also resizes, bicubic, which the cell's keyframes do not need);
the probe's attention is spelled as its matrix products where HF calls
``nn.MultiheadAttention``; token ids come as they are (the SentencePiece
vocabulary is not in the repository). Every tower runs in blocks of rows so
that it fits beside the cell's data. ``dense`` replaces every dense layer
of the blocks and of the MAP head (``fp8_dense`` is the control's).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .clip import exact_f32, fp8_dense, normalize

__all__ = ["MEAN", "STD", "EPS", "fp8_dense", "image_embed", "logits", "normalize",
           "text_embed"]

MEAN = (0.5, 0.5, 0.5)
STD = (0.5, 0.5, 0.5)
EPS = 1e-6


def _ln(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], EPS)


def _dense(x, sd, name, bias=True):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"] if bias else None)


def _mlp(x, sd, name, dense):
    h = F.gelu(dense(x, sd, f"{name}.fc1"), approximate="tanh")
    return dense(h, sd, f"{name}.fc2")


def _heads(y, heads):
    b, t, d = y.shape
    return y.reshape(b, t, heads, d // heads).transpose(1, 2)      # (b, h, t, dh)


def _attend(q, k, v):
    """softmax(q k^T * dh^-1/2) v per head, softmax in float32."""
    w = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2), dim=-1)
    b, h, t, dh = q.shape
    return (w @ v).transpose(1, 2).reshape(b, t, h * dh)


def _block(x, sd, name, heads, dense):
    h = _ln(x, sd, f"{name}.layer_norm1")
    q, k, v = (_heads(dense(h, sd, f"{name}.self_attn.{p}_proj"), heads) for p in "qkv")
    x = x + dense(_attend(q, k, v), sd, f"{name}.self_attn.out_proj")
    return x + _mlp(_ln(x, sd, f"{name}.layer_norm2"), sd, f"{name}.mlp", dense)


def _packed(x, sd, name, part, d, dense):
    """One of the probe attention's q, k, v projections (``part`` 0, 1, 2)
    from the packed ``in_proj_weight`` and ``in_proj_bias``."""
    one = {"p.weight": sd[f"{name}.in_proj_weight"][part * d:(part + 1) * d],
           "p.bias": sd[f"{name}.in_proj_bias"][part * d:(part + 1) * d]}
    return dense(x, one, "p")


def _map_head(x, sd, name, heads, dense):
    b, _, d = x.shape
    probe = sd[f"{name}.probe"].expand(b, 1, d)
    att = f"{name}.attention"
    q, k, v = (_heads(_packed(y, sd, att, i, d, dense), heads)
               for i, y in enumerate((probe, x, x)))
    a = dense(_attend(q, k, v), sd, f"{att}.out_proj")
    h = a + _mlp(_ln(a, sd, f"{name}.layernorm"), sd, f"{name}.mlp", dense)
    return h[:, 0]


def _f32(sd: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items() if k.startswith(prefix)}


@torch.no_grad()
def image_embed(sd: Mapping[str, torch.Tensor], cfg: Mapping, pixels: torch.Tensor,
                block: int = 8, dense=_dense) -> torch.Tensor:
    """(B, H, W, 3) uint8 at the input size -> (B, hidden) f32, unnormalized."""
    vc = cfg["vision_config"]
    w = _f32(sd, "vision_model.")
    p, heads = vc["patch_size"], vc["num_attention_heads"]
    mean = torch.tensor(MEAN, device=pixels.device)
    std = torch.tensor(STD, device=pixels.device)
    outs = []
    with exact_f32():
        for s in range(0, len(pixels), block):
            x = (pixels[s:s + block].float() / 255.0 - mean) / std
            x = F.conv2d(x.permute(0, 3, 1, 2), w["vision_model.embeddings.patch_embedding.weight"],
                         w["vision_model.embeddings.patch_embedding.bias"], stride=p)
            x = x.flatten(2).transpose(1, 2)                          # (b, patches, D)
            x = x + w["vision_model.embeddings.position_embedding.weight"]
            for i in range(vc["num_hidden_layers"]):
                x = _block(x, w, f"vision_model.encoder.layers.{i}", heads, dense)
            x = _ln(x, w, "vision_model.post_layernorm")
            outs.append(_map_head(x, w, "vision_model.head", heads, dense))
    return torch.cat(outs)


@torch.no_grad()
def text_embed(sd: Mapping[str, torch.Tensor], cfg: Mapping, tokens: torch.Tensor,
               block: int = 64) -> torch.Tensor:
    """(B, T) token ids -> (B, hidden) f32, unnormalized."""
    tc = cfg["text_config"]
    w = _f32(sd, "text_model.")
    outs = []
    with exact_f32():
        for s in range(0, len(tokens), block):
            ids = tokens[s:s + block]
            x = w["text_model.embeddings.token_embedding.weight"][ids]
            x = x + w["text_model.embeddings.position_embedding.weight"][:ids.shape[1]]
            for i in range(tc["num_hidden_layers"]):
                x = _block(x, w, f"text_model.encoder.layers.{i}",
                           tc["num_attention_heads"], _dense)
            x = _ln(x, w, "text_model.final_layer_norm")
            outs.append(_dense(x[:, -1], w, "text_model.head"))
    return torch.cat(outs)


def logits(sd: Mapping[str, torch.Tensor], image: torch.Tensor,
           text: torch.Tensor) -> torch.Tensor:
    """(images, texts) sigmoid-loss logits of unnormalized embeddings."""
    with exact_f32():
        return (normalize(image) @ normalize(text).T * sd["logit_scale"].float().exp()
                + sd["logit_bias"].float())
