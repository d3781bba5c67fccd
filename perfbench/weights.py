"""Seeded CLIP weights at a configuration's published widths, made on the
device in one generator call.

The leaves carry HF ``CLIPModel`` names. Every random leaf is a slice of one
standard-normal float32 buffer drawn from ``torch.Generator(device)``, scaled
in place: linear and patch weights by fan_in^-1/2, projections by
hidden^-1/2, token and class embeddings by 0.02, position embeddings by 0.01
(text) or 0.02 (vision), biases by 0.02, LayerNorm weights ``1 + 0.1 n`` and
their biases ``0.02 n``. Biases and LayerNorm parameters are random so that
a path which drops one shows in the comparison. The same seed gives the
same leaves, so the reference makes its own copy after the program's state
is freed.
"""

from __future__ import annotations

from typing import Mapping

import torch

LOGIT_SCALE = 2.6592


def _tower(prefix: str, c: Mapping, out: list) -> None:
    d, f = c["hidden_size"], c["intermediate_size"]
    for i in range(c["num_hidden_layers"]):
        layer = f"{prefix}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{layer}.{ln}.weight", (d,), "ln_w"), (f"{layer}.{ln}.bias", (d,), "bias")]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{layer}.self_attn.{proj}.weight", (d, d), d ** -0.5),
                    (f"{layer}.self_attn.{proj}.bias", (d,), "bias")]
        out += [(f"{layer}.mlp.fc1.weight", (f, d), d ** -0.5), (f"{layer}.mlp.fc1.bias", (f,), "bias"),
                (f"{layer}.mlp.fc2.weight", (d, f), f ** -0.5), (f"{layer}.mlp.fc2.bias", (d,), "bias")]


def spec(cfg: Mapping) -> list[tuple[str, tuple, object]]:
    """(name, shape, std or kind) of every leaf of the configuration."""
    t, v, proj = cfg["text_config"], cfg["vision_config"], cfg["projection_dim"]
    td, vd, p = t["hidden_size"], v["hidden_size"], v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    out: list = [
        ("text_model.embeddings.token_embedding.weight", (t["vocab_size"], td), 0.02),
        ("text_model.embeddings.position_embedding.weight", (t["max_position_embeddings"], td), 0.01),
    ]
    _tower("text_model", t, out)
    out += [("text_model.final_layer_norm.weight", (td,), "ln_w"),
            ("text_model.final_layer_norm.bias", (td,), "bias"),
            ("vision_model.embeddings.patch_embedding.weight", (vd, 3, p, p), (3 * p * p) ** -0.5),
            ("vision_model.embeddings.class_embedding", (vd,), 0.02),
            ("vision_model.embeddings.position_embedding.weight", (patches + 1, vd), 0.02),
            ("vision_model.pre_layrnorm.weight", (vd,), "ln_w"),
            ("vision_model.pre_layrnorm.bias", (vd,), "bias")]
    _tower("vision_model", v, out)
    out += [("vision_model.post_layernorm.weight", (vd,), "ln_w"),
            ("vision_model.post_layernorm.bias", (vd,), "bias"),
            ("visual_projection.weight", (proj, vd), vd ** -0.5),
            ("text_projection.weight", (proj, td), td ** -0.5),
            ("logit_scale", (), "logit")]
    return out


def make(cfg: Mapping, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The state dict of the configuration's towers from ``seed``: float32
    leaves on ``device``, views of one buffer."""
    leaves = spec(cfg)
    sizes = [torch.Size(shape).numel() for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    with torch.no_grad():
        for (name, shape, how), n in zip(leaves, sizes):
            leaf = flat[at:at + n].view(shape)
            at += n
            if how == "ln_w":
                leaf.mul_(0.1).add_(1.0)
            elif how == "bias":
                leaf.mul_(0.02)
            elif how == "logit":
                leaf.fill_(LOGIT_SCALE)
            else:
                leaf.mul_(how)
            out[name] = leaf
    return out
