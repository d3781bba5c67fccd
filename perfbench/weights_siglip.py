"""Seeded SigLIP weights at a configuration's published widths, made on the
device in one generator call, in the style of :mod:`perfbench.weights`.

The leaves carry HF ``SiglipModel`` names. Every random leaf is a slice of
one standard-normal float32 buffer drawn from ``torch.Generator(device)``,
scaled in place: linear, packed ``in_proj`` and patch weights by
fan_in^-1/2, the token embeddings and the MAP head's ``probe`` by 0.02,
position embeddings by 0.01 (text) or 0.02 (vision), biases by 0.02,
LayerNorm weights ``1 + 0.1 n`` and their biases ``0.02 n``; ``logit_scale``
is log 10 and ``logit_bias`` -10, the paper's initialization. Biases and
LayerNorm parameters are random so that a path which drops one shows in the
comparison. The same seed gives the same leaves, so the reference makes its
own copy after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from .weights import _tower

LOGIT_SCALE = math.log(10.0)
LOGIT_BIAS = -10.0


def spec(cfg: Mapping) -> list[tuple[str, tuple, object]]:
    """(name, shape, std or kind) of every leaf of the configuration."""
    t, v = cfg["text_config"], cfg["vision_config"]
    td, vd, vf, p = t["hidden_size"], v["hidden_size"], v["intermediate_size"], v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    head = "vision_model.head"
    out: list = [
        ("text_model.embeddings.token_embedding.weight", (t["vocab_size"], td), 0.02),
        ("text_model.embeddings.position_embedding.weight", (t["max_position_embeddings"], td), 0.01),
    ]
    _tower("text_model", t, out)
    out += [("text_model.final_layer_norm.weight", (td,), "ln_w"),
            ("text_model.final_layer_norm.bias", (td,), "bias"),
            ("text_model.head.weight", (td, td), td ** -0.5),
            ("text_model.head.bias", (td,), "bias"),
            ("vision_model.embeddings.patch_embedding.weight", (vd, 3, p, p), (3 * p * p) ** -0.5),
            ("vision_model.embeddings.patch_embedding.bias", (vd,), "bias"),
            ("vision_model.embeddings.position_embedding.weight", (patches, vd), 0.02)]
    _tower("vision_model", v, out)
    out += [("vision_model.post_layernorm.weight", (vd,), "ln_w"),
            ("vision_model.post_layernorm.bias", (vd,), "bias"),
            (f"{head}.probe", (1, 1, vd), 0.02),
            (f"{head}.attention.in_proj_weight", (3 * vd, vd), vd ** -0.5),
            (f"{head}.attention.in_proj_bias", (3 * vd,), "bias"),
            (f"{head}.attention.out_proj.weight", (vd, vd), vd ** -0.5),
            (f"{head}.attention.out_proj.bias", (vd,), "bias"),
            (f"{head}.layernorm.weight", (vd,), "ln_w"),
            (f"{head}.layernorm.bias", (vd,), "bias"),
            (f"{head}.mlp.fc1.weight", (vf, vd), vd ** -0.5),
            (f"{head}.mlp.fc1.bias", (vf,), "bias"),
            (f"{head}.mlp.fc2.weight", (vd, vf), vf ** -0.5),
            (f"{head}.mlp.fc2.bias", (vd,), "bias"),
            ("logit_scale", (1,), LOGIT_SCALE),
            ("logit_bias", (1,), LOGIT_BIAS)]
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
            elif name.startswith("logit_"):
                leaf.fill_(how)
            else:
                leaf.mul_(how)
            out[name] = leaf
    return out
