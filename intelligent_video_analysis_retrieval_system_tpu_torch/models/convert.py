"""Weights across frameworks: the JAX tree, HF checkpoints and seeded init.

The port's modules carry HF-CLIP state-dict names, so

- an HF ``CLIPModel.state_dict()`` loads as it is (extra HF buffers such as
  ``position_ids`` are dropped);
- :func:`from_jax_params` turns the JAX package's ``CLIPModel`` param tree
  (numpy arrays) into a state dict, and the JAX package's
  ``convert_hf_clip_params`` is its exact inverse.

Conventions: Flax Dense kernels are ``(in, out)``, torch Linear weights
``(out, in)``; the Flax patch kernel is HWIO ``(p, p, 3, D)``, HF's conv
weight ``(D, 3, p, p)``; the towers' ``proj`` matrices become the
``text_projection`` / ``visual_projection`` weights (transposed); Flax
LayerNorm ``scale`` is torch ``weight``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

__all__ = ["from_jax_params", "hf_config_to_ours", "load_clip", "empty_model"]


def _tensor(x: Any, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def _block(tree: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}

    def lin(src: Mapping[str, Any], name: str) -> None:
        out[f"{prefix}.{name}.weight"] = _tensor(src["kernel"], transpose=True)
        out[f"{prefix}.{name}.bias"] = _tensor(src["bias"])

    def ln(src: Mapping[str, Any], name: str) -> None:
        out[f"{prefix}.{name}.weight"] = _tensor(src["scale"])
        out[f"{prefix}.{name}.bias"] = _tensor(src["bias"])

    ln(tree["ln_1"], "layer_norm1")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin(tree["attn"][proj], f"self_attn.{proj}")
    ln(tree["ln_2"], "layer_norm2")
    lin(tree["mlp_fc"], "mlp.fc1")
    lin(tree["mlp_proj"], "mlp.fc2")
    return out


def from_jax_params(params: Mapping[str, Any], config: CLIPConfig) -> dict[str, torch.Tensor]:
    """JAX ``CLIPModel`` params (``{vision, text, logit_scale}``, numpy
    leaves) -> a state dict for :class:`models.clip.CLIPModel`."""
    v, t = params["vision"], params["text"]
    sd: dict[str, torch.Tensor] = {
        "vision_model.embeddings.patch_embedding.weight": torch.from_numpy(
            np.array(np.transpose(np.asarray(v["patch_embed"]["kernel"], np.float32),
                                  (3, 2, 0, 1)), order="C")),
        "vision_model.embeddings.class_embedding": _tensor(v["class_embedding"]),
        "vision_model.embeddings.position_embedding.weight":
            _tensor(v["positional_embedding"]),
        "vision_model.pre_layrnorm.weight": _tensor(v["ln_pre"]["scale"]),
        "vision_model.pre_layrnorm.bias": _tensor(v["ln_pre"]["bias"]),
        "vision_model.post_layernorm.weight": _tensor(v["ln_post"]["scale"]),
        "vision_model.post_layernorm.bias": _tensor(v["ln_post"]["bias"]),
        "visual_projection.weight": _tensor(v["proj"], transpose=True),
        "text_model.embeddings.token_embedding.weight": _tensor(t["token_embedding"]),
        "text_model.embeddings.position_embedding.weight":
            _tensor(t["positional_embedding"]),
        "text_model.final_layer_norm.weight": _tensor(t["ln_final"]["scale"]),
        "text_model.final_layer_norm.bias": _tensor(t["ln_final"]["bias"]),
        "text_projection.weight": _tensor(t["proj"], transpose=True),
        "logit_scale": _tensor(params["logit_scale"]).reshape(()),
    }
    for i in range(config.vision.num_layers):
        sd.update(_block(v["transformer"][f"layer_{i}"],
                         f"vision_model.encoder.layers.{i}"))
    for i in range(config.text.num_layers):
        sd.update(_block(t["transformer"][f"layer_{i}"],
                         f"text_model.encoder.layers.{i}"))
    return sd


def hf_config_to_ours(hf_config: Any) -> CLIPConfig:
    """``transformers.CLIPConfig`` -> our dataclass config."""
    v, t = hf_config.vision_config, hf_config.text_config
    return CLIPConfig(
        vision=CLIPVisionConfig(
            image_size=v.image_size,
            patch_size=v.patch_size,
            hidden_size=v.hidden_size,
            num_layers=v.num_hidden_layers,
            num_heads=v.num_attention_heads,
            mlp_ratio=v.intermediate_size // v.hidden_size,
            projection_dim=hf_config.projection_dim,
        ),
        text=CLIPTextConfig(
            vocab_size=t.vocab_size,
            max_length=t.max_position_embeddings,
            hidden_size=t.hidden_size,
            num_layers=t.num_hidden_layers,
            num_heads=t.num_attention_heads,
            mlp_ratio=t.intermediate_size // t.hidden_size,
            projection_dim=hf_config.projection_dim,
        ),
    )


def empty_model(config: CLIPConfig, device: torch.device | str = "cpu",
                **kwargs: Any) -> CLIPModel:
    """A :class:`CLIPModel` with uninitialized parameters on ``device``
    (built on the meta device, so no default init runs)."""
    with torch.device("meta"):
        model = CLIPModel(config, **kwargs)
    return model.to_empty(device=device)


@torch.no_grad()
def _seeded_init(model: CLIPModel, generator: torch.Generator) -> None:
    """CLIP-style init (the reference's Flax initializers): Linear weights
    lecun-normal, biases zero, LayerNorm ones/zeros, embeddings N(0, 0.02)
    (text positions N(0, 0.01)), projections N(0, hidden^-1/2)."""
    cfg = model.config
    for name, p in model.named_parameters():
        if name == "logit_scale":
            p.fill_(cfg.logit_scale_init)
        elif "layer_norm" in name or "layrnorm" in name or "layernorm" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        elif name.endswith("projection.weight"):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif name == "text_model.embeddings.position_embedding.weight":
            p.normal_(0.0, 0.01, generator=generator)
        elif "embedding" in name and "patch" not in name:
            p.normal_(0.0, 0.02, generator=generator)
        else:  # Linear (out, in) and the patch conv (D, 3, p, p): fan_in
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=generator)


def load_clip(
    model_name_or_path: str | Path | None = None,
    config: CLIPConfig | None = None,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> tuple[CLIPConfig, dict[str, torch.Tensor]]:
    """(config, state dict on ``device``).

    A local HF checkpoint directory loads when ``transformers`` imports;
    otherwise (or without a path) the towers are initialized at the
    config's full width from ``torch.Generator(device).manual_seed(seed)``.
    Network access is never attempted.
    """
    if model_name_or_path is not None:
        try:
            import transformers

            hf = transformers.CLIPModel.from_pretrained(
                str(model_name_or_path), local_files_only=True
            )
            cfg = hf_config_to_ours(hf.config)
            keys = set(empty_model(cfg, "meta").state_dict())
            sd = {k: v.detach().float().to(device)
                  for k, v in hf.state_dict().items() if k in keys}
            return cfg, sd
        except (ImportError, OSError, ValueError) as exc:
            logging.getLogger(__name__).warning(
                "could not load HF CLIP checkpoint from %r (%s: %s) — "
                "using randomly-initialized towers",
                str(model_name_or_path), type(exc).__name__, exc,
            )
    cfg = config or CLIPConfig.vit_l_14()
    model = empty_model(cfg, device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    _seeded_init(model, gen)
    return cfg, model.state_dict()
