"""Weights across frameworks: the JAX tree, HF checkpoints and seeded init.

The port's modules carry HF-CLIP state-dict names, so

- an HF ``CLIPModel.state_dict()`` loads as it is (extra HF buffers such as
  ``position_ids`` are dropped);
- :func:`from_jax_params` turns the JAX package's ``CLIPModel`` param tree
  (numpy arrays) into a state dict, and the JAX package's
  ``convert_hf_clip_params`` is its exact inverse;
- :func:`from_optax_state` carries the trainer's optimizer state (optax's
  Adam ``count``, ``mu``, ``nu``) across through the same table, so a run
  of the JAX trainer continues in ``parallel.train``.

Conventions: Flax Dense kernels are ``(in, out)``, torch Linear weights
``(out, in)``; the Flax patch kernel is HWIO ``(p, p, 3, D)``, HF's conv
weight ``(D, 3, p, p)``; the towers' ``proj`` matrices become the
``text_projection`` / ``visual_projection`` weights (transposed); Flax
LayerNorm ``scale`` is torch ``weight``.

SigLIP (:mod:`models.siglip`) carries HF ``SiglipModel`` names, the MAP
head's ``vision_model.head.*``, ``text_model.head.*`` and ``logit_bias``
included: :func:`load_clip` seeds it or loads a local ``SiglipModel``
checkpoint when its config is a ``SiglipConfig`` or the checkpoint's
``model_type`` is ``siglip``, and :func:`from_hf_state_dict` keeps what
either family's modules hold of an HF state dict. :func:`model_config` is
the config of a ``model.name``.

The DINO tower (:mod:`models.dino`) carries HF ``ViTModel`` names:
:func:`from_jax_dino_params` turns the JAX ``DINOTower`` tree into its state
dict, the JAX package's ``convert_hf_vit_params`` is its exact inverse, and
:func:`load_dino` loads a local checkpoint or seeds the tower.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .clip import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig
from .dino import DINOConfig, DINOTower, hf_name
from .siglip import SiglipConfig, SiglipModel, SiglipTextConfig, SiglipVisionConfig

__all__ = ["MODEL_NAMES", "from_jax_params", "from_optax_state", "from_hf_state_dict",
           "hf_config_to_ours", "hf_siglip_config_to_ours", "load_clip", "empty_model",
           "model_config", "from_jax_dino_params", "load_dino"]

# ``model.name`` -> the towers it builds (HF repository names); each preset
# is looked up when called
MODEL_NAMES = {
    "clip-vit-large-patch14": lambda: CLIPConfig.vit_l_14(),
    "clip-vit-base-patch32": lambda: CLIPConfig.vit_b_32(),
    "siglip-so400m-patch14-384": lambda: SiglipConfig.so400m_patch14_384(),
}


def model_config(name: str) -> CLIPConfig | SiglipConfig:
    """The config of a ``model.name`` (:data:`MODEL_NAMES`)."""
    try:
        return MODEL_NAMES[name]()
    except KeyError:
        raise ValueError(f"unknown model.name {name!r}; known: {sorted(MODEL_NAMES)}") from None


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


def from_optax_state(opt_state: Any, config: CLIPConfig) -> dict[str, Any]:
    """The JAX trainer's ``optax.chain(clip_by_global_norm, adamw)`` state
    -> ``{"count": int, "mu": state dict, "nu": state dict}``, the optimizer
    state of ``parallel.train.CLIPTrainer`` before it is sharded
    (``CLIPTrainer.shard_opt_state``). The Adam state is the node of the
    chain's state that has ``count``, ``mu`` and ``nu``; its moments are
    param trees and map through :func:`from_jax_params`."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            return {"count": int(np.asarray(node.count)),
                    "mu": from_jax_params(node.mu, config),
                    "nu": from_jax_params(node.nu, config)}
        if isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
    raise ValueError("from_optax_state: no Adam state (count, mu, nu) in the optimizer state")


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


def hf_siglip_config_to_ours(hf_config: Any) -> SiglipConfig:
    """``transformers.SiglipConfig`` -> our dataclass config."""
    v, t = hf_config.vision_config, hf_config.text_config
    return SiglipConfig(
        vision=SiglipVisionConfig(
            image_size=v.image_size, patch_size=v.patch_size, hidden_size=v.hidden_size,
            intermediate_size=v.intermediate_size, num_layers=v.num_hidden_layers,
            num_heads=v.num_attention_heads, ln_eps=v.layer_norm_eps),
        text=SiglipTextConfig(
            vocab_size=t.vocab_size, max_length=t.max_position_embeddings,
            hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
            num_layers=t.num_hidden_layers, num_heads=t.num_attention_heads,
            ln_eps=t.layer_norm_eps),
    )


def empty_model(config: CLIPConfig | SiglipConfig, device: torch.device | str = "cpu",
                **kwargs: Any) -> CLIPModel | SiglipModel:
    """The model of ``config``'s family (:class:`CLIPModel` or
    :class:`SiglipModel`) with uninitialized parameters on ``device`` (built
    on the meta device, so no default init runs)."""
    family = SiglipModel if isinstance(config, SiglipConfig) else CLIPModel
    with torch.device("meta"):
        model = family(config, **kwargs)
    return model.to_empty(device=device)


def from_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                       config: CLIPConfig | SiglipConfig,
                       device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """An HF ``CLIPModel`` or ``SiglipModel`` state dict -> the f32 state
    dict of :func:`empty_model` ``(config)`` on ``device``: the same names,
    HF's buffers (``position_ids``) dropped; a name the model holds and the
    checkpoint lacks raises ``KeyError``."""
    keys = empty_model(config, "meta").state_dict()
    missing = sorted(set(keys) - set(state_dict))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's tensors: {missing[:4]}")
    return {k: state_dict[k].detach().float().reshape(keys[k].shape).to(device) for k in keys}


def _checkpoint_type(path: str | Path) -> str | None:
    """``model_type`` of a local HF checkpoint directory's config.json."""
    try:
        return json.loads((Path(path) / "config.json").read_text()).get("model_type")
    except (OSError, ValueError):
        return None


@torch.no_grad()
def _seeded_init(model: CLIPModel, generator: torch.Generator) -> None:
    """CLIP-style init (the reference's Flax initializers): Linear weights
    lecun-normal, biases zero, LayerNorm ones/zeros, embeddings N(0, 0.02)
    (text positions N(0, 0.01)), projections N(0, hidden^-1/2). SigLIP's
    packed ``in_proj_weight`` and ``probe`` take fan_in too, its
    ``logit_bias`` the config's init."""
    cfg = model.config
    for name, p in model.named_parameters():
        if name == "logit_scale":
            p.fill_(cfg.logit_scale_init)
        elif name == "logit_bias":
            p.fill_(cfg.logit_bias_init)
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
    config: CLIPConfig | SiglipConfig | None = None,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> tuple[CLIPConfig | SiglipConfig, dict[str, torch.Tensor]]:
    """(config, state dict on ``device``) of either tower family.

    A local HF checkpoint directory loads when ``transformers`` imports (a
    ``SiglipModel`` where ``config`` is a ``SiglipConfig`` or the
    checkpoint's ``model_type`` is ``siglip``, else a ``CLIPModel``);
    otherwise (or without a path) the towers are initialized at the
    config's full width from ``torch.Generator(device).manual_seed(seed)``.
    Network access is never attempted.
    """
    if model_name_or_path is not None:
        try:
            import transformers

            siglip = (isinstance(config, SiglipConfig)
                      or _checkpoint_type(model_name_or_path) == "siglip")
            family = transformers.SiglipModel if siglip else transformers.CLIPModel
            hf = family.from_pretrained(str(model_name_or_path), local_files_only=True)
            cfg = (hf_siglip_config_to_ours if siglip else hf_config_to_ours)(hf.config)
            return cfg, from_hf_state_dict(hf.state_dict(), cfg, device)
        except (ImportError, OSError, ValueError) as exc:
            logging.getLogger(__name__).warning(
                "could not load HF checkpoint from %r (%s: %s) — "
                "using randomly-initialized towers",
                str(model_name_or_path), type(exc).__name__, exc,
            )
    cfg = config or CLIPConfig.vit_l_14()
    model = empty_model(cfg, device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    _seeded_init(model, gen)
    return cfg, model.state_dict()


# ---------------------------------------------------------------------------
# DINO ViT-S/16
# ---------------------------------------------------------------------------


def from_jax_dino_params(params: Mapping[str, Any],
                         config: DINOConfig) -> dict[str, torch.Tensor]:
    """JAX ``DINOTower`` params (numpy leaves) -> a state dict in HF
    ``ViTModel`` names for :class:`models.dino.DINOTower`."""
    sd: dict[str, torch.Tensor] = {
        "embeddings.cls_token": _tensor(params["cls_token"]).reshape(1, 1, -1),
        "embeddings.position_embeddings": _tensor(params["positional_embedding"])[None],
        "embeddings.patch_embeddings.projection.weight": torch.from_numpy(
            np.array(np.transpose(np.asarray(params["patch_embed"]["kernel"], np.float32),
                                  (3, 2, 0, 1)), order="C")),
        "embeddings.patch_embeddings.projection.bias": _tensor(params["patch_embed"]["bias"]),
        "layernorm.weight": _tensor(params["ln_final"]["scale"]),
        "layernorm.bias": _tensor(params["ln_final"]["bias"]),
    }
    for i in range(config.num_layers):
        block = _block(params["transformer"][f"layer_{i}"], f"encoder.layers.{i}")
        sd.update({hf_name(k): v for k, v in block.items()})
    return sd


@torch.no_grad()
def _seeded_dino_init(tower: DINOTower, generator: torch.Generator) -> None:
    """The reference's Flax initializers: the patch projection and Linear
    weights lecun-normal, biases zero, LayerNorm ones/zeros, the CLS token
    and positions N(0, 0.02)."""
    for name, p in tower.named_parameters():
        if "layer_norm" in name or name.startswith("layernorm"):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        elif name.endswith(("cls_token", "position_embeddings")):
            p.normal_(0.0, 0.02, generator=generator)
        else:  # Linear (out, in) and the patch projection (D, 3, p, p): fan_in
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def load_dino(
    model_path: str | Path | None = None,
    config: DINOConfig | None = None,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> tuple[DINOConfig, dict[str, torch.Tensor]]:
    """(config, state dict on ``device``) of the DINO tower.

    A local HF ``ViTModel`` checkpoint directory loads when ``transformers``
    imports (``local_files_only``: nothing is downloaded); otherwise, or
    without a path, the tower is initialized at the config's width from
    ``torch.Generator(device).manual_seed(seed)``."""
    cfg = config or DINOConfig.vit_s_16()
    if model_path is not None:
        try:
            import transformers

            hf = transformers.ViTModel.from_pretrained(
                str(model_path), local_files_only=True, add_pooling_layer=False)
            return cfg, {k: v.detach().float().to(device)
                         for k, v in hf.state_dict().items()}
        except (ImportError, OSError, ValueError) as exc:
            logging.getLogger(__name__).warning(
                "could not load HF ViT checkpoint from %r (%s: %s) — using a "
                "randomly-initialized DINO tower", str(model_path), type(exc).__name__, exc)
    with torch.device("meta"):
        tower = DINOTower(cfg)
    tower = tower.to_empty(device=device)
    _seeded_dino_init(tower, torch.Generator(device=torch.device(device)).manual_seed(seed))
    return cfg, tower.state_dict()
