"""Seeded DeepSeek-V2 weights at a configuration's published widths, made
on the device one leaf at a time, so that a layer can be made again alone.

The leaves carry the checkpoint's names (``DeepseekV2ForCausalLM``). Each
is drawn standard normal in float32 from a generator of its own, seeded
from ``--seed`` and the leaf's place in :func:`spec`, scaled, and rounded
to bfloat16: the program loads those values and the reference
(``reference/deepseek_v2.py``) the same values upcast to float32. Products
are scaled by fan_in^-1/2 (the gate's too, so that its 64 scores spread
by about one), the token embedding by 1, and every RMSNorm weight is
``1 + 0.1 n``, random so that a path which drops one shows. A layer's
routed experts are three stacked leaves, each expert's weight a slice.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch

from .data import seed64
from .reference.deepseek_v2 import is_moe

DTYPE = torch.bfloat16


def _layer_spec(cfg: Mapping, i: int) -> list[tuple[str, tuple, str | float]]:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out: list = [
        ("input_layernorm.weight", (d,), "norm"),
        ("self_attn.q_proj.weight", (h * (nope + rd), d), d ** -0.5),
        ("self_attn.kv_a_proj_with_mqa.weight", (r + rd, d), d ** -0.5),
        ("self_attn.kv_a_layernorm.weight", (r,), "norm"),
        ("self_attn.kv_b_proj.weight", (h * (nope + vd), r), r ** -0.5),
        ("self_attn.o_proj.weight", (d, h * vd), (h * vd) ** -0.5),
        ("post_attention_layernorm.weight", (d,), "norm"),
    ]
    if is_moe(cfg, i):
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        s = f * cfg["n_shared_experts"]
        out += [("mlp.gate.weight", (e, d), d ** -0.5),
                ("mlp.experts.*.gate_proj.weight", (e, f, d), d ** -0.5),
                ("mlp.experts.*.up_proj.weight", (e, f, d), d ** -0.5),
                ("mlp.experts.*.down_proj.weight", (e, d, f), f ** -0.5)]
        if s:
            out += [("mlp.shared_experts.gate_proj.weight", (s, d), d ** -0.5),
                    ("mlp.shared_experts.up_proj.weight", (s, d), d ** -0.5),
                    ("mlp.shared_experts.down_proj.weight", (d, s), s ** -0.5)]
    else:
        f = cfg["intermediate_size"]
        out += [("mlp.gate_proj.weight", (f, d), d ** -0.5),
                ("mlp.up_proj.weight", (f, d), d ** -0.5),
                ("mlp.down_proj.weight", (d, f), f ** -0.5)]
    return out


def _outer_spec(cfg: Mapping) -> list[tuple[str, tuple, str | float]]:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("model.embed_tokens.weight", (v, d), 1.0),
            ("model.norm.weight", (d,), "norm"),
            ("lm_head.weight", (v, d), d ** -0.5)]


def spec(cfg: Mapping) -> list[tuple[str, tuple, str | float]]:
    """(name, shape, std or ``"norm"``) of every leaf; a ``*`` stands for
    the expert index of a stacked leaf."""
    out = _outer_spec(cfg)
    for i in range(cfg["num_hidden_layers"]):
        out += [(f"model.layers.{i}.{n}", s, how) for n, s, how in _layer_spec(cfg, i)]
    return out


def _leaf(seed: int, k: int, shape: tuple, how, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed64(seed64(seed) * 1_000_003 + k))
    x = torch.randn(shape, generator=gen, device=device)
    x = x.mul_(0.1).add_(1.0) if how == "norm" else x.mul_(how)
    return x.to(DTYPE)


def _make(cfg: Mapping, seed: int, device: torch.device, names: list[tuple[int, str, tuple, object]],
          prefix: str) -> dict[str, torch.Tensor]:
    out = {}
    for k, name, shape, how in names:
        leaf = _leaf(seed, k, shape, how, device)
        name = name[len(prefix):]
        if "*" in name:
            for e in range(shape[0]):
                out[name.replace("*", str(e))] = leaf[e]
        else:
            out[name] = leaf
    return out


def layer(cfg: Mapping, seed: int, i: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Layer ``i``'s bf16 leaves, named without ``model.layers.<i>.``."""
    pre = f"model.layers.{i}."
    names = [(k, n, s, how) for k, (n, s, how) in enumerate(spec(cfg)) if n.startswith(pre)]
    return _make(cfg, seed, device, names, pre)


def outer(cfg: Mapping, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The embedding, the final norm and the head, bf16."""
    names = [(k, n, s, how) for k, (n, s, how) in enumerate(spec(cfg)) if not n.startswith("model.layers.")]
    return _make(cfg, seed, device, names, "")


def layers(cfg: Mapping, seed: int, device: torch.device) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
    for i in range(cfg["num_hidden_layers"]):
        yield i, layer(cfg, seed, i, device)


def make(cfg: Mapping, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The whole state dict in the checkpoint's names, bf16 (small
    configurations; the large one is loaded a layer at a time)."""
    out = outer(cfg, seed, device)
    for i, leaves in layers(cfg, seed, device):
        out.update({f"model.layers.{i}.{k}": v for k, v in leaves.items()})
    return out


def load(model, cfg: Mapping, seed: int) -> None:
    """Copy the seeded leaves into the program's ``DeepseekV2ForCausalLM``
    a layer at a time (each layer strict: every leaf present, none extra)."""
    dev = model.lm_head.weight.device
    sd = outer(cfg, seed, dev)
    model.lm_head.load_state_dict({"weight": sd.pop("lm_head.weight")})
    model.model.norm.load_state_dict({"weight": sd.pop("model.norm.weight")})
    model.model.embed_tokens.load_state_dict({"weight": sd.pop("model.embed_tokens.weight")})
    for i, leaves in layers(cfg, seed, dev):
        model.model.layers[i].load_state_dict(leaves)
        del leaves
