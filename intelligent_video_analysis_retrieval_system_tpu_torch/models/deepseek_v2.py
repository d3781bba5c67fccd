"""DeepSeek-V2-Lite as a PyTorch decoder (``deepseek-ai/DeepSeek-V2-Lite``).

DeepSeek-AI, "DeepSeek-V2: A Strong, Economical, and Efficient
Mixture-of-Experts Language Model" (arXiv:2405.04434); the equations of the
published ``modeling_deepseek.py``. The JAX package has no decoder: the
plain reference the tests hold this module to is
``perfbench/reference/deepseek_v2.py``.

- Pre-norm blocks (RMSNorm, eps 1e-6, the variance in float32).
- MLA, multi-head latent attention, without query compression: each head's
  query and key are 128 wide without position plus 64 with RoPE, its value
  128 wide. Keys and values come from a 512-wide latent with its own
  RMSNorm (``kv_a_layernorm``) through ``kv_b_proj``; the RoPE key is 64
  wide and shared by every head.
- YaRN RoPE on the 64 rotary dims, in the published layout: the pairs are
  de-interleaved before ``rotate_half``. The softmax scale is
  ``192^-1/2 * mscale^2`` (0.114721 for the published config).
- Layer 0 a dense SwiGLU MLP; the others a mixture of experts: a softmax
  gate in float32 over the routed experts, greedy top-k with no
  renormalisation, times ``routed_scaling_factor``; the routed experts as
  grouped products (:mod:`..ops.moe`), plus the shared experts as one MLP
  ``n_shared * moe_intermediate_size`` wide.
- An untied ``lm_head``; logits in the weights' dtype, then float32.

The cache (:class:`LatentCache`) holds per token and layer only the normed
latent and the roped key, 576 values at the published widths. Prefill
up-projects keys and values from the latent; decode attends in the latent
space: ``W_UK`` is folded into the query, ``W_UV`` applied after the
softmax, so nothing is up-projected over the cache in a step. A decode
step's shapes do not change with the position, and nothing in a step
reads a device value back.

Parameter names are the published checkpoint's (``DeepseekV2ForCausalLM``):
``model.layers.N.self_attn.q_proj``, ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``, ``mlp.gate``,
``mlp.experts.N.{gate,up,down}_proj``, ``mlp.shared_experts.*``. The routed
experts are stored stacked for the grouped products and read and written
under the per-expert names, so the checkpoint's state dict loads as it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import routed_experts

__all__ = ["DeepseekV2Config", "DeepseekV2ForCausalLM", "LatentCache", "YarnRope",
           "init_seeded", "yarn_correction_range"]


@dataclass(frozen=True)
class DeepseekV2Config:
    """Shape keys of the published ``config.json`` under its own names."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 163840
    rope_factor: float = 40.0
    rope_original_max_position_embeddings: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    @classmethod
    def lite(cls) -> DeepseekV2Config:
        """DeepSeek-V2-Lite as published: 27 layers of 2,048, 16 heads, 64
        routed experts 1,408 wide (top 6) and 2 shared, 102,400 ids."""
        return cls()

    @classmethod
    def tiny_test(cls) -> DeepseekV2Config:
        """Every mechanism at CPU-test size: one dense layer and two MoE
        layers, 8 experts (top 3) and 2 shared, the published YaRN."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                   num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
                   num_experts_per_tok=3, kv_lora_rank=32, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16)

    @classmethod
    def from_hf(cls, cfg: Mapping[str, Any]) -> DeepseekV2Config:
        """The config of a published ``config.json`` (a mapping). Only the
        variant DeepSeek-V2-Lite uses is built: no query compression, a
        softmax gate with greedy top-k, YaRN."""
        rs = cfg.get("rope_scaling") or {}
        if cfg.get("q_lora_rank") is not None:
            raise ValueError("query compression (q_lora_rank) is not built")
        if cfg.get("scoring_func", "softmax") != "softmax" or cfg.get("topk_method", "greedy") != "greedy":
            raise ValueError("only the softmax gate with greedy top-k is built")
        if rs and rs.get("type") != "yarn":
            raise ValueError(f"rope_scaling {rs.get('type')!r}: only yarn is built")
        keys = {k: cfg[k] for k in (
            "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
            "num_hidden_layers", "num_attention_heads", "n_routed_experts", "n_shared_experts",
            "num_experts_per_tok", "first_k_dense_replace", "moe_layer_freq", "kv_lora_rank",
            "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rms_norm_eps", "rope_theta",
            "max_position_embeddings", "routed_scaling_factor", "norm_topk_prob") if k in cfg}
        if rs:
            keys.update(rope_factor=rs["factor"],
                        rope_original_max_position_embeddings=rs["original_max_position_embeddings"],
                        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"],
                        rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"])
        return cls(**keys)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token keeps per layer in the cache: latent plus RoPE key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        m = _yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.q_head_dim ** -0.5 * m * m

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# -- YaRN RoPE -----------------------------------------------------------------


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_correction_range(cfg: DeepseekV2Config) -> tuple[int, int]:
    """The rotary pairs between which YaRN ramps from interpolated to
    original frequencies ((10, 23) for the published config)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig = cfg.rope_original_max_position_embeddings
    low = math.floor(_correction_dim(cfg.rope_beta_fast, dim, base, orig))
    high = math.ceil(_correction_dim(cfg.rope_beta_slow, dim, base, orig))
    return max(low, 0), min(high, dim - 1)


class YarnRope:
    """YaRN's rotation over the rotary dims as a complex64 table (``cos +
    i sin`` of each pair's angle, times YaRN's cos/sin scale), built for
    the positions in use on the device that asks."""

    def __init__(self, cfg: DeepseekV2Config) -> None:
        dim = cfg.qk_rope_head_dim
        expo = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        extra = 1.0 / cfg.rope_theta ** expo
        inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** expo)
        low, high = yarn_correction_range(cfg)
        high = high + 0.001 if low == high else high
        ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
        keep = 1.0 - ramp
        self.inv_freq = inter * (1 - keep) + extra * keep
        self.mscale = (_yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
                       / _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
        self._table: torch.Tensor | None = None

    def table(self, n: int, device: torch.device) -> torch.Tensor:
        """(n', dim / 2) complex64 with n' >= n, on ``device``."""
        t = self._table
        if t is None or t.shape[0] < n or t.device != torch.device(device):
            freqs = torch.outer(torch.arange(n, dtype=torch.float32), self.inv_freq)
            t = torch.complex(freqs.cos() * self.mscale, freqs.sin() * self.mscale).to(device)
            self._table = t
        return t

    def at(self, pos: torch.Tensor) -> torch.Tensor:
        """The rotation at integer positions ``pos`` (any shape, on the
        table's device; build the table first with :meth:`table`)."""
        return self._table[pos]


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """The published rotation: de-interleave the pairs, then rotate_half,
    i.e. pair ``(x[2i], x[2i+1])`` times ``rot[i]`` as a complex number,
    the real parts first; in float32, rounded once to ``x``'s dtype."""
    z = torch.view_as_complex(x.float().contiguous().unflatten(-1, (-1, 2))) * rot
    return torch.view_as_real(z).transpose(-1, -2).flatten(-2).to(x.dtype)


# -- modules -------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In float32, the weight applied before the one rounding to
        ``x``'s dtype (the published code rounds, then applies it)."""
        return F.rms_norm(x, self.weight.shape, self.weight, self.eps)


def _linear(n_in: int, n_out: int, device, dtype) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)
    layer.weight.requires_grad_(False)
    return layer


class DeepseekV2Attention(nn.Module):
    """MLA without query compression. :meth:`prefill` up-projects keys and
    values from the latent; :meth:`decode` attends against the cached
    latent with ``W_UK`` folded into the query."""

    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None) -> None:
        super().__init__()
        self.cfg = cfg
        h, d, r = cfg.num_attention_heads, cfg.hidden_size, cfg.kv_lora_rank
        self.q_proj = _linear(d, h * cfg.q_head_dim, device, dtype)
        self.kv_a_proj_with_mqa = _linear(d, r + cfg.qk_rope_head_dim, device, dtype)
        # the published module builds this norm with its default eps, 1e-6
        self.kv_a_layernorm = RMSNorm(r, 1e-6, device, dtype)
        self.kv_b_proj = _linear(r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), device, dtype)
        self.o_proj = _linear(h * cfg.v_head_dim, d, device, dtype)

    def _queries(self, x, rot) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        q = self.q_proj(x).unflatten(-1, (c.num_attention_heads, c.q_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)
        return q_nope, apply_rope(q_pe, rot.unsqueeze(-2))

    def latent(self, x, rot) -> torch.Tensor:
        """(..., 576): the normed latent and the roped shared key."""
        r = self.cfg.kv_lora_rank
        ckv = self.kv_a_proj_with_mqa(x)
        return torch.cat((self.kv_a_layernorm(ckv[..., :r]), apply_rope(ckv[..., r:], rot)), -1)

    def _up(self, lat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., H, 192) keys and (..., H, 128) values from latents."""
        c = self.cfg
        kv = self.kv_b_proj(lat[..., :c.kv_lora_rank]).unflatten(
            -1, (c.num_attention_heads, c.qk_nope_head_dim + c.v_head_dim))
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], dim=-1)
        k_pe = lat[..., c.kv_lora_rank:].unsqueeze(-2).expand(*k_nope.shape[:-1], -1)
        return torch.cat((k_nope, k_pe), -1), v

    def prefill(self, x, rot, prefix: torch.Tensor | None):
        """``x`` (B, T, D) at rotations (B, T, 32); each token attends to every
        ``prefix`` latent (P, 576) and causally to its own row. Returns the
        output and the rows' latents (B, T, 576)."""
        b, t, _ = x.shape
        q_nope, q_pe = self._queries(x, rot)
        q = torch.cat((q_nope, q_pe), -1).transpose(1, 2)              # (B, H, T, 192)
        lat = self.latent(x, rot)
        k, v = self._up(lat)
        scores = q @ k.permute(0, 2, 3, 1)                               # (B, H, T, T)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.float().masked_fill(~causal, float("-inf"))
        if prefix is not None:
            kp, vp = self._up(prefix)                                    # (P, H, ...)
            scores = torch.cat((torch.einsum("bhtd,phd->bhtp", q, kp).float(), scores), -1)
        p = torch.softmax(scores * self.cfg.softmax_scale, dim=-1).to(x.dtype)
        n_pre = 0 if prefix is None else prefix.shape[0]
        o = p[..., n_pre:] @ v.transpose(1, 2)                           # (B, H, T, 128)
        if prefix is not None:
            o = o + torch.einsum("bhtp,phv->bhtv", p[..., :n_pre], vp)
        return self.o_proj(o.transpose(1, 2).flatten(-2)), lat

    def decode(self, x, rot, prefix: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
               invalid: torch.Tensor) -> torch.Tensor:
        """One token a row: ``x`` (B, D). Its latent goes into ``rows`` (B, L,
        576, a view of the cache) at ``slot`` (B,); the token attends to the
        prefix and to the row's slots but where ``invalid`` (B, 1, L)."""
        c = self.cfg
        h, r, nope = c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim
        q_nope, q_pe = self._queries(x, rot)                              # (B, H, 128), (B, H, 64)
        rows[torch.arange(x.shape[0], device=x.device), slot] = self.latent(x, rot)
        w = self.kv_b_proj.weight.view(h, nope + c.v_head_dim, r)
        q_lat = torch.einsum("bhn,hnc->bhc", q_nope, w[:, :nope])          # W_UK folded in
        qf = torch.cat((q_lat, q_pe), -1) * c.softmax_scale                # (B, H, 576)
        s_own = torch.bmm(qf, rows.transpose(1, 2)).masked_fill(invalid, float("-inf"))
        s = torch.cat((torch.einsum("bhc,pc->bhp", qf, prefix), s_own), -1)
        p = torch.softmax(s, dim=-1, dtype=torch.float32).to(x.dtype)
        n_pre = prefix.shape[0]
        o_lat = torch.baddbmm(torch.einsum("bhp,pc->bhc", p[..., :n_pre], prefix[:, :r]),
                              p[..., n_pre:], rows[..., :r])
        o = torch.einsum("bhc,hvc->bhv", o_lat, w[:, nope:])              # W_UV after
        return self.o_proj(o.flatten(-2))


class DeepseekV2MLP(nn.Module):
    def __init__(self, hidden: int, inter: int, device=None, dtype=None) -> None:
        super().__init__()
        self.gate_proj = _linear(hidden, inter, device, dtype)
        self.up_proj = _linear(hidden, inter, device, dtype)
        self.down_proj = _linear(inter, hidden, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DeepseekV2Experts(nn.Module):
    """The routed experts stacked for the grouped products: ``gate_up`` (E,
    2I, H), each expert's gate projection above its up projection, and
    ``down`` (E, H, I). Read and written under the checkpoint's names,
    ``<prefix><e>.{gate,up,down}_proj.weight``."""

    def __init__(self, n: int, hidden: int, inter: int, device=None, dtype=None) -> None:
        super().__init__()
        self.inter = inter
        self.gate_up = nn.Parameter(torch.empty(n, 2 * inter, hidden, device=device, dtype=dtype),
                                    requires_grad=False)
        self.down = nn.Parameter(torch.empty(n, hidden, inter, device=device, dtype=dtype),
                                 requires_grad=False)

    def _views(self, prefix: str):
        i = self.inter
        for e in range(self.gate_up.shape[0]):
            yield f"{prefix}{e}.gate_proj.weight", self.gate_up[e, :i]
            yield f"{prefix}{e}.up_proj.weight", self.gate_up[e, i:]
            yield f"{prefix}{e}.down_proj.weight", self.down[e]

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, view in self._views(prefix):
            destination[name] = view if keep_vars else view.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        names = set()
        with torch.no_grad():
            for name, view in self._views(prefix):
                names.add(name)
                if name not in state_dict:
                    missing_keys.append(name)
                elif state_dict[name].shape != view.shape:
                    error_msgs.append(f"{name}: shape {tuple(state_dict[name].shape)}, "
                                      f"expected {tuple(view.shape)}")
                else:
                    view.copy_(state_dict[name])
        if strict:
            unexpected_keys.extend(k for k in state_dict if k.startswith(prefix) and k not in names)


class DeepseekV2MoEGate(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None) -> None:
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.scale = cfg.routed_scaling_factor
        self.weight = nn.Parameter(
            torch.empty(cfg.n_routed_experts, cfg.hidden_size, device=device, dtype=dtype),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, k) expert ids and float32 weights: softmax of float32 scores,
        greedy top-k, no renormalisation."""
        scores = F.linear(x.float(), self.weight.float()).softmax(dim=-1)
        weight, idx = torch.topk(scores, self.top_k, dim=-1)
        return idx, (weight if self.scale == 1.0 else weight * self.scale)


class DeepseekV2MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None) -> None:
        super().__init__()
        self.gate = DeepseekV2MoEGate(cfg, device, dtype)
        self.experts = DeepseekV2Experts(cfg.n_routed_experts, cfg.hidden_size,
                                         cfg.moe_intermediate_size, device, dtype)
        self.shared_experts = (DeepseekV2MLP(cfg.hidden_size,
                                             cfg.moe_intermediate_size * cfg.n_shared_experts,
                                             device, dtype)
                               if cfg.n_shared_experts else None)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The layer's output and the (E,) pair count of each routed expert."""
        flat = x.reshape(-1, x.shape[-1])
        idx, weight = self.gate(flat)
        y, counts = routed_experts(flat, idx, weight, self.experts.gate_up, self.experts.down)
        if self.shared_experts is not None:
            y = y + self.shared_experts(flat)
        return y.view(x.shape), counts


class DeepseekV2DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, device=None, dtype=None) -> None:
        super().__init__()
        self.self_attn = DeepseekV2Attention(cfg, device, dtype)
        self.mlp = (DeepseekV2MoE(cfg, device, dtype) if cfg.is_moe(layer)
                    else DeepseekV2MLP(cfg.hidden_size, cfg.intermediate_size, device, dtype))
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)

    def feed_forward(self, h: torch.Tensor, hits: torch.Tensor | None) -> torch.Tensor:
        """``h + mlp(norm(h))``; a MoE layer adds its distinct experts
        touched to ``hits`` (a device scalar), never read here."""
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, DeepseekV2MoE):
            y, counts = self.mlp(x)
            if hits is not None:
                hits += counts.count_nonzero()
            return h + y
        return h + self.mlp(x)


class DeepseekV2Model(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None) -> None:
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.embed_tokens.weight.requires_grad_(False)
        self.layers = nn.ModuleList(DeepseekV2DecoderLayer(cfg, i, device, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)


@dataclass
class LatentCache:
    """Per layer, the shared prefix's latents (layers, P, 576) and a block
    of rows (layers, B, L, 576): row ``b``'s own tokens at slots 0, 1, ...
    in order, prompt first, then each generated token."""

    prefix: torch.Tensor
    rows: torch.Tensor

    @classmethod
    def allocate(cls, cfg: DeepseekV2Config, prefix: torch.Tensor, rows: int, length: int) -> LatentCache:
        return cls(prefix=prefix,
                   rows=prefix.new_zeros(cfg.num_hidden_layers, rows, length, cfg.latent_dim))


class DeepseekV2ForCausalLM(nn.Module):
    """The decoder and its head, with the engine's three passes:
    :meth:`encode_prefix`, :meth:`prefill` and :meth:`decode`; ``forward``
    is the full causal pass with no cache."""

    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=torch.bfloat16) -> None:
        super().__init__()
        self.config = cfg
        self.model = DeepseekV2Model(cfg, device, dtype)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, device, dtype)
        self.rope = YarnRope(cfg)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.model.norm(h)).float()

    def _prefill_layers(self, ids: torch.Tensor, pos: torch.Tensor, prefix: torch.Tensor | None,
                        hits: torch.Tensor | None):
        """Hidden states (B, T, D) and each layer's latents (B, T, 576)."""
        rot = self.rope.at(pos)
        h = self.model.embed_tokens(ids)
        lats = []
        for i, layer in enumerate(self.model.layers):
            a, lat = layer.self_attn.prefill(layer.input_layernorm(h), rot,
                                             None if prefix is None else prefix[i])
            lats.append(lat)
            h = layer.feed_forward(h + a, hits)
        return h, lats

    @torch.inference_mode()
    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T, V) float32 logits of the full causal pass, no cache."""
        self.rope.table(ids.shape[1], ids.device)
        pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape[0], -1)
        h, _ = self._prefill_layers(ids, pos, None, None)
        return self._logits(h)

    @torch.inference_mode()
    def encode_prefix(self, ids: torch.Tensor) -> torch.Tensor:
        """(layers, P, 576): the latents of the 1-D prompt ``ids`` at
        positions 0..P-1."""
        self.rope.table(ids.shape[0], ids.device)
        _, lats = self._prefill_layers(ids[None], torch.arange(ids.shape[0], device=ids.device)[None],
                                       None, None)
        return torch.stack([lat[0] for lat in lats])

    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor, lengths: torch.Tensor, cache: LatentCache,
                hits: torch.Tensor | None = None) -> torch.Tensor:
        """Row ``b``'s ``lengths[b]`` tokens of ``ids`` (B, T, padded at the
        end) after the cached prefix: their latents go to the cache's rows
        0..B-1 at slots 0..T-1, and the float32 logits (B, V) of each row's
        last token come back. Pads follow every real token, so the causal
        mask keeps them out of every real token's attention."""
        b, t = ids.shape
        n_pre = cache.prefix.shape[1]
        pos = n_pre + torch.arange(t, device=ids.device).expand(b, -1)
        h, lats = self._prefill_layers(ids, pos, cache.prefix, hits)
        for i, lat in enumerate(lats):
            cache.rows[i, :b, :t] = lat
        last = h[torch.arange(b, device=ids.device), lengths - 1]
        return self._logits(last)

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, slot: torch.Tensor, cache: LatentCache,
               hits: torch.Tensor | None = None) -> torch.Tensor:
        """One token a row: ``tokens`` (B,) at slot ``slot`` (B,) of their
        rows (position prefix + slot), each attending to the prefix and to
        its slots up to its own. Every slot of a row is read and those
        after its own masked, so the shapes are the same at every position
        (what a captured step needs). Returns float32 logits (B, V)."""
        b = tokens.shape[0]
        rot = self.rope.at(cache.prefix.shape[1] + slot)
        invalid = (torch.arange(cache.rows.shape[2], device=tokens.device)
                   > slot[:, None]).unsqueeze(1)
        h = self.model.embed_tokens(tokens)
        for i, layer in enumerate(self.model.layers):
            a = layer.self_attn.decode(layer.input_layernorm(h), rot, cache.prefix[i],
                                       cache.rows[i, :b], slot, invalid)
            h = layer.feed_forward(h + a, hits)
        return self._logits(h)


@torch.no_grad()
def init_seeded(model: DeepseekV2ForCausalLM, seed: int) -> DeepseekV2ForCausalLM:
    """Random weights from ``seed`` where no checkpoint is given: products
    normal with std fan_in^-1/2, the embedding standard normal, norms one.
    Each parameter draws from its own generator on its own device."""
    for i, (name, p) in enumerate(sorted(model.named_parameters())):
        if name.endswith("layernorm.weight") or name.endswith("norm.weight"):
            p.fill_(1.0)
            continue
        gen = torch.Generator(device=p.device).manual_seed(seed * 1_000_003 + i)
        std = 1.0 if name.endswith("embed_tokens.weight") else p.shape[-1] ** -0.5
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
    return model
