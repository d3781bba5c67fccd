"""Operations and bytes of DeepSeek-V2's generation calls, from the
configuration's shapes and the program's counters, at the peaks of
:mod:`perfbench.roofline`.

A call (the program's ``llm.generate`` span, ``rows`` rows) runs one
prefill pass over ``llm.prefill_tokens`` tokens (``rows`` x the longest
row, pads included: what the card computes) and ``llm.steps`` decode
steps of ``rows`` tokens each (``llm.decode_tokens``). Each pass reads
every weight outside the routed experts once (the embedding only at its
gathered rows) and each routed expert it touches once
(``moe.experts_hit``, summed over the MoE layers' passes); a decode step
also reads the cached latents it attends to (the prefix of ``prefix``
tokens and each row's own slots). Operations: two for every weight a
token meets, attention's products (prefill up-projected, decode in the
latent space), and the head over each row's last prefill token and every
decoded token.
"""

from __future__ import annotations

from typing import Mapping

from .reference.deepseek_v2 import is_moe
from .roofline import bound_s

__all__ = ["attn_params", "call_bound_s", "call_work", "dense_params", "expert_bound_s",
           "expert_params", "expert_work"]

ELEM = 2   # bf16


def _moe_layers(c: Mapping) -> int:
    return sum(1 for i in range(c["num_hidden_layers"]) if is_moe(c, i))


def attn_params(c: Mapping) -> int:
    d, h, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return d * h * (nope + rd) + d * (r + rd) + r * h * (nope + vd) + h * vd * d


def expert_params(c: Mapping) -> int:
    """One routed expert: gate, up and down."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def dense_params(c: Mapping) -> int:
    """Weights every token meets in one pass, the routed experts and the
    embedding left out: attention, the dense MLPs, the gates, the shared
    experts and the head."""
    d, layers, moe = c["hidden_size"], c["num_hidden_layers"], _moe_layers(c)
    shared = 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"]
    return (layers * attn_params(c) + (layers - moe) * 3 * d * c["intermediate_size"]
            + moe * (shared + c["n_routed_experts"] * d) + c["vocab_size"] * d)


def expert_work(c: Mapping, counts: Mapping) -> tuple[float, float]:
    """(ops, bytes) of the routed experts' grouped products in a call: each
    token-expert pair through gate, up and down; each touched expert's
    weights once, each pair's input, hidden and output once."""
    d, f, k = c["hidden_size"], c["moe_intermediate_size"], c["num_experts_per_tok"]
    pairs = (counts["llm.prefill_tokens"] + counts["llm.decode_tokens"]) * k * _moe_layers(c)
    ops = 2.0 * pairs * expert_params(c)
    nbytes = counts["moe.experts_hit"] * expert_params(c) * ELEM + pairs * (2 * d + 3 * f) * ELEM
    return ops, float(nbytes)


def call_work(c: Mapping, counts: Mapping, rows: int, prompt: int, prefix: int) -> tuple[float, float]:
    """(ops, bytes) of one generation call of ``rows`` rows holding
    ``prompt`` real prompt tokens in all, after a cached prefix of
    ``prefix`` tokens. Attention counts what the rows need: the prefix and
    each row's own tokens so far (its pads and the longer rows' slots left
    out; the causal part of prefill at its least for ``prompt`` tokens)."""
    d, h, layers = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"]
    r, rd, nope, vd = c["kv_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"], c["v_head_dim"]
    steps, pre, dec = counts["llm.steps"], counts["llm.prefill_tokens"], counts["llm.decode_tokens"]
    tokens = pre + dec
    e_ops, e_bytes = expert_work(c, counts)
    head = c["vocab_size"] * d
    ops = 2.0 * (dense_params(c) - head) * tokens + 2.0 * head * (rows + dec) + e_ops
    # prefill: the prefix's keys and values up-projected, scores and values
    # over the prefix and, causally, the row's own tokens
    ops += layers * (2.0 * prefix * r * h * (nope + vd)
                     + 2.0 * h * (nope + rd + vd) * (prompt * prefix + prompt * prompt / (2.0 * rows)))
    # decode: W_UK and W_UV folded in, scores and values over the 576- and
    # 512-wide latents of the prefix and the row's slots so far
    own = steps * prompt + rows * steps * (steps + 1) / 2.0
    ops += layers * (dec * 4.0 * h * nope * r + 2.0 * h * (2 * r + rd) * (dec * prefix + own))
    latent = (r + rd) * ELEM
    nbytes = (dense_params(c) * ELEM * (steps + 1) + tokens * d * ELEM + e_bytes
              + layers * latent * (steps * prefix + own + tokens))
    return ops, float(nbytes)


def call_bound_s(c: Mapping, counts: Mapping, rows: int, prompt: int, prefix: int) -> float:
    return bound_s(*call_work(c, counts, rows, prompt, prefix))


def expert_bound_s(c: Mapping, counts: Mapping) -> float:
    return bound_s(*expert_work(c, counts))

