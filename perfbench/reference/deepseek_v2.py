"""DeepSeek-V2(-Lite) in plain PyTorch, float32, TF32 off: the reference
that decides the translate cell's ``correct``.

The full causal forward pass of one sequence, with no cache, no
absorption and no batching, written from the published
``modeling_deepseek.py`` (``DeepseekV2ForCausalLM``) and the configuration
file's keys. It reads a state dict in the checkpoint's names. The routed
experts run one by one over the tokens routed to each.

Departures from the published code, each noted where it is made:

- everything runs in float32 (the published code runs in the weights'
  dtype, with the gate's scores and the attention softmax in float32);
- the cos and sin tables and the rotation stay in float32 (the published
  code rounds them to the weights' dtype);
- the softmax scale multiplies float32 scores (the published code scales in
  the weights' dtype before its float32 softmax);
- the layers can run over several sequences in turn, one layer's weights
  at a time (:func:`logits_at`), so that float32 weights of a 15.7B
  model need not be held at once; each sequence still passes alone;
- only the variant DeepSeek-V2-Lite uses: no query compression, a softmax
  gate with greedy top-k, YaRN; no auxiliary loss.

``dense`` replaces every product with a weight (not the gate, whose scores
the published code computes in float32): :func:`fp8_dense` rounds inputs
and weights to float8 (e4m3), the control below the configuration's
bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Dense = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.t()


def fp8_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with ``x`` scaled per row and ``w`` per output channel to
    float8 e4m3's largest value (448), rounded to it, and scaled back."""
    e4m3 = torch.float8_e4m3fn

    def q(t: torch.Tensor) -> torch.Tensor:
        s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
        return (t / s).to(e4m3).float() * s

    return q(x) @ q(w).t()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def softmax_scale(cfg: Mapping) -> float:
    """``q_head_dim^-1/2`` times YaRN's ``mscale_all_dim`` factor squared."""
    qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    rs = cfg.get("rope_scaling") or {}
    m = _mscale(rs["factor"], rs["mscale_all_dim"]) if rs.get("mscale_all_dim") else 1.0
    return qd ** -0.5 * m * m


def rope_tables(cfg: Mapping, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of YaRN at positions 0..n-1, each (n, rope_dim)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot: float) -> float:
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra, inter = 1.0 / base ** expo, 1.0 / (factor * base ** expo)
    keep = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                  / (high - low)).clamp(0, 1)
    inv = inter * (1 - keep) + extra * keep
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    emb = torch.cat((freqs, freqs), -1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb``: de-interleave, rotate_half."""
    d = x.shape[-1]
    x = x.view(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat((-x[..., d // 2:], x[..., : d // 2]), -1)
    return x * cos + rot * sin


def attention(p: Mapping, cfg: Mapping, x: torch.Tensor, cos, sin, dense: Dense) -> torch.Tensor:
    """MLA over one sequence ``x`` (T, D), keys and values up-projected."""
    t = x.shape[0]
    h, nope, rd, vd, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    q = dense(x, p["self_attn.q_proj.weight"]).view(t, h, nope + rd)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], cos[:, None], sin[:, None])
    ckv = dense(x, p["self_attn.kv_a_proj_with_mqa.weight"])
    # the published kv_a_layernorm keeps its default eps, 1e-6
    c = rms_norm(ckv[:, :r], p["self_attn.kv_a_layernorm.weight"], 1e-6)
    k_pe = rope(ckv[:, r:], cos, sin)
    kv = dense(c, p["self_attn.kv_b_proj.weight"]).view(t, h, nope + vd)
    k = torch.cat((kv[..., :nope], k_pe[:, None].expand(t, h, rd)), -1)
    v = kv[..., nope:]
    qf = torch.cat((q_nope, q_pe), -1)
    scores = torch.einsum("thd,shd->hts", qf, k) * softmax_scale(cfg)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = scores.masked_fill(~mask, float("-inf")).softmax(-1)
    o = torch.einsum("hts,shv->thv", probs, v).reshape(t, h * vd)
    return dense(o, p["self_attn.o_proj.weight"])


def mlp(p: Mapping, pre: str, x: torch.Tensor, dense: Dense) -> torch.Tensor:
    g = dense(x, p[f"{pre}gate_proj.weight"])
    return dense(F.silu(g) * dense(x, p[f"{pre}up_proj.weight"]), p[f"{pre}down_proj.weight"])


def route(p: Mapping, cfg: Mapping, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, k) expert ids and weights: softmax over the gate's float32
    scores, greedy top-k, not renormalised, times the scaling factor."""
    scores = (x @ p["mlp.gate.weight"].t()).softmax(-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    return idx, w * cfg.get("routed_scaling_factor", 1.0)


def moe(p: Mapping, cfg: Mapping, x: torch.Tensor, dense: Dense) -> torch.Tensor:
    """The routed experts one by one over their tokens, then the shared
    experts (one MLP ``n_shared`` experts wide) over every token."""
    idx, w = route(p, cfg, x)
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, mlp(p, f"mlp.experts.{e}.", x[tok], dense) * w[tok, slot, None])
    if cfg.get("n_shared_experts"):
        y = y + mlp(p, "mlp.shared_experts.", x, dense)
    return y


def is_moe(cfg: Mapping, layer: int) -> bool:
    return (cfg["n_routed_experts"] > 0 and layer >= cfg["first_k_dense_replace"]
            and layer % cfg["moe_layer_freq"] == 0)


def layer(p: Mapping, cfg: Mapping, i: int, h: torch.Tensor, cos, sin, dense: Dense) -> torch.Tensor:
    """Decoder layer ``i`` over one sequence; ``p`` holds its leaves without
    the ``model.layers.<i>.`` prefix."""
    eps = cfg["rms_norm_eps"]
    h = h + attention(p, cfg, rms_norm(h, p["input_layernorm.weight"], eps), cos, sin, dense)
    x = rms_norm(h, p["post_attention_layernorm.weight"], eps)
    return h + (moe(p, cfg, x, dense) if is_moe(cfg, i) else mlp(p, "mlp.", x, dense))


def logits_at(cfg: Mapping, seqs: list[torch.Tensor], at: list[torch.Tensor],
              layer_params: Callable[[int], Mapping], outer: Mapping,
              dense: Dense = dense_f32) -> list[torch.Tensor]:
    """For each 1-D sequence of ids in ``seqs``, the (len(at[j]), V)
    logits at positions ``at[j]``. Layer ``i``'s float32 leaves come from
    ``layer_params(i)`` (names without ``model.layers.<i>.``) and are
    dropped before the next layer's; ``outer`` holds
    ``model.embed_tokens.weight``, ``model.norm.weight`` and
    ``lm_head.weight``."""
    dev = outer["lm_head.weight"].device
    n = max(int(s.shape[0]) for s in seqs)
    cos, sin = rope_tables(cfg, n, dev)
    hs = [outer["model.embed_tokens.weight"][s.to(dev)] for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(i)
        hs = [layer(p, cfg, i, h, cos[:h.shape[0]], sin[:h.shape[0]], dense) for h in hs]
        del p
    out = []
    for h, pos in zip(hs, at):
        x = rms_norm(h[pos.to(dev)], outer["model.norm.weight"], cfg["rms_norm_eps"])
        out.append(dense(x, outer["lm_head.weight"]))
    return out


def logits(sd: Mapping, cfg: Mapping, ids: torch.Tensor, dense: Dense = dense_f32) -> torch.Tensor:
    """(T, V) logits of the full causal pass over the 1-D ``ids``, from a
    whole float32 state dict."""
    def params(i: int) -> dict:
        pre = f"model.layers.{i}."
        return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}

    return logits_at(cfg, [ids], [torch.arange(ids.shape[0])], params, sd, dense)[0]


def generation_numbers(rows: list[tuple[list[int], list[float], list[float]]],
                       ref: list[torch.Tensor]) -> dict[str, float]:
    """The numbers that compare generated tokens with the reference.
    ``rows``: per sequence, the generated ids, the program's logit of each
    and the log-sum-exp of the logits it was chosen from; ``ref``: the
    reference's logits at those positions. Each gap is over the reference
    row's spread (the standard deviation of its logits), at every
    generated position:

    - ``logit_gap``: the program's logit of its token against the
      reference's logit of the same token, the mean over a row's
      positions, the largest of the rows;
    - ``lse_gap``: the two log-sum-exps, the same way;
    - ``token_shortfall``: how far below the reference's best logit the
      program's token lies (0 unless a near-tie flipped), the largest;
    - ``logit_gap_max``: the largest logit gap. A near-tie of the router
      that bfloat16 flips (another expert among the top k) moves a few
      positions' logits at once, so the largest gap has a long tail on
      sound runs; a row's mean holds the precision of its positions, and
      the largest row's holds a fault of one row alone (a slot or length
      off by one) undiluted by the others.

    A missing or non-finite number reads infinity on all of them."""
    names = ("logit_gap", "lse_gap", "token_shortfall", "logit_gap_max")
    logit, lse, short = [], [], []
    for (tokens, got, got_lse), r in zip(rows, ref):
        r = r.double().cpu()
        got = torch.tensor(got, dtype=torch.float64)
        got_lse = torch.tensor(got_lse, dtype=torch.float64)
        if (not len(tokens) or r.shape[0] != len(tokens) or got.shape != (len(tokens),)
                or got_lse.shape != got.shape or not torch.isfinite(got).all()
                or not torch.isfinite(got_lse).all()):
            return {k: math.inf for k in names}
        spread = r.std(dim=-1)
        chosen = r[torch.arange(len(tokens)), torch.tensor(tokens)]
        logit.append((got - chosen).abs() / spread)
        lse.append((got_lse - torch.logsumexp(r, -1)).abs() / spread)
        short.append((r.max(-1).values - chosen) / spread)
    if not logit:
        return {k: math.inf for k in names}
    return {"logit_gap": max(float(g.mean()) for g in logit),
            "lse_gap": max(float(g.mean()) for g in lse),
            "token_shortfall": max(float(g.max()) for g in short),
            "logit_gap_max": max(float(g.max()) for g in logit)}
