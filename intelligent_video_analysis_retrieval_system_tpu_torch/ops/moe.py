"""Routed experts of a mixture-of-experts layer as grouped products.

The JAX package has no mixture of experts; this op serves
``models/deepseek_v2.py``. Every token-expert pair of a layer is sorted by
expert, and each projection then runs as ONE grouped product over the
pairs: group ``e`` multiplies the rows routed to expert ``e`` by that
expert's weight. A decode step of 64 rows at top-6 routes 384 pairs over
64 experts, six rows an expert: the product reads each touched expert's
weights once and is bound by those bytes (1.1 GB a layer at
DeepSeek-V2-Lite's widths when all 64 are touched).

On a card the grouped product is ``torch._grouped_mm`` (one launch a
projection, group ends from a device tensor, so nothing is read back to the
host); on the CPU the plain version below loops over the experts, and the
CPU tests hold the two paths to the same arithmetic. The combine is the
published modelling code's: each pair's output times its routing weight in
float32, summed over a token's experts, rounded once to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grouped_mm", "routed_experts"]


def _grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``x`` (M, K) rows sorted by group, ``w`` (E, N, K), ``ends`` (E,)
    cumulative row counts: rows ``[ends[e-1], ends[e])`` times ``w[e].T``."""
    out = x.new_empty(x.shape[0], w.shape[1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """(M, N): the rows of each group times its expert's (N, K) weight.

    A CUDA tensor takes one ``torch._grouped_mm`` launch (bf16, ``ends`` an
    int32 device tensor, no host read); a CPU tensor the plain loop."""
    if x.device.type != "cuda":
        return _grouped_mm_plain(x, w, ends)
    grouped_mm.launches += 1
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


grouped_mm.launches = 0


def routed_experts(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                   gate_up: torch.Tensor, down: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ_k weight[t, k] · expert_{idx[t, k]}(x[t]) for SwiGLU experts.

    ``x`` (T, H); ``idx`` (T, k) expert ids and ``weight`` (T, k) float32
    routing weights; ``gate_up`` (E, 2I, H) each expert's gate and up
    projections stacked, ``down`` (E, H, I). Returns the (T, H) result in
    ``x``'s dtype and the (E,) pair count of each expert."""
    t, k = idx.shape
    n_exp, two_i, _ = gate_up.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # a scatter, not bincount: bincount reads the largest id back to the host
    counts = torch.zeros(n_exp, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    ends = counts.cumsum(0, dtype=torch.int32)
    h = grouped_mm(x[order // k], gate_up, ends)
    out_sorted = grouped_mm(F.silu(h[:, : two_i // 2]) * h[:, two_i // 2:], down, ends)
    pairs = torch.empty_like(out_sorted)
    pairs[order] = out_sorted
    y = torch.bmm(weight.unsqueeze(1), pairs.view(t, k, -1).float()).squeeze(1)
    return y.to(x.dtype), counts
