"""L2 normalization of embedding batches (port of ``ops/normalize.py``)."""

from __future__ import annotations

import torch

__all__ = ["l2_normalize"]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalize along the last axis, in f32 accumulation, then
    back to the input dtype."""
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(norm, min=eps)).to(x.dtype)
