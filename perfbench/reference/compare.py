"""The numbers that compare answers with the reference.

A search answer is the ranked row ids and scores of one query. Against the
reference's scores of the same query:

- ``hit_shortfall``: the most by which the reference's score of an answered
  row lies below the reference's k-th best score (0 when every answered row
  is among the reference's top k; a wrong row, a missing part of the index
  or a perturbed query shows here);
- ``score_gap``: the most by which an answered score differs from the
  reference's score of that row (the precision of the query's embedding and
  of the product);
- an answer with fewer than k rows, or a row twice, is wrong outright and
  reads infinity on both.

An embedding is compared by ``embed_gap``: the largest L2 distance between
the program's normalized embedding and the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def search_numbers(ids: np.ndarray, scores: np.ndarray, counts: np.ndarray,
                   ref_kth: torch.Tensor, ref_of_ids: torch.Tensor) -> dict[str, float]:
    """``ids``/``scores``: (B, k) answered rows and scores (anything where
    ``counts`` < k); ``ref_kth``: (B,) the reference's k-th best score;
    ``ref_of_ids``: (B, k) the reference's score of each answered row."""
    k = ids.shape[1]
    bad = counts < k
    bad |= np.array([len(set(row.tolist())) < k for row in ids])
    if bad.any():
        return {"hit_shortfall": math.inf, "score_gap": math.inf}
    ref = ref_of_ids.double().cpu().numpy()
    kth = ref_kth.double().cpu().numpy()
    shortfall = float(np.max(np.maximum(kth[:, None] - ref, 0.0)))
    gap = float(np.max(np.abs(scores.astype(np.float64) - ref)))
    return {"hit_shortfall": shortfall, "score_gap": gap}


def embed_gap(program: np.ndarray, reference: torch.Tensor) -> float:
    """Largest L2 distance between rows of two sets of embeddings, each
    normalized here."""
    ref = reference.double().cpu().numpy()
    ref /= np.maximum(np.linalg.norm(ref, axis=-1, keepdims=True), 1e-12)
    got = np.asarray(program, np.float64)
    got = got / np.maximum(np.linalg.norm(got, axis=-1, keepdims=True), 1e-12)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.max(np.linalg.norm(got - ref, axis=-1)))


def judge(numbers: dict[str, float], limits: dict[str, float | None]) -> list[tuple[str, float, float | None]]:
    """(name, number, limit) for every number, in the order of ``limits``."""
    return [(name, numbers[name], limits.get(name)) for name in limits]


def passed(checks: list[tuple[str, float, float | None]]) -> bool:
    """Every number at or under its limit; a number without a limit fails."""
    return all(limit is not None and value <= limit for _, value, limit in checks)
