"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/evaluation.py``: the JAX
package's ``retrieval/__init__.py`` imports the JAX temporal module, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Retrieval-quality evaluation: Recall@K, rank agreement, parity gates.

The project's goal is "Recall@10 parity; identical top-k rankings versus
the reference" (BASELINE.json). This module provides the measurement
tools:

- :func:`recall_at_k` — fraction of ground-truth items recovered in top-k;
- :func:`rank_agreement` — exact position-wise agreement of two rankings
  (the strictest parity gate);
- :func:`overlap_at_k` — set overlap (rank-insensitive);
- :func:`evaluate_backends` — run the same queries through two search
  callables and report all metrics (used to gate the Pallas kernel against
  the jnp oracle, bf16 against f32, or this framework against an external
  system's result dumps).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

__all__ = [
    "recall_at_k",
    "rank_agreement",
    "overlap_at_k",
    "EvalReport",
    "evaluate_backends",
]


def _rows(ids: Any) -> np.ndarray:
    arr = np.asarray(ids)
    return arr[None] if arr.ndim == 1 else arr


def recall_at_k(
    result_ids: Any, truth_ids: Any, k: int | None = None
) -> float:
    """Mean fraction of ground-truth ids present in the top-k results."""
    res, truth = _rows(result_ids), _rows(truth_ids)
    if k is not None:
        res = res[:, :k]
        truth = truth[:, :k]
    recalls = []
    for r, t in zip(res, truth):
        tset = set(int(x) for x in t)
        if not tset:
            continue
        hits = sum(1 for x in r if int(x) in tset)
        recalls.append(hits / len(tset))
    return float(np.mean(recalls)) if recalls else 1.0


def rank_agreement(result_ids: Any, truth_ids: Any) -> float:
    """Fraction of positions with the exact same id (strict parity)."""
    res, truth = _rows(result_ids), _rows(truth_ids)
    k = min(res.shape[1], truth.shape[1])
    if k == 0:
        return 1.0
    return float((res[:, :k] == truth[:, :k]).mean())


def overlap_at_k(result_ids: Any, truth_ids: Any, k: int | None = None) -> float:
    """Mean |top-k ∩ top-k| / k (rank-insensitive set agreement)."""
    res, truth = _rows(result_ids), _rows(truth_ids)
    if k is None:
        k = min(res.shape[1], truth.shape[1])
    overlaps = []
    for r, t in zip(res, truth):
        a, b = set(map(int, r[:k])), set(map(int, t[:k]))
        if not b:
            continue
        overlaps.append(len(a & b) / len(b))
    return float(np.mean(overlaps)) if overlaps else 1.0


@dataclass(slots=True)
class EvalReport:
    queries: int
    k: int
    recall_at_k: float
    rank_agreement: float
    overlap_at_k: float
    score_max_abs_diff: float

    def passes_parity(
        self, min_recall: float = 1.0, min_rank_agreement: float = 1.0
    ) -> bool:
        return (
            self.recall_at_k >= min_recall
            and self.rank_agreement >= min_rank_agreement
        )

    def as_dict(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}  # type: ignore[attr-defined]


# a search backend: (queries (B, D)) -> (scores (B, k), ids (B, k))
SearchBackend = Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]


def evaluate_backends(
    candidate: SearchBackend,
    oracle: SearchBackend,
    queries: np.ndarray,
    k: int,
) -> EvalReport:
    """Run identical queries through candidate and oracle; compare."""
    c_scores, c_ids = candidate(queries)
    o_scores, o_ids = oracle(queries)
    c_scores, o_scores = np.asarray(c_scores, np.float64), np.asarray(
        o_scores, np.float64
    )
    kk = min(k, c_ids.shape[1], o_ids.shape[1])
    return EvalReport(
        queries=len(_rows(queries)),
        k=kk,
        recall_at_k=recall_at_k(c_ids, o_ids, kk),
        rank_agreement=rank_agreement(c_ids, o_ids),
        overlap_at_k=overlap_at_k(c_ids, o_ids, kk),
        score_max_abs_diff=float(
            np.abs(c_scores[:, :kk] - o_scores[:, :kk]).max()
        )
        if kk
        else 0.0,
    )
