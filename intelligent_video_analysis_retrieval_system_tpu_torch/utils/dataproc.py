"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/dataproc.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Host-side data munging: normalization checks, result merge/dedup.

Parity with the reference ``DataProcessor`` (``utils.py:1776-2015``). The
heavy math (L2 normalization of embedding matrices) lives on-device in
``ops.normalize``; these helpers serve the orchestration layer where inputs
are small numpy arrays or result dicts.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

import numpy as np

__all__ = ["DataProcessor"]


class DataProcessor:
    """Small-array normalization and search-result set operations."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats = {"normalizations": 0, "merges": 0}

    # -- normalization -------------------------------------------------------

    def normalize_features(self, features: np.ndarray, eps: float = 1e-12) -> np.ndarray:
        """L2-normalize rows (host fallback of ops.normalize.l2_normalize)."""
        feats = np.asarray(features, dtype=np.float32)
        if feats.ndim == 1:
            feats = feats[None, :]
        norms = np.linalg.norm(feats, axis=-1, keepdims=True)
        out = feats / np.maximum(norms, eps)
        with self._lock:
            self._stats["normalizations"] += 1
        return out

    @staticmethod
    def is_normalized(features: np.ndarray, atol: float = 1e-3) -> bool:
        norms = np.linalg.norm(np.asarray(features, dtype=np.float32), axis=-1)
        return bool(np.allclose(norms, 1.0, atol=atol))

    # -- result merging (reference utils.py:1925-2015) ------------------------

    @staticmethod
    def result_key(result: dict[str, Any]) -> tuple:
        """Identity key of a search result: (folder, image)."""
        return (result.get("folder"), result.get("image"))

    def merge_results(
        self,
        result_lists: Iterable[list[dict[str, Any]]],
        limit: int | None = None,
        score_field: str = "similarity_score",
    ) -> list[dict[str, Any]]:
        """Merge multiple ranked lists, dedup by (folder, image), keep the
        highest score per key, sort descending. Used by hybrid search and the
        multi-shard / multi-node merges."""
        best: dict[tuple, dict[str, Any]] = {}
        for results in result_lists:
            for r in results:
                key = self.result_key(r)
                prev = best.get(key)
                if prev is None or r.get(score_field, 0.0) > prev.get(score_field, 0.0):
                    best[key] = r
        merged = sorted(best.values(), key=lambda r: r.get(score_field, 0.0), reverse=True)
        with self._lock:
            self._stats["merges"] += 1
        return merged[:limit] if limit is not None else merged

    def blend_results(
        self,
        primary: list[dict[str, Any]],
        secondary: list[dict[str, Any]],
        primary_weight: float = 0.7,
        secondary_weight: float = 0.3,
        limit: int | None = None,
        score_field: str = "similarity_score",
    ) -> list[dict[str, Any]]:
        """Weighted blend for hybrid mode (reference system.py:1868-1897)."""
        scores: dict[tuple, float] = {}
        rows: dict[tuple, dict[str, Any]] = {}
        for weight, results in ((primary_weight, primary), (secondary_weight, secondary)):
            for r in results:
                key = self.result_key(r)
                scores[key] = scores.get(key, 0.0) + weight * r.get(score_field, 0.0)
                rows.setdefault(key, r)
        blended = []
        for key, score in scores.items():
            row = dict(rows[key])
            row[score_field] = score
            blended.append(row)
        blended.sort(key=lambda r: r[score_field], reverse=True)
        return blended[:limit] if limit is not None else blended

    def get_stats(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stats)
