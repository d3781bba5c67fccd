"""Temporal analysis over embedding sequences.

Port of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/temporal.py``:
scene-boundary detection from the cosine of adjacent frames, similar-sequence
search (the mean cosine of every length-M window against an M-frame query,
one (N, D) x (D, M) product and a diagonal gather), transition frames and
frame-interval statistics. The products run in f32 on the analyzer's
``device`` (default ``"cuda"``, which raises where CUDA is missing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..index.unified import resolve_device

__all__ = ["TemporalAnalyzer", "SceneBoundary"]


@dataclass(slots=True)
class SceneBoundary:
    start: int
    end: int  # exclusive
    length: int


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def _adjacent_similarity(feats: torch.Tensor) -> torch.Tensor:
    """cos(f[i], f[i+1]) for every i."""
    f = _l2n(feats.float())
    return torch.sum(f[:-1] * f[1:], dim=-1)


def _windowed_sequence_scores(feats: torch.Tensor, query: torch.Tensor,
                              window: int) -> torch.Tensor:
    """Mean cosine of every length-``window`` slice of ``feats`` against
    ``query``: score(start) = mean_j cos(f[start + j], q[j])."""
    f = _l2n(feats.float())                       # (N, D)
    q = _l2n(query.float())                       # (M, D)
    sims = f @ q.T                                # (N, M)
    n = sims.shape[0]
    dev = sims.device
    idx = torch.arange(n - window + 1, device=dev)[:, None] + torch.arange(window, device=dev)
    gathered = sims[idx, torch.arange(window, device=dev)[None, :]]   # (N-M+1, M)
    return gathered.mean(dim=1)


class TemporalAnalyzer:
    """Scene and sequence analysis over a folder's ordered embeddings."""

    def __init__(self, scene_threshold: float = 0.3, min_scene_length: int = 5,
                 device: torch.device | str = "cuda") -> None:
        # reference defaults: threshold 0.3, min length 5 (core.py:3584-3642)
        self.scene_threshold = scene_threshold
        self.min_scene_length = min_scene_length
        self.device = resolve_device(device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    # -- scene boundaries ----------------------------------------------------

    def adjacent_similarities(self, features: np.ndarray) -> np.ndarray:
        if len(features) < 2:
            return np.zeros((0,), dtype=np.float32)
        return _adjacent_similarity(self._tensor(features)).cpu().numpy()

    def detect_scene_boundaries(self, features: np.ndarray) -> list[SceneBoundary]:
        """Cut where cos(f[i], f[i+1]) < threshold; merge scenes shorter than
        ``min_scene_length`` into their predecessor."""
        n = len(features)
        if n == 0:
            return []
        if n == 1:
            return [SceneBoundary(0, 1, 1)]
        sims = self.adjacent_similarities(features)
        cut_after = np.nonzero(sims < self.scene_threshold)[0]  # cut between i, i+1
        starts = [0] + [int(i) + 1 for i in cut_after]
        ends = [int(i) + 1 for i in cut_after] + [n]
        scenes: list[SceneBoundary] = []
        for s, e in zip(starts, ends):
            if scenes and (e - s) < self.min_scene_length:
                prev = scenes[-1]
                scenes[-1] = SceneBoundary(prev.start, e, e - prev.start)
            else:
                scenes.append(SceneBoundary(s, e, e - s))
        return scenes

    def assign_shot_ids(self, features: np.ndarray) -> np.ndarray:
        """Per-frame shot id from detected boundaries."""
        shots = np.zeros(len(features), dtype=np.int32)
        for i, scene in enumerate(self.detect_scene_boundaries(features)):
            shots[scene.start:scene.end] = i
        return shots

    # -- similar-sequence search ----------------------------------------------

    def find_similar_sequences(self, features: np.ndarray, query_sequence: np.ndarray,
                               top_k: int = 5, min_score: float = 0.0) -> list[dict[str, Any]]:
        """Top windows of ``features`` matching ``query_sequence``:
        [{start, end, score}] by score, descending; a window that overlaps a
        better one is dropped."""
        n, m = len(features), len(query_sequence)
        if n < m or m == 0:
            return []
        scores = _windowed_sequence_scores(self._tensor(features), self._tensor(query_sequence),
                                           m).cpu().numpy()
        order = np.argsort(-scores)
        chosen: list[dict[str, Any]] = []
        taken = np.zeros(n, dtype=bool)
        for start in order:
            score = float(scores[start])
            if score < min_score or len(chosen) >= top_k:
                break
            if taken[start:start + m].any():
                continue
            taken[start:start + m] = True
            chosen.append({"start": int(start), "end": int(start + m), "score": score})
        return chosen

    # -- transition frames ----------------------------------------------------

    def extract_transition_frames(self, features: np.ndarray) -> list[int]:
        """The first frame of each scene after the first."""
        return [s.start for s in self.detect_scene_boundaries(features)[1:]]

    # -- interval statistics --------------------------------------------------

    @staticmethod
    def frame_interval_stats(frame_ids: list[int] | np.ndarray) -> dict[str, float]:
        ids = np.asarray(sorted(int(i) for i in frame_ids), dtype=np.int64)
        if len(ids) < 2:
            return {"count": float(len(ids)), "mean_gap": 0.0, "std_gap": 0.0,
                    "min_gap": 0.0, "max_gap": 0.0, "regularity": 1.0}
        gaps = np.diff(ids).astype(np.float64)
        mean = float(gaps.mean())
        std = float(gaps.std())
        return {
            "count": float(len(ids)),
            "mean_gap": mean,
            "std_gap": std,
            "min_gap": float(gaps.min()),
            "max_gap": float(gaps.max()),
            # 1 = perfectly regular sampling
            "regularity": float(1.0 / (1.0 + std / mean)) if mean > 0 else 0.0,
        }
