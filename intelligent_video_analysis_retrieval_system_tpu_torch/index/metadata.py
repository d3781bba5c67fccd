"""MetadataManager: in-memory metadata DB with temporal & similarity graphs.

Port of ``intelligent_video_analysis_retrieval_system_tpu/index/metadata.py``:
the ``folder -> {image -> KeyframeMetadata}`` store, the per-folder
temporal order by frame_id and the per-folder top-k cosine-similarity graph
(threshold 0.7), one batched matmul per folder on the manager's ``device``
(the port's ``ops.topk.topk_exact_reference``). The graph's readers (the
agent tools) and the JSON save/load (portable export) come with their
ports.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

from ..retrieval.results import KeyframeMetadata
from .unified import resolve_device

__all__ = ["MetadataManager"]


class MetadataManager:
    def __init__(
        self,
        similarity_threshold: float = 0.7,   # core.py:3507
        similarity_top_k: int = 10,           # core.py:3493-3531
        device: torch.device | str = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.similarity_threshold = similarity_threshold
        self.similarity_top_k = similarity_top_k
        self.by_folder: dict[str, dict[str, KeyframeMetadata]] = {}
        self.temporal_index: dict[str, list[str]] = {}
        self.similarity_graph: dict[str, dict[str, list[tuple[str, float]]]] = {}

    # -- building -----------------------------------------------------------

    def build_metadata(
        self,
        metadata: Iterable[KeyframeMetadata],
        features: np.ndarray | None = None,
        build_similarity: bool = True,
    ) -> None:
        """Index records by folder; optionally build the per-folder
        similarity graph from the embedding matrix (row_id-aligned)."""
        self.by_folder = {}
        rows: dict[str, list[KeyframeMetadata]] = {}
        for meta in metadata:
            self.by_folder.setdefault(meta.folder, {})[meta.image] = meta
            rows.setdefault(meta.folder, []).append(meta)
        self.temporal_index = {
            folder: [
                m.image
                for m in sorted(metas, key=lambda m: (m.frame_id, m.image))
            ]
            for folder, metas in rows.items()
        }
        self.similarity_graph = {}
        if build_similarity and features is not None:
            for folder, metas in rows.items():
                self._build_similarity_for(folder, metas, features)

    def _build_similarity_for(
        self, folder: str, metas: Sequence[KeyframeMetadata], features: np.ndarray
    ) -> None:
        from ..ops.normalize import l2_normalize
        from ..ops.topk import topk_exact_reference

        ids = [m.row_id for m in metas]
        if any(i < 0 or i >= len(features) for i in ids) or len(ids) < 2:
            return
        feats = l2_normalize(torch.from_numpy(
            np.asarray(features[np.asarray(ids)], np.float32)).to(self.device))
        k = min(self.similarity_top_k + 1, len(ids))
        result = topk_exact_reference(feats, feats, k)
        scores = result.scores.cpu().numpy()
        indices = result.indices.cpu().numpy()
        graph: dict[str, list[tuple[str, float]]] = {}
        for i, meta in enumerate(metas):
            neighbors = []
            for score, j in zip(scores[i], indices[i]):
                if j == i:
                    continue
                if score < self.similarity_threshold:
                    break  # scores descend
                neighbors.append((metas[j].image, float(score)))
                if len(neighbors) >= self.similarity_top_k:
                    break
            graph[meta.image] = neighbors
        self.similarity_graph[folder] = graph

    # -- queries ------------------------------------------------------------

    def count(self) -> int:
        return sum(len(v) for v in self.by_folder.values())

    def stats(self) -> dict[str, Any]:
        return {
            "folders": len(self.by_folder),
            "keyframes": self.count(),
            "similarity_edges": sum(
                len(pairs)
                for g in self.similarity_graph.values()
                for pairs in g.values()
            ),
        }
