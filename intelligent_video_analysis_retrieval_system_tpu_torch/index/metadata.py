"""MetadataManager: in-memory metadata DB with temporal & similarity graphs.

Port of ``intelligent_video_analysis_retrieval_system_tpu/index/metadata.py``:
the ``folder -> {image -> KeyframeMetadata}`` store, the per-folder
temporal order by frame_id and the per-folder top-k cosine-similarity graph
(threshold 0.7), one batched matmul per folder on the manager's ``device``
(the port's ``ops.topk.topk_exact_reference``), their readers (``get``,
``folders``, ``get_temporal_neighbors``, ``get_similar_frames``, the
gap-based ``get_scene_boundaries``), and the verified JSON save/load
(portable export).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from ..retrieval.results import KeyframeMetadata
from ..utils.files import FileManager
from .unified import resolve_device

__all__ = ["MetadataManager"]


class MetadataManager:
    def __init__(
        self,
        similarity_threshold: float = 0.7,   # core.py:3507
        similarity_top_k: int = 10,           # core.py:3493-3531
        scene_gap_threshold: int = 5,         # core.py:3242-3276
        device: torch.device | str = "cuda",
        file_manager: FileManager | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.fm = file_manager or FileManager()
        self.similarity_threshold = similarity_threshold
        self.similarity_top_k = similarity_top_k
        self.scene_gap_threshold = scene_gap_threshold
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

    def get(self, folder: str, image: str) -> KeyframeMetadata | None:
        return self.by_folder.get(folder, {}).get(image)

    def folders(self) -> list[str]:
        return sorted(self.by_folder)

    def count(self) -> int:
        return sum(len(v) for v in self.by_folder.values())

    def get_temporal_neighbors(self, folder: str, image: str,
                               window: int = 3) -> list[KeyframeMetadata]:
        """+-window neighbours in frame order."""
        order = self.temporal_index.get(folder, [])
        try:
            pos = order.index(image)
        except ValueError:
            return []
        out = []
        for offset in range(-window, window + 1):
            idx = pos + offset
            if offset != 0 and 0 <= idx < len(order):
                out.append(self.by_folder[folder][order[idx]])
        return out

    def get_similar_frames(self, folder: str, image: str) -> list[tuple[str, float]]:
        return self.similarity_graph.get(folder, {}).get(image, [])

    def get_scene_boundaries(self, folder: str) -> list[int]:
        """Start positions (in frame order) of the folder's scenes: a new
        scene where the frame_id gap exceeds ``scene_gap_threshold``."""
        order = self.temporal_index.get(folder, [])
        if not order:
            return []
        frame_ids = [self.by_folder[folder][img].frame_id for img in order]
        boundaries = [0]
        for i in range(1, len(frame_ids)):
            if frame_ids[i] - frame_ids[i - 1] > self.scene_gap_threshold:
                boundaries.append(i)
        return boundaries

    # -- persistence (the JAX package's format, readable by either) ----------

    def save(self, path: str | Path) -> None:
        payload = {
            "version": "2.0",
            "folders": {
                folder: {img: m.to_dict() for img, m in images.items()}
                for folder, images in self.by_folder.items()
            },
            "similarity_graph": self.similarity_graph,
        }
        raw = json.dumps(payload, ensure_ascii=False)
        self.fm.safe_write(Path(path), raw)
        # post-write verification
        reread = json.loads(Path(path).read_text(encoding="utf-8"))
        count = sum(len(v) for v in reread.get("folders", {}).values())
        if count != self.count():
            raise IOError(
                f"metadata save verification failed: wrote {count}, "
                f"expected {self.count()}"
            )

    def load(self, path: str | Path) -> None:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
        metas: list[KeyframeMetadata] = []
        for folder_data in data.get("folders", {}).values():
            for record in folder_data.values():
                metas.append(KeyframeMetadata.from_dict(record))
        self.build_metadata(metas, features=None, build_similarity=False)
        graph = data.get("similarity_graph", {})
        self.similarity_graph = {
            folder: {
                img: [(n, float(s)) for n, s in pairs]
                for img, pairs in folder_graph.items()
            }
            for folder, folder_graph in graph.items()
        }

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
