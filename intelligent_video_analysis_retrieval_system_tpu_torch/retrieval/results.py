"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/results.py``: the JAX
package's ``retrieval/__init__.py`` imports the JAX temporal module, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Core data models: keyframe metadata and search results.

Parity with the reference records (``core.py:84-172``):
``KeyframeMetadata`` (folder, image, frame_id, path, temporal context,
tags) and ``SearchResult`` (metadata + similarity score + rank +
explanation). Implemented as slotted dataclasses with explicit validation
instead of Pydantic — these are created millions of times during index
builds, so construction cost matters.

Embeddings are deliberately NOT stored on the metadata record (unlike
reference ``core.py:120`` which keeps ``clip_features`` per record): the
embedding matrix lives as one contiguous device array inside the index,
keyed by row id. That is what makes zero-copy host->HBM upload and the
Pallas search kernel possible.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any

__all__ = ["KeyframeMetadata", "SearchResult"]


@dataclass(slots=True)
class KeyframeMetadata:
    """One keyframe's identity and context.

    ``row_id`` is the record's row in the index embedding matrix; it doubles
    as the global temporal ordinal used by the Pallas gather paths.
    """

    folder: str
    image: str
    frame_id: int
    row_id: int = -1
    path: str = ""
    pts_time: float = -1.0
    fps: float = -1.0
    shot_id: int = -1
    tags: list[str] = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.folder:
            raise ValueError("KeyframeMetadata.folder must be non-empty")
        if not self.image:
            raise ValueError("KeyframeMetadata.image must be non-empty")
        self.frame_id = int(self.frame_id)
        if self.frame_id < 0:
            raise ValueError(f"frame_id must be >= 0, got {self.frame_id}")

    @property
    def key(self) -> tuple[str, str]:
        return (self.folder, self.image)

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "KeyframeMetadata":
        known = _KF_FIELDS  # hoisted: this runs once per corpus row on load
        kwargs = {k: v for k, v in data.items() if k in known}
        extra = {k: v for k, v in data.items() if k not in known}
        if extra:
            kwargs.setdefault("extra", {}).update(extra)
        return cls(**kwargs)


_KF_FIELDS = frozenset(KeyframeMetadata.__dataclass_fields__)  # type: ignore[attr-defined]


@dataclass(slots=True)
class SearchResult:
    """One ranked hit (reference ``core.py:161-172``)."""

    metadata: KeyframeMetadata
    similarity_score: float
    rank: int
    source: str = "local"  # local | remote:<node> | shard:<i>
    explanation: str = ""
    temporal_context: list[dict[str, Any]] = field(default_factory=list)

    def to_dict(self, detail_level: str = "standard") -> dict[str, Any]:
        """Serialize at one of the API detail levels
        (minimal/standard/rich/full — reference ``api.py:2006-2221``)."""
        minimal = {
            "folder": self.metadata.folder,
            "image": self.metadata.image,
            "similarity_score": round(float(self.similarity_score), 6),
            "rank": self.rank,
        }
        if detail_level == "minimal":
            return minimal
        standard = {
            **minimal,
            "frame_id": self.metadata.frame_id,
            "pts_time": self.metadata.pts_time,
            "path": self.metadata.path,
        }
        if detail_level == "standard":
            return standard
        rich = {
            **standard,
            "fps": self.metadata.fps,
            "shot_id": self.metadata.shot_id,
            "tags": list(self.metadata.tags),
            "source": self.source,
            "explanation": self.explanation,
        }
        if detail_level == "rich":
            return rich
        return {
            **rich,
            "row_id": self.metadata.row_id,
            "temporal_context": self.temporal_context,
            "extra": self.metadata.extra,
        }
