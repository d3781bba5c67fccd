"""SystemHealthMonitor: per-component checks + recovery recommendations.

Copy of ``intelligent_video_analysis_retrieval_system_tpu/system/health.py``
adapted to the port's facade (no W8A8 calibration state to report).

Parity with the reference ``SystemHealthMonitor`` (``system.py:95-401``):
component checks for config / index / metadata / embedder / cache /
consistency, an overall status roll-up, and actionable recovery options.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from .facade import EnhancedRetrievalSystem

__all__ = ["SystemHealthMonitor"]


class SystemHealthMonitor:
    def __init__(self, system: "EnhancedRetrievalSystem") -> None:
        self.system = system

    def comprehensive_health_check(self) -> dict[str, Any]:
        components: dict[str, dict[str, Any]] = {
            "config": self._check_config(),
            "embedder": self._check_embedder(),
            "index": self._check_index(),
            "metadata": self._check_metadata(),
            "cache": self._check_cache(),
            "consistency": self._check_consistency(),
        }
        statuses = [c["status"] for c in components.values()]
        if any(s == "error" for s in statuses):
            overall = "error"
        elif any(s == "warning" for s in statuses):
            overall = "warning"
        else:
            overall = "healthy"
        return {
            "overall": overall,
            "components": components,
            "recovery_options": self._recovery_options(components),
        }

    # -- individual checks ---------------------------------------------------

    def _check_config(self) -> dict[str, Any]:
        problems = self.system.config.validate(auto_fix=False)
        return {
            "status": "warning" if problems else "ok",
            "detail": problems or "validated",
        }

    def _check_embedder(self) -> dict[str, Any]:
        stats = self.system.embedder.get_stats()
        if not stats["loaded"]:
            return {"status": "warning", "detail": "model not loaded yet (lazy)"}
        warnings: list[str] = []  # degraded states can coexist; report ALL
        if not stats["pretrained"]:
            warnings.append(
                "random-initialized towers (no local checkpoint); "
                "retrieval quality limited to self-similarity"
            )
        if stats.get("tokenizer") == "hash_fallback":
            warnings.append(
                "hash-fallback tokenizer active (no CLIP vocab files "
                "found) — text embeddings do not match real CLIP semantics"
            )
        if warnings:
            return {"status": "warning", "detail": "; ".join(warnings)}
        return {"status": "ok", "detail": stats}

    def _check_index(self) -> dict[str, Any]:
        index = self.system.index
        if index is None or not index.is_loaded:
            return {"status": "error", "detail": "no index loaded"}
        if index.ntotal == 0:
            return {"status": "warning", "detail": "index is empty"}
        return {"status": "ok", "detail": {"ntotal": index.ntotal, "dim": index.dim}}

    def _check_metadata(self) -> dict[str, Any]:
        count = self.system.metadata.count()
        index = self.system.index
        if index is not None and index.is_loaded and count == 0 and index.ntotal > 0:
            return {"status": "warning", "detail": "metadata graphs not built"}
        return {"status": "ok", "detail": {"records": count}}

    def _check_cache(self) -> dict[str, Any]:
        stats = self.system.cache.get_stats()
        return {"status": "ok", "detail": stats}

    def _check_consistency(self) -> dict[str, Any]:
        index = self.system.index
        if index is None or not index.is_loaded:
            return {"status": "warning", "detail": "nothing to validate"}
        report = self.system.validator.validate_index_metadata_consistency(
            index.ntotal, index._metadata
        )
        if not report.ok:
            return {"status": "error", "detail": report.errors}
        if report.warnings:
            return {"status": "warning", "detail": report.warnings}
        return {"status": "ok", "detail": report.checked}

    # -- recovery (reference system.py:333-369) ------------------------------

    @staticmethod
    def _recovery_options(components: dict[str, dict[str, Any]]) -> list[str]:
        options: list[str] = []
        if components["index"]["status"] == "error":
            options.append(
                "load an index with load_system(path) or build one with "
                "build_system(keyframes_dir)"
            )
        if components["consistency"]["status"] == "error":
            options.append(
                "rebuild the index (build_system with resume=False) — "
                "stored sections disagree"
            )
        if components["embedder"]["status"] == "warning":
            options.append(
                "point config model.path at a local openai/clip-vit-* "
                "checkpoint directory (weights + merges.txt/vocab.json) for "
                "full retrieval quality"
            )
        if components["metadata"]["status"] == "warning":
            options.append("call load_system again to rebuild metadata graphs")
        return options
