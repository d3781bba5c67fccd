"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/paths.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Multi-strategy path resolution for portable indexes.

Parity with the reference ``SmartPathResolver`` (``utils.py:2867-3159``):
resolve a relative keyframe path recorded inside a portable index package
against the machine it was moved to. Strategies, in order: exact path,
registered mappings, package-relative, cwd-relative, anchor-dir search
(``keyframes/``), and parent-dir walk.
"""

from __future__ import annotations

import threading
from pathlib import Path

__all__ = ["SmartPathResolver"]


class SmartPathResolver:
    """Resolves portable (relative) paths to local absolute paths."""

    ANCHOR = "keyframes"  # path anchor used by PortableIndex (core.py:3909-3941)

    def __init__(self, search_roots: list[str | Path] | None = None) -> None:
        self._mappings: dict[str, Path] = {}
        self._roots: list[Path] = [Path(r) for r in (search_roots or [])]
        self._lock = threading.Lock()
        self._cache: dict[str, Path | None] = {}

    def register_mapping(self, prefix: str, local_root: str | Path) -> None:
        """Pin a recorded path prefix to a local directory."""
        with self._lock:
            self._mappings[prefix.rstrip("/\\")] = Path(local_root)
            self._cache.clear()

    def add_search_root(self, root: str | Path) -> None:
        with self._lock:
            self._roots.append(Path(root))
            self._cache.clear()

    def resolve_portable_path(
        self, recorded: str | Path, package_dir: str | Path | None = None
    ) -> Path | None:
        """Best-effort resolution of a recorded path; None if not found."""
        key = f"{recorded}::{package_dir}"
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        result = self._resolve(Path(recorded), Path(package_dir) if package_dir else None)
        with self._lock:
            self._cache[key] = result
        return result

    def _resolve(self, recorded: Path, package_dir: Path | None) -> Path | None:
        # 1. exact
        if recorded.is_absolute() and recorded.exists():
            return recorded
        # 2. registered mappings (longest prefix first)
        rec_str = str(recorded).replace("\\", "/")
        with self._lock:
            mappings = sorted(self._mappings.items(), key=lambda kv: -len(kv[0]))
        for prefix, root in mappings:
            if rec_str.startswith(prefix):
                candidate = root / rec_str[len(prefix) :].lstrip("/\\")
                if candidate.exists():
                    return candidate
        # 3. package-relative and cwd-relative
        candidates = []
        if package_dir is not None:
            candidates.append(package_dir / recorded)
        candidates.append(Path.cwd() / recorded)
        # 4. anchor: strip everything before "keyframes/" and retry under
        #    each search root (reference strategy, utils.py:2995-3060).
        parts = [p for p in recorded.parts if p not in (".", "..")]
        if self.ANCHOR in parts:
            anchored = Path(*parts[parts.index(self.ANCHOR) :])
            roots = [Path.cwd()] + ([package_dir] if package_dir else []) + self._roots
            for root in roots:
                candidates.append(root / anchored)
            # 5. parent walk from cwd
            cur = Path.cwd()
            for parent in [cur, *cur.parents][:6]:
                candidates.append(parent / anchored)
        for c in candidates:
            if c.exists():
                return c.resolve()
        return None

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
