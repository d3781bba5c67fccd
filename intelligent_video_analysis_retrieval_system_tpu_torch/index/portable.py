"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/index/portable.py``: its
``load_package`` opens the JAX package's ``UnifiedIndex``, so the port keeps its
own copy, which opens the port's on a torch device. Keep the two in step.

PortableIndex: cross-machine index packages.

Parity with the reference ``PortableIndex`` (``core.py:3839-4090``):
absolute->relative path rewriting anchored at ``keyframes/``, a manifest
with a version compatibility range, reverse resolution on the destination
machine (via :class:`utils.paths.SmartPathResolver`), and package
validation.

A package is a directory:
    package/
      manifest.json
      index.rvdb          (the single-file container — already portable)
      metadata.json       (optional MetadataManager export)
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any

from ..utils.paths import SmartPathResolver

__all__ = ["PortableIndex"]

FORMAT_VERSION = "3.0"
MIN_COMPATIBLE = "2.0"  # reference compat range 2.0-3.0 (core.py:3851-3866)
ANCHOR = "keyframes"


def _version_tuple(v: str) -> tuple[int, ...]:
    return tuple(int(p) for p in v.split("."))


class PortableIndex:
    def __init__(self, resolver: SmartPathResolver | None = None) -> None:
        self.resolver = resolver or SmartPathResolver()

    # -- path rewriting (reference core.py:3909-3999) -----------------------

    @staticmethod
    def to_portable_path(path: str | Path) -> str:
        """Strip everything before the ``keyframes/`` anchor."""
        parts = Path(path).parts
        if ANCHOR in parts:
            idx = parts.index(ANCHOR)
            return "/".join(parts[idx:])
        return Path(path).name

    def resolve_path(
        self, portable: str, package_dir: str | Path | None = None
    ) -> Path | None:
        return self.resolver.resolve_portable_path(portable, package_dir)

    # -- package creation ----------------------------------------------------

    def create_package(
        self,
        index_path: str | Path,
        package_dir: str | Path,
        metadata_path: str | Path | None = None,
        extra: dict[str, Any] | None = None,
    ) -> Path:
        """Bundle an index file into a portable package directory."""
        index_path = Path(index_path)
        if not index_path.is_file():
            raise FileNotFoundError(index_path)
        package_dir = Path(package_dir)
        package_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy2(index_path, package_dir / "index.rvdb")
        if metadata_path and Path(metadata_path).is_file():
            shutil.copy2(metadata_path, package_dir / "metadata.json")
        manifest = {
            "format_version": FORMAT_VERSION,
            "min_compatible_version": MIN_COMPATIBLE,
            "created_at": time.time(),
            "index_file": "index.rvdb",
            "index_bytes": index_path.stat().st_size,
            "anchor": ANCHOR,
            **(extra or {}),
        }
        (package_dir / "manifest.json").write_text(
            json.dumps(manifest, indent=2), encoding="utf-8"
        )
        return package_dir

    # -- validation (reference core.py:4026-4090) ---------------------------

    def validate_package(self, package_dir: str | Path) -> dict[str, Any]:
        package_dir = Path(package_dir)
        errors: list[str] = []
        manifest: dict[str, Any] = {}
        manifest_path = package_dir / "manifest.json"
        if not package_dir.is_dir():
            errors.append(f"package dir missing: {package_dir}")
        elif not manifest_path.is_file():
            errors.append("manifest.json missing")
        else:
            try:
                manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
            except json.JSONDecodeError as exc:
                errors.append(f"manifest unreadable: {exc}")
        if manifest:
            version = manifest.get("format_version", "0.0")
            try:
                if _version_tuple(version) < _version_tuple(MIN_COMPATIBLE):
                    errors.append(
                        f"package version {version} < min compatible {MIN_COMPATIBLE}"
                    )
            except ValueError:
                errors.append(f"bad version string: {version}")
            index_file = package_dir / manifest.get("index_file", "index.rvdb")
            if not index_file.is_file():
                errors.append(f"index file missing: {index_file.name}")
            elif (
                "index_bytes" in manifest
                and index_file.stat().st_size != manifest["index_bytes"]
            ):
                errors.append("index file size mismatch (corrupt transfer?)")
        return {"ok": not errors, "errors": errors, "manifest": manifest}

    def load_package(self, package_dir: str | Path, config=None, device="cuda"):
        """Validate then open the packaged index on ``device`` (returns
        UnifiedIndex; the default ``"cuda"`` raises where CUDA is missing)."""
        from .unified import UnifiedIndex

        package_dir = Path(package_dir)
        report = self.validate_package(package_dir)
        if not report["ok"]:
            raise ValueError(f"invalid portable package: {report['errors']}")
        index_file = package_dir / report["manifest"].get("index_file", "index.rvdb")
        index = UnifiedIndex(config, device=device)
        index.load_unified_index(index_file, mode="r")
        return index
