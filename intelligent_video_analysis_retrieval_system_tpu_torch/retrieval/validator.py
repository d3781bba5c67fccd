"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/validator.py``: the JAX
package's ``retrieval/__init__.py`` imports the JAX temporal module, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Data-consistency validation for index <-> metadata invariants.

Parity with the reference ``DataConsistencyValidator`` (``core.py:267-378``):
- index row count must equal metadata record count,
- per-record validity (non-empty folder/image, frame_id >= 0, unique keys),
- optional file-existence spot checks,
- keyframe folder structure validation.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

from ..utils.files import IMAGE_EXTENSIONS
from .results import KeyframeMetadata

__all__ = ["DataConsistencyValidator", "ValidationReport"]


@dataclass(slots=True)
class ValidationReport:
    ok: bool
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)
    checked: dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {
            "ok": self.ok,
            "errors": self.errors,
            "warnings": self.warnings,
            "checked": self.checked,
        }


class DataConsistencyValidator:
    """Invariant checks run at build, save, and load time."""

    def __init__(self, spot_check_files: int = 32) -> None:
        self.spot_check_files = spot_check_files

    def validate_index_metadata_consistency(
        self,
        num_index_rows: int,
        metadata: Sequence[KeyframeMetadata],
        check_files: bool = False,
    ) -> ValidationReport:
        """Reference ``core.py:267-332`` semantics."""
        errors: list[str] = []
        warnings: list[str] = []
        if num_index_rows != len(metadata):
            errors.append(
                f"index rows ({num_index_rows}) != metadata records ({len(metadata)})"
            )
        seen: set[tuple[str, str]] = set()
        dupes = 0
        bad_rows = 0
        for i, record in enumerate(metadata):
            if record.row_id not in (-1, i):
                bad_rows += 1
            if record.key in seen:
                dupes += 1
            seen.add(record.key)
        if dupes:
            warnings.append(f"{dupes} duplicate (folder, image) keys")
        if bad_rows:
            errors.append(f"{bad_rows} records with row_id != position")
        missing = 0
        if check_files and metadata:
            sample = random.sample(
                list(metadata), min(self.spot_check_files, len(metadata))
            )
            for record in sample:
                if record.path and not Path(record.path).is_file():
                    missing += 1
            if missing:
                warnings.append(
                    f"{missing}/{len(sample)} spot-checked files missing on disk"
                )
        return ValidationReport(
            ok=not errors,
            errors=errors,
            warnings=warnings,
            checked={
                "index_rows": num_index_rows,
                "metadata_records": len(metadata),
                "duplicates": dupes,
                "missing_files_sampled": missing,
            },
        )

    def validate_keyframes_folder(self, keyframes_dir: str | Path) -> ValidationReport:
        """Reference ``core.py:334-378`` semantics: directory exists, holds
        video subfolders, subfolders hold images."""
        root = Path(keyframes_dir)
        errors: list[str] = []
        warnings: list[str] = []
        if not root.is_dir():
            return ValidationReport(
                ok=False, errors=[f"keyframes dir not found: {root}"], checked={}
            )
        folders = [p for p in root.iterdir() if p.is_dir()]
        if not folders:
            errors.append(f"no video folders under {root}")
        total_images = 0
        empty_folders = []
        for folder in folders:
            n = sum(
                1
                for p in folder.iterdir()
                if p.is_file() and p.suffix.lower() in IMAGE_EXTENSIONS
            )
            total_images += n
            if n == 0:
                empty_folders.append(folder.name)
        if empty_folders:
            warnings.append(f"{len(empty_folders)} empty folders: {empty_folders[:5]}")
        if total_images == 0:
            errors.append("no keyframe images found")
        return ValidationReport(
            ok=not errors,
            errors=errors,
            warnings=warnings,
            checked={"folders": len(folders), "images": total_images},
        )
