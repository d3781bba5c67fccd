"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/files.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

File management: keyframe scans, CSV frame-map loading, atomic writes.

Parity with the reference ``FileManager`` (``utils.py:1228-1743``):
- ``scan_keyframes``: keyframe directory -> ``{folder: [image names]}``
  with numeric-aware sorting (``utils.py:1228-1329``),
- ``load_csv_mapping``: robust ``map/<video>.csv`` loader with header
  sniffing and column aliases (``utils.py:1331-1510``) — this file maps a
  keyframe ordinal ``n`` to its source video frame index / timestamp
  (written by the ingest CLIs, ``video_frame_filter.py:51``),
- atomic ``safe_write``, backups, temp cleanup (``utils.py:1512-1743``).

The env-var side channel ``MAP_FOLDER_PATH`` (reference ``system.py:503-519``)
is replaced by an explicit ``map_dir`` argument.
"""

from __future__ import annotations

import csv
import io
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

__all__ = ["FileManager", "natural_key"]

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}

_NUM_RE = re.compile(r"(\d+)")


def natural_key(name: str) -> tuple:
    """Sort key treating digit runs numerically: kf2 < kf10."""
    return tuple(int(p) if p.isdigit() else p for p in _NUM_RE.split(name))


# Accepted aliases for each logical CSV column (reference utils.py:1393-1440
# sniffs similar variants).
_COLUMN_ALIASES: dict[str, tuple[str, ...]] = {
    "n": ("n", "id", "keyframe", "kf", "index", "stt"),
    "pts_time": ("pts_time", "pts", "time", "timestamp", "seconds"),
    "fps": ("fps", "frame_rate", "framerate"),
    "frame_idx": ("frame_idx", "frame", "frame_id", "frameid", "frame_index"),
}

_MAX_CSV_BYTES = 50 * 1024 * 1024  # reference caps at 50MB (utils.py:1466)


class FileManager:
    """Host-side filesystem operations for the retrieval pipeline."""

    def __init__(self, temp_dir: str | Path | None = None) -> None:
        self.temp_dir = Path(temp_dir) if temp_dir else None
        self._lock = threading.Lock()
        self._stats = {"scans": 0, "csv_loads": 0, "writes": 0, "errors": 0}

    # -- keyframe scanning --------------------------------------------------

    def scan_keyframes(self, keyframes_dir: str | Path) -> dict[str, list[str]]:
        """Map each video folder to its sorted keyframe image filenames.

        Layout produced by ingest: ``keyframes/<video_name>/<n>.jpg``.
        """
        root = Path(keyframes_dir)
        result: dict[str, list[str]] = {}
        if not root.is_dir():
            return result
        for folder in sorted(root.iterdir(), key=lambda p: natural_key(p.name)):
            if not folder.is_dir():
                continue
            images = [
                p.name
                for p in folder.iterdir()
                if p.is_file() and p.suffix.lower() in IMAGE_EXTENSIONS
            ]
            if images:
                images.sort(key=natural_key)
                result[folder.name] = images
        with self._lock:
            self._stats["scans"] += 1
        return result

    # -- CSV frame-index maps -----------------------------------------------

    def load_csv_mapping(
        self, csv_path: str | Path
    ) -> dict[int, dict[str, float]]:
        """Load ``map/<video>.csv`` -> {n: {pts_time, fps, frame_idx}}.

        Tolerates header variants, missing columns, and junk rows, mirroring
        the defensive loader at reference ``utils.py:1331-1510``.
        """
        path = Path(csv_path)
        if not path.is_file() or path.stat().st_size > _MAX_CSV_BYTES:
            return {}
        text = path.read_text(encoding="utf-8", errors="replace")
        reader = csv.reader(io.StringIO(text))
        rows = [r for r in reader if any(cell.strip() for cell in r)]
        if not rows:
            return {}
        header, data_rows = self._detect_header(rows)
        colmap = self._map_columns(header)
        mapping: dict[int, dict[str, float]] = {}
        for i, row in enumerate(data_rows):
            try:
                n = int(float(row[colmap["n"]])) if "n" in colmap else i
                entry: dict[str, float] = {}
                for field in ("pts_time", "fps", "frame_idx"):
                    if field in colmap and colmap[field] < len(row):
                        raw = row[colmap[field]].strip()
                        if raw:
                            entry[field] = float(raw)
                mapping[n] = entry
            except (ValueError, IndexError):
                continue
        with self._lock:
            self._stats["csv_loads"] += 1
        return mapping

    def load_folder_mapping(
        self, map_dir: str | Path, folder: str
    ) -> dict[int, dict[str, float]]:
        """Convenience: mapping for one keyframe folder (``map/<folder>.csv``)."""
        return self.load_csv_mapping(Path(map_dir) / f"{folder}.csv")

    @staticmethod
    def _detect_header(rows: list[list[str]]) -> tuple[list[str] | None, list[list[str]]]:
        first = rows[0]
        numericish = sum(1 for c in first if _is_number(c))
        if numericish >= max(1, len(first) // 2):
            return None, rows  # headerless file
        return [c.strip().lower() for c in first], rows[1:]

    @staticmethod
    def _map_columns(header: list[str] | None) -> dict[str, int]:
        if header is None:
            # positional convention from the ingest writer:
            # n, pts_time, fps, frame_idx  (video_frame_filter.py:51)
            return {"n": 0, "pts_time": 1, "fps": 2, "frame_idx": 3}
        colmap: dict[str, int] = {}
        for logical, aliases in _COLUMN_ALIASES.items():
            for idx, name in enumerate(header):
                if name in aliases:
                    colmap[logical] = idx
                    break
        return colmap

    def save_csv_mapping(
        self, csv_path: str | Path, rows: list[dict[str, Any]]
    ) -> None:
        """Write a frame map with the canonical header."""
        path = Path(csv_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        buf = io.StringIO()
        writer = csv.writer(buf)
        writer.writerow(["n", "pts_time", "fps", "frame_idx"])
        for row in rows:
            writer.writerow(
                [row.get("n"), row.get("pts_time"), row.get("fps"), row.get("frame_idx")]
            )
        self.safe_write(path, buf.getvalue().encode("utf-8"))

    # -- atomic writes / backups / temp (reference utils.py:1512-1743) ------

    def safe_write(self, path: str | Path, data: bytes | str) -> Path:
        """Atomic write via tmp-file + rename."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp{int(time.time() * 1e6)}")
        if isinstance(data, str):
            data = data.encode("utf-8")
        tmp.write_bytes(data)
        tmp.replace(path)
        with self._lock:
            self._stats["writes"] += 1
        return path

    def backup(self, path: str | Path, keep: int = 3) -> Path | None:
        path = Path(path)
        if not path.exists():
            return None
        backup = path.with_name(path.name + f".bak.{int(time.time())}")
        shutil.copy2(path, backup)
        backups = sorted(path.parent.glob(path.name + ".bak.*"))
        for old in backups[:-keep]:
            old.unlink(missing_ok=True)
        return backup

    def cleanup_temp(self, older_than_s: float = 3600.0) -> int:
        if self.temp_dir is None or not self.temp_dir.is_dir():
            return 0
        cutoff = time.time() - older_than_s
        removed = 0
        for p in self.temp_dir.iterdir():
            try:
                if p.stat().st_mtime < cutoff:
                    if p.is_dir():
                        shutil.rmtree(p, ignore_errors=True)
                    else:
                        p.unlink(missing_ok=True)
                    removed += 1
            except OSError:
                continue
        return removed

    def get_stats(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stats)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
