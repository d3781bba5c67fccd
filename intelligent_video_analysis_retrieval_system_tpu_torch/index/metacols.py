"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/index/metacols.py``: the JAX
package's ``index/__init__.py`` imports flax, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Columnar metadata sidecar: O(arrays) index opens at capacity scale.

The container's per-record zstd+JSON metadata blobs are the authoritative
store (``index/container.py``), but materializing them into Python
objects is the dominant open cost at capacity scale — at 10M rows the
eager path spends minutes parsing and holds ~5 GB of dataclass objects.
This module mirrors the embedding ``.flat`` sidecar pattern
(``index/builder.py:175``, ``unified.py _invalidate_sidecar``): a
best-effort acceleration file next to the ``.rvdb`` that is

- written AFTER a successful blob load (atomic tmp+rename, never a
  failure — a broken/missing sidecar just means the blob path runs);
- unlinked by every mutation that touches rows (append/compact), and
  additionally guarded by a row-count check at load;
- loaded as a handful of numpy arrays, behind :class:`ColumnarMetadata`
  — a list-protocol view constructing :class:`KeyframeMetadata` on
  access (microseconds from arrays, ~25x less resident memory than the
  object list; records with ``tags``/``extra`` fall back to their
  authoritative container blob).

Reference analog: ``unified_index.py:10,373`` claims "50x faster load;
sub-second loading" — this makes re-opens O(numpy reads) regardless of
corpus size.
"""

from __future__ import annotations

import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from ..retrieval.results import KeyframeMetadata

__all__ = [
    "ColumnarMetadata",
    "sidecar_path",
    "write_sidecar",
    "load_sidecar",
    "SIDECAR_MIN_ROWS",
]

_FORMAT = 1
_SUFFIX = ".meta.npz"
# below this the eager blob load is already instant; don't spam sidecars
SIDECAR_MIN_ROWS = 10_000
# if too many records need the blob fallback (tags/extra), the sidecar
# buys little — skip writing it
_MAX_BLOB_FRACTION = 0.2


def sidecar_path(container_path: str | Path) -> Path:
    p = Path(container_path)
    return p.with_name(p.name + _SUFFIX)


def _pack_strings(values: Iterable[str]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated utf-8 bytes + int64 offsets (n+1)."""
    parts = [v.encode("utf-8") for v in values]
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(b) for b in parts], out=off[1:])
    data = np.frombuffer(b"".join(parts), np.uint8).copy()
    return data, off


class ColumnarMetadata(Sequence):
    """List-protocol view over sidecar columns.

    ``__getitem__`` constructs a fresh :class:`KeyframeMetadata` from the
    arrays (rows flagged in ``blob_rows`` read their authoritative
    container blob instead — they carry ``tags``/``extra`` the columns
    don't store). Appends after load land in an in-memory overlay, same
    as the eager list's ``extend``.
    """

    __slots__ = (
        "_n", "_folder_table", "_folder_id", "_img_b", "_img_o",
        "_path_b", "_path_o", "_frame_id", "_row_id", "_pts", "_fps",
        "_shot", "_blob_rows", "_blob_set", "_get_blob", "_overlay",
    )

    def __init__(self, arrays: dict[str, np.ndarray],
                 get_blob: Callable[[int], dict[str, Any]]):
        self._n = int(arrays["n"])
        self._folder_table = [
            s.decode("utf-8") for s in bytes(arrays["folder_table_b"]).split(b"\x00")
        ] if arrays["folder_table_b"].size else [""]
        self._folder_id = arrays["folder_id"]
        self._img_b, self._img_o = arrays["img_b"], arrays["img_o"]
        self._path_b, self._path_o = arrays["path_b"], arrays["path_o"]
        self._frame_id = arrays["frame_id"]
        self._row_id = arrays["row_id"]
        self._pts, self._fps = arrays["pts"], arrays["fps"]
        self._shot = arrays["shot"]
        self._blob_rows = arrays["blob_rows"]
        self._blob_set = (
            frozenset(int(i) for i in self._blob_rows)
            if self._blob_rows.size else frozenset()
        )
        self._get_blob = get_blob
        self._overlay: list[KeyframeMetadata] = []

    # -- list protocol -------------------------------------------------------

    def __len__(self) -> int:
        return self._n + len(self._overlay)

    def _str(self, data: np.ndarray, off: np.ndarray, i: int) -> str:
        return data[off[i]:off[i + 1]].tobytes().decode("utf-8")

    def _make(self, i: int) -> KeyframeMetadata:
        if i in self._blob_set:
            # authoritative blob carries this row's tags/extra. If the
            # backing container was swapped out from under a snapshot
            # (live compact), degrade to the columnar base fields rather
            # than failing the request.
            try:
                rec = dict(self._get_blob(i))
                rec.setdefault("row_id", i)
                return KeyframeMetadata.from_dict(rec)
            except Exception:
                pass
        return KeyframeMetadata(
            folder=self._folder_table[self._folder_id[i]],
            image=self._str(self._img_b, self._img_o, i),
            frame_id=int(self._frame_id[i]),
            row_id=int(self._row_id[i]),
            path=self._str(self._path_b, self._path_o, i),
            pts_time=float(self._pts[i]),
            fps=float(self._fps[i]),
            shot_id=int(self._shot[i]),
        )

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        if i >= self._n:
            return self._overlay[i - self._n]
        return self._make(i)

    def __iter__(self) -> Iterator[KeyframeMetadata]:
        for i in range(self._n):
            yield self._make(i)
        yield from self._overlay

    def extend(self, metas: Iterable[KeyframeMetadata]) -> None:
        self._overlay.extend(metas)

    def append(self, meta: KeyframeMetadata) -> None:
        self._overlay.append(meta)

    def iter_keys(self) -> Iterator[tuple[str, str]]:
        """(folder, image) keys without constructing records — feeds the
        lazy row_by_key fill at ~10x the full-object iteration speed."""
        table, fid = self._folder_table, self._folder_id
        for i in range(self._n):
            yield (table[fid[i]], self._str(self._img_b, self._img_o, i))
        for m in self._overlay:
            yield m.key


class LazyRowByKey(dict):
    """(folder, image) -> row dict filled on first key lookup.

    Explicit ``[key] = row`` writes before the fill (live appends) are
    kept; the fill merges beneath them. Avoids paying a full-corpus key
    scan on open for deployments that never look rows up by key."""

    def __init__(self, metas: ColumnarMetadata):
        super().__init__()
        self._metas = metas
        self._filled = False
        self._fill_lock = threading.Lock()

    def _ensure(self) -> None:
        # _filled flips True only AFTER the map is fully populated, and
        # the O(n) fill runs under a lock: key lookups from concurrent
        # request threads (REST pool reads with no index lock) either
        # see the complete map or wait for it — never a partial one.
        if self._filled:
            return
        with self._fill_lock:
            if self._filled:
                return
            base: dict[tuple[str, str], int] = {
                key: i for i, key in enumerate(self._metas.iter_keys())
            }
            # Explicit pre-fill writes (live appends) win over the scan;
            # no clear() — the dict is only ever added to, so readers
            # racing the final update still see their key once present.
            # NB: dict(self) would call the OVERRIDDEN keys() (CPython's
            # merge path for dict subclasses) and re-enter _ensure on the
            # non-reentrant lock — snapshot via the C-level view instead.
            base.update(dict.items(self))
            dict.update(self, base)
            self._filled = True

    def get(self, key, default=None):
        self._ensure()
        return dict.get(self, key, default)

    def __getitem__(self, key):
        self._ensure()
        return dict.__getitem__(self, key)

    def __contains__(self, key) -> bool:
        self._ensure()
        return dict.__contains__(self, key)

    # NB: CPython's ``dict(lazy)`` merge path calls the overridden
    # ``keys()`` for dict subclasses, so it DOES trigger the fill.
    def __iter__(self):
        self._ensure()
        return dict.__iter__(self)

    def __len__(self) -> int:
        self._ensure()
        return dict.__len__(self)

    def keys(self):
        self._ensure()
        return dict.keys(self)

    def items(self):
        self._ensure()
        return dict.items(self)

    def values(self):
        self._ensure()
        return dict.values(self)

    def __eq__(self, other) -> bool:
        self._ensure()
        return dict.__eq__(self, other)

    __hash__ = None


def write_sidecar(metas: Sequence[KeyframeMetadata],
                  container_path: str | Path) -> bool:
    """Best-effort columnar sidecar write (atomic). Never raises."""
    try:
        n = len(metas)
        blob_rows = [
            i for i, m in enumerate(metas) if m.tags or m.extra
        ]
        if n and len(blob_rows) / n > _MAX_BLOB_FRACTION:
            return False
        fmap: dict[str, int] = {}
        folder_id = np.empty(n, np.int32)
        for i, m in enumerate(metas):
            folder_id[i] = fmap.setdefault(m.folder, len(fmap))
        table = sorted(fmap, key=fmap.get)
        if any("\x00" in f for f in table):
            return False  # NUL-joined table can't represent these
        img_b, img_o = _pack_strings(m.image for m in metas)
        path_b, path_o = _pack_strings(m.path for m in metas)
        arrays = {
            "format": np.int64(_FORMAT),
            "n": np.int64(n),
            "folder_table_b": np.frombuffer(
                "\x00".join(table).encode("utf-8"), np.uint8
            ).copy(),
            "folder_id": folder_id,
            "img_b": img_b, "img_o": img_o,
            "path_b": path_b, "path_o": path_o,
            "frame_id": np.fromiter(
                (m.frame_id for m in metas), np.int64, n),
            "row_id": np.fromiter((m.row_id for m in metas), np.int64, n),
            "pts": np.fromiter((m.pts_time for m in metas), np.float64, n),
            "fps": np.fromiter((m.fps for m in metas), np.float64, n),
            "shot": np.fromiter((m.shot_id for m in metas), np.int32, n),
            "blob_rows": np.asarray(blob_rows, np.int64),
        }
        target = sidecar_path(container_path)
        fd, tmp = tempfile.mkstemp(
            dir=str(target.parent), suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except Exception:
        return False


def load_sidecar(container_path: str | Path, expected_n: int,
                 get_blob: Callable[[int], dict[str, Any]]
                 ) -> ColumnarMetadata | None:
    """Load the sidecar if present, current-format, and row-count-matched
    (stale sidecars from external writers fail the count check; local
    mutations unlink it eagerly). Never raises."""
    try:
        target = sidecar_path(container_path)
        if not target.is_file():
            return None
        with np.load(target) as z:
            if int(z["format"]) != _FORMAT or int(z["n"]) != expected_n:
                return None
            arrays = {k: z[k] for k in z.files}
        return ColumnarMetadata(arrays, get_blob)
    except Exception:
        return None
