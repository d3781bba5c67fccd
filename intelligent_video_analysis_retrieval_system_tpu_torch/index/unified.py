"""UnifiedIndex: the searchable single-file index, dense rows on a device.

Port of the dense device half of
``intelligent_video_analysis_retrieval_system_tpu/index/unified.py``:

- the searchable state is a padded ``(capacity, dim)`` bf16/f32 tensor on
  ``device`` plus the live row count; search is :func:`ops.topk.topk_search`
  (kernel B1 on a card);
- rows load from the ``.flat`` sidecar when it is fresh (read through the
  JAX package's ``native.FlatEmbeddingFile``), else from the container,
  and are L2-normalized ON the device in chunks written in place into the
  row buffer;
- appends write into the padded capacity in place; an append past the
  capacity re-uploads;
- tombstones are an int8 ``(capacity, 1)`` mask applied before chunk
  selection.

Not ported yet (each raises ``NotImplementedError`` naming the later
change): int8 containers (capacity mode, kernel B2), IVF ANN and the
multi-device mesh. A container that carries a persisted ANN structure is
served by the exact dense sweep, with a warning. Compaction and asset
reads come with the builder and the REST server.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.topk import TILE_N, topk_search
from ..retrieval.results import KeyframeMetadata, SearchResult
from .container import IndexContainer

__all__ = ["UnifiedIndex", "UnifiedIndexConfig"]

_LATER_INT8 = ("int8 containers (the int8 capacity mode with kernel B2) are "
               "ported in a later change")
_LATER_ANN = "IVF ANN search is ported in a later change"
_LATER_MESH = "multi-device search is ported in a later change"

# rows normalized per device step at upload (bounds the f32 temporary)
_UPLOAD_ROWS = 262_144


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a machine without
    CUDA raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@dataclass(slots=True)
class UnifiedIndexConfig:
    """Runtime knobs of the dense index (the reference's fields that this
    port reads; build and IVF fields come with those modes)."""

    # L2-normalize rows at upload and append (cosine = inner product)
    normalize: bool = True
    # IVF approximate search: refused until the ANN port lands
    ann: bool = False
    # False: ignore a persisted ANN structure without the warning
    ann_restore: bool = True


class UnifiedIndex:
    """Searchable index over a single container, rows on ``device``."""

    def __init__(
        self,
        config: UnifiedIndexConfig | None = None,
        device: torch.device | str = "cpu",
        mesh: Any | None = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(_LATER_MESH)
        self.config = config or UnifiedIndexConfig()
        if self.config.ann:
            raise NotImplementedError(_LATER_ANN)
        self.device = resolve_device(device)
        self._container: Any | None = None
        self._lock = threading.RLock()
        self._dev_x: torch.Tensor | None = None       # (cap, dim) bf16/f32
        self._n_valid = 0
        self._capacity = 0
        self._deleted: set[int] = set()
        self._dev_deleted: torch.Tensor | None = None  # (cap, 1) int8
        # bumps on load/append/delete so result caches keyed on it never
        # serve hits from before a mutation
        self.generation = 0
        self._metadata: list[KeyframeMetadata] = []
        self._row_by_key: dict[tuple[str, str], int] = {}
        self.load_time_s: float | None = None
        self.path: Path | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def is_loaded(self) -> bool:
        return self._container is not None

    @property
    def ntotal(self) -> int:
        return self._n_valid

    @property
    def dim(self) -> int:
        return self._container.dim if self._container else 0

    def load_unified_index(self, path: str | Path, mode: str = "r") -> "UnifiedIndex":
        """Open the container, upload its rows to the device, read metadata."""
        t0 = time.perf_counter()
        with self._lock:
            self.close()
            self._container = IndexContainer(path, mode=mode)
            self.path = Path(path)
            report = self._container.consistency_report()
            if not report["ok"] and mode != "r":
                self._container.repair_to_consistent()
            self._load_metadata_cache()
            self._upload_embeddings()
        self.load_time_s = time.perf_counter() - t0
        return self

    def attach_container(self, container: Any) -> "UnifiedIndex":
        """Adopt an already-open container (anything with the container's
        read interface)."""
        t0 = time.perf_counter()
        with self._lock:
            self.close()
            self._container = container
            self.path = container.path
            self._load_metadata_cache()
            self._upload_embeddings()
        self.load_time_s = time.perf_counter() - t0
        return self

    def close(self) -> None:
        with self._lock:
            if self._container is not None:
                self._container.close()
                self._container = None
            self._dev_x = None
            self._dev_deleted = None
            self._n_valid = 0
            self._capacity = 0
            self._metadata = []
            self._row_by_key = {}

    # -- device state -------------------------------------------------------

    def _upload_embeddings(self) -> None:
        assert self._container is not None
        if self._container.dtype == "int8":
            raise NotImplementedError(_LATER_INT8)
        if self.config.ann_restore and self._container.get_ann() is not None:
            logging.getLogger("ivars").warning(
                "container carries a persisted ANN structure; IVF search is "
                "not ported yet, serving exact dense search"
            )
        n = self._container.num_rows
        self._n_valid = n
        self.generation += 1
        if n == 0:
            self._dev_x = None
            self._capacity = 0
        else:
            self._capacity = _ceil_to(n, TILE_N)
            self._dev_x = self._rows_to_device(n, self._capacity)
        self._deleted = set(self._container.deleted_rows())
        self._dev_deleted = None
        if self._deleted:
            self._rebuild_deleted_mask()

    def _read_rows_raw(self, n: int) -> np.ndarray:
        """Rows in their storage form (uint16 bf16 bits / f16 / f32): the
        ``.flat`` sidecar when fresh, else the container."""
        assert self._container is not None
        d = self._container.dim
        flat_dtype = "bfloat16" if self._container.dtype == "bfloat16" else "float32"
        p = (self.path.with_name(self.path.name + ".flat")
             if self.path is not None else None)
        if p is not None and p.is_file():
            from intelligent_video_analysis_retrieval_system_tpu import native

            try:
                f = native.FlatEmbeddingFile(p)
                fn, fd, fname = f.header()
                if fn == n and fd == d and fname == flat_dtype:
                    out = np.empty((n, d), np.uint16 if fname == "bfloat16"
                                   else np.float32)
                    f.read_into(out)
                    return out
            except OSError:  # stale or torn sidecar: the container wins
                pass
        return self._container.read_embeddings(0, n)

    def _rows_to_device(self, n: int, cap: int) -> torch.Tensor:
        """Padded (cap, d) rows in the storage's compute dtype, normalized
        on the device chunk by chunk, each chunk copied in place into the
        row buffer (the reference's ``dynamic_update_slice`` program)."""
        host = self._read_rows_raw(n)
        d = host.shape[1]
        out_dtype = (torch.bfloat16 if self._container.dtype == "bfloat16"
                     else torch.float32)
        buf = torch.zeros((cap, d), dtype=out_dtype, device=self.device)
        for s in range(0, n, _UPLOAD_ROWS):
            e = min(s + _UPLOAD_ROWS, n)
            chunk = torch.from_numpy(np.ascontiguousarray(host[s:e]))
            if host.dtype == np.uint16:  # raw bf16 bits
                chunk = chunk.view(torch.int16).to(self.device).view(torch.bfloat16)
            else:
                chunk = chunk.to(self.device)
            xf = chunk.float()
            if self.config.normalize:
                xf = xf / torch.clamp(torch.linalg.norm(xf, dim=-1, keepdim=True),
                                      min=1e-12)
            buf[s:e].copy_(xf)
        return buf

    def _rebuild_deleted_mask(self) -> None:
        mask = np.zeros((self._capacity, 1), np.int8)
        for row in self._deleted:
            if 0 <= row < self._capacity:
                mask[row, 0] = 1
        self._dev_deleted = torch.from_numpy(mask).to(self.device)

    def _invalidate_sidecar(self) -> None:
        if self.path is not None:
            for suffix in (".flat", ".flat8", ".meta.npz"):
                self.path.with_name(self.path.name + suffix).unlink(missing_ok=True)

    def _append_device_rows(self, rows: np.ndarray) -> None:
        """Append normalized rows into the padded capacity in place; past
        the capacity, re-upload everything from the container."""
        m = len(rows)
        if m == 0:
            return
        if self._dev_x is None or self._n_valid + m > self._capacity:
            self._upload_embeddings()
            return
        self._dev_x[self._n_valid:self._n_valid + m].copy_(
            torch.from_numpy(np.ascontiguousarray(rows, np.float32)))
        self._n_valid += m

    def _load_metadata_cache(self) -> None:
        assert self._container is not None
        self._metadata = []
        self._row_by_key = {}
        for i, record in enumerate(self._container.iter_metadata()):
            record.setdefault("row_id", i)
            meta = KeyframeMetadata.from_dict(record)
            self._metadata.append(meta)
            self._row_by_key[meta.key] = i

    # -- search ---------------------------------------------------------------

    def search_vectors(
        self,
        query_vectors: np.ndarray,
        top_k: int = 20,
        filter_fn: Callable[[KeyframeMetadata], bool] | None = None,
        over_fetch: int = 4,
    ) -> list[list[SearchResult]]:
        """Top-k per query vector, as ranked SearchResults (exact search).

        ``filter_fn``: metadata predicate applied after the search, over
        ``over_fetch`` x ``top_k`` candidates.
        """
        with self._lock:
            if self._dev_x is None or self._n_valid == 0:
                return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
            q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
            q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
            fetch = min(self._n_valid, top_k * over_fetch if filter_fn else top_k)
            result = topk_search(
                self._dev_x,
                torch.from_numpy(q).to(self.device, self._dev_x.dtype),
                fetch,
                n_valid=self._n_valid,
                deleted=self._dev_deleted,
            )
            scores = result.scores.float().cpu().numpy()
            indices = result.indices.cpu().numpy()
            # snapshot the metadata INSIDE the lock: a concurrent reload
            # swaps self._metadata, and row ids must meet the metadata of
            # the rows they were computed on
            metadata = self._metadata

        out: list[list[SearchResult]] = []
        for b in range(len(q)):
            hits: list[SearchResult] = []
            for score, row in zip(scores[b], indices[b]):
                if not np.isfinite(score):
                    break  # -inf tail: masked rows (k > live rows)
                if row < 0 or row >= len(metadata):
                    continue
                meta = metadata[row]
                if filter_fn is not None and not filter_fn(meta):
                    continue
                hits.append(SearchResult(metadata=meta,
                                         similarity_score=float(score),
                                         rank=len(hits) + 1, source="local"))
                if len(hits) >= top_k:
                    break
            out.append(hits)
        return out

    def search(
        self,
        query_vector: np.ndarray,
        top_k: int = 20,
        filter_fn: Callable[[KeyframeMetadata], bool] | None = None,
    ) -> list[SearchResult]:
        """Single-query convenience."""
        q = np.asarray(query_vector)
        return self.search_vectors(q[None] if q.ndim == 1 else q, top_k,
                                   filter_fn)[0]

    def search_by_row(
        self,
        row_id: int,
        top_k: int = 20,
        exclude_self: bool = True,
        filter_fn: Callable[[KeyframeMetadata], bool] | None = None,
    ) -> list[SearchResult]:
        """Frames similar to an indexed frame."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        if not 0 <= row_id < self._n_valid:
            raise IndexError(f"row {row_id} out of range [0, {self._n_valid})")
        qvec = self._container.read_embeddings(row_id, row_id + 1,
                                               as_float32=True)[0]
        hits = self.search(qvec, top_k + (1 if exclude_self else 0), filter_fn)
        if exclude_self:
            hits = [h for h in hits if h.metadata.row_id != row_id][:top_k]
            for rank, h in enumerate(hits):
                h.rank = rank + 1
        return hits

    # -- assets / metadata ----------------------------------------------------

    def get_metadata(self, row_id: int) -> KeyframeMetadata:
        return self._metadata[row_id]

    def row_for(self, folder: str, image: str) -> int | None:
        return self._row_by_key.get((folder, image))

    def get_temporal_context(self, row_id: int, window: int = 5) -> list[dict[str, Any]]:
        """+-window neighbours within the same folder (adjacent rows)."""
        if not 0 <= row_id < len(self._metadata):
            return []
        center = self._metadata[row_id]
        context = []
        for offset in range(-window, window + 1):
            idx = row_id + offset
            if offset == 0 or not 0 <= idx < len(self._metadata) or idx in self._deleted:
                continue
            m = self._metadata[idx]
            if m.folder == center.folder:
                context.append({"row_id": m.row_id, "folder": m.folder,
                                "image": m.image, "frame_id": m.frame_id,
                                "offset": offset})
        return context

    # -- incremental update -----------------------------------------------

    def incremental_update(
        self,
        new_embeddings: np.ndarray,
        new_metadata: Sequence[KeyframeMetadata | dict[str, Any]],
        thumbnails: list[bytes] | None = None,
        file_hashes: list[str] | None = None,
    ) -> dict[str, Any]:
        """Append rows (embeddings + metadata + assets) without a rebuild:
        in place within the device capacity, a re-upload past it."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        if self._container.mode == "r":
            raise PermissionError("index opened read-only")
        rows = np.atleast_2d(np.asarray(new_embeddings, dtype=np.float32))
        if len(rows) != len(new_metadata):
            raise ValueError("embeddings/metadata count mismatch")
        if self.config.normalize and len(rows):
            rows = rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True),
                                     1e-12)
        with self._lock:
            start = self._container.num_rows
            metas: list[KeyframeMetadata] = []
            for i, m in enumerate(new_metadata):
                meta = (m if isinstance(m, KeyframeMetadata)
                        else KeyframeMetadata.from_dict(dict(m)))
                meta.row_id = start + i
                metas.append(meta)
            self._invalidate_sidecar()  # row count changes -> sidecar stale
            self._container.append_embeddings(rows)
            self._container.append_metadata([m.to_dict() for m in metas])
            # a thumbnail-bearing container gains one entry per row, or a
            # later repair would truncate these rows away
            has_thumbs = self._container.num_thumbnails > 0
            if thumbnails is not None:
                if len(thumbnails) != len(rows):
                    raise ValueError(f"{len(thumbnails)} thumbnails for {len(rows)} rows")
                if has_thumbs or start == 0:
                    self._container.append_thumbnails(thumbnails)
            elif has_thumbs:
                self._container.append_thumbnails([b""] * len(rows))
            if file_hashes:
                self._container.append_journal(file_hashes)
            self._container.flush_checkpoint()
            self._metadata.extend(metas)
            for meta in metas:
                self._row_by_key[meta.key] = meta.row_id
            self.generation += 1
            self._append_device_rows(rows)
        return {"appended": len(rows), "ntotal": self._n_valid}

    # -- deletion (tombstones) ------------------------------------------------

    @property
    def num_deleted(self) -> int:
        return len(self._deleted)

    @property
    def num_live(self) -> int:
        return self._n_valid - len(self._deleted)

    @property
    def deleted_rows(self) -> frozenset:
        return frozenset(self._deleted)

    def delete_rows(self, row_ids: Sequence[int]) -> dict[str, Any]:
        """Tombstone rows: excluded from every search at once, logged in
        the container's delete journal."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        if self._container.mode == "r":
            raise PermissionError("index opened read-only")
        with self._lock:
            fresh = sorted({int(r) for r in row_ids
                            if 0 <= int(r) < self._n_valid
                            and int(r) not in self._deleted})
            if not fresh:
                return {"deleted": 0, "num_live": self.num_live}
            self._container.append_deleted(fresh)
            self._container.flush_checkpoint()
            self._deleted.update(fresh)
            self.generation += 1
            self._rebuild_deleted_mask()
        return {"deleted": len(fresh), "num_live": self.num_live}

    # -- stats ----------------------------------------------------------------

    def get_stats(self) -> dict[str, Any]:
        stats: dict[str, Any] = {
            "ntotal": self._n_valid,
            "num_live": self.num_live,
            "num_deleted": self.num_deleted,
            "dim": self.dim,
            "capacity": self._capacity,
            "load_time_s": self.load_time_s,
            "loaded": self.is_loaded,
            "ann_active": False,
            "device": str(self.device),
        }
        if self._container is not None:
            stats["container"] = self._container.stats().as_dict()
        return stats
