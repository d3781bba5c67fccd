"""UnifiedIndex: the searchable single-file index, rows on a device.

Port of the single-device half (dense and int8) of
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
  selection;
- int8 containers (the capacity mode) keep int8 rows and f32 per-row
  scales on the device, with the row normalization folded into the scale;
  search is :func:`ops.quant.topk_search_int8` (kernel B2 on a card). The
  rows load from the ``.flat8`` sidecar when it is fresh, else from the
  container, which then writes the sidecar for the next open. With
  ``int8_rescore`` the widened int8 candidate set is rescored on the host
  against the container's bf16 copy of the rows.

Not ported yet (each raises ``NotImplementedError`` naming the later
change): IVF ANN and the multi-device mesh. A container that carries a
persisted ANN structure is served by the exact sweep, with a warning.
``index.builder.RAGBuilder`` writes containers and hands the fresh one to
:meth:`UnifiedIndex.attach_container`. Compaction and asset reads come with
the REST server.
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

from .. import native
from ..ops.quant import quantize_rows_int8, topk_search_int8
from ..ops.topk import TILE_N, topk_search
from ..retrieval.results import KeyframeMetadata, SearchResult
from .container import IndexContainer

__all__ = ["UnifiedIndex", "UnifiedIndexConfig"]

_LATER_ANN = "IVF ANN search is ported in a later change"
_LATER_MESH = "multi-device search is ported in a later change"

# rows normalized per device step at upload (bounds the f32 temporary)
_UPLOAD_ROWS = 262_144


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _fold_norm_into_scales(rows_i8: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Fold row L2-normalization into the int8 dequant scale:
    ``score = (q . int) / ||int||``. The one definition shared by the upload
    and the in-place append, so an appended row scores as it will after a
    reload. Sums of squares of int8 rows are exact integers below 2^24, so
    the result does not depend on the chunking (copy of the JAX function)."""
    out = np.asarray(scales, np.float32).copy()
    CH = 1_000_000
    for s in range(0, len(rows_i8), CH):
        q = rows_i8[s:s + CH].astype(np.int32)
        n2 = np.einsum("nd,nd->n", q, q)              # exact integers
        norms = np.sqrt(n2.astype(np.float32))        # exact f32 inputs
        inv = (1.0 / np.maximum(norms, 1e-12)).astype(np.float32)
        live = n2 > 0
        view = out[s:s + CH]
        view[live] = inv[live]
    return out


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a machine without
    CUDA raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@dataclass(slots=True)
class UnifiedIndexConfig:
    """Build and runtime knobs of the index (the reference's fields that
    this port reads; the IVF fields come with that mode)."""

    # build (index.builder.RAGBuilder): files per device batch and container
    # transaction, chunks between checkpoint flushes, stored assets, and the
    # container's row dtype ("bfloat16", "float32", "float16" or "int8")
    chunk_size: int = 1024
    checkpoint_every_chunks: int = 5
    store_thumbnails: bool = True
    thumbnail_size: int = 224
    store_full_images: bool = False
    dtype: str = "bfloat16"
    # L2-normalize rows at upload and append (cosine = inner product)
    normalize: bool = True
    # int8 exact-rescore mode: an int8 container that carries the bf16 copy
    # of its rows (``keep_fp``) rescores the int8 top (k * factor)
    # candidates at full precision on the host
    int8_rescore: bool = False
    int8_rescore_factor: int = 4
    # keep the bf16 rescore rows in host RAM instead of gathering them from
    # the container per query (2 bytes x dim per row)
    int8_rescore_cache: bool = False
    # IVF approximate search: refused until the ANN port lands
    ann: bool = False
    # False: ignore a persisted ANN structure without the warning
    ann_restore: bool = True


class UnifiedIndex:
    """Searchable index over a single container, rows on ``device``."""

    def __init__(
        self,
        config: UnifiedIndexConfig | None = None,
        device: torch.device | str = "cuda",
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
        self._dev_x: torch.Tensor | None = None       # (cap, dim) bf16/f32/int8
        self._dev_scales: torch.Tensor | None = None  # (cap,) f32, int8 mode only
        self._n_valid = 0
        self._capacity = 0
        self._deleted: set[int] = set()
        self._dev_deleted: torch.Tensor | None = None  # (cap, 1) int8
        # host-RAM bf16 bits of the rescore rows (config.int8_rescore_cache)
        self._fp_cache: np.ndarray | None = None
        self._fp_cache_n = 0
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
            self._maybe_build_fp_cache()
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
            self._maybe_build_fp_cache()
        self.load_time_s = time.perf_counter() - t0
        return self

    def close(self) -> None:
        with self._lock:
            if self._container is not None:
                self._container.close()
                self._container = None
            self._dev_x = None
            self._dev_scales = None
            self._dev_deleted = None
            self._n_valid = 0
            self._capacity = 0
            self._metadata = []
            self._row_by_key = {}
            self._fp_cache = None
            self._fp_cache_n = 0

    # -- device state -------------------------------------------------------

    def _upload_embeddings(self) -> None:
        assert self._container is not None
        if self.config.ann_restore and self._container.get_ann() is not None:
            logging.getLogger("ivars").warning(
                "container carries a persisted ANN structure; IVF search is "
                "not ported yet, serving exact dense search"
            )
        n = self._container.num_rows
        self._n_valid = n
        self.generation += 1
        self._dev_scales = None
        self._fp_cache = None
        self._fp_cache_n = 0
        if n == 0:
            self._dev_x = None
            self._capacity = 0
        elif self._container.dtype == "int8":
            # int8 rows go up as they are; the row normalization is folded
            # into the per-row scale (dividing a row by its norm is dividing
            # its scale by the norm)
            self._capacity = _ceil_to(n, TILE_N)
            host = np.zeros((self._capacity, self._container.dim), np.int8)
            host_s = np.zeros((self._capacity,), np.float32)
            self._quantized_into(host[:n], host_s[:n])
            self._dev_x = torch.from_numpy(host).to(self.device)
            self._dev_scales = torch.from_numpy(host_s).to(self.device)
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

    # write the .flat8 sidecar only above this many rows (the JAX index's
    # threshold): tiny corpora open instantly either way
    _FLAT_MIN_ROWS = 10_000

    def _fresh_flat8(self) -> "native.FlatInt8File | None":
        """The ``.flat8`` sidecar when its header matches this container's
        (rows, dim) and this config's ``normalize``, else None."""
        if self.path is None or self._container is None:
            return None
        p = self.path.with_name(self.path.name + ".flat8")
        if not p.is_file():
            return None
        try:
            f = native.FlatInt8File(p)
            n, d, norm = f.header()
        except OSError:  # unreadable sidecar: the container wins
            return None
        if (n, d, norm) == (self._container.num_rows, self._container.dim,
                            bool(self.config.normalize)):
            return f
        return None

    def _quantized_into(self, rows_out: np.ndarray, scales_out: np.ndarray) -> None:
        """Fill ``(n, d)`` int8 rows and ``(n,)`` f32 serving scales: from a
        fresh ``.flat8`` sidecar (scales already folded) in one sequential
        read, else from the container plus the fold, then write the sidecar
        (at >= ``_FLAT_MIN_ROWS`` rows) so the next open reads it."""
        assert self._container is not None
        f8 = self._fresh_flat8()
        if f8 is not None:
            try:
                f8.read_into(rows_out, scales_out)
                return
            except OSError:  # torn mid-read: the container wins
                pass
        rows, scales = self._container.read_quantized()
        if self.config.normalize:
            scales = _fold_norm_into_scales(rows, scales)
        rows_out[:] = rows
        scales_out[:] = scales
        if self.path is not None and len(rows) >= self._FLAT_MIN_ROWS:
            try:
                native.FlatInt8File.write(self.path.with_name(self.path.name + ".flat8"),
                                          rows, scales,
                                          normalized=bool(self.config.normalize))
            except OSError:  # a read-only directory is never a load failure
                pass

    def _quantize_like_upload(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Quantize new rows as the upload does on reload (normalization
        folded into the scale), so appended rows score bit-identically to a
        later reload."""
        q, s = quantize_rows_int8(np.asarray(rows, np.float32))
        if self.config.normalize:
            s = _fold_norm_into_scales(q, s)
        return q, s

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
            self._reload_for_append()
            return
        n = self._n_valid
        if self._dev_scales is not None:  # int8
            q, s = self._quantize_like_upload(rows)
            self._dev_x[n:n + m].copy_(torch.from_numpy(q))
            self._dev_scales[n:n + m].copy_(torch.from_numpy(s))
        else:
            self._dev_x[n:n + m].copy_(
                torch.from_numpy(np.ascontiguousarray(rows, np.float32)))
        self._n_valid += m

    def _reload_for_append(self) -> None:
        """Re-upload past the capacity; the resident rescore cache is
        rebuilt from the container, which already holds the new rows."""
        self._upload_embeddings()
        self._maybe_build_fp_cache()

    def _load_metadata_cache(self) -> None:
        assert self._container is not None
        self._metadata = []
        self._row_by_key = {}
        for i, record in enumerate(self._container.iter_metadata()):
            record.setdefault("row_id", i)
            meta = KeyframeMetadata.from_dict(record)
            self._metadata.append(meta)
            self._row_by_key[meta.key] = i

    # -- int8 exact rescore ---------------------------------------------------

    def _maybe_build_fp_cache(self) -> None:
        """Read the container's bf16 rescore rows into host RAM
        (``config.int8_rescore_cache``). Caller holds the index lock."""
        self._fp_cache = None
        self._fp_cache_n = 0
        if not (self.config.int8_rescore and self.config.int8_rescore_cache
                and self._container is not None
                and getattr(self._container, "has_fp_rows", False)):
            return
        n = self._n_valid
        if n == 0:
            return
        chunk = 262_144
        cache = np.empty((_ceil_to(n, chunk), self.dim), np.uint16)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            cache[s:e] = self._container.read_fp_bits(s, e)
        self._fp_cache = cache
        self._fp_cache_n = n
        logging.getLogger("ivars").info(
            "int8_rescore_cache: %d bf16 rows resident in host RAM (%.2f GB)",
            n, cache.nbytes / 1e9)

    def _fp_cache_append(self, rows_f32: np.ndarray) -> None:
        """Extend the resident rescore cache with appended rows (the bf16
        bits the container's copy stores). Caller holds the index lock."""
        if self._fp_cache is None or len(rows_f32) == 0:
            return
        if self._fp_cache_n >= self._n_valid:
            # an append past the capacity reloaded the cache from the
            # container, new rows included
            return
        bits = native.f32_to_bf16(np.ascontiguousarray(rows_f32, np.float32))
        n0, m = self._fp_cache_n, len(bits)
        if n0 + m > self._fp_cache.shape[0]:
            grown = np.empty((max(_ceil_to(n0 + m, 262_144), int(n0 * 1.5)), self.dim),
                             np.uint16)
            grown[:n0] = self._fp_cache[:n0]
            self._fp_cache = grown
        self._fp_cache[n0:n0 + m] = bits
        self._fp_cache_n = n0 + m

    def _rescore_fp_host(self, q: np.ndarray, scores: np.ndarray, indices: np.ndarray,
                         want: int) -> tuple[np.ndarray, np.ndarray]:
        """Rescore the int8 search's widened candidates in f32 against their
        bf16 rows (the resident cache, else a gather from the container) and
        return the top ``want``, ties in candidate order. Caller holds the
        index lock."""
        b, k_dev = indices.shape
        if k_dev == 0:
            return scores, indices
        finite = np.isfinite(scores)
        safe = np.where(finite, indices, 0)
        if self._fp_cache is not None:
            bits = np.ascontiguousarray(self._fp_cache[safe.reshape(-1)])
            rows = native.bf16_to_f32(bits).reshape(b, k_dev, -1)
        else:
            rows = self._container.read_fp_rows(safe.reshape(-1)).reshape(b, k_dev, -1)
        new = np.einsum("bd,bkd->bk", q.astype(np.float32), rows,
                        optimize=True).astype(np.float32)
        new = np.where(finite, new, -np.inf)
        order = np.argsort(-new, axis=1, kind="stable")[:, :want]
        return (np.take_along_axis(new, order, axis=1),
                np.take_along_axis(indices, order, axis=1))

    # -- search ---------------------------------------------------------------

    def search_vectors(
        self,
        query_vectors: np.ndarray,
        top_k: int = 20,
        filter_fn: Callable[[KeyframeMetadata], bool] | None = None,
        over_fetch: int = 4,
    ) -> list[list[SearchResult]]:
        """Top-k per query vector, as ranked SearchResults (exact search;
        an int8 container searches its quantized metric).

        ``filter_fn``: metadata predicate applied after the search, over
        ``over_fetch`` x ``top_k`` candidates. With ``int8_rescore`` on an
        int8 container that keeps its bf16 rows, ``int8_rescore_factor`` x
        as many candidates are fetched and rescored at full precision.
        """
        with self._lock:
            if self._dev_x is None or self._n_valid == 0:
                return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
            q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
            q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
            fetch = min(self._n_valid, top_k * over_fetch if filter_fn else top_k)
            rescore_fp = (self.config.int8_rescore and self._dev_scales is not None
                          and getattr(self._container, "has_fp_rows", False))
            want = fetch
            if rescore_fp:
                fetch = min(self._n_valid,
                            fetch * max(int(self.config.int8_rescore_factor), 1))
            if self._dev_scales is not None:  # int8
                result = topk_search_int8(
                    self._dev_x,
                    self._dev_scales,
                    torch.from_numpy(q).to(self.device),
                    fetch,
                    n_valid=self._n_valid,
                    deleted=self._dev_deleted,
                )
            else:
                result = topk_search(
                    self._dev_x,
                    torch.from_numpy(q).to(self.device, self._dev_x.dtype),
                    fetch,
                    n_valid=self._n_valid,
                    deleted=self._dev_deleted,
                )
            scores = result.scores.float().cpu().numpy()
            indices = result.indices.cpu().numpy()
            if rescore_fp:
                scores, indices = self._rescore_fp_host(q, scores, indices, want)
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
            self._fp_cache_append(rows)
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

    def read_rows_f32(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """f32 rows whatever the storage dtype (int8 dequantizes), for
        evaluation and export. An int8 container with the bf16 copy of its
        rows answers from that copy, so evaluation oracles measure against
        full precision rather than the dequantized int8 rows."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        if end is None:
            end = self._n_valid
        if getattr(self._container, "has_fp_rows", False):
            return native.bf16_to_f32(self._container.read_fp_bits(start, end))
        return self._container.read_embeddings_f32_any(start, end)

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
