"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/index/container.py``: the JAX
package's ``index/__init__.py`` imports flax, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Single-file index container (HDF5) with streaming append + resume.

Successor of the reference's ``.rvdb`` layout (``unified_index.py:718-731``
groups ``vectors/ metadata/ thumbnails/ temporal/ index/ system/``). Design
changes for TPU:

- embeddings are stored as **raw row bits** (bf16 as uint16 / f16 / f32) in
  a resizable contiguous-chunk dataset — index load is one bulk
  ``read_direct`` + one host->HBM transfer. No serialized FAISS blob exists
  (the reference stored one in-file, ``unified_index.py:1795-1829``) because
  search runs on-device over this matrix.
- thumbnails/full images are concatenated blobs + offset tables (the
  reference's repaired-offset design, ``unified_index.py:996-1065``, made
  append-safe: offsets are written in the same flush as the blob).
- a hash journal dataset records SHA-processed source files for
  checkpoint/resume and incremental update (semantics of
  ``unified_index.py:140-167,1520-1544``).

All writes go through ``flush_checkpoint`` so a crash can lose at most the
last unflushed chunk; consistency is re-derived on open (counts must agree
across sections, trailing partial data is truncated).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

try:
    import zstandard
except ImportError:  # pragma: no cover
    zstandard = None

__all__ = ["IndexContainer", "ContainerStats"]

FORMAT_VERSION = "2.0"
MAGIC = "IVARS-TPU-RVDB"

# bytes of blob data per bulk slab read (module constant so tests can
# shrink it to exercise slab boundaries)
_BLOB_SLAB = 64 * 1024 * 1024

_DTYPE_CODES = {"bfloat16": 0, "float16": 1, "float32": 2, "int8": 3}
_STORE_DTYPES = {
    "bfloat16": np.uint16,
    "float16": np.float16,
    "float32": np.float32,
    "int8": np.int8,
}


# zstd contexts are reused per thread: constructing a ZstdCompressor/
# ZstdDecompressor per ~100-byte record is 5x/16x slower than the
# (de)compression itself (measured at 200k metadata records: 8.6s vs
# 1.7s compress, 5.1s vs 0.3s decompress). Contexts are not documented
# thread-safe, hence thread-local rather than module-global — container
# reads happen from concurrent serving threads.
_zstd_local = threading.local()


def _zstd_ctx():
    ctx = getattr(_zstd_local, "pair", None)
    if ctx is None:
        ctx = _zstd_local.pair = (
            zstandard.ZstdCompressor(level=3),
            zstandard.ZstdDecompressor(),
        )
    return ctx


def _compress(data: bytes) -> bytes:
    if zstandard is not None:
        return _zstd_ctx()[0].compress(data)
    return data


def _decompress(data: bytes, compressed: bool) -> bytes:
    if not compressed:
        return data
    if zstandard is None:
        raise RuntimeError("container uses zstd but zstandard is unavailable")
    return _zstd_ctx()[1].decompress(data)


@dataclass(slots=True)
class ContainerStats:
    path: str
    num_rows: int
    dim: int
    dtype: str
    num_thumbnails: int
    num_images: int
    num_metadata: int
    file_bytes: int
    journal_files: int

    def as_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}  # type: ignore[attr-defined]


class IndexContainer:
    """Low-level single-file storage. One writer OR many readers."""

    def __init__(
        self,
        path: str | Path,
        mode: str = "r",
        dim: int = 768,
        dtype: str = "bfloat16",
        chunk_rows: int = 4096,
        keep_fp: bool = False,
    ) -> None:
        """``keep_fp``: int8 containers additionally store a bf16-bit copy
        of every row (disk-only) so searches can exactly rescore the int8
        top candidates at full precision (``UnifiedIndexConfig.
        int8_rescore``). Ignored for non-int8 dtypes and when opening an
        existing file (the layout is whatever was written)."""
        if h5py is None:
            raise RuntimeError("h5py is required for IndexContainer")
        self._keep_fp = bool(keep_fp)
        self.path = Path(path)
        self.mode = mode
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be r/w/a, got {mode}")
        exists = self.path.is_file()
        if mode == "r" and not exists:
            raise FileNotFoundError(self.path)
        if mode == "a" and not exists:
            mode = "w"
        # 100MB chunk cache for bulk reads (reference tunes the same knob,
        # unified_index.py:365-413)
        self._f = h5py.File(
            self.path, mode, rdcc_nbytes=100 * 1024 * 1024, rdcc_nslots=100003
        )
        if mode == "w":
            self._create_layout(dim, dtype, chunk_rows)
        self._validate_layout()
        self.dim = int(self._f.attrs["dim"])
        self.dtype = str(self._f.attrs["dtype"])
        self._closed = False

    # -- layout -----------------------------------------------------------

    def _create_layout(self, dim: int, dtype: str, chunk_rows: int) -> None:
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"unsupported dtype {dtype}")
        f = self._f
        f.attrs["magic"] = MAGIC
        f.attrs["version"] = FORMAT_VERSION
        f.attrs["dim"] = dim
        f.attrs["dtype"] = dtype
        f.attrs["created_at"] = time.time()
        f.attrs["compressed_meta"] = zstandard is not None
        store = _STORE_DTYPES[dtype]
        f.create_dataset(
            "embeddings", shape=(0, dim), maxshape=(None, dim), dtype=store,
            chunks=(chunk_rows, dim),
        )
        if dtype == "int8":  # per-row symmetric quantization scales
            f.create_dataset(
                "embedding_scales", shape=(0,), maxshape=(None,),
                dtype=np.float32, chunks=(chunk_rows,),
            )
            if self._keep_fp:
                # optional full-precision (bf16-bit) copy for the exact-
                # rescore mode: lives on DISK only (HBM keeps the 2x int8
                # capacity win); small chunks bound the read amplification
                # of the per-query top-k*factor row gather (64 rows * 768
                # * 2 B ~= 96 KB per touched chunk)
                f.create_dataset(
                    "embeddings_fp", shape=(0, dim), maxshape=(None, dim),
                    dtype=np.uint16, chunks=(min(64, chunk_rows), dim),
                )
        blob = dict(shape=(0,), maxshape=(None,), dtype=np.uint8,
                    chunks=(1 << 20,))
        off = dict(shape=(1,), maxshape=(None,), dtype=np.int64, chunks=(4096,))
        f.create_dataset("thumbnails/data", **blob)
        thumb_off = f.create_dataset("thumbnails/offsets", **off)
        thumb_off[0] = 0
        f.create_dataset("images/data", **blob)
        img_off = f.create_dataset("images/offsets", **off)
        img_off[0] = 0
        f.create_dataset("metadata/data", **blob)
        meta_off = f.create_dataset("metadata/offsets", **off)
        meta_off[0] = 0
        f.create_dataset(
            "journal/hashes",
            shape=(0,), maxshape=(None,),
            dtype=h5py.string_dtype(encoding="utf-8"), chunks=(4096,),
        )
        f.create_dataset(
            "journal/deleted", shape=(0,), maxshape=(None,), dtype=np.int64,
            chunks=(4096,),
        )
        f.create_group("maps")
        f.create_group("system")

    def _validate_layout(self) -> None:
        f = self._f
        if f.attrs.get("magic") != MAGIC:
            raise ValueError(f"{self.path} is not an {MAGIC} container")
        required = [
            "embeddings", "thumbnails/data", "thumbnails/offsets",
            "metadata/data", "metadata/offsets", "journal/hashes",
        ]
        missing = [k for k in required if k not in f]
        if missing:
            raise ValueError(f"container missing sections: {missing}")

    # -- embeddings --------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return int(self._f["embeddings"].shape[0])

    def append_embeddings(self, rows: np.ndarray) -> tuple[int, int]:
        """Append (M, dim) f32 rows; returns (start_row, end_row).

        For ``int8`` containers the rows are quantized here (per-row
        symmetric scales stored alongside).
        """
        ds = self._f["embeddings"]
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (M, {self.dim}), got {rows.shape}")
        start = ds.shape[0]
        if self.dtype == "int8":
            from ..ops.quant import quantize_rows_int8

            q, scales = quantize_rows_int8(rows.astype(np.float32))
            ds.resize((start + len(rows), self.dim))
            ds[start:] = q
            sds = self._f["embedding_scales"]
            sds.resize((start + len(rows),))
            sds[start:] = scales
            if "embeddings_fp" in self._f:
                from .. import native

                fp = self._f["embeddings_fp"]
                fp.resize((start + len(rows), self.dim))
                fp[start:] = native.f32_to_bf16(
                    np.ascontiguousarray(rows, np.float32)
                )
        else:
            stored = self._to_storage(rows)
            ds.resize((start + len(rows), self.dim))
            ds[start:] = stored
        return start, start + len(rows)

    def append_quantized(
        self, rows_i8: np.ndarray, scales: np.ndarray
    ) -> tuple[int, int]:
        """Append PRE-QUANTIZED int8 rows + per-row scales verbatim
        (int8 containers only; returns (start_row, end_row)).

        ``append_embeddings`` re-quantizes f32 input, which is not
        idempotent for rows that did not originate from this quantizer
        (the max-abs scale is recomputed) — external quantizers, exact
        replication across deployments, and bit-exact device-twin
        benchmarking (benchmarks/exp_coldstart_10m.py) need the stored
        bytes to be EXACTLY the caller's. When the container carries the
        full-precision copy (``keep_fp``), the bf16 rows are the
        dequantized int8 values — the best reconstruction available
        without the original f32 rows.
        """
        if self.dtype != "int8":
            raise ValueError("append_quantized requires an int8 container")
        rows_i8 = np.asarray(rows_i8, np.int8)
        scales = np.asarray(scales, np.float32).reshape(-1)
        if rows_i8.ndim != 2 or rows_i8.shape[1] != self.dim:
            raise ValueError(
                f"expected (M, {self.dim}), got {rows_i8.shape}"
            )
        if len(scales) != len(rows_i8):
            raise ValueError(
                f"{len(scales)} scales for {len(rows_i8)} rows"
            )
        ds = self._f["embeddings"]
        start = ds.shape[0]
        ds.resize((start + len(rows_i8), self.dim))
        ds[start:] = rows_i8
        sds = self._f["embedding_scales"]
        sds.resize((start + len(rows_i8),))
        sds[start:] = scales
        if "embeddings_fp" in self._f:
            from .. import native

            fp = self._f["embeddings_fp"]
            fp.resize((start + len(rows_i8), self.dim))
            fp[start:] = native.f32_to_bf16(np.ascontiguousarray(
                rows_i8.astype(np.float32) * scales[:, None], np.float32
            ))
        return start, start + len(rows_i8)

    def read_quantized(
        self, start: int = 0, end: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """int8 rows + scales (int8 containers only)."""
        if self.dtype != "int8":
            raise ValueError("read_quantized requires an int8 container")
        ds = self._f["embeddings"]
        end = ds.shape[0] if end is None else end
        rows = np.empty((end - start, self.dim), np.int8)
        scales = np.empty((end - start,), np.float32)
        if end > start:
            ds.read_direct(rows, np.s_[start:end])
            self._f["embedding_scales"].read_direct(scales, np.s_[start:end])
        return rows, scales

    @property
    def has_fp_rows(self) -> bool:
        """True when this int8 container carries the optional bf16 copy
        (written with ``keep_fp=True``) enabling exact rescore."""
        return "embeddings_fp" in self._f

    def read_fp_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Gather full-precision rows by id from the bf16 copy -> (n, dim)
        f32. The per-query exact-rescore gather (k*factor rows, ~100 KB):
        ids are sorted for h5py then results restored to request order."""
        if "embeddings_fp" not in self._f:
            raise ValueError("container has no embeddings_fp (keep_fp) copy")
        ids = np.asarray(row_ids, np.int64).reshape(-1)
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        # h5py fancy indexing requires strictly increasing ids: dedupe
        uniq, inverse = np.unique(sorted_ids, return_inverse=True)
        bits = self._f["embeddings_fp"][uniq.tolist()]
        from .. import native

        rows_sorted = native.bf16_to_f32(bits)[inverse]
        out = np.empty_like(rows_sorted)
        out[order] = rows_sorted
        return out

    def read_fp_bits(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """Bulk-read the bf16 copy's raw bits (uint16) for range copies
        (compact must preserve full precision, not round-trip through the
        int8 quantizer)."""
        if "embeddings_fp" not in self._f:
            raise ValueError("container has no embeddings_fp (keep_fp) copy")
        ds = self._f["embeddings_fp"]
        end = ds.shape[0] if end is None else end
        out = np.empty((end - start, self.dim), np.uint16)
        if end > start:
            ds.read_direct(out, np.s_[start:end])
        return out

    def read_embeddings(
        self, start: int = 0, end: int | None = None, as_float32: bool = False
    ) -> np.ndarray:
        """Bulk-read rows. Default returns the raw storage view (bf16 bits as
        uint16) for zero-conversion device upload; ``as_float32`` converts
        (dequantizing int8 containers via their stored scales)."""
        if as_float32 and self.dtype == "int8":
            rows, scales = self.read_quantized(start, end)
            return rows.astype(np.float32) * scales[:, None]
        ds = self._f["embeddings"]
        end = ds.shape[0] if end is None else end
        out = np.empty((end - start, self.dim), dtype=ds.dtype)
        if end > start:
            ds.read_direct(out, np.s_[start:end])
        if as_float32:
            return self._to_float32(out)
        return out

    def _to_storage(self, rows: np.ndarray) -> np.ndarray:
        if self.dtype == "bfloat16":
            # bf16 = top 16 bits of f32, round-to-nearest-even (native C++
            # codec when available; numpy fallback inside)
            from .. import native

            return native.f32_to_bf16(
                np.ascontiguousarray(rows, dtype=np.float32)
            )
        return np.asarray(rows, dtype=_STORE_DTYPES[self.dtype])

    def _to_float32(self, stored: np.ndarray) -> np.ndarray:
        if self.dtype == "bfloat16":
            from .. import native

            return native.bf16_to_f32(stored)
        return stored.astype(np.float32)

    def read_embeddings_f32_any(self, start: int = 0, end: int | None = None
                                ) -> np.ndarray:
        """f32 rows regardless of storage dtype (dequantizes int8)."""
        if self.dtype == "int8":
            rows, scales = self.read_quantized(start, end)
            return rows.astype(np.float32) * scales[:, None]
        return self.read_embeddings(start, end, as_float32=True)

    # -- blob sections (thumbnails / images / metadata) --------------------

    def _append_blobs(self, section: str, blobs: list[bytes]) -> None:
        data = self._f[f"{section}/data"]
        offs = self._f[f"{section}/offsets"]
        joined = b"".join(blobs)
        dstart = data.shape[0]
        data.resize((dstart + len(joined),))
        if joined:
            data[dstart:] = np.frombuffer(joined, dtype=np.uint8)
        ostart = offs.shape[0]
        offs.resize((ostart + len(blobs),))
        cursor = dstart
        new_offsets = []
        for b in blobs:
            cursor += len(b)
            new_offsets.append(cursor)
        offs[ostart:] = np.asarray(new_offsets, dtype=np.int64)

    def _blob_count(self, section: str) -> int:
        return int(self._f[f"{section}/offsets"].shape[0]) - 1

    def _read_blob(self, section: str, idx: int) -> bytes:
        offs = self._f[f"{section}/offsets"]
        count = offs.shape[0] - 1
        if not 0 <= idx < count:
            raise IndexError(f"{section}[{idx}] out of range (count={count})")
        start, end = int(offs[idx]), int(offs[idx + 1])
        if end == start:
            return b""
        return bytes(self._f[f"{section}/data"][start:end])

    def append_thumbnails(self, jpegs: list[bytes]) -> None:
        self._append_blobs("thumbnails", jpegs)

    def get_thumbnail(self, row_id: int) -> bytes:
        return self._read_blob("thumbnails", row_id)

    @property
    def num_thumbnails(self) -> int:
        return self._blob_count("thumbnails")

    def append_images(self, jpegs: list[bytes]) -> None:
        self._append_blobs("images", jpegs)

    def get_image(self, row_id: int) -> bytes:
        return self._read_blob("images", row_id)

    @property
    def num_images(self) -> int:
        return self._blob_count("images")

    def append_metadata(self, records: list[dict[str, Any]]) -> None:
        compressed = bool(self._f.attrs.get("compressed_meta", False))
        blobs = []
        for record in records:
            raw = json.dumps(record, ensure_ascii=False).encode("utf-8")
            blobs.append(_compress(raw) if compressed else raw)
        self._append_blobs("metadata", blobs)

    def get_metadata(self, row_id: int) -> dict[str, Any]:
        compressed = bool(self._f.attrs.get("compressed_meta", False))
        raw = _decompress(self._read_blob("metadata", row_id), compressed)
        return json.loads(raw.decode("utf-8"))

    def _iter_blob_slabs(
        self, section: str, lo: int, hi: int
    ) -> Iterator[bytes]:
        """Stream blobs [lo, hi) of a section via BULK slab reads.

        Per-record ``_read_blob`` pays ~1 ms of h5py call overhead per
        record (measured: 200k records took >180 s at index load); 64 MB
        slabs of the offsets + data datasets make consumers parse-bound
        instead (~100x faster at scale), with bounded memory even when a
        caller's range spans gigabytes.
        """
        count = self._blob_count(section)
        lo, hi = max(lo, 0), min(hi, count)
        if hi <= lo:
            return
        offs_ds = self._f[f"{section}/offsets"]
        data_ds = self._f[f"{section}/data"]
        offs = np.empty((hi - lo + 1,), np.int64)
        offs_ds.read_direct(offs, np.s_[lo:hi + 1])
        i = 0
        n = hi - lo
        while i < n:
            j = i + 1
            while j < n and offs[j + 1] - offs[i] <= _BLOB_SLAB:
                j += 1
            blob = np.empty((int(offs[j] - offs[i]),), np.uint8)
            if blob.size:
                data_ds.read_direct(blob, np.s_[int(offs[i]):int(offs[j])])
            buf = blob.tobytes()
            base = int(offs[i])
            for r in range(i, j):
                yield buf[int(offs[r]) - base:int(offs[r + 1]) - base]
            i = j

    def read_blob_range(self, section: str, lo: int, hi: int) -> list[bytes]:
        """Bulk-read blobs [lo, hi) of a section (thumbnails/images/...)."""
        return list(self._iter_blob_slabs(section, lo, hi))

    def iter_metadata(self) -> Iterator[dict[str, Any]]:
        """Stream all metadata records via bulk slab reads
        (:meth:`_iter_blob_slabs` rationale)."""
        compressed = bool(self._f.attrs.get("compressed_meta", False))
        for raw in self._iter_blob_slabs("metadata", 0, self.num_metadata):
            yield json.loads(_decompress(raw, compressed).decode("utf-8"))

    def read_metadata_range(self, lo: int, hi: int) -> list[dict[str, Any]]:
        """Bulk-read records [lo, hi) via slab reads (bounded memory even
        when the range spans a large deleted gap)."""
        compressed = bool(self._f.attrs.get("compressed_meta", False))
        return [
            json.loads(_decompress(raw, compressed).decode("utf-8"))
            for raw in self._iter_blob_slabs("metadata", lo, hi)
        ]

    @property
    def num_metadata(self) -> int:
        return self._blob_count("metadata")

    # -- journal (checkpoint/resume) --------------------------------------

    def journal_hashes(self) -> set[str]:
        ds = self._f["journal/hashes"]
        return {h.decode("utf-8") if isinstance(h, bytes) else str(h) for h in ds[:]}

    def append_journal(self, hashes: list[str]) -> None:
        ds = self._f["journal/hashes"]
        start = ds.shape[0]
        ds.resize((start + len(hashes),))
        ds[start:] = hashes

    # -- tombstone delete log (append-only, crash-safe) --------------------

    def append_deleted(self, row_ids: list[int]) -> None:
        if "journal/deleted" not in self._f:  # containers from older builds
            self._f.create_dataset(
                "journal/deleted", shape=(0,), maxshape=(None,),
                dtype=np.int64, chunks=(4096,),
            )
        ds = self._f["journal/deleted"]
        start = ds.shape[0]
        ds.resize((start + len(row_ids),))
        ds[start:] = np.asarray(row_ids, dtype=np.int64)

    def deleted_rows(self) -> set[int]:
        if "journal/deleted" not in self._f:
            return set()
        return {int(r) for r in self._f["journal/deleted"][:]}

    # -- frame maps --------------------------------------------------------

    def put_map(self, folder: str, csv_text: str) -> None:
        grp = self._f["maps"]
        if folder in grp:
            del grp[folder]
        grp[folder] = np.frombuffer(csv_text.encode("utf-8"), dtype=np.uint8)

    def get_map(self, folder: str) -> str | None:
        grp = self._f["maps"]
        if folder not in grp:
            return None
        return bytes(grp[folder][:]).decode("utf-8")

    def map_folders(self) -> list[str]:
        return list(self._f["maps"].keys())

    # -- system kv ---------------------------------------------------------

    def put_system(self, key: str, value: Any) -> None:
        grp = self._f["system"]
        if key in grp:
            del grp[key]
        raw = json.dumps(value, ensure_ascii=False).encode("utf-8")
        grp[key] = np.frombuffer(raw, dtype=np.uint8)

    def get_system(self, key: str, default: Any = None) -> Any:
        grp = self._f["system"]
        if key not in grp:
            return default
        return json.loads(bytes(grp[key][:]).decode("utf-8"))

    # -- ANN sidecar (optional "ann" group) --------------------------------
    # Persists the IVF structure (ops.ann) so reopening a large index skips
    # the k-means/bucketing build. The group is OPTIONAL: absent in older
    # files, ignored by older readers, dropped whenever row ids shift
    # (compaction). ``attrs["ann_rows"]`` records the corpus size the
    # buckets cover; rows appended after that land in the tail at load.

    def put_ann(self, arrays: dict[str, np.ndarray],
                attrs: dict[str, Any]) -> None:
        f = self._f
        if "ann" in f:
            del f["ann"]
        grp = f.create_group("ann")
        for key, arr in arrays.items():
            grp.create_dataset(key, data=np.asarray(arr))
        for key, val in attrs.items():
            grp.attrs[key] = val

    def update_ann_attrs(self, attrs: dict[str, Any]) -> None:
        """Update scalar attrs on an existing ann group in place (tuned
        nprobe, measured crossover batch) without rewriting the arrays."""
        if "ann" in self._f and self.mode != "r":
            grp = self._f["ann"]
            for key, val in attrs.items():
                grp.attrs[key] = val

    def get_ann(self) -> tuple[dict[str, np.ndarray], dict[str, Any]] | None:
        if "ann" not in self._f:
            return None
        grp = self._f["ann"]
        arrays = {key: np.asarray(grp[key]) for key in grp}
        return arrays, {k: v for k, v in grp.attrs.items()}

    def drop_ann(self) -> None:
        if "ann" in self._f and self.mode != "r":
            del self._f["ann"]

    # -- consistency & lifecycle ------------------------------------------

    def flush_checkpoint(self, extra: dict[str, Any] | None = None) -> None:
        """Durability point: flush HDF5 buffers + record counts."""
        self.put_system(
            "checkpoint",
            {
                "ts": time.time(),
                "num_rows": self.num_rows,
                "num_thumbnails": self.num_thumbnails,
                "num_metadata": self.num_metadata,
                **(extra or {}),
            },
        )
        self._f.flush()

    def consistency_report(self) -> dict[str, Any]:
        rows, thumbs, metas = self.num_rows, self.num_thumbnails, self.num_metadata
        images = self.num_images
        issues = []
        if metas != rows:
            issues.append(f"metadata count {metas} != embedding rows {rows}")
        if thumbs not in (0, rows):
            issues.append(f"thumbnail count {thumbs} != rows {rows} (or 0)")
        if images not in (0, rows):
            issues.append(f"full-image count {images} != rows {rows} (or 0)")
        return {"ok": not issues, "issues": issues, "rows": rows,
                "thumbnails": thumbs, "images": images, "metadata": metas}

    def repair_to_consistent(self) -> int:
        """Truncate every section to the shortest consistent row count
        (crash recovery — by design this can drop at most one chunk)."""
        rows = self.num_rows
        counts = [rows, self.num_metadata]
        if self.num_thumbnails:
            counts.append(self.num_thumbnails)
        if self.num_images:
            counts.append(self.num_images)
        target = min(counts)
        self._truncate_rows(target)
        return target

    def _truncate_rows(self, target: int) -> None:
        self._f["embeddings"].resize((target, self.dim))
        if self.dtype == "int8" and "embedding_scales" in self._f:
            self._f["embedding_scales"].resize((target,))
        # roll the hash journal back too: builder appends one hash per row,
        # so journal entries beyond the surviving rows belong to truncated
        # data — leaving them would make resume skip those source files
        # forever (silent data loss instead of re-processing)
        journal = self._f["journal/hashes"]
        if journal.shape[0] > target:
            journal.resize((target,))
        # drop tombstones pointing past the surviving rows — those row ids
        # will be reused by future appends and must not be born-dead
        if "journal/deleted" in self._f:
            dead = self._f["journal/deleted"]
            live = [int(r) for r in dead[:] if int(r) < target]
            if len(live) != dead.shape[0]:
                dead.resize((len(live),))
                if live:
                    dead[:] = np.asarray(live, dtype=np.int64)
        for section in ("thumbnails", "images", "metadata"):
            offs = self._f[f"{section}/offsets"]
            count = offs.shape[0] - 1
            keep = min(count, target)
            if keep < count:
                end = int(offs[keep])
                offs.resize((keep + 1,))
                self._f[f"{section}/data"].resize((end,))
        self._f.flush()

    def stats(self) -> ContainerStats:
        return ContainerStats(
            path=str(self.path),
            num_rows=self.num_rows,
            dim=self.dim,
            dtype=self.dtype,
            num_thumbnails=self.num_thumbnails,
            num_images=self.num_images,
            num_metadata=self.num_metadata,
            file_bytes=self.path.stat().st_size if self.path.is_file() else 0,
            journal_files=int(self._f["journal/hashes"].shape[0]),
        )

    def close(self) -> None:
        if not self._closed:
            self._f.close()
            self._closed = True

    def __enter__(self) -> "IndexContainer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
