"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/native/__init__.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Native (C++) host-side kernels, loaded via ctypes.

Compile-on-demand with graceful degradation: when a toolchain is missing
every entry point falls back to the pure-Python implementation, so the
framework never hard-depends on the native library. ``is_available()``
reports which path is active.

Exposed:
- :func:`hash_files` — multithreaded SHA-256 content hashing (journal)
- :func:`topk_ip` — exact inner-product top-k on CPU (FAISS-IndexFlatIP
  semantics; device-less fallback)
- :func:`f32_to_bf16` / :func:`bf16_to_f32` — container row codecs
- :class:`FlatEmbeddingFile` — mmap'd flat embedding sidecar (zero-copy
  host view for instant startup)
- :class:`FlatInt8File` — the int8 capacity-mode analog (rows + folded
  per-row scales in one mmap'd file)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "is_available",
    "hash_files",
    "topk_ip",
    "f32_to_bf16",
    "bf16_to_f32",
    "FlatEmbeddingFile",
    "FlatInt8File",
]

_SRC = Path(__file__).with_name("ivars_native.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_dir() -> Path:
    cache = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))
    return cache / "ivars_torch_native"  # the original's is ivars_tpu_native


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
            out_dir = _build_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            so_path = out_dir / f"ivars_native_{src_hash}.so"
            if not so_path.is_file():
                with tempfile.TemporaryDirectory() as td:
                    tmp_so = Path(td) / "ivars_native.so"
                    cmd = [
                        "g++", "-O3", "-march=native", "-std=c++17", "-shared",
                        "-fPIC", "-pthread", str(_SRC), "-o", str(tmp_so),
                    ]
                    subprocess.run(
                        cmd, check=True, capture_output=True, timeout=120
                    )
                    tmp_so.replace(so_path)
            lib = ctypes.CDLL(str(so_path))
            _bind(lib)
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    lib.ivars_hash_files.restype = ctypes.c_int
    lib.ivars_hash_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,
    ]
    lib.ivars_topk_ip.restype = None
    lib.ivars_topk_ip.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.ivars_f32_to_bf16.restype = None
    lib.ivars_f32_to_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
    ]
    lib.ivars_bf16_to_f32.restype = None
    lib.ivars_bf16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.ivars_flat_write.restype = ctypes.c_int
    lib.ivars_flat_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ivars_flat_open.restype = ctypes.c_void_p
    lib.ivars_flat_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ivars_flat_close.restype = None
    lib.ivars_flat_close.argtypes = [ctypes.c_void_p, ctypes.c_int64]


def is_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


def hash_files(paths: list[str | Path], threads: int = 8) -> list[str | None]:
    """SHA-256[:16] per file (None on failure). Native when possible."""
    paths = [str(p) for p in paths]
    if not paths:
        return []
    lib = _load()
    if lib is None:
        return [_py_hash(p) for p in paths]
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode("utf-8") for p in paths]
    )
    out = ctypes.create_string_buffer(len(paths) * 16)
    ok = (ctypes.c_int8 * len(paths))()
    lib.ivars_hash_files(arr, len(paths), out, ok, threads)
    results: list[str | None] = []
    raw = out.raw
    for i in range(len(paths)):
        if ok[i] == 0:
            results.append(raw[i * 16 : (i + 1) * 16].decode("ascii"))
        else:
            results.append(None)
    return results


def _py_hash(path: str) -> str | None:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()[:16]
    except OSError:
        return None


# ---------------------------------------------------------------------------
# CPU top-k
# ---------------------------------------------------------------------------


def topk_ip(
    x: np.ndarray, q: np.ndarray, k: int, threads: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Exact inner-product top-k: (scores, ids), both (B, k), descending."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    q = np.ascontiguousarray(np.atleast_2d(q), dtype=np.float32)
    n, d = x.shape
    b = q.shape[0]
    k = min(k, n)
    if k == 0:
        return (np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int32))
    lib = _load()
    if lib is None:
        scores = q @ x.T
        ids = np.argsort(-scores, axis=1)[:, :k].astype(np.int32)
        top = np.take_along_axis(scores, ids, axis=1).astype(np.float32)
        return top, ids
    out_scores = np.empty((b, k), np.float32)
    out_ids = np.empty((b, k), np.int32)
    lib.ivars_topk_ip(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n),
        d,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b,
        k,
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out_scores, out_ids


# ---------------------------------------------------------------------------
# bf16 codecs
# ---------------------------------------------------------------------------


def f32_to_bf16(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    lib = _load()
    if lib is None:
        bits = rows.view(np.uint32)
        return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    out = np.empty(rows.shape, np.uint16)
    lib.ivars_f32_to_bf16(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(rows.size),
    )
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    lib = _load()
    if lib is None:
        return (bits.astype(np.uint32) << 16).view(np.float32)
    out = np.empty(bits.shape, np.float32)
    lib.ivars_bf16_to_f32(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(bits.size),
    )
    return out


# ---------------------------------------------------------------------------
# Flat embedding sidecar (mmap)
# ---------------------------------------------------------------------------

_DTYPE_CODES = {"bfloat16": 0, "float32": 2}
_CODE_DTYPES = {0: np.uint16, 2: np.float32}


class FlatEmbeddingFile:
    """mmap'd flat (N, D) embedding array with near-zero open cost.

    Written next to the container at finalize; loading maps the file and
    exposes a numpy view without copying (the copy happens only on the
    host->device transfer).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._ptr = None
        self._map_len = ctypes.c_int64(0)
        self.rows: np.ndarray | None = None
        self.dtype_name: str | None = None

    @staticmethod
    def write(path: str | Path, rows: np.ndarray, dtype: str = "bfloat16") -> Path:
        path = Path(path)
        code = _DTYPE_CODES[dtype]
        if dtype == "bfloat16":
            data = f32_to_bf16(np.asarray(rows, np.float32))
        else:
            data = np.ascontiguousarray(rows, np.float32)
        lib = _load()
        if lib is None:
            # python fallback: same binary layout
            import struct

            with open(path, "wb") as f:
                f.write(b"IVARSFLT")
                f.write(struct.pack("<qii", rows.shape[0], rows.shape[1], code))
                f.write(data.tobytes())
            return path
        rc = lib.ivars_flat_write(
            str(path).encode(), data.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(rows.shape[0]), rows.shape[1], code,
        )
        if rc != 0:
            raise IOError(f"flat write failed rc={rc}")
        return path

    @staticmethod
    def write_raw(path: str | Path, data: np.ndarray, dtype: str) -> Path:
        """Atomic write of an ALREADY-storage-dtype payload (u16 bf16 bits
        or f32) — the lazy-on-load writer's path; :meth:`write` converts
        from f32 instead."""
        import struct

        path = Path(path)
        want = np.uint16 if dtype == "bfloat16" else np.float32
        data = np.ascontiguousarray(data)
        if data.ndim != 2 or data.dtype != want:
            raise ValueError(f"payload must be 2-D {want} for {dtype}")
        _atomic_write(path, [
            b"IVARSFLT",
            struct.pack("<qii", data.shape[0], data.shape[1],
                        _DTYPE_CODES[dtype]),
            data.tobytes(),
        ])
        return path

    def header(self) -> tuple[int, int, str]:
        """Validate magic + size; returns ``(n, d, dtype_name)``."""
        import struct

        with open(self.path, "rb") as f:
            h = f.read(24)
        if h[:8] != b"IVARSFLT":
            raise IOError(f"not a flat embedding file: {self.path}")
        n, d, code = struct.unpack("<qii", h[8:24])
        np_dtype = _CODE_DTYPES.get(code)
        if np_dtype is None:
            raise IOError(f"unknown dtype code {code} in {self.path}")
        if self.path.stat().st_size != 24 + n * d * np.dtype(np_dtype).itemsize:
            raise IOError(f"truncated flat embedding file: {self.path}")
        self.dtype_name = "bfloat16" if code == 0 else "float32"
        return n, d, self.dtype_name

    def read_into(self, out: np.ndarray) -> str:
        """Stream the raw payload (u16 bf16 bits / f32) into a caller-owned
        buffer with buffered sequential ``readinto`` — see
        ``FlatInt8File.read_into`` for why bulk loads read rather than
        map. Returns the dtype name."""
        n, d, name = self.header()
        want = np.uint16 if name == "bfloat16" else np.float32
        if (out.shape != (n, d) or out.dtype != want
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous {want} (n, d)")
        _stream_into(self.path, 24, (out,))
        return name

    def open(self) -> np.ndarray:
        """Map the file; returns the (N, D) raw-bits view."""
        lib = _load()
        if lib is None:
            return self._open_py()
        n = ctypes.c_int64(0)
        d = ctypes.c_int32(0)
        code = ctypes.c_int32(0)
        ptr = lib.ivars_flat_open(
            str(self.path).encode(), ctypes.byref(n), ctypes.byref(d),
            ctypes.byref(code), ctypes.byref(self._map_len),
        )
        if not ptr:
            raise IOError(f"cannot map {self.path}")
        self._ptr = ptr
        np_dtype = _CODE_DTYPES[code.value]
        self.dtype_name = "bfloat16" if code.value == 0 else "float32"
        buf_type = ctypes.c_uint8 * (n.value * d.value * np.dtype(np_dtype).itemsize)
        buf = buf_type.from_address(ptr)
        self.rows = np.frombuffer(buf, dtype=np_dtype).reshape(n.value, d.value)
        return self.rows

    def _open_py(self) -> np.ndarray:
        import mmap as _mmap
        import struct

        with open(self.path, "rb") as f:
            header = f.read(24)
            magic = header[:8]
            if magic != b"IVARSFLT":
                raise IOError(f"not a flat embedding file: {self.path}")
            n, d, code = struct.unpack("<qii", header[8:24])
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        np_dtype = _CODE_DTYPES[code]
        self.dtype_name = "bfloat16" if code == 0 else "float32"
        self._py_map = mm
        self.rows = np.frombuffer(
            mm, dtype=np_dtype, offset=24, count=n * d
        ).reshape(n, d)
        return self.rows

    def as_float32(self) -> np.ndarray:
        """Owned f32 copy (safe to use after close() unmaps the file)."""
        assert self.rows is not None, "open() first"
        if self.dtype_name == "bfloat16":
            return bf16_to_f32(self.rows)
        return np.array(self.rows, np.float32, copy=True)

    def close(self) -> None:
        self.rows = None
        lib = _load()
        if self._ptr is not None and lib is not None:
            lib.ivars_flat_close(self._ptr, self._map_len)
            self._ptr = None
        if getattr(self, "_py_map", None) is not None:
            self._py_map.close()
            self._py_map = None

    def __enter__(self) -> "FlatEmbeddingFile":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Shared flat-sidecar I/O helpers (FlatEmbeddingFile + FlatInt8File)
# ---------------------------------------------------------------------------

_STREAM_CHUNK = 64 << 20


def _atomic_write(path: Path, chunks: list[bytes]) -> None:
    """tmp-in-same-dir + os.replace: readers never see a torn file."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            for c in chunks:
                f.write(c)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _stream_into(path: Path, offset: int, arrays: tuple) -> None:
    """Buffered sequential ``readinto`` of consecutive payloads into
    caller-owned contiguous arrays — bulk sidecar loads READ rather than
    mmap (fault-driven streaming measured 66 MB/s on this virtio disk vs
    ~800 MB/s for plain reads)."""
    with open(path, "rb") as f:
        f.seek(offset)
        for out in arrays:
            mv = memoryview(out).cast("B")
            off, total = 0, out.nbytes
            while off < total:
                take = min(_STREAM_CHUNK, total - off)
                if f.readinto(mv[off:off + take]) != take:
                    raise IOError(f"short read in flat sidecar: {path}")
                off += take


# ---------------------------------------------------------------------------
# Quantized flat sidecar (int8 rows + per-row scales, mmap)
# ---------------------------------------------------------------------------

_FLAT8_MAGIC = b"IVARSFL8"


class FlatInt8File:
    """mmap'd int8 ``(N, D)`` rows + f32 ``(N,)`` scales — the capacity-mode
    analog of :class:`FlatEmbeddingFile`, written lazily by ``UnifiedIndex``
    after the first blob load of an int8 container.

    Why it exists (round-5 measurement at 10M rows): the ``.rvdb``'s int8
    embedding chunks interleave on disk with the optional ``keep_fp`` bf16
    blob and the metadata store, so a dataset-order h5py read of the rows
    streams at **71 MB/s (~108 s for 7.7 GB)** against the disk's ~1 GB/s
    sequential rate — and normalization folding costs another full integer
    pass. This file stores the rows contiguously WITH the scales **as
    served** (the fold already applied when ``normalized``), so a re-open
    is two mmap views + one linear copy into the padded device staging
    buffer. Same freshness contract as the ``.flat``/``.meta.npz``
    sidecars: unlinked by every row mutation, row-count checked at load
    (``unified.py _invalidate_sidecar``).

    Layout: ``IVARSFL8 | n:int64 | d:int32 | normalized:int32`` then
    ``n*d`` int8 row bytes, then ``n`` f32 scale bytes.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.rows: np.ndarray | None = None
        self.scales: np.ndarray | None = None
        self.normalized: bool | None = None
        self._py_map = None

    @staticmethod
    def write(path: str | Path, rows: np.ndarray, scales: np.ndarray,
              normalized: bool) -> Path:
        """Atomic (tmp+rename) sequential write; plain file I/O is already
        disk-rate for a contiguous stream — no native helper needed."""
        import struct

        path = Path(path)
        rows = np.ascontiguousarray(rows, np.int8)
        scales = np.ascontiguousarray(scales, np.float32)
        if rows.ndim != 2 or scales.shape != (rows.shape[0],):
            raise ValueError("rows must be (n, d) with scales (n,)")
        _atomic_write(path, [
            _FLAT8_MAGIC,
            struct.pack("<qii", rows.shape[0], rows.shape[1],
                        1 if normalized else 0),
            rows.tobytes(),
            scales.tobytes(),
        ])
        return path

    def header(self) -> tuple[int, int, bool]:
        """Validate magic + size; returns ``(n, d, normalized)``."""
        import struct

        with open(self.path, "rb") as f:
            h = f.read(24)
        if h[:8] != _FLAT8_MAGIC:
            raise IOError(f"not a flat int8 sidecar: {self.path}")
        n, d, norm = struct.unpack("<qii", h[8:24])
        if self.path.stat().st_size != 24 + n * d + 4 * n:
            raise IOError(f"truncated flat int8 sidecar: {self.path}")
        self.normalized = bool(norm)
        return n, d, bool(norm)

    def read_into(self, rows_out: np.ndarray, scales_out: np.ndarray) -> None:
        """Stream the file into caller-owned buffers with buffered
        sequential ``readinto`` — mmap fault-driven streaming measured
        66 MB/s on this virtio disk vs ~800 MB/s for plain reads, so the
        load path reads, it does not map. ``rows_out``/``scales_out`` are
        typically slices of the padded device staging buffers (zero extra
        copies)."""
        n, d, _ = self.header()
        if (rows_out.shape != (n, d) or rows_out.dtype != np.int8
                or not rows_out.flags.c_contiguous):
            raise ValueError("rows_out must be C-contiguous int8 (n, d)")
        if (scales_out.shape != (n,) or scales_out.dtype != np.float32
                or not scales_out.flags.c_contiguous):
            raise ValueError("scales_out must be contiguous f32 (n,)")
        _stream_into(self.path, 24, (rows_out, scales_out))

    def open(self) -> tuple[np.ndarray, np.ndarray]:
        """Map the file; returns ``(rows_i8_view, scales_f32_view)``.

        Zero-copy random access (used by tests/tools); bulk loads should
        prefer :meth:`read_into` — see its docstring for why."""
        import mmap as _mmap

        n, d, _ = self.header()
        with open(self.path, "rb") as f:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        self._py_map = mm
        self.rows = np.frombuffer(mm, np.int8, offset=24,
                                  count=n * d).reshape(n, d)
        self.scales = np.frombuffer(mm, np.float32, offset=24 + n * d,
                                    count=n)
        return self.rows, self.scales

    def close(self) -> None:
        self.rows = None
        self.scales = None
        if self._py_map is not None:
            try:
                self._py_map.close()
            except BufferError:
                # numpy views handed out by open() are still alive in the
                # caller; the mapping closes when they are collected
                pass
            self._py_map = None

    def __enter__(self) -> "FlatInt8File":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
