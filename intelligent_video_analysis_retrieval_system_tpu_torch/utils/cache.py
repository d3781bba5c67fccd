"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/cache.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Two-tier cache: in-memory LRU with a byte budget + on-disk persistence.

Parity with the reference ``CacheManager`` (``utils.py:2018-2436``): memory
tier with LRU eviction under a configurable byte budget, disk tier keyed by
content hash, TTL on both tiers, atomic persist, hit/miss/eviction stats,
and the domain helpers ``cache_query_results`` / ``get_cached_results``.

Differences: disk serialization is msgpack-or-JSON (not pickle) for safety
and cross-process stability; keys are blake2b (not md5).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

try:
    import msgpack
except ImportError:  # pragma: no cover
    msgpack = None

__all__ = ["CacheManager"]


def _key_of(raw: str) -> str:
    return hashlib.blake2b(raw.encode("utf-8"), digest_size=16).hexdigest()


def _sizeof(value: Any) -> int:
    """Rough byte estimate for budget accounting."""
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value) * 2
    if isinstance(value, dict):
        return 64 + sum(_sizeof(k) + _sizeof(v) for k, v in value.items())
    if isinstance(value, (list, tuple, set)):
        return 64 + sum(_sizeof(v) for v in value)
    return 64


@dataclass
class _Entry:
    value: Any
    expires_at: float
    size: int


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    disk_hits: int = 0
    disk_misses: int = 0
    bytes_used: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def as_dict(self) -> dict[str, Any]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "evictions": self.evictions,
            "disk_hits": self.disk_hits,
            "disk_misses": self.disk_misses,
            "bytes_used": self.bytes_used,
        }


class CacheManager:
    """Thread-safe two-tier (memory LRU + disk) cache with TTL."""

    def __init__(
        self,
        cache_dir: str | Path | None = None,
        memory_budget_mb: int = 512,
        default_ttl_s: float = 3600.0,
    ) -> None:
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.memory_budget = memory_budget_mb * 1024 * 1024
        self.default_ttl = default_ttl_s
        self._mem: OrderedDict[str, _Entry] = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    # -- memory tier ------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        k = _key_of(key)
        now = time.monotonic()
        with self._lock:
            entry = self._mem.get(k)
            if entry is not None:
                if entry.expires_at < now:
                    self._evict(k)
                else:
                    self._mem.move_to_end(k)
                    self.stats.hits += 1
                    return entry.value
            self.stats.misses += 1
        # fall through to disk tier
        value = self._disk_get(k)
        if value is not _MISSING:
            with self._lock:
                self._mem_put(k, value, self.default_ttl)
            return value
        return default

    def set(self, key: str, value: Any, ttl_s: float | None = None) -> None:
        k = _key_of(key)
        ttl = self.default_ttl if ttl_s is None else ttl_s
        with self._lock:
            self._mem_put(k, value, ttl)
        self._disk_put(k, value, ttl)

    def delete(self, key: str) -> None:
        k = _key_of(key)
        with self._lock:
            if k in self._mem:
                self._evict(k, count_eviction=False)
        if self.cache_dir is not None:
            for p in (self._disk_path(k), self._disk_meta_path(k)):
                p.unlink(missing_ok=True)

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self.stats.bytes_used = 0
        if self.cache_dir is not None:
            for p in self.cache_dir.glob("*.cache*"):
                p.unlink(missing_ok=True)

    def _mem_put(self, k: str, value: Any, ttl: float) -> None:
        size = _sizeof(value)
        if size > self.memory_budget:
            return  # too large for the memory tier; disk only
        old = self._mem.pop(k, None)
        if old is not None:
            self.stats.bytes_used -= old.size
        while self.stats.bytes_used + size > self.memory_budget and self._mem:
            victim, entry = self._mem.popitem(last=False)
            self.stats.bytes_used -= entry.size
            self.stats.evictions += 1
        self._mem[k] = _Entry(value, time.monotonic() + ttl, size)
        self.stats.bytes_used += size

    def _evict(self, k: str, count_eviction: bool = True) -> None:
        entry = self._mem.pop(k, None)
        if entry is not None:
            self.stats.bytes_used -= entry.size
            if count_eviction:
                self.stats.evictions += 1

    # -- disk tier ---------------------------------------------------------

    def _disk_path(self, k: str) -> Path:
        assert self.cache_dir is not None
        return self.cache_dir / f"{k}.cache"

    def _disk_meta_path(self, k: str) -> Path:
        assert self.cache_dir is not None
        return self.cache_dir / f"{k}.cache.meta"

    def _disk_put(self, k: str, value: Any, ttl: float) -> None:
        if self.cache_dir is None:
            return
        blob = _serialize(value)
        if blob is None:
            return  # unserializable values live in memory only
        kind, payload = blob
        # unique tmp names: two threads writing the same key must not race
        # on one tmp file (the loser's replace() would raise)
        nonce = f"{threading.get_ident()}.{time.monotonic_ns()}"
        target = self._disk_path(k)
        tmp = target.with_name(f"{target.name}.{nonce}.tmp")
        tmp.write_bytes(payload)
        tmp.replace(target)
        meta = {"kind": kind, "expires_at": time.time() + ttl}
        meta_target = self._disk_meta_path(k)
        mt = meta_target.with_name(f"{meta_target.name}.{nonce}.tmp")
        mt.write_text(json.dumps(meta), encoding="utf-8")
        mt.replace(meta_target)

    def _disk_get(self, k: str) -> Any:
        if self.cache_dir is None:
            return _MISSING
        path, meta_path = self._disk_path(k), self._disk_meta_path(k)
        if not (path.is_file() and meta_path.is_file()):
            self.stats.disk_misses += 1
            return _MISSING
        try:
            meta = json.loads(meta_path.read_text(encoding="utf-8"))
            if meta.get("expires_at", 0) < time.time():
                path.unlink(missing_ok=True)
                meta_path.unlink(missing_ok=True)
                self.stats.disk_misses += 1
                return _MISSING
            value = _deserialize(meta["kind"], path.read_bytes())
            self.stats.disk_hits += 1
            return value
        except Exception:
            self.stats.disk_misses += 1
            return _MISSING

    # -- domain helpers (reference utils.py:2176-2272) ---------------------

    def cache_query_results(
        self, query: str, mode: str, limit: int, results: list[dict], ttl_s: float = 3600.0
    ) -> None:
        self.set(f"query::{mode}::{limit}::{query}", results, ttl_s=ttl_s)

    def get_cached_results(self, query: str, mode: str, limit: int) -> list[dict] | None:
        return self.get(f"query::{mode}::{limit}::{query}")

    def cache_agent_response(
        self, message: str, response: dict, ttl_s: float = 1800.0
    ) -> None:
        """Agent-response cache (reference utils.py:2176-2272 helper pair)."""
        self.set(f"agent::{message}", response, ttl_s=ttl_s)

    def get_cached_agent_response(self, message: str) -> dict | None:
        return self.get(f"agent::{message}")

    def get_stats(self) -> dict[str, Any]:
        with self._lock:
            stats = self.stats.as_dict()
            stats["entries"] = len(self._mem)
            return stats


class _Missing:
    __slots__ = ()


_MISSING = _Missing()


def _serialize(value: Any) -> tuple[str, bytes] | None:
    if isinstance(value, np.ndarray):
        header = json.dumps({"dtype": str(value.dtype), "shape": value.shape}).encode()
        return "ndarray", len(header).to_bytes(4, "little") + header + value.tobytes()
    if msgpack is not None:
        try:
            return "msgpack", msgpack.packb(value, use_bin_type=True)
        except (TypeError, ValueError):
            pass
    try:
        return "json", json.dumps(value, ensure_ascii=False).encode("utf-8")
    except (TypeError, ValueError):
        return None


def _deserialize(kind: str, payload: bytes) -> Any:
    if kind == "ndarray":
        hlen = int.from_bytes(payload[:4], "little")
        header = json.loads(payload[4 : 4 + hlen])
        arr = np.frombuffer(payload[4 + hlen :], dtype=np.dtype(header["dtype"]))
        return arr.reshape(header["shape"]).copy()
    if kind == "msgpack":
        if msgpack is None:
            raise RuntimeError("msgpack payload but msgpack unavailable")
        return msgpack.unpackb(payload, raw=False)
    return json.loads(payload.decode("utf-8"))
