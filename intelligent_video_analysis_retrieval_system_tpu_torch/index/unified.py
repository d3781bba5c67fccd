"""UnifiedIndex: the searchable single-file index, rows on a device.

Port of the single-device half (dense, int8 and IVF) of
``intelligent_video_analysis_retrieval_system_tpu/index/unified.py``:

- the searchable state is a padded ``(capacity, dim)`` bf16/f32 tensor on
  ``device`` plus the live row count; search is :func:`ops.topk.topk_search`
  (kernel B1 on a card);
- rows load from the ``.flat`` sidecar when it is fresh (read through the
  port's own ``native.FlatEmbeddingFile``), else from the container, which
  then writes the sidecar for the next open (bf16 and f32 storage, at
  ``_FLAT_MIN_ROWS`` rows or more); a stale, short or torn sidecar of
  either kind falls back to the container. Rows are L2-normalized ON the
  device in chunks written in place into the row buffer;
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
  against the container's bf16 copy of the rows;
- the IVF approximate mode (:mod:`ops.ann`, ``config.ann`` or a container
  that carries a persisted ``ann`` group): batches of at most
  ``config.ann_max_batch`` queries probe ``config.ann_nprobe`` buckets,
  larger ones and ``exact=True`` take the dense sweep. The structure is
  built off the index lock over the live row buffer, recall-checked
  (:meth:`UnifiedIndex.tune_nprobe`), persisted in the container with its
  tuned knobs, restored on open (rows appended since go to its tail), and
  rebuilt after a compaction.

- on a mesh (``parallel.create_mesh``, an ``"index"`` axis) the rows
  shard over the mesh's devices (``parallel.ShardedIndexSearcher``): every
  shard runs the search above over its rows and one merge combines them,
  the IVF structure partitions over the same shards
  (``parallel.sharded_ann``), and appends, deletes and the ANN maintenance
  go through the searcher. Answers equal the single-device index's (int8:
  bit for bit).

``index.builder.RAGBuilder`` writes containers and hands the fresh one to
:meth:`UnifiedIndex.attach_container`. Above ``metacols.SIDECAR_MIN_ROWS``
rows the metadata opens from the columnar ``.meta.npz`` sidecar when it is
fresh (records made on access), else record by record, after which the
sidecar is written for the next open. :meth:`UnifiedIndex.compact` drops
tombstoned rows into a fresh container.
"""

from __future__ import annotations

import gc
import logging
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from .. import native, trace
from ..ops import ann
from ..ops.quant import quantize_rows_int8, topk_search_int8
from ..ops.topk import TILE_N, topk_search
from ..retrieval.results import KeyframeMetadata, SearchResult
from .container import IndexContainer
from .metacols import SIDECAR_MIN_ROWS, LazyRowByKey, load_sidecar, write_sidecar

__all__ = ["UnifiedIndex", "UnifiedIndexConfig"]

# rows normalized per device step at upload (bounds the f32 temporary)
_UPLOAD_ROWS = 262_144


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


_held_lock = threading.Lock()
_held_depth = 0
_held_was_on = False


@contextmanager
def _collector_held() -> Iterator[None]:
    """Python's cyclic collector off for the duration, then as it was found.

    Re-entrant and shared by threads: the first to enter records whether
    the collector was on and turns it off, the last to leave turns it back
    on only if it was. Never forces a collection. A call's hits are acyclic
    records that reference counting frees once the caller drops them; made
    with the collector on, young collections move them into the older
    generations, whose growth triggers full collections that free nothing.
    """
    global _held_depth, _held_was_on
    with _held_lock:
        if _held_depth == 0:
            _held_was_on = gc.isenabled()
            gc.disable()
        _held_depth += 1
    try:
        yield
    finally:
        with _held_lock:
            _held_depth -= 1
            if _held_depth == 0 and _held_was_on:
                gc.enable()


def _collector_passes() -> int:
    """Collector passes of any generation since the interpreter started."""
    return sum(s["collections"] for s in gc.get_stats())


def _ranked_hits(
    scores: np.ndarray,
    indices: np.ndarray,
    metadata: Sequence[KeyframeMetadata],
    top_k: int,
    filter_fn: Callable[[KeyframeMetadata], bool] | None,
) -> list[list[SearchResult]]:
    """Each query's ranked ``SearchResult``s from its candidate scores and
    rows, best first: stop at the first non-finite score (the masked tail
    when ``top_k`` exceeds the live rows) or at ``top_k`` hits; skip rows
    outside ``metadata`` and records ``filter_fn`` refuses. One pass over
    plain Python values: ``tolist`` gives each score as ``float`` of its
    float32 and each row as an ``int``."""
    n_meta = len(metadata)
    out: list[list[SearchResult]] = []
    for row_scores, row_ids in zip(scores.tolist(), indices.tolist()):
        hits: list[SearchResult] = []
        for score, row in zip(row_scores, row_ids):
            if not math.isfinite(score):
                break
            if row < 0 or row >= n_meta:
                continue
            meta = metadata[row]
            if filter_fn is not None and not filter_fn(meta):
                continue
            hits.append(SearchResult(metadata=meta, similarity_score=score,
                                     rank=len(hits) + 1, source="local"))
            if len(hits) >= top_k:
                break
        out.append(hits)
    return out


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
    this port reads)."""

    # build (index.builder.RAGBuilder): files per device batch and container
    # transaction, chunks between checkpoint flushes, stored assets, and the
    # container's row dtype ("bfloat16", "float32", "float16" or "int8")
    chunk_size: int = 1024
    checkpoint_every_chunks: int = 5
    store_thumbnails: bool = True
    thumbnail_size: int = 224
    store_full_images: bool = False
    dtype: str = "bfloat16"
    # temporal-context window of augmented_search (the reference's +-5)
    temporal_window: int = 5
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
    # IVF approximate search (ops.ann): opt-in latency mode for small
    # batches. Batches larger than ann_max_batch take the dense sweep, which
    # amortizes one pass over the rows across the batch. The default 4 is the
    # crossover of ivf_topk (nprobe 64) against topk_search_int8 over 10M
    # int8 rows on an H100 (chip_smoke.py's IVF phase); over 1M bf16 rows the
    # dense sweep wins already at B=1. measure_ann_crossover() measures the
    # corpus's own crossover, installs and persists it.
    ann: bool = False
    ann_nlist: int | None = None     # None = ops.ann.default_nlist(n)
    ann_nprobe: int = 32
    ann_max_batch: int = 4
    # recall guard: every build_ann() samples recall at the configured nprobe
    # and climbs the tune_nprobe ladder to this target (on a corpus without
    # cluster structure the ladder lands at nprobe = nlist, which is exact,
    # and warns). None disables (build time only; restores skip it).
    ann_target_recall: float | None = 0.95
    # a container carrying an ``ann`` group reactivates approximate search
    # on open even with ann=False (the file is the index type); False serves
    # exact only whatever the container carries (the facade's "exact")
    ann_restore: bool = True


class UnifiedIndex:
    """Searchable index over a single container, rows on ``device``."""

    def __init__(
        self,
        config: UnifiedIndexConfig | None = None,
        device: torch.device | str = "cuda",
        mesh: Any | None = None,
    ) -> None:
        """``mesh``: a ``parallel.Mesh`` with an ``"index"`` axis: rows shard
        over its devices and searches merge across them (int8 containers
        shard rows and scales together). The index then lives on the mesh's
        first shard's device, whose type ``device`` must name."""
        self.config = config or UnifiedIndexConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        # parallel.ShardedIndexSearcher while rows are loaded on a mesh
        self._sharded: Any | None = None
        if mesh is not None:
            first = mesh.local_shards("index")[1][0]
            if first.type != self.device.type:
                raise ValueError(f"a mesh on {first.type} for an index on {self.device}")
            self.device = first
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
        # IVF structure (ops.ann.IVFState) while the ANN mode is active
        self._ann: ann.IVFState | None = None
        # bumps whenever self._ann is replaced (build, drop, restore, tail
        # registration): tune_nprobe and measure_ann_crossover watch it, as
        # an ANN swap does not bump self.generation
        self._ann_gen = 0
        # True once config.ann_max_batch comes from a crossover measurement
        self._ann_crossover_measured = False
        # set while an overflow-append reload runs: the persisted structure
        # is restored, but no synchronous k-means rebuild blocks the append
        self._ann_autobuild_suppressed = False
        # bumps only when existing row ids change meaning (reload, compact,
        # close): the off-lock build_ann install retries on it, and rides
        # appends and deletes
        self._rows_gen = 0
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
            self._sharded = None
            self._ann = None
            self._ann_gen += 1
            self._n_valid = 0
            self._capacity = 0
            self._rows_gen += 1
            self._metadata = []
            self._row_by_key = {}
            self._fp_cache = None
            self._fp_cache_n = 0

    # -- device state -------------------------------------------------------

    def _upload_embeddings(self) -> None:
        assert self._container is not None
        n = self._container.num_rows
        self._n_valid = n
        self.generation += 1
        self._rows_gen += 1
        self._ann = None
        self._ann_gen += 1
        self._dev_scales = None
        self._sharded = None
        self._fp_cache = None
        self._fp_cache_n = 0
        if n == 0:
            self._dev_x = None
            self._capacity = 0
        elif self.mesh is not None:
            self._upload_to_mesh(n)
            return
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
        self._restore_or_build_ann()

    def _upload_to_mesh(self, n: int) -> None:
        """Rows onto the mesh's shards: int8 rows and their folded scales as
        the single-device upload makes them; bf16/f32 rows normalized by the
        single-device upload's code into a buffer of the mesh's padded size,
        whose rows the shards view (or copy, on distinct devices)."""
        from ..parallel.sharded_search import ShardedIndexSearcher

        assert self._container is not None
        self._deleted = set(self._container.deleted_rows())
        if self._container.dtype == "int8":
            rows = np.empty((n, self._container.dim), np.int8)
            scales = np.empty((n,), np.float32)
            self._quantized_into(rows, scales)
            self._sharded = ShardedIndexSearcher(self.mesh)
            self._sharded.load_int8(rows, scales, deleted_rows=self._deleted)
        else:
            dtype = (torch.bfloat16 if self._container.dtype == "bfloat16"
                     else torch.float32)
            self._sharded = ShardedIndexSearcher(self.mesh, dtype=dtype)
            cap = _ceil_to(n, self._sharded.n_devices * TILE_N)
            self._sharded.load(self._rows_to_device(n, cap), deleted_rows=self._deleted,
                               n_rows=n)
        self._capacity = self._sharded.capacity
        self._dev_x = None
        self._dev_deleted = None
        self._restore_or_build_ann()

    # -- ANN (IVF approximate search, ops.ann) -----------------------------

    def _restore_or_build_ann(self) -> None:
        """Restore the persisted IVF structure (rows appended since its
        build go to the always-scanned tail), or build it when the config
        enables ANN. A failed build logs and serves dense search."""
        self._ann = None
        self._ann_gen += 1
        if self._dev_x is None and self._sharded is None:
            return
        if (not self._restore_persisted_ann() and self.config.ann
                and not self._ann_autobuild_suppressed):
            try:
                self.build_ann()
            except Exception:
                logging.getLogger("ivars").exception(
                    "ANN build failed; falling back to dense search")

    def _restore_persisted_ann(self) -> bool:
        assert self._container is not None
        if not self.config.ann_restore:
            return False  # exact-only serving requested
        got = self._container.get_ann()
        if got is None:
            return False
        arrays, attrs = got
        ann_rows = int(attrs.get("ann_rows", -1))
        if ann_rows < 0 or ann_rows > self._n_valid or int(attrs.get("dim", self.dim)) != self.dim:
            self._container.drop_ann()  # stale (a no-op when read-only)
            return False
        tail_count = int(attrs.get("tail_count", 0))
        extra = self._n_valid - ann_rows
        if tail_count + extra > ann.TAIL_MAX:
            return False  # appends outgrew the tail: dense until rebuilt
        try:
            # a corrupt or partly written group degrades to dense search
            state = ann.IVFState(
                centroids=torch.from_numpy(
                    np.ascontiguousarray(arrays["centroids"], np.float32)).to(self.device),
                bucket_ids=torch.from_numpy(
                    np.ascontiguousarray(arrays["bucket_ids"], np.int32)).to(self.device),
                tail_ids=torch.from_numpy(
                    np.ascontiguousarray(arrays["tail_ids"], np.int32)).to(self.device),
                tail_count=tail_count,
                ann_rows=ann_rows,
            )
            if (state.centroids.dim() != 2 or state.bucket_ids.dim() != 2
                    or int(state.centroids.shape[1]) != self.dim):
                raise ValueError(f"bad ANN shapes: centroids {tuple(state.centroids.shape)}, "
                                 f"bucket_ids {tuple(state.bucket_ids.shape)}")
            if extra:
                state = ann.tail_append(state, list(range(ann_rows, self._n_valid)))
        except Exception:
            logging.getLogger("ivars").exception(
                "persisted ANN group unreadable; dropping it and serving dense search")
            try:
                self._container.drop_ann()  # a no-op when read-only
            except Exception:
                pass
            return False
        self._ann = state
        self._ann_gen += 1
        if self._sharded is not None:
            self._sharded.set_ann(state)
        # the knobs tuned or measured on this corpus come back, but only where
        # the live config still holds the dataclass default (an explicitly
        # set value is never clobbered by a stale build-time one)
        defaults = type(self.config)()
        if "nprobe" in attrs and self.config.ann_nprobe == defaults.ann_nprobe:
            self.config.ann_nprobe = int(attrs["nprobe"])
        if "max_batch" in attrs and self.config.ann_max_batch == defaults.ann_max_batch:
            self.config.ann_max_batch = int(attrs["max_batch"])
            self._ann_crossover_measured = bool(attrs.get("max_batch_measured", False))
        if not self.config.ann:
            logging.getLogger("ivars").warning(
                "persisted ANN restored (nlist=%d, nprobe=%d): small batches serve "
                "approximate results; pass exact=True per query, use "
                "index_type='exact', or drop_ann() for exact-only serving",
                int(state.bucket_ids.shape[0]), self.config.ann_nprobe)
        return True

    def build_ann(self, nlist: int | None = None, persist: bool = True,
                  check_recall: bool | None = None, **build_kwargs) -> dict[str, Any]:
        """Build (or rebuild) the IVF structure over the current device rows
        and activate approximate search (``config.ann_nprobe`` probes per
        query, exact within the probed candidates; see :mod:`ops.ann`).

        The build runs off the index lock over the live row buffer, so
        searches keep serving: rows below the snapshot's count never change
        in place (appends write past it, deletes only mask). Rows appended
        meanwhile ride the fresh structure's tail; a remap (reload, compact,
        close) seen at install time retries the build, at most three times.
        On a mesh the build runs over the shards
        (``parallel.sharded_ann.build_ivf_sharded``: the state equals the
        single-device build's) and the state is partitioned over them. The
        JAX index's retry for a buffer donated by a concurrent append has no
        counterpart: torch donates no buffer.
        ``persist`` stores the structure in a writable container.
        ``check_recall`` (default: on when ``config.ann_target_recall`` is
        set) samples recall against the exact path afterwards and climbs the
        :meth:`tune_nprobe` ladder to the target.
        """
        log = logging.getLogger("ivars")
        report = None
        remap_retries, max_remap = 0, 3
        while True:
            if remap_retries >= max_remap:
                raise RuntimeError(
                    "build_ann gave up: rows were reloaded/remapped mid-build on every "
                    f"attempt ({remap_retries} retries); retry when the index stops being "
                    "rebuilt concurrently (the previous ANN structure, if any, is still "
                    "serving)")
            with self._lock:
                sharded = self._sharded
                if (self._dev_x is None and sharded is None) or self._n_valid == 0:
                    raise RuntimeError("no device rows loaded")
                if sharded is not None:
                    x, scales = sharded._x, sharded._scales
                else:
                    x, scales = self._dev_x, self._dev_scales
                snap_n, snap_gen = self._n_valid, self._rows_gen
            if sharded is not None:
                from ..parallel.sharded_ann import build_ivf_sharded

                state, report = build_ivf_sharded(x, snap_n, scales,
                                                  nlist=nlist or self.config.ann_nlist,
                                                  **build_kwargs)
            else:
                state, report = ann.build_ivf(x, n_rows=snap_n, x_scales=scales,
                                              nlist=nlist or self.config.ann_nlist,
                                              **build_kwargs)
            with self._lock:
                if self._rows_gen != snap_gen:
                    remap_retries += 1
                    log.info("build_ann: rows reloaded/remapped mid-build (retry %d/%d); "
                             "rebuilding over the new buffer", remap_retries, max_remap)
                    continue
                self._ann = state
                self._ann_gen += 1
                if self._sharded is not None:
                    self._sharded.set_ann(state)
                if self._n_valid > snap_n:
                    # rows appended mid-build ride the fresh state's tail
                    self._ann_register_append(snap_n, self._n_valid - snap_n)
                if (self._ann is not None and persist and self._container is not None
                        and self._container.mode != "r"):
                    self._persist_ann()
                break
        out = report._asdict()
        target = self.config.ann_target_recall
        if check_recall is None:
            check_recall = bool(target)
        if check_recall and target and self._container is not None and self._ann is not None:
            try:
                tune = self.tune_nprobe(target_recall=float(target))
                out["recall_check"] = tune
                nlist_built = int(state.bucket_ids.shape[0])
                if tune.get("raced_mutation"):
                    log.warning("ANN recall check raced a concurrent mutation; the estimate "
                                "was discarded — run tune_ann when mutations settle")
                elif tune["nprobe"] >= nlist_built:
                    log.warning(
                        "ANN recall check: this corpus shows weak cluster structure — "
                        "nprobe climbed to nlist=%d (equivalent to exact search with gather "
                        "overhead; ladder: %s). ANN buys no latency here; consider "
                        "index_type='exact'.", nlist_built, tune["ladder"])
                else:
                    log.info("ANN recall check: recall@%d %.4f at tuned nprobe=%d "
                             "(target %.2f)", tune["top_k"], tune["recall"], tune["nprobe"],
                             float(target))
            except Exception:
                log.exception("ANN recall check failed; keeping configured nprobe %d "
                              "UNVERIFIED on this corpus", self.config.ann_nprobe)
        return out

    def tune_nprobe(self, target_recall: float = 0.99, sample: int = 32, top_k: int = 10,
                    noise: float = 0.25, seed: int = 0) -> dict[str, Any]:
        """Pick the smallest ``ann_nprobe`` reaching ``target_recall``.

        Samples ``sample`` stored rows, perturbs them (``noise`` is the
        relative norm of the noise vector: served queries embed near, not
        at, their matches), and compares the ANN path with the exact sweep
        at each rung of a doubling ladder from 4, stopping at the first
        rung whose mean recall@``top_k`` meets the target. The ladder runs
        off the index lock with a per-call ``nprobe``; a mutation or an ANN
        swap during it discards the result (``raced_mutation=True``).
        Installs the result into ``config.ann_nprobe`` and the persisted
        group, and returns ``{"nprobe", "recall", "ladder", ...}``.
        """
        with self._lock:
            if self._ann is None:
                raise RuntimeError("ANN not active; call build_ann() first")
            assert self._container is not None
            rng = np.random.default_rng(seed)
            n_live = self._n_valid - len(self._deleted)
            if n_live <= 0:
                raise RuntimeError("no live rows to sample")
            # rejection-sample live row ids (tombstones are sparse)
            want = min(sample, n_live)
            picks: list[int] = []
            seen: set[int] = set()
            while len(picks) < want:
                for r in rng.integers(0, self._n_valid, size=4 * want):
                    r = int(r)
                    if r in seen or r in self._deleted:
                        continue
                    seen.add(r)
                    picks.append(r)
                    if len(picks) >= want:
                        break
                else:
                    if len(seen) + len(self._deleted) >= self._n_valid:
                        picks = [r for r in range(self._n_valid)
                                 if r not in self._deleted][:want]
                        break
            picks = sorted(picks)
            rows = np.stack([self._container.read_embeddings(r, r + 1, as_float32=True)[0]
                             for r in picks])
            nlist = int(self._ann.bucket_ids.shape[0])
            snap_gen, snap_ann_gen = self.generation, self._ann_gen
        q = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        if noise > 0:
            d = q.shape[1]
            q = q + (noise / d**0.5) * rng.standard_normal(q.shape).astype(np.float32)
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        exact = self.search_vectors(q, top_k=top_k, exact=True)
        exact_ids = [{h.metadata.row_id for h in hits} for hits in exact]
        ladder: list[tuple[int, float]] = []
        best = nlist
        nprobe = 4
        while True:
            nprobe = min(nprobe, nlist)
            got: list[list] = []
            step = max(int(self.config.ann_max_batch), 1)
            for s in range(0, len(q), step):
                got.extend(self.search_vectors(q[s:s + step], top_k=top_k, nprobe=nprobe))
            recall = float(np.mean([len({h.metadata.row_id for h in hits} & ids)
                                    / max(len(ids), 1)
                                    for hits, ids in zip(got, exact_ids)]))
            ladder.append((nprobe, recall))
            if recall >= target_recall or nprobe >= nlist:
                best = nprobe
                break
            nprobe *= 2
        with self._lock:
            raced = self.generation != snap_gen or self._ann_gen != snap_ann_gen
            if not raced:
                self.config.ann_nprobe = best
                if self._container is not None and self._container.mode != "r":
                    # travels with the structure: a reopened index serves at it
                    self._container.update_ann_attrs({"nprobe": int(best)})
        if raced:
            logging.getLogger("ivars").warning(
                "tune_nprobe: index mutated during the ladder (row ids may have remapped, "
                "deflating the recall estimate toward random overlap); the measured "
                "nprobe=%d was NOT installed — config keeps nprobe=%d. Re-run when "
                "mutations settle.", best, self.config.ann_nprobe)
        return {"nprobe": best, "recall": ladder[-1][1], "target": target_recall,
                "ladder": ladder, "sample": len(q), "top_k": top_k, "raced_mutation": raced}

    def measure_ann_crossover(self, batch_sizes: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
                              top_k: int = 10, repeats: int = 3,
                              persist: bool = True) -> dict[str, Any]:
        """Measure the IVF/dense crossover batch size on this corpus and
        device, install it as ``config.ann_max_batch`` and persist it with
        the structure.

        Walks ``batch_sizes`` in order; at each B times ``search_vectors``
        on the ANN path (an explicit ``nprobe`` forces probing past the
        current cap) against the exact sweep, fresh random queries every
        timed call, min over ``repeats``. The crossover is the last B before
        IVF first loses; 0 means IVF never won and every batch takes the
        dense sweep. Runs off the index lock; a mutation or ANN swap during
        the ladder discards the result (``raced_mutation=True``).
        """
        with self._lock:
            if self._ann is None:
                raise RuntimeError("ANN not active; call build_ann() first")
            if self._dev_x is None and self._sharded is None:
                raise RuntimeError("no device rows loaded")
            snap_gen, snap_ann_gen = self.generation, self._ann_gen
            nprobe = int(self.config.ann_nprobe)
            d = self.dim
        rng = np.random.default_rng(0)
        ladder: list[dict[str, Any]] = []
        crossover = 0
        for b in batch_sizes:
            if b > self._n_valid:
                break
            warm = rng.standard_normal((b, d)).astype(np.float32)
            self.search_vectors(warm, top_k=top_k, nprobe=nprobe)
            self.search_vectors(warm, top_k=top_k, exact=True)
            t_ann = t_dense = float("inf")
            for _ in range(repeats):
                q = rng.standard_normal((b, d)).astype(np.float32)
                t0 = time.perf_counter()
                self.search_vectors(q, top_k=top_k, nprobe=nprobe)
                t_ann = min(t_ann, time.perf_counter() - t0)
                q = rng.standard_normal((b, d)).astype(np.float32)
                t0 = time.perf_counter()
                self.search_vectors(q, top_k=top_k, exact=True)
                t_dense = min(t_dense, time.perf_counter() - t0)
            ladder.append({"batch": b, "ann_ms": round(t_ann * 1e3, 3),
                           "dense_ms": round(t_dense * 1e3, 3)})
            if t_ann < t_dense:
                crossover = b
            else:
                break
        with self._lock:
            raced = self.generation != snap_gen or self._ann_gen != snap_ann_gen
            if not raced:
                self.config.ann_max_batch = crossover
                self._ann_crossover_measured = True
                if persist and self._container is not None and self._container.mode != "r":
                    self._container.update_ann_attrs(
                        {"max_batch": int(crossover), "max_batch_measured": True})
        if raced:
            logging.getLogger("ivars").warning(
                "measure_ann_crossover: index mutated during the ladder; the measured "
                "crossover=%d was NOT installed — config keeps ann_max_batch=%d. Re-run "
                "when mutations settle.", crossover, self.config.ann_max_batch)
        return {"max_batch": crossover, "nprobe": nprobe, "ladder": ladder,
                "raced_mutation": raced}

    def _persist_ann(self) -> None:
        assert self._container is not None and self._ann is not None
        state = self._ann
        self._container.put_ann(
            {"centroids": state.centroids.cpu().numpy().astype(np.float32),
             "bucket_ids": state.bucket_ids.cpu().numpy().astype(np.int32),
             "tail_ids": state.tail_ids.cpu().numpy().astype(np.int32)},
            {"ann_rows": int(state.ann_rows),
             "tail_count": int(state.tail_count),
             "dim": self.dim,
             "nlist": int(state.bucket_ids.shape[0]),
             # the knobs measured on this corpus travel with the structure
             "nprobe": int(self.config.ann_nprobe),
             "max_batch": int(self.config.ann_max_batch),
             "max_batch_measured": bool(self._ann_crossover_measured),
             "version": 1},
        )

    @property
    def ann_active(self) -> bool:
        return self._ann is not None

    def drop_ann(self) -> dict[str, Any]:
        """Deactivate approximate search and (when writable) remove the
        persisted structure: the container is a plain exact index again on
        every later open."""
        with self._lock:
            was_active = self._ann is not None
            self._ann = None
            self._ann_gen += 1
            if self._sharded is not None:
                self._sharded.clear_ann()
            dropped = False
            if self._container is not None and self._container.mode != "r":
                self._container.drop_ann()
                dropped = True
            return {"was_active": was_active, "persisted_removed": dropped}

    def _ann_register_append(self, start: int, count: int) -> None:
        """Track appended rows in the IVF tail; on overflow serve dense
        search until the next :meth:`build_ann`. On a mesh the partitioned
        tails follow the global state; where the append re-sharded (new
        shard size, the partition cleared) the whole state is partitioned
        again."""
        if self._ann is None or count == 0:
            return
        try:
            self._ann = ann.tail_append(self._ann, list(range(start, start + count)))
        except OverflowError:
            logging.getLogger("ivars").warning(
                "IVF tail full after append; reverting to dense search until build_ann() "
                "is called again")
            self._ann = None
            if self._sharded is not None:
                self._sharded.clear_ann()
        self._ann_gen += 1
        if self._ann is not None and self._sharded is not None:
            if self._sharded.ann_active:
                self._sharded.update_ann_tail(self._ann.tail_ids.cpu().numpy(),
                                              int(self._ann.tail_count))
            else:
                self._sharded.set_ann(self._ann)

    def _read_rows_raw(self, n: int) -> np.ndarray:
        """Rows in their storage form (uint16 bf16 bits / f16 / f32): the
        ``.flat`` sidecar when fresh, else the container, after which the
        sidecar is written for the next open (not for float16 storage, as in
        the JAX index)."""
        assert self._container is not None
        d = self._container.dim
        store = self._container.dtype
        flat_dtype = "bfloat16" if store == "bfloat16" else "float32"
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
            except Exception:  # stale or torn sidecar: the container wins
                pass
        host = self._container.read_embeddings(0, n)
        if store != "float16" and p is not None and n >= self._FLAT_MIN_ROWS:
            try:
                native.FlatEmbeddingFile.write_raw(p, host, flat_dtype)
            except Exception:  # a read-only directory is never a load failure
                pass
        return host

    # write the .flat and .flat8 sidecars only above this many rows (the JAX
    # index's threshold): tiny corpora open instantly either way
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
        except Exception:  # unreadable or short sidecar: the container wins
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
            except Exception:  # torn mid-read: the container wins
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
            except Exception:  # a read-only directory is never a load failure
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
        the capacity, re-upload everything from the container (a mesh's
        searcher re-shards its rows instead)."""
        m = len(rows)
        if m == 0:
            return
        if self._sharded is not None:
            # in place into the owning shards, or a re-shard carrying the
            # tombstones (the searcher decides)
            start = self._n_valid
            if self._sharded._scales is not None:
                self._sharded.append_quantized(*self._quantize_like_upload(rows))
            else:
                self._sharded.append(np.asarray(rows, np.float32))
            self._n_valid += m
            self._capacity = self._sharded.capacity
            self._ann_register_append(start, m)
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
        self._ann_register_append(n, m)
        self._n_valid += m

    def _reload_for_append(self) -> None:
        """Re-upload past the capacity, without the ANN auto-build (an append
        never blocks on a k-means rebuild; the persisted structure is still
        restored when its tail can take the new rows, else search is dense
        until :meth:`build_ann`). The resident rescore cache is rebuilt from
        the container, which already holds the new rows."""
        self._ann_autobuild_suppressed = True
        try:
            self._upload_embeddings()
        finally:
            self._ann_autobuild_suppressed = False
        self._maybe_build_fp_cache()
        if self.config.ann and self._ann is None:
            logging.getLogger("ivars").warning(
                "ANN rebuild deferred after capacity-overflow append; dense search until "
                "build_ann() is called")

    def _load_metadata_cache(self) -> None:
        assert self._container is not None
        n = self._container.num_metadata
        use_sidecar = self._container.path is not None and n >= SIDECAR_MIN_ROWS
        if use_sidecar:
            # columnar sidecar (metacols.py): the open reads a few arrays and
            # records are made on access; the container's blobs below stay
            # authoritative and are the fallback for every failure
            cols = load_sidecar(self._container.path, n, self._container.get_metadata)
            if cols is not None:
                self._metadata = cols
                self._row_by_key = LazyRowByKey(cols)
                return
        self._metadata = []
        self._row_by_key = {}
        for i, record in enumerate(self._container.iter_metadata()):
            record.setdefault("row_id", i)
            meta = KeyframeMetadata.from_dict(record)
            self._metadata.append(meta)
            self._row_by_key[meta.key] = i
        if use_sidecar:
            write_sidecar(self._metadata, self._container.path)

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
        exact: bool = False,
        nprobe: int | None = None,
    ) -> list[list[SearchResult]]:
        """Top-k per query vector, as ranked SearchResults (an int8
        container searches its quantized metric).

        Exact by default; while the IVF mode is active, batches of at most
        ``config.ann_max_batch`` queries probe instead. ``exact=True``
        forces the dense sweep for the call; ``nprobe`` overrides the
        configured probe count for the call only and, as an explicit
        request for the IVF path, bypasses the batch cap.

        ``filter_fn``: metadata predicate applied after the search, over
        ``over_fetch`` x ``top_k`` candidates. With ``int8_rescore`` on an
        int8 container that keeps its bf16 rows, ``int8_rescore_factor`` x
        as many candidates are fetched and rescored at full precision.

        Spans (:mod:`..trace`): ``index.search`` around the call (``queries``,
        ``top_k``, ``path``), and under it ``index.dispatch`` (normalize,
        upload, the path's launches), ``index.readback`` (the host waiting
        for the scores) and ``index.results`` (building the
        ``SearchResult``s with the cyclic collector held off, counted in
        ``index.hits``; ``gc_passes``: the collector's passes inside it).
        """
        with trace.span("index.search", top_k=top_k) as call:
            with self._lock:
                if (self._dev_x is None and self._sharded is None) or self._n_valid == 0:
                    return [[] for _ in range(len(np.atleast_2d(query_vectors)))]
                with trace.span("index.dispatch"):
                    q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
                    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
                    fetch = min(self._n_valid, top_k * over_fetch if filter_fn else top_k)
                    rescore_fp = (self.config.int8_rescore and self._container is not None
                                  and self._container.dtype == "int8"
                                  and getattr(self._container, "has_fp_rows", False))
                    want = fetch
                    if rescore_fp:
                        fetch = min(self._n_valid,
                                    fetch * max(int(self.config.int8_rescore_factor), 1))
                    use_ann = (not exact and self._ann is not None
                               and (nprobe is not None or len(q) <= self.config.ann_max_batch))
                    if nprobe is None:
                        nprobe_eff = self.config.ann_nprobe
                    elif int(nprobe) <= 0:
                        raise ValueError(f"nprobe must be positive, got {nprobe}")
                    else:
                        nprobe_eff = int(nprobe)
                    if use_ann and self._sharded is not None:
                        # the sharded IVF: equal to the single-device IVF's answer
                        call.note(queries=len(q), path="mesh.ivf")
                        result = self._sharded.search_ann(q, fetch, nprobe=nprobe_eff)
                    elif use_ann:  # IVF latency mode
                        call.note(queries=len(q), path="ivf")
                        result = ann.ivf_topk(
                            self._dev_x,
                            self._ann,
                            torch.from_numpy(q).to(self.device),
                            fetch,
                            nprobe=nprobe_eff,
                            n_valid=self._n_valid,
                            deleted=self._dev_deleted,
                            x_scales=self._dev_scales,
                        )
                    elif self._sharded is not None:  # the mesh
                        call.note(queries=len(q), path="mesh")
                        result = self._sharded.search(q, fetch)
                    elif self._dev_scales is not None:  # int8
                        call.note(queries=len(q), path="int8")
                        result = topk_search_int8(
                            self._dev_x,
                            self._dev_scales,
                            torch.from_numpy(q).to(self.device),
                            fetch,
                            n_valid=self._n_valid,
                            deleted=self._dev_deleted,
                        )
                    else:
                        call.note(queries=len(q), path="bf16")
                        result = topk_search(
                            self._dev_x,
                            torch.from_numpy(q).to(self.device, self._dev_x.dtype),
                            fetch,
                            n_valid=self._n_valid,
                            deleted=self._dev_deleted,
                        )
                # the host waits here for the card to finish the call's work
                with trace.span("index.readback"):
                    scores = result.scores.float().cpu().numpy()
                    indices = result.indices.cpu().numpy()
                if rescore_fp:
                    scores, indices = self._rescore_fp_host(q, scores, indices, want)
                # snapshot the metadata INSIDE the lock: a concurrent reload
                # swaps self._metadata, and row ids must meet the metadata of
                # the rows they were computed on
                metadata = self._metadata

            # held around the whole span, so that gc_passes covers all of it; the
            # young collection the hits cost runs once the span has closed
            with _collector_held(), trace.span("index.results") as results:
                on = trace.enabled()
                passes = _collector_passes() if on else 0
                out = _ranked_hits(scores, indices, metadata, top_k, filter_fn)
                if on:
                    results.note(gc_passes=_collector_passes() - passes)
                trace.count("index.hits", sum(map(len, out)))
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

    def augmented_search(
        self,
        query_vector: np.ndarray,
        top_k: int = 20,
        temporal_window: int | None = None,
        filter_fn: Callable[[KeyframeMetadata], bool] | None = None,
    ) -> list[SearchResult]:
        """:meth:`search`, each hit with its temporal context
        (``config.temporal_window`` neighbours unless given)."""
        window = self.config.temporal_window if temporal_window is None else temporal_window
        hits = self.search(query_vector, top_k, filter_fn)
        for hit in hits:
            hit.temporal_context = self.get_temporal_context(hit.metadata.row_id, window)
        return hits

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

    def get_thumbnail(self, row_id_or_folder: int | str, image: str | None = None) -> bytes:
        """Thumbnail JPEG by row id or (folder, image) pair."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        return self._container.get_thumbnail(self._resolve_row(row_id_or_folder, image))

    def get_full_image(self, row_id_or_folder: int | str, image: str | None = None) -> bytes:
        """The stored full image, else the original file on disk (where the
        build stored no full images), else ``b""``."""
        if self._container is None:
            raise RuntimeError("index not loaded")
        row = self._resolve_row(row_id_or_folder, image)
        data = self._container.get_image(row) if self._container.num_images else b""
        if not data:
            meta = self._metadata[row]
            if meta.path and Path(meta.path).is_file():
                return Path(meta.path).read_bytes()
        return data

    def _resolve_row(self, row_or_folder: int | str, image: str | None) -> int:
        if isinstance(row_or_folder, int):
            return row_or_folder
        row = self._row_by_key.get((row_or_folder, image or ""))
        if row is None:
            raise KeyError(f"no such keyframe: {row_or_folder}/{image}")
        return row

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
            if self._sharded is not None:
                self._sharded.set_deleted(self._deleted)
            else:
                self._rebuild_deleted_mask()
        return {"deleted": len(fresh), "num_live": self.num_live}

    def delete_keys(self, keys: Sequence[tuple[str, str]]) -> dict[str, Any]:
        """Tombstone rows by (folder, image); unknown keys are skipped."""
        return self.delete_rows([self._row_by_key[key] for key in keys
                                 if key in self._row_by_key])

    def is_deleted(self, row_id: int) -> bool:
        return row_id in self._deleted

    def compact(self, output_path: str | Path | None = None) -> dict[str, Any]:
        """Physically drop tombstoned rows into a fresh container.

        Writes a new file (renamed over the original by default, then
        reloaded), remapping row ids; thumbnails, images, the journal, maps
        and build info of live rows are kept. An int8 source with the bf16
        copy of its rows is copied from that copy, so full precision
        survives. Holds the index lock for the whole copy and swap:
        searches queue behind it.
        """
        with self._lock:
            if self._container is None or self.path is None:
                raise RuntimeError("index not loaded from a file")
            if not self._deleted:
                return {"compacted": 0, "ntotal": self._n_valid}
            src = self._container
            dst_path = (Path(output_path) if output_path
                        else self.path.with_name(self.path.name + ".compact"))
            keep = [r for r in range(src.num_rows) if r not in self._deleted]
            src_fp = getattr(src, "has_fp_rows", False)
            with IndexContainer(dst_path, mode="w", dim=src.dim, dtype=src.dtype,
                                keep_fp=src_fp) as dst:
                CHUNK_ROWS = 8192
                for start in range(0, len(keep), CHUNK_ROWS):
                    rows = keep[start:start + CHUNK_ROWS]
                    # bulk-read the covering range, then select (tombstones
                    # are sparse, so the range is tight)
                    lo, hi = rows[0], rows[-1] + 1
                    if src_fp:
                        block = native.bf16_to_f32(src.read_fp_bits(lo, hi))
                    else:
                        block = src.read_embeddings(lo, hi, as_float32=True)
                    dst.append_embeddings(block[np.asarray(rows) - lo])
                    range_records = src.read_metadata_range(lo, hi)
                    records = []
                    for new_id, old in enumerate(rows, start=start):
                        record = range_records[old - lo]
                        record["row_id"] = new_id
                        records.append(record)
                    dst.append_metadata(records)
                    if src.num_thumbnails:
                        thumbs = src.read_blob_range("thumbnails", lo, hi)
                        dst.append_thumbnails([thumbs[r - lo] for r in rows])
                    if src.num_images:
                        imgs = src.read_blob_range("images", lo, hi)
                        dst.append_images([imgs[r - lo] for r in rows])
                dst.append_journal(sorted(src.journal_hashes()))
                for folder in src.map_folders():
                    dst.put_map(folder, src.get_map(folder))
                build_info = src.get_system("build")
                if build_info:
                    dst.put_system("build", build_info)
                dst.flush_checkpoint({"compacted_from": str(self.path)})
            removed = len(self._deleted)
            mode = self._container.mode
            in_place = output_path is None
            if in_place:
                self._container.close()
                self._container = None
                self._invalidate_sidecar()
                dst_path.replace(self.path)
                self.load_unified_index(self.path, mode="a" if mode != "r" else "r")
            return {"compacted": removed, "ntotal": self._n_valid,
                    "path": str(self.path if in_place else dst_path)}

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
            "ann_active": self._ann is not None,
            "device": str(self.device),
        }
        if self._ann is not None:
            stats["ann"] = {
                "nlist": int(self._ann.bucket_ids.shape[0]),
                "bucket_cap": int(self._ann.bucket_ids.shape[1]),
                "nprobe": self.config.ann_nprobe,
                "max_batch": self.config.ann_max_batch,
                "max_batch_measured": self._ann_crossover_measured,
                "tail_count": int(self._ann.tail_count),
                "ann_rows": self._ann.ann_rows,
            }
        if self._container is not None:
            stats["container"] = self._container.stats().as_dict()
        return stats
