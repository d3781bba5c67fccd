"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/serve/batching.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Query micro-batching: aggregate concurrent searches into device batches.

The fused search kernel costs nearly the same for B=64 queries as for B=1
(one extra matmul column per query — the sweep is bandwidth-bound on the
database read). Under concurrent load, per-request device calls waste that
structure; this batcher collects requests for up to ``window_ms`` (or until
``max_batch``), runs ONE text-encode + ONE top-k for the whole group, and
fans results back out.

Pure-host component with its own worker thread; used by RetrievalServer
when enabled (``api.batching`` config) and usable standalone around any
``EnhancedRetrievalSystem``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from ..system.facade import EnhancedRetrievalSystem

__all__ = ["QueryBatcher", "BatcherStats"]


@dataclass(slots=True)
class _Pending:
    query: str
    top_k: int
    done: threading.Event = field(default_factory=threading.Event)
    results: list[dict[str, Any]] | None = None
    error: str | None = None


@dataclass(slots=True)
class BatcherStats:
    requests: int = 0
    batches: int = 0
    max_batch_seen: int = 0

    @property
    def avg_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class QueryBatcher:
    """Thread-safe micro-batcher over a retrieval system."""

    def __init__(
        self,
        system: "EnhancedRetrievalSystem",
        window_ms: float = 3.0,
        max_batch: int = 64,
    ) -> None:
        self.system = system
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = BatcherStats()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fail fast for anything still queued — otherwise blocked callers
        # hang for their full timeout
        while True:
            try:
                pending = self._queue.get_nowait()
            except queue.Empty:
                break
            pending.error = "batcher stopped"
            pending.done.set()

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- client API ----------------------------------------------------------

    def search(
        self, query: str, top_k: int = 20, timeout_s: float = 30.0
    ) -> list[dict[str, Any]]:
        """Blocking search through the batcher (thread-safe)."""
        if not self.is_running:
            raise RuntimeError("QueryBatcher not started")
        pending = _Pending(query=query, top_k=top_k)
        self._queue.put(pending)
        if not pending.done.wait(timeout=timeout_s):
            raise TimeoutError(f"batched search timed out after {timeout_s}s")
        if pending.error is not None:
            raise RuntimeError(pending.error)
        return pending.results or []

    # -- worker --------------------------------------------------------------
    #
    # ANN note (round 5): the batcher deliberately does NOT shrink
    # micro-batches to keep the IVF path engaged. Rounds 3-4 capped the
    # micro-batch at ``config.ann_max_batch`` so batches stayed under the
    # IVF/dense crossover; the round-5 chip measurement at 10M rows
    # (benchmarks/exp_ivf_10m.py + bench.py served A/B) showed that policy
    # is dominated everywhere by per-batch routing:
    #   - light load: batches are naturally small (<= crossover) and route
    #     to IVF inside ``search_vectors`` anyway (p50 1.8 ms vs 14.6 dense);
    #   - heavy load: the dense sweep amortizes ONE corpus pass over the
    #     whole batch (B=16: 17.5 ms = 1.1 ms/query vs capped-IVF 4x6.6 ms
    #     FIFO = 26 ms for the same 16 queries), so forcing IVF under load
    #     LOWERED served QPS at 10M: 92 QPS capped vs 127 uncapped
    #     (bench keys served_qps_10M_int8_{ann,dense}, 2026-08-19).
    # Routing lives in UnifiedIndex.search_vectors: batches above the
    # (measured, persisted) ``ann_max_batch`` crossover serve dense.

    def _collect(self) -> list[_Pending]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(batch))
            try:
                self._run_batch(batch)
            except Exception as exc:  # pragma: no cover — surfaced per request
                for p in batch:
                    p.error = str(exc)
                    p.done.set()

    def _run_batch(self, batch: list[_Pending]) -> None:
        system = self.system
        index = system.index
        if index is None:
            for p in batch:
                p.results = []
                p.done.set()
            return
        # one translation pass + ONE batched text encode
        prompts = []
        for p in batch:
            translation = system.translator.translate_query(p.query)
            prompts.append(
                translation.clip_prompt
                if translation.confidence >= system.translator.min_confidence
                else p.query
            )
        qvecs = system.embedder.encode_text(prompts)        # (B, D), one call
        max_k = max(p.top_k for p in batch)
        all_hits = index.search_vectors(qvecs, top_k=max_k)  # ONE device search
        for p, hits in zip(batch, all_hits):
            p.results = [h.to_dict("rich") for h in hits[: p.top_k]]
            for rank, r in enumerate(p.results):
                r["rank"] = rank + 1
            p.done.set()
