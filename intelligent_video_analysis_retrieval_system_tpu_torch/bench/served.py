"""The bench's served sections: queries per second through the REST server
with the micro-batcher on.

Counterpart of the JAX bench's ``bench_served_qps`` (root ``bench.py``) and
of its two sections: ``served_qps`` over the 1M bf16 rows (keys
``served_qps_1M``, ``served_p50_ms``, ``served_p95_ms``,
``served_avg_batch``) and ``served_10M`` over the 10M int8 rows of the IVF
section, first with its IVF state attached, then dense (keys
``served_qps_10M_int8_{ann,dense}``, ``served_p50_…_ms``,
``served_p95_…_ms``, ``served_avg_batch_…``). The server is the port's
``RetrievalServer`` (batching on: at most 64 queries a batch, an 8 ms
window; a rate limit of 10**9 a minute) around a facade whose index is the
section's device rows; metadata is made per hit, as in the JAX bench. The
client is the standard library's: 16 threads, each with one persistent
``http.client.HTTPConnection``. Two warm-up rounds of 40 and 64 requests
(the first builds the kernels and fills the allocator's pools), then 256
timed distinct queries, ``limit`` 10, at concurrency 16.

Every timed response must say ``success`` with ``count`` 10. With a
``verify`` hook (``headline.Verify``), the hits of every timed response are
handed to it with the query vector the server searched: recorded where the
batcher encodes the prompt, together with the route the batch took (a batch
of at most ``ann_max_batch`` queries probes the IVF state and is handed over
with ``ivf=(state, nprobe)``). The hook also gets ``decimals=6``: a served
score is rounded to six decimals (``SearchResult.to_dict``), so a reference
is rounded the same way before it is compared.
"""

from __future__ import annotations

import http.client
import json
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from ..index.unified import UnifiedIndex, UnifiedIndexConfig
from ..ops import ann
from ..ops.topk import TILE_N, TopKResult, _ceil_to
from ..retrieval.results import KeyframeMetadata
from ..serve.rest import RetrievalServer
from ..system.embedder import CLIPEmbedder
from ..system.facade import EnhancedRetrievalSystem, SearchOptions
from ..utils.config import Config
from .data import gen_db_bf16
from .headline import K, Verify, log

__all__ = ["CONCURRENCY", "TIMED", "WARMUPS", "Recorder", "fire", "served_qps", "served_10M"]

CONCURRENCY = 16
WARMUPS = (40, 64)
TIMED = 256
SERVE_SEED = 31   # the JAX bench's seed for the served rows
# a served hit's score is rounded to this many decimals (SearchResult.to_dict)
SCORE_DECIMALS = 6


class _LazyMetas:
    """A sequence of ``n`` keyframe records made on access (only the hits'
    rows are ever made): row ``i`` is ``v{i % 97}/{i}.jpg``, frame ``i``."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        if not 0 <= i < self.n:
            raise IndexError(i)
        return KeyframeMetadata(folder=f"v{i % 97}", image=f"{i}.jpg", frame_id=i, row_id=i)


class Recorder:
    """What the served path searched. ``vectors[prompt]``: every embedding the
    prompt got from the embedder's ``encode_text``, in order. With an
    ``index``, ``searched[prompt]``: ``(q, probed)`` for every search of it,
    ``q`` the vector L2-normalized with its batch as ``search_vectors``
    normalizes it (the int8 quantizer sees every bit) and ``probed`` whether
    the batch probed the IVF state (``ops.ann.ivf_topk.calls`` moved during
    the call). A search is tied to its prompts by the thread's last
    ``encode_text``, as the batcher encodes a batch and then searches it
    (two prompts may embed to the same vector). :meth:`close` takes the
    wrappers off."""

    def __init__(self, embedder: CLIPEmbedder, index: UnifiedIndex | None = None) -> None:
        self.vectors: dict[str, list[np.ndarray]] = {}
        self.searched: dict[str, list[tuple[np.ndarray, bool]]] = {}
        self._lock = threading.Lock()
        self._last = threading.local()
        self._embedder, self._index = embedder, index
        encode = embedder.encode_text

        def encode_text(texts, *args, **kwargs):
            out = encode(texts, *args, **kwargs)
            pairs = list(zip(texts, np.asarray(out, np.float32)))
            with self._lock:
                for text, vec in pairs:
                    self.vectors.setdefault(text, []).append(vec.copy())
            self._last.pairs = pairs
            return out

        embedder.encode_text = encode_text
        if index is None:
            return
        search = index.search_vectors

        def search_vectors(query_vectors, *args, **kwargs):
            before = ann.ivf_topk.calls
            out = search(query_vectors, *args, **kwargs)
            probed = ann.ivf_topk.calls != before
            raw = np.atleast_2d(np.asarray(query_vectors, np.float32))
            q = raw / np.maximum(np.linalg.norm(raw, axis=-1, keepdims=True), 1e-12)
            pairs, self._last.pairs = getattr(self._last, "pairs", []), []
            if len(pairs) == len(raw) and all(np.array_equal(vec, row)
                                              for (_, vec), row in zip(pairs, raw)):
                with self._lock:
                    for (text, _), row in zip(pairs, q):
                        self.searched.setdefault(text, []).append((row, probed))
            return out

        index.search_vectors = search_vectors

    def close(self) -> None:
        del self._embedder.encode_text   # the class's methods again
        if self._index is not None:
            del self._index.search_vectors


def fire(port: int, texts: list[str], concurrency: int = CONCURRENCY,
         limit: int = K) -> tuple[float, list[float], list[dict]]:
    """POST every text to ``/api/search`` from ``concurrency`` threads, each
    on one persistent connection. Returns the wall seconds of the whole
    round, each request's seconds and each response's body, in the order of
    ``texts``; raises unless every response is 200 with ``success``."""
    lock = threading.Lock()
    todo = iter(range(len(texts)))
    lat: list[float] = [0.0] * len(texts)
    bodies: list[Any] = [None] * len(texts)
    errors: list[BaseException] = []

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            while True:
                with lock:
                    i = next(todo, None)
                if i is None:
                    return
                body = json.dumps({"query": texts[i], "limit": limit}).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/api/search", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                lat[i] = time.perf_counter() - t0
                out = json.loads(data)
                if resp.status != 200 or not out.get("success"):
                    raise RuntimeError(f"served search answered {resp.status}: {out}")
                bodies[i] = out
        except BaseException as exc:   # re-raised by the caller
            errors.append(exc)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or any(b is None for b in bodies):
        raise RuntimeError("served requests did not all finish")
    return elapsed, lat, bodies


def _bench_served(device: torch.device, embedder: CLIPEmbedder, x: torch.Tensor,
                  n_valid: int, key_suffix: str, verify: Verify | None,
                  scales: torch.Tensor | None = None, ann_state: Any = None) -> dict:
    """One served section over the device rows ``x`` (``scales``: int8 rows;
    ``ann_state``: an IVF structure attached)."""
    with tempfile.TemporaryDirectory(prefix="ivars_bench_serve_") as workdir:
        cfg = Config(config_file=None, base_dir=workdir, create_dirs=True, overrides={
            "api": {"batching": True, "batching_max_batch": 64, "batching_window_ms": 8.0,
                    "rate_limit_per_minute": 10**9},
            "logging": {"file": False}})
        system = EnhancedRetrievalSystem(cfg, embedder=embedder, device=device)
        index = UnifiedIndex(UnifiedIndexConfig(
            dtype="int8" if scales is not None else "bfloat16"), device=device)
        index._dev_x = x
        index._dev_scales = scales
        index._n_valid = n_valid
        index._capacity = int(x.shape[0])
        index._metadata = _LazyMetas(n_valid)
        index._ann = ann_state
        system.index = index
        system.is_built = True
        # the encode and search shapes the 16-deep pattern reaches, before
        # the server starts (JAX: its compile buckets; here the kernels'
        # first builds and the allocator's pools)
        for b in (1, 32):
            embedder.encode_text([f"warm {i}" for i in range(b)])
        for b in (1, 9):
            index.search_vectors(embedder.encode_text([f"warm s{i}" for i in range(b)]),
                                 top_k=K, exact=ann_state is None)
        recorder = Recorder(embedder, index)
        server = RetrievalServer(system, host="127.0.0.1", port=0)
        try:
            server.run(block=False)
            fire(server.port, [f"photo of warm scene {i}" for i in range(WARMUPS[0])])
            fire(server.port, [f"photo of warm2 scene {i}" for i in range(WARMUPS[1])])
            stats = server.batcher.stats
            requests0, batches0 = stats.requests, stats.batches
            texts = [f"photo of timed scene {i}" for i in range(TIMED)]
            elapsed, lat, bodies = fire(server.port, texts)
            avg_batch = (stats.requests - requests0) / max(stats.batches - batches0, 1)
        finally:
            server.stop()
            recorder.close()
        checked = _check(system, recorder, x, scales, n_valid, ann_state, texts, bodies,
                         key_suffix, verify)
        system.index = None
    qps = TIMED / elapsed
    p50 = float(np.percentile(lat, 50)) * 1e3
    p95 = float(np.percentile(lat, 95)) * 1e3
    log(f"served-QPS[{key_suffix}]: {qps:.1f} QPS p50={p50:.3f} ms p95={p95:.3f} ms "
        f"avg_batch={avg_batch:.2f} over {TIMED} requests at concurrency {CONCURRENCY}; "
        f"{checked} answers checked")
    if key_suffix == "1M":   # the JAX bench's names for its first served section
        return {"served_qps_1M": round(qps, 1), "served_p50_ms": round(p50, 3),
                "served_p95_ms": round(p95, 3), "served_avg_batch": round(avg_batch, 2)}
    return {f"served_qps_{key_suffix}": round(qps, 1),
            f"served_p50_{key_suffix}_ms": round(p50, 3),
            f"served_p95_{key_suffix}_ms": round(p95, 3),
            f"served_avg_batch_{key_suffix}": round(avg_batch, 2)}


def _check(system, recorder: Recorder, x, scales, n_valid, ann_state, texts, bodies,
           key_suffix: str, verify: Verify | None) -> int:
    """Every timed answer has ``K`` hits; with ``verify``, the hits go to
    it with the vector the server searched (as ``search_vectors`` sends it
    to the device), split by the route the batch took."""
    for text, body in zip(texts, bodies):
        if body["count"] != K or len(body["results"]) != K:
            raise RuntimeError(f"served search for {text!r} answered {body['count']} hits")
    if verify is None:
        return 0
    groups: dict[bool, tuple[list, list, list]] = {False: ([], [], []), True: ([], [], [])}
    for text, body in zip(texts, bodies):
        seen = recorder.searched.get(system._clip_prompt(text, SearchOptions())[0], [])
        if len(seen) != 1:
            raise RuntimeError(f"the prompt of {text!r} was searched {len(seen)} times")
        q, probed = seen[0]
        qs, ids, sc = groups[probed]
        qs.append(q)
        ids.append([r["frame_id"] for r in body["results"]])
        sc.append([r["similarity_score"] for r in body["results"]])
    section = f"served_{key_suffix}"
    for probed, (qs, ids, sc) in groups.items():
        if not qs:
            continue
        q = torch.from_numpy(np.stack(qs)).to(x.device)
        if scales is None:
            q = q.to(x.dtype)
        result = TopKResult(torch.tensor(sc, dtype=torch.float32, device=x.device),
                            torch.tensor(ids, dtype=torch.int64, device=x.device))
        if probed:
            verify(section, x, scales, n_valid, q, result, decimals=SCORE_DECIMALS,
                   ivf=(ann_state, system.index.config.ann_nprobe))
        else:
            verify(section, x, scales, n_valid, q, result, decimals=SCORE_DECIMALS)
    return len(texts)


def served_qps(device: torch.device, embedder: CLIPEmbedder, rows: int,
               verify: Verify | None = None) -> dict:
    """``served_qps``: the REST server over ``rows`` fresh bf16 rows."""
    embedder.ensure_loaded()
    dim = embedder.config.text.projection_dim
    log(f"served-QPS: generating {rows} x {dim} bf16 rows on {device}...")
    x = gen_db_bf16(_ceil_to(rows, TILE_N), dim, SERVE_SEED, device)
    return _bench_served(device, embedder, x, rows, "1M", verify)


def served_10M(device: torch.device, embedder: CLIPEmbedder, rows: int, kept: dict,
               verify: Verify | None = None) -> dict:
    """``served_10M``: the REST server over the IVF section's int8 rows
    (``kept``: its ``x``, ``scales`` and ``state``), with the IVF state
    attached (``10M_int8_ann``), then dense (``10M_int8_dense``)."""
    x, s, state = kept["x"], kept["scales"], kept["state"]
    log("served-QPS: 10M int8 with the IVF state attached...")
    out = _bench_served(device, embedder, x, rows, "10M_int8_ann", verify, scales=s,
                        ann_state=state)
    log("served-QPS: 10M int8 dense...")
    out.update(_bench_served(device, embedder, x, rows, "10M_int8_dense", verify, scales=s))
    return out
