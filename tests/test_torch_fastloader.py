"""``FastLoader`` of the PyTorch port against the JAX package's.

- ``load_with_cache``: a cold open and a warm one (metadata from the cache)
  answer like ``load_unified_index`` and like the JAX loader over the same
  file.
- ``progressive_load``: searches over the growing prefix see exactly the
  rows loaded so far; once the loader thread has joined, the answers equal
  a full load's and the JAX progressive load's (tie-aware, atol 5e-4: the
  progressive path normalizes rows on the host, the full load on the
  device). Tombstones apply from the first chunk.
"""

import threading

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.index.fastloader import (
    FastLoader as JaxFastLoader,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.fastloader import FastLoader
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.cache import CacheManager

torch.set_num_threads(2)

N, DIM = 2500, 32


def _record(i: int) -> dict:
    return {"folder": f"video_{i // 300}", "image": f"{i % 300:04d}.jpg",
            "frame_id": (i % 300) * 10, "row_id": i}


def _write(path, dtype: str = "bfloat16", deleted=()):
    rows = np.random.default_rng(0).standard_normal((N, DIM)).astype(np.float32)
    with JaxContainer(path, "w", dim=DIM, dtype=dtype) as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i) for i in range(N)])
        if deleted:
            c.append_deleted(list(deleted))
        c.flush_checkpoint()
    return rows


def _lists(hits):
    return (np.array([h.metadata.row_id for h in hits]),
            np.array([h.similarity_score for h in hits], np.float32))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        tie_aware_equal(*_lists(g), *_lists(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_load_with_cache_cold_and_warm(tmp_path, dtype):
    path = tmp_path / "a.rvdb"
    _write(path, dtype)
    q = np.random.default_rng(1).standard_normal((3, DIM)).astype(np.float32)
    full = UnifiedIndex(device="cpu").load_unified_index(path)
    want = full.search_vectors(q, top_k=10)
    cache = CacheManager(cache_dir=tmp_path / "cache")
    loader = FastLoader(cache=cache, device="cpu")
    cold = loader.load_with_cache(path)
    hits_before = cache.get_stats()["hits"]
    warm = loader.load_with_cache(path)
    assert cache.get_stats()["hits"] == hits_before + 1
    assert warm.load_time_s == 0.0 and warm.ntotal == cold.ntotal == N
    jax_warm = JaxFastLoader(cache=CacheManager(cache_dir=tmp_path / "jcache"))
    jax_warm.load_with_cache(path).close()
    jwarm = jax_warm.load_with_cache(path)
    for index in (cold, warm):
        got = index.search_vectors(q, top_k=10)
        if dtype == "int8":   # the int8 metric is exact: bit for bit
            assert [_lists(h)[0].tolist() for h in got] == [_lists(h)[0].tolist() for h in want]
            assert [_lists(h)[1].tolist() for h in got] == [_lists(h)[1].tolist() for h in want]
        _assert_same(got, want)
        _assert_same(got, jwarm.search_vectors(q, top_k=10))
        assert index.get_metadata(301).to_dict() == full.get_metadata(301).to_dict()
        assert index.row_for("video_2", "0005.jpg") == 605
    for index in (full, cold, warm, jwarm):
        index.close()
    # a changed file is another cache key: the warm path is not taken
    with JaxContainer(path, "a") as c:
        c.append_embeddings(np.ones((1, DIM), np.float32))
        c.append_metadata([_record(N)])
        c.flush_checkpoint()
    again = loader.load_with_cache(path)
    assert again.ntotal == N + 1 and again.load_time_s > 0.0
    again.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_progressive_load_serves_a_growing_prefix(tmp_path, dtype):
    path = tmp_path / "a.rvdb"
    rows = _write(path, dtype, deleted=(3, 1700))
    q = rows[[3, 40, 1700, 2400]] + 0.01       # near rows in the first and last chunks
    gate, reached = threading.Event(), threading.Event()
    progress = []

    def on_progress(loaded, total):
        progress.append((loaded, total))
        if loaded == 1000:      # hold the loader after its first chunk
            reached.set()
            assert gate.wait(timeout=60)

    index, thread = FastLoader(device="cpu").progressive_load(path, chunk_rows=1000,
                                                            on_progress=on_progress)
    assert reached.wait(timeout=60)
    assert index.ntotal == 1000 and index.get_stats()["capacity"] == 4096
    prefix = index.search_vectors(q, top_k=5)
    for hits in prefix:
        assert hits and all(h.metadata.row_id < 1000 for h in hits)
    assert prefix[1][0].metadata.row_id == 40
    assert 3 not in [h.metadata.row_id for h in prefix[0]]       # tombstoned from the start
    gate.set()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert index.ntotal == N and progress == [(1000, N), (2000, N), (N, N)]
    got = index.search_vectors(q, top_k=5)
    assert [hits[0].metadata.row_id for hits in got[1::2]] == [40, 2400]
    assert not {3, 1700} & {h.metadata.row_id for hits in got for h in hits}
    full = UnifiedIndex(device="cpu").load_unified_index(path)
    _assert_same(got, full.search_vectors(q, top_k=5))
    jindex, jthread = JaxFastLoader().progressive_load(path, chunk_rows=1000)
    jthread.join(timeout=120)
    assert not jthread.is_alive()
    _assert_same(got, jindex.search_vectors(q, top_k=5))
    for i in (index, full, jindex):
        i.close()


def test_fastloader_defaults_to_the_card(tmp_path):
    with pytest.raises(RuntimeError):
        FastLoader()
