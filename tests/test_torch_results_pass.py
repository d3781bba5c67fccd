"""The pass of ``UnifiedIndex.search_vectors`` that builds each call's
``SearchResult``s (its ``index.results`` stage), and the cyclic collector
it holds off meanwhile.

The hits are held to the per-element loop the pass replaced, copied below
as the oracle and run over the very scores, rows and records the pass was
given: int8 and bf16 indexes, ``top_k`` past the live rows (the masked
``-inf`` tail), tombstones, a filter over ``over_fetch`` candidates, and
records fewer than the rows. The collector is left as it was found: on or
off, when the filter raises, and when two threads are in the pass at once;
with tracing on, the span notes how many collector passes ran inside it.
Sixteen threads churning through the hold lose no count. The file imports
no JAX.
"""

from __future__ import annotations

import gc
import sys
import threading

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch import trace
from intelligent_video_analysis_retrieval_system_tpu_torch.index import unified
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import IndexContainer
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex, UnifiedIndexConfig)
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.results import (
    KeyframeMetadata, SearchResult)

torch.set_num_threads(2)

DIM = 32


def _index(tmp_path, dtype: str, n: int = 600):
    pytest.importorskip("h5py")          # the container's file format
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    with IndexContainer(tmp_path / "r.rvdb", "w", dim=DIM, dtype=dtype) as c:
        c.append_embeddings(rows)
        c.append_metadata([{"folder": f"v{i // 100}", "image": f"{i % 100:04d}.jpg",
                            "frame_id": i % 100, "row_id": i} for i in range(n)])
        c.flush_checkpoint()
    index = UnifiedIndex(UnifiedIndexConfig(dtype=dtype), device="cpu")
    return index.load_unified_index(tmp_path / "r.rvdb", mode="a"), rows


def _queries(rows: np.ndarray, at: list[int], seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rows[at] + 0.3 * rng.standard_normal((len(at), DIM)).astype(np.float32)


def _loop_before(scores, indices, metadata, top_k, filter_fn):
    """The per-element loop the one pass replaced, as it was."""
    out = []
    for b in range(len(scores)):
        hits = []
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


def _given(monkeypatch) -> list[tuple]:
    """Records what each call of the pass is given."""
    seen: list[tuple] = []
    real = unified._ranked_hits

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(unified, "_ranked_hits", spy)
    return seen


# (n rows, tombstoned rows, query rows, top_k, filter, over_fetch, records kept)
CASES = {
    "plain": (600, [], [3, 50, 120, 399, 598], 10, None, 4, None),
    "k_past_live": (40, [3, 17, 29], [0, 11, 38], 60, None, 4, None),
    "tombstones": (600, [3, 50, 51, 120, 400], [3, 50, 120, 399, 598], 10, None, 4, None),
    "filter": (600, [], [3, 50, 120, 399, 598], 8, "thirds", 5, None),
    "records_short": (600, [], [560, 575, 590, 599, 10], 10, None, 4, 550),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_the_pass_gives_the_loop_it_replaced(tmp_path, monkeypatch, dtype, case):
    n, dead, at, top_k, filt, over_fetch, kept = CASES[case]
    index, rows = _index(tmp_path, dtype, n)
    if dead:
        index.delete_rows(dead)
    if kept is not None:
        index._metadata = index._metadata[:kept]
    filter_fn = (lambda m: m.row_id % 3 == 0) if filt == "thirds" else None
    seen = _given(monkeypatch)
    got = index.search_vectors(_queries(rows, at), top_k=top_k, filter_fn=filter_fn,
                               over_fetch=over_fetch)
    (scores, indices, metadata, k, fn), = seen
    want = _loop_before(scores, indices, metadata, k, fn)

    # each case reaches the rule it names
    if case == "k_past_live":
        assert not np.isfinite(scores).all() and scores.shape[1] > n - len(dead)
    if case == "tombstones":
        assert not set(dead) & {h.metadata.row_id for hits in got for h in hits}
    if case == "filter":
        assert scores.shape[1] == top_k * over_fetch
        assert any(len(hits) == top_k for hits in got)
    if case == "records_short":
        assert (indices[:4, 0] >= kept).all()          # skipped, not ended on
        assert [len(hits) for hits in got] == list((indices < kept).sum(axis=1))
        assert all(got[:4])

    assert [len(h) for h in got] == [len(h) for h in want] and any(got)
    for g_hits, w_hits in zip(got, want):
        for g, w in zip(g_hits, w_hits):
            assert g.metadata.row_id == w.metadata.row_id and g.metadata == w.metadata
            assert type(g.similarity_score) is float
            assert g.similarity_score == w.similarity_score
            assert (g.rank, g.source) == (w.rank, w.source)


class _PlainRecords:
    """Records made on access (as a benchmark harness serves them) that
    note the type of each row they are asked for."""

    def __init__(self, n: int) -> None:
        self.n, self.keys = n, []

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        self.keys.append(type(i))
        return KeyframeMetadata(folder="v", image=f"{i:06d}.jpg", frame_id=i, row_id=i)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_records_are_asked_for_by_plain_int(tmp_path, dtype):
    index, rows = _index(tmp_path, dtype)
    index._metadata = records = _PlainRecords(len(rows))
    got = index.search_vectors(_queries(rows, [1, 2, 3]), top_k=7)
    assert set(records.keys) == {int} and len(records.keys) == 21
    assert {type(h.metadata.row_id) for hits in got for h in hits} == {int}


# -- the collector -------------------------------------------------------------


@pytest.fixture
def collector():
    """The collector as the test found it, afterwards."""
    was = gc.isenabled()
    try:
        yield
    finally:
        gc.enable() if was else gc.disable()


@pytest.mark.parametrize("on", [True, False])
def test_the_collector_is_left_as_found(tmp_path, collector, on):
    index, rows = _index(tmp_path, "int8")
    gc.enable() if on else gc.disable()
    during: list[bool] = []
    index.search_vectors(_queries(rows, [1, 2]), top_k=5,
                         filter_fn=lambda m: during.append(gc.isenabled()) or True)
    assert during and not any(during)
    assert gc.isenabled() is on and unified._held_depth == 0


@pytest.mark.parametrize("on", [True, False])
def test_a_raising_filter_leaves_the_collector_as_found(tmp_path, collector, on):
    index, rows = _index(tmp_path, "bfloat16")
    gc.enable() if on else gc.disable()

    def refuse(meta):
        raise RuntimeError("filter failed")

    with pytest.raises(RuntimeError, match="filter failed"):
        index.search_vectors(_queries(rows, [1, 2]), top_k=5, filter_fn=refuse)
    assert gc.isenabled() is on and unified._held_depth == 0


def test_two_threads_in_the_pass_leave_it_enabled(tmp_path, collector):
    index, rows = _index(tmp_path, "int8")
    gc.enable()
    both_inside = threading.Barrier(2, timeout=30)
    local = threading.local()
    during: list[bool] = []
    errors: list[BaseException] = []

    def meet(meta):
        if not getattr(local, "met", False):      # each thread's first record
            local.met = True
            during.append(gc.isenabled())
            both_inside.wait()
        return True

    def client(at):
        try:
            answers = index.search_vectors(_queries(rows, at), top_k=5, filter_fn=meet)
            assert all(len(hits) == 5 for hits in answers)
        except BaseException as e:             # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(at,)) for at in ([1, 2], [3, 4, 5])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert during == [False, False]
    assert gc.isenabled() and unified._held_depth == 0


@pytest.fixture
def recorder():
    trace.take()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_the_results_span_notes_no_collector_pass(tmp_path, collector, recorder, dtype):
    index, rows = _index(tmp_path, dtype)
    gc.enable()
    trace.take()
    answers = index.search_vectors(_queries(rows, list(range(64))), top_k=50)
    # more hits than the allocations that start a young collection
    assert sum(map(len, answers)) > gc.get_threshold()[0]
    results = [s for s in trace.take() if s.name == "index.results"]
    assert len(results) == 1 and results[0].attrs == {"gc_passes": 0}
    assert gc.isenabled()


def test_the_results_span_counts_a_pass_made_inside_it(tmp_path, collector, recorder):
    index, rows = _index(tmp_path, "int8")
    trace.take()
    made = []

    def collect_once(meta):
        if not made:
            made.append(gc.collect(0))
        return True

    index.search_vectors(_queries(rows, [1, 2]), top_k=5, filter_fn=collect_once)
    results = [s for s in trace.take() if s.name == "index.results"]
    assert made and results[0].attrs == {"gc_passes": 1}


def test_many_threads_entering_and_leaving_the_hold_lose_no_count(collector):
    gc.enable()
    workers, rounds = 16, 2_000
    seen_on: list[bool] = []
    errors: list[BaseException] = []
    start = threading.Barrier(workers, timeout=30)

    def churn():
        try:
            start.wait()
            for i in range(rounds):
                with unified._collector_held():
                    if i % 3 == 0:
                        with unified._collector_held():      # re-entered
                            seen_on.append(gc.isenabled())
                    seen_on.append(gc.isenabled())
        except BaseException as e:             # noqa: BLE001 - surfaced below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(seen_on) == workers * (rounds + -(-rounds // 3)) and not any(seen_on)
    assert gc.isenabled() and unified._held_depth == 0
