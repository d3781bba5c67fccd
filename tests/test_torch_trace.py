"""The port's span recorder (``trace.py``) and the spans of its k-NN and
image-encode paths.

The recorder: off it records nothing, reads no clock and makes no object;
on it nests spans with parent and root ids, keeps one stack per thread,
stops at its cap and counts what it drops, and ``take()`` clears it. The
paths: a CPU ``UnifiedIndex.search_vectors`` and a tiny-config CPU
``CLIPEmbedder.encode_images`` leave the spans their docstrings name, in
order; the int8 two-phase search counts its B2 launches in
``quant.phase1`` and notes their query group (on the card, 8 launches of
64 for 512 queries of 1,280 int8, 2 of 256 at 64). The file imports no
JAX, so the card case runs where there is none:

    python -m pytest --noconftest tests/test_torch_trace.py -q -m cuda
"""

from __future__ import annotations

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch import trace
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import IndexContainer
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex, UnifiedIndexConfig)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant as tq
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder

torch.set_num_threads(2)


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty again afterwards."""
    trace.take()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(child, parent):
    return (child.parent == parent.id and child.root == parent.root
            and parent.start <= child.start <= child.end <= parent.end)


# -- the recorder ----------------------------------------------------------


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    trace.disable()
    trace.take()

    def refuse(*args, **kwargs):
        raise AssertionError("the clock was read or a span made while off")

    monkeypatch.setattr(trace, "perf_counter", refuse)
    monkeypatch.setattr(trace, "Span", refuse)

    def calls(n):
        for _ in range(n):
            with trace.span("index.search", top_k=20) as s:
                s.note(path="int8")
                with trace.span("index.results"):
                    trace.count("index.hits", 7)

    calls(10)   # warm the code paths once
    assert trace.span("a") is trace.span("b", x=1)   # the one shared no-op
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        calls(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # nothing kept (on, 20,000 spans hold ~9 MB), and no more than a call's
    # keyword arguments alive at a time
    assert after - before <= 0 and peak - before < 2048, (before, after, peak)
    assert trace.take() == [] and trace.dropped() == 0


def test_nesting_parents_roots_attributes_and_counts(recorder):
    with trace.span("outer", queries=4) as outer:
        outer.note(path="bf16")
        with trace.span("a") as a:
            trace.count("launches", 3)
            trace.count("launches")
            with trace.span("a.inner") as inner:
                trace.count("index.hits", 5)
        with trace.span("b") as b:
            pass
    with trace.span("second") as second:
        pass
    trace.count("outside_any_span", 1)         # not kept
    spans = recorder.take()
    assert [s.name for s in spans] == ["a.inner", "a", "b", "outer", "second"]
    assert outer.parent is None and outer.root == outer.id
    assert _inside(a, outer) and _inside(b, outer) and _inside(inner, a)
    assert inner.root == outer.id and a.end <= b.start
    assert second.parent is None and second.root == second.id != outer.id
    assert outer.attrs == {"queries": 4, "path": "bf16"}
    assert a.counts == {"launches": 4} and inner.counts == {"index.hits": 5}
    assert outer.counts == {} and second.counts == {}
    assert len({s.id for s in spans}) == 5


def test_a_span_left_by_an_exception_is_kept_and_closed(recorder):
    with pytest.raises(RuntimeError):
        with trace.span("outer"):
            with trace.span("failing"):
                raise RuntimeError("boom")
    with trace.span("next") as nxt:
        pass
    assert [s.name for s in recorder.take()] == ["failing", "outer", "next"]
    assert nxt.parent is None


def test_two_threads_keep_separate_stacks(recorder):
    inner_open = threading.Event()
    release = threading.Event()
    kept = {}

    def worker():
        with trace.span("worker.root") as root:
            inner_open.set()
            release.wait(10)
            with trace.span("worker.child") as child:
                pass
        kept.update(root=root, child=child)

    t = threading.Thread(target=worker)
    with trace.span("main.root") as main_root:
        t.start()
        assert inner_open.wait(10)
        with trace.span("main.child") as main_child:
            release.set()
            t.join(10)
    assert not t.is_alive()
    assert _inside(main_child, main_root)
    assert kept["root"].parent is None and kept["root"].root == kept["root"].id
    assert kept["child"].parent == kept["root"].id and kept["child"].root == kept["root"].id
    assert kept["root"].thread != main_root.thread == main_child.thread
    assert len(recorder.take()) == 4


def test_the_cap_keeps_the_first_spans_and_counts_the_dropped(recorder, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert trace.dropped() == 2
    assert [s.name for s in trace.take()] == ["s0", "s1", "s2"]


def test_take_clears(recorder, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 1)
    with trace.span("one"):
        pass
    with trace.span("two"):
        pass
    assert [s.name for s in trace.take()] == ["one"] and trace.dropped() == 0
    assert trace.take() == []
    with trace.span("three"):
        pass
    assert [s.name for s in trace.take()] == ["three"]


# -- the k-NN path -----------------------------------------------------------

N, DIM = 600, 32


def _index(tmp_path, dtype="bfloat16"):
    pytest.importorskip("h5py")          # the container's file format
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    with IndexContainer(tmp_path / "t.rvdb", "w", dim=DIM, dtype=dtype) as c:
        c.append_embeddings(rows)
        c.append_metadata([{"folder": f"v{i // 100}", "image": f"{i % 100:04d}.jpg",
                            "frame_id": i % 100, "row_id": i} for i in range(N)])
        c.flush_checkpoint()
    index = UnifiedIndex(UnifiedIndexConfig(dtype=dtype), device="cpu")
    return index.load_unified_index(tmp_path / "t.rvdb"), rows


@pytest.mark.parametrize("dtype, path", [("bfloat16", "bf16"), ("int8", "int8")])
def test_search_vectors_spans(recorder, tmp_path, dtype, path):
    index, rows = _index(tmp_path, dtype)
    trace.take()
    # k larger than the rows that pass the filter: fewer results than asked
    answers = index.search_vectors(rows[:5], top_k=10,
                                   filter_fn=lambda m: m.row_id % 50 == 0)
    spans = _by_name(trace.take())
    assert sorted(spans) == ["index.dispatch", "index.readback", "index.results",
                             "index.search"]
    call = spans["index.search"][0]
    assert call.attrs == {"top_k": 10, "queries": 5, "path": path}
    kids = [spans[n][0] for n in ("index.dispatch", "index.readback", "index.results")]
    assert all(_inside(k, call) for k in kids)
    assert kids[0].end <= kids[1].start and kids[1].end <= kids[2].start
    hits = kids[2].counts["index.hits"]
    assert hits == sum(len(a) for a in answers) and 0 < hits < 5 * 10


def test_search_vectors_spans_close_on_the_empty_index(recorder):
    answers = UnifiedIndex(device="cpu").search_vectors(np.ones((3, DIM), np.float32))
    assert answers == [[], [], []]
    spans = trace.take()
    assert [s.name for s in spans] == ["index.search"] and spans[0].end >= spans[0].start
    with trace.span("after") as after:
        pass
    assert after.parent is None          # nothing left open on the stack


def test_int8_two_phase_search_spans_on_the_cpu(recorder):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4096, 64)).astype(np.float32))
    x_i8, xs = tq.symmetric_int8(x, dim=-1)
    q = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    before = tq.int8_chunk_max_sweep.launches
    tq.topk_search_int8(x_i8, xs, q, 10, n_valid=4000, use_pallas=True)
    spans = _by_name(trace.take())
    assert sorted(spans) == ["quant.phase1", "quant.phase2"]
    one, two = spans["quant.phase1"][0], spans["quant.phase2"][0]
    # the plain version of B2 runs on the CPU: no kernel launched
    assert one.counts == {"launches": 0} and tq.int8_chunk_max_sweep.launches == before
    assert one.end <= two.start


# -- the image-encode path ---------------------------------------------------


def test_encode_images_spans(recorder):
    emb = CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32", device="cpu",
                       image_batch_size=8)
    emb.ensure_loaded()
    loads = _by_name(trace.take())
    load = loads["embed.load"][0]
    # the self-test's calls nest under the load
    assert _inside(loads["embed.text"][0], load) and _inside(loads["embed.images"][0], load)
    s = emb.config.vision.image_size
    frames = np.random.default_rng(2).integers(0, 256, (20, s, s, 3), dtype=np.uint8)
    out = emb.encode_images(frames)
    assert out.shape[0] == 20
    spans = _by_name(trace.take())
    (call,) = spans["embed.images"]
    assert call.attrs == {"images": 20} and call.parent is None
    chunks = [(u, d, r) for u, d, r in zip(spans["embed.upload"], spans["embed.dispatch"],
                                           spans["embed.readback"])]
    assert len(chunks) == 3                      # 8 + 8 + 4 images
    for (u, d, r), b in zip(chunks, (8, 8, 8)):  # the last chunk pads to 8
        assert all(_inside(x, call) for x in (u, d, r))
        assert u.end <= d.start and d.end <= r.start
        assert u.attrs == {"bytes": b * s * s * 3}
    assert chunks[0][2].end <= chunks[1][0].start
    emb.encode_text(["a cat", "a dog"])
    spans = _by_name(trace.take())
    (text,) = spans["embed.text"]
    assert text.attrs == {"texts": 2}
    assert _inside(spans["embed.dispatch"][0], text) and _inside(spans["embed.readback"][0], text)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B2 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phase1_counts_eight_b2_launches_for_512_queries(recorder, cuda_device):
    # rows of 1,280 take groups of 64 queries (8 sweeps for 512), rows of 64
    # groups of 256 (2 sweeps): the group follows the shapes
    for d, launches, group in ((1280, 8, 64), (64, 2, 256)):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        x = torch.randn(8192, d, generator=gen, device=cuda_device)
        x_i8, xs = tq.symmetric_int8(x, dim=-1)
        q = torch.randn(512, d, generator=gen, device=cuda_device)
        tq.topk_search_int8(x_i8, xs, q, 20)
        torch.cuda.synchronize()
        spans = _by_name(trace.take())
        assert spans["quant.phase1"][0].counts == {"launches": launches}
        assert spans["quant.phase1"][0].attrs == {"group": group}
        assert spans["quant.phase1"][0].end <= spans["quant.phase2"][0].start
