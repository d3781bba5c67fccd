"""Parity of the PyTorch port's dense index with the JAX ``UnifiedIndex``.

A tiny ``.rvdb`` is written by the JAX package's container; each package
opens its own copy and both answer the same queries, through deletes, an
append within the padded capacity, an append past it, and a metadata
filter. The JAX index runs its plain reference search on CPU; the port runs
its two-phase search with the plain chunk-max sweep. f32 rows: the same ids
and scores within 1e-5; bf16 rows: tie-aware (atol 5e-4).

int8 containers (the capacity mode) answer bit for bit like the JAX index,
ties included, through the same mutations, with and without the exact
rescore against the bf16 copy, and over the ``.flat8`` sidecar.
"""

import shutil

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu import native
from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.index.metadata import (
    MetadataManager as JaxMetadataManager,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndex as JaxIndex,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
    IndexContainer,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.metadata import (
    MetadataManager,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.results import (
    KeyframeMetadata,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

torch.set_num_threads(2)

N, DIM = 3000, 32   # capacity pads to 4096 rows


def _record(i: int) -> dict:
    return {"folder": f"video_{i // 300}", "image": f"{i % 300:04d}.jpg",
            "frame_id": (i % 300) * 10, "row_id": i}


def _write(path, dtype: str, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    with JaxContainer(path, "w", dim=DIM, dtype=dtype) as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i) for i in range(n)])
        c.append_thumbnails([b"jpg%d" % i for i in range(n)])
        c.flush_checkpoint()
    return rows


def _open_pair(tmp_path, dtype: str):
    _write(tmp_path / "a.rvdb", dtype)
    shutil.copy(tmp_path / "a.rvdb", tmp_path / "b.rvdb")
    j = JaxIndex().load_unified_index(tmp_path / "a.rvdb", mode="a")
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "b.rvdb", mode="a")
    return j, t


def _ids(hits):
    return np.array([h.metadata.row_id for h in hits]), \
        np.array([h.similarity_score for h in hits])


def _assert_same(j, t, q, dtype, top_k=10, filter_fn=None):
    jr = j.search_vectors(q, top_k=top_k, filter_fn=filter_fn)
    tr = t.search_vectors(q, top_k=top_k, filter_fn=filter_fn)
    assert len(jr) == len(tr)
    for jh, th in zip(jr, tr):
        (ji, js), (ti, ts) = _ids(jh), _ids(th)
        assert len(ji) == len(ti)
        if dtype == "float32":
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(ts, js, atol=1e-5)
        else:
            tie_aware_equal(ti, ts, ji, js)
        if filter_fn is not None:
            assert all(filter_fn(h.metadata) for h in th)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_matches_jax_through_mutations(tmp_path, dtype):
    j, t = _open_pair(tmp_path, dtype)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    assert t.ntotal == j.ntotal == N and t.get_stats()["capacity"] == 4096
    _assert_same(j, t, q, dtype)
    # deletes: each query's current best row, plus a scatter
    best = [h[0].metadata.row_id for h in t.search_vectors(q, top_k=1)]
    dead = best + list(range(0, N, 97))
    assert t.delete_rows(dead) == j.delete_rows(dead)
    _assert_same(j, t, q, dtype, top_k=20)
    assert not set(best) & {h.metadata.row_id for hs in t.search_vectors(q) for h in hs}
    # append within capacity: in place, no re-upload
    new = rng.standard_normal((60, DIM)).astype(np.float32)
    meta = [_record(N + i) for i in range(60)]
    buf = t._dev_x
    assert t.incremental_update(new, meta) == j.incremental_update(new, meta)
    assert t._dev_x is buf and t.ntotal == N + 60
    _assert_same(j, t, np.concatenate([q, new[:3]]), dtype, top_k=15)
    # filter with over-fetch
    _assert_same(j, t, q, dtype, top_k=5, filter_fn=lambda m: m.folder == "video_3")
    # append past capacity: re-upload from the container
    big = rng.standard_normal((1200, DIM)).astype(np.float32)
    meta = [_record(N + 60 + i) for i in range(1200)]
    t.incremental_update(big, meta)
    j.incremental_update(big, meta)
    assert t.get_stats()["capacity"] == 6144 and t.ntotal == N + 1260
    _assert_same(j, t, np.concatenate([q, big[-3:]]), dtype, top_k=10)
    assert t.num_deleted == j.num_deleted and t.num_live == j.num_live
    j.close()
    t.close()


def test_reopen_keeps_tombstones_and_rows(tmp_path):
    j, t = _open_pair(tmp_path, "bfloat16")
    t.delete_rows([5, 6, 7])
    t.incremental_update(np.ones((2, DIM), np.float32), [_record(N), _record(N + 1)])
    t.close()
    j.close()
    t2 = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "b.rvdb")
    j2 = JaxIndex().load_unified_index(tmp_path / "b.rvdb")
    assert t2.deleted_rows == j2.deleted_rows == frozenset({5, 6, 7})
    q = np.random.default_rng(2).standard_normal((3, DIM)).astype(np.float32)
    _assert_same(j2, t2, q, "bfloat16", top_k=12)
    t2.close()
    j2.close()


def test_flat_sidecar_is_read(tmp_path):
    rows = _write(tmp_path / "s.rvdb", "float32")
    # a sidecar whose rows differ from the container's: the index must
    # serve the sidecar's rows when its header matches
    other = np.random.default_rng(9).standard_normal(rows.shape).astype(np.float32)
    native.FlatEmbeddingFile.write_raw(tmp_path / "s.rvdb.flat", other, "float32")
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "s.rvdb")
    dev = t._dev_x[:N].numpy()
    want = other / np.linalg.norm(other, axis=-1, keepdims=True)
    np.testing.assert_allclose(dev, want, atol=1e-6)
    t.close()
    # a stale sidecar (wrong row count) is ignored
    native.FlatEmbeddingFile.write_raw(tmp_path / "s.rvdb.flat", other[:10], "float32")
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "s.rvdb")
    np.testing.assert_allclose(t._dev_x[:N].numpy(),
                               rows / np.linalg.norm(rows, axis=-1, keepdims=True),
                               atol=1e-6)
    t.close()


def _pair_of_copies(tmp_path, dtype: str, n: int):
    """One container of ``n`` rows as ``a.rvdb`` (for the JAX index) and
    ``b.rvdb`` (for the port)."""
    if dtype == "int8":
        _write_int8(tmp_path / "a.rvdb", n=n, keep_fp=False)
    else:
        _write(tmp_path / "a.rvdb", dtype, n=n)
    shutil.copy(tmp_path / "a.rvdb", tmp_path / "b.rvdb")
    return tmp_path / "a.rvdb", tmp_path / "b.rvdb"


def _top_ids(index, q, top_k=5):
    return [[h.metadata.row_id for h in hits] for hits in index.search_vectors(q, top_k=top_k)]


def test_open_writes_the_flat_sidecar_as_jax_does(tmp_path, monkeypatch):
    # a float32 container read from its blob writes `.flat` for the next
    # open, in both packages, and the two sidecars are the same bytes
    monkeypatch.setattr(JaxIndex, "_FLAT_MIN_ROWS", 8)
    monkeypatch.setattr(UnifiedIndex, "_FLAT_MIN_ROWS", 8)
    a, b = _pair_of_copies(tmp_path, "float32", 12)
    q = np.random.default_rng(6).standard_normal((3, DIM)).astype(np.float32)
    j = JaxIndex().load_unified_index(a)
    t = UnifiedIndex(device="cpu").load_unified_index(b)
    want = _top_ids(j, q)
    assert _top_ids(t, q) == want
    j.close()
    t.close()
    flat_a, flat_b = a.with_name(a.name + ".flat"), b.with_name(b.name + ".flat")
    assert flat_b.is_file() and flat_b.read_bytes() == flat_a.read_bytes()

    def _no_blob(self, *args, **kwargs):
        raise AssertionError("the container's rows were read beside a fresh .flat")

    monkeypatch.setattr(IndexContainer, "read_embeddings", _no_blob)
    t = UnifiedIndex(device="cpu").load_unified_index(b)
    assert t.ntotal == 12 and _top_ids(t, q) == want
    t.close()


@pytest.mark.parametrize("dtype,suffix,magic", [("float32", ".flat", b"IVARSFLT"),
                                                ("int8", ".flat8", b"IVARSFL8")])
def test_a_torn_sidecar_falls_back_to_the_container(tmp_path, dtype, suffix, magic):
    # 12 bytes that keep the magic: the header cannot even be unpacked
    a, b = _pair_of_copies(tmp_path, dtype, 12)
    for path in (a, b):
        path.with_name(path.name + suffix).write_bytes(magic + b"\0\0\0\0")
    q = np.random.default_rng(7).standard_normal((3, DIM)).astype(np.float32)
    j = JaxIndex().load_unified_index(a)
    t = UnifiedIndex(device="cpu").load_unified_index(b)
    assert t.ntotal == j.ntotal == 12
    assert _top_ids(t, q) == _top_ids(j, q)
    j.close()
    t.close()


def test_search_by_row_and_temporal_context(tmp_path):
    j, t = _open_pair(tmp_path, "float32")
    for row in (0, 1234):
        th = t.search_by_row(row, top_k=5)
        jh = j.search_by_row(row, top_k=5)
        assert [h.metadata.row_id for h in th] == [h.metadata.row_id for h in jh]
        assert row not in {h.metadata.row_id for h in th}
    assert t.get_temporal_context(301, 3) == j.get_temporal_context(301, 3)
    assert t.row_for("video_2", "0005.jpg") == j.row_for("video_2", "0005.jpg") == 605
    assert isinstance(t.get_metadata(3), KeyframeMetadata)
    j.close()
    t.close()


def test_port_container_reads_and_writes_rvdb(tmp_path):
    rows = _write(tmp_path / "c.rvdb", "bfloat16", n=50)
    with IndexContainer(tmp_path / "c.rvdb", "r") as c:
        got = c.read_embeddings(as_float32=True)
        assert c.num_metadata == 50 and c.get_metadata(7)["image"] == "0007.jpg"
    with JaxContainer(tmp_path / "c.rvdb", "r") as c:
        np.testing.assert_array_equal(got, c.read_embeddings(as_float32=True))
    np.testing.assert_allclose(got, rows, rtol=1e-2)
    with IndexContainer(tmp_path / "d.rvdb", "w", dim=DIM, dtype="float32") as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i) for i in range(50)])
        c.flush_checkpoint()
    with JaxContainer(tmp_path / "d.rvdb", "r") as c:
        np.testing.assert_array_equal(c.read_embeddings(), rows)


def test_unported_modes_raise(tmp_path):
    # the IVF mode is ported (tests/test_torch_ann.py), and the mesh
    # (tests/test_torch_parallel.py): an index on a CPU mesh lives on the CPU,
    # and a mesh of another device type than the index's raises
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import create_mesh

    assert UnifiedIndex(UnifiedIndexConfig(ann=True), device="cpu").config.ann
    mesh = create_mesh(devices=["cpu"] * 4)
    assert UnifiedIndex(device="cpu", mesh=mesh).device == torch.device("cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            UnifiedIndex(device="cuda", mesh=mesh)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError):
        UnifiedIndex(device="cuda")


def test_similarity_graph_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((60, DIM)).astype(np.float32)
    feats[1] = feats[0] + 0.05            # near-duplicates clear the 0.7 bar
    feats[31] = feats[30] + 0.08
    metas = [KeyframeMetadata(folder=f"v{i // 30}", image=f"{i}.jpg", frame_id=i, row_id=i)
             for i in range(60)]
    t, j = MetadataManager(similarity_threshold=0.0, device="cpu"), JaxMetadataManager(similarity_threshold=0.0)
    t.build_metadata(metas, feats)
    from intelligent_video_analysis_retrieval_system_tpu.retrieval.results import (
        KeyframeMetadata as JaxMeta,
    )
    j.build_metadata([JaxMeta(**m.to_dict()) for m in metas], feats)
    assert t.temporal_index == j.temporal_index
    for folder in ("v0", "v1"):
        for img, pairs in j.similarity_graph[folder].items():
            got = t.similarity_graph[folder][img]
            assert [n for n, _ in got] == [n for n, _ in pairs]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in pairs], atol=1e-5)
    assert t.stats() == j.stats()


# ---------------------------------------------------------------------------
# int8 capacity mode: bit for bit against the JAX index
# ---------------------------------------------------------------------------


def _write_int8(path, n: int = N, seed: int = 0, keep_fp: bool = True):
    """A JAX-written int8 container (with the bf16 copy when ``keep_fp``);
    rows 7, 100 and 2500 duplicate row 1000 where there are that many, so
    they tie exactly."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    if n > 2500:
        rows[[7, 100, 2500]] = rows[1000]
    with JaxContainer(path, "w", dim=DIM, dtype="int8", keep_fp=keep_fp) as c:
        for s in range(0, n, 4096):
            c.append_embeddings(rows[s:s + 4096])
        c.append_metadata([_record(i) for i in range(n)])
        c.flush_checkpoint()
    return rows


def _assert_equal_int8(j, t, q, top_k=10):
    jr = j.search_vectors(q, top_k=top_k)
    tr = t.search_vectors(q, top_k=top_k)
    assert len(jr) == len(tr)
    for jh, th in zip(jr, tr):
        (ji, js), (ti, ts) = _ids(jh), _ids(th)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("mode", ["int8", "rescore", "rescore_cache"])
def test_int8_index_matches_jax_bit_for_bit(tmp_path, mode):
    from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
        UnifiedIndexConfig as JaxConfig,
    )

    rows = _write_int8(tmp_path / "a.rvdb")
    shutil.copy(tmp_path / "a.rvdb", tmp_path / "b.rvdb")
    kw = dict(int8_rescore=mode != "int8", int8_rescore_cache=mode == "rescore_cache")
    j = JaxIndex(JaxConfig(**kw)).load_unified_index(tmp_path / "a.rvdb", mode="a")
    t = UnifiedIndex(UnifiedIndexConfig(**kw), device="cpu").load_unified_index(tmp_path / "b.rvdb",
                                                                   mode="a")
    assert t._dev_x.dtype == torch.int8 and t.get_stats()["capacity"] == 4096
    assert (t._fp_cache is not None) == (mode == "rescore_cache")
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    q[0] = rows[1000]                                    # the tie group
    _assert_equal_int8(j, t, q)
    top = [h.metadata.row_id for h in t.search_vectors(q[:1], top_k=4)[0]]
    if mode == "int8":   # the quantized metric ties the duplicates exactly
        assert top == [7, 100, 1000, 2500]
    # deletes: a tie member, each query's best row, a scatter
    dead = [100] + [h[0].metadata.row_id for h in t.search_vectors(q, top_k=1)] + \
        list(range(0, N, 97))
    assert t.delete_rows(dead) == j.delete_rows(dead)
    _assert_equal_int8(j, t, q, top_k=20)
    # append within the capacity: in place, the same buffer
    new = rng.standard_normal((60, DIM)).astype(np.float32)
    new[3] = rows[1000]
    meta = [_record(N + i) for i in range(60)]
    buf = t._dev_x
    assert t.incremental_update(new, meta) == j.incremental_update(new, meta)
    assert t._dev_x is buf and t.ntotal == N + 60
    _assert_equal_int8(j, t, np.concatenate([q, new[:3]]), top_k=15)
    # append past the capacity: re-upload from the container
    big = rng.standard_normal((1200, DIM)).astype(np.float32)
    meta = [_record(N + 60 + i) for i in range(1200)]
    assert t.incremental_update(big, meta) == j.incremental_update(big, meta)
    assert t.get_stats()["capacity"] == 6144 and t.ntotal == N + 1260
    _assert_equal_int8(j, t, np.concatenate([q, big[-3:]]), top_k=12)
    np.testing.assert_array_equal(t.read_rows_f32(N - 5, N + 70),
                                  j.read_rows_f32(N - 5, N + 70))
    j.close()
    t.close()
    # reopened, both packages still answer the same
    j = JaxIndex(JaxConfig(**kw)).load_unified_index(tmp_path / "a.rvdb")
    t = UnifiedIndex(UnifiedIndexConfig(**kw), device="cpu").load_unified_index(tmp_path / "b.rvdb")
    _assert_equal_int8(j, t, q, top_k=10)
    j.close()
    t.close()


def test_int8_in_place_append_scores_as_a_reload(tmp_path):
    _write_int8(tmp_path / "a.rvdb", keep_fp=False)
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb", mode="a")
    new = np.random.default_rng(3).standard_normal((40, DIM)).astype(np.float32)
    t.incremental_update(new, [_record(N + i) for i in range(40)])
    x, s = t._dev_x[:N + 40].clone(), t._dev_scales[:N + 40].clone()
    t.close()
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb")
    assert torch.equal(t._dev_x[:N + 40], x) and torch.equal(t._dev_scales[:N + 40], s)
    t.close()


def test_flat8_sidecar_route(tmp_path):
    n = 10_240   # at or above the sidecar threshold
    _write_int8(tmp_path / "a.rvdb", n=n, keep_fp=False)
    side = tmp_path / "a.rvdb.flat8"
    j = JaxIndex().load_unified_index(tmp_path / "a.rvdb")   # writes the sidecar
    assert side.is_file()
    jax_bytes = side.read_bytes()
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb")
    assert side.read_bytes() == jax_bytes
    q = np.random.default_rng(2).standard_normal((4, DIM)).astype(np.float32)
    _assert_equal_int8(j, t, q)
    j.close()
    t.close()
    # the port writes the same sidecar when there is none
    side.unlink()
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb")
    assert side.read_bytes() == jax_bytes
    t.close()
    # a fresh sidecar is what the port serves: rows that differ from the
    # container's show up on the device
    other = np.random.default_rng(9).integers(-127, 128, (n, DIM), dtype=np.int8)
    scales = np.random.default_rng(9).uniform(0.01, 0.1, n).astype(np.float32)
    native.FlatInt8File.write(side, other, scales, normalized=True)
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb")
    np.testing.assert_array_equal(t._dev_x[:n].numpy(), other)
    np.testing.assert_array_equal(t._dev_scales[:n].numpy(), scales)
    t.close()
    # stale (another row count, or another normalize setting): the container wins
    for rows_, norm in ((other[:10], True), (other, False)):
        native.FlatInt8File.write(side, rows_, scales[:len(rows_)], normalized=norm)
        t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "a.rvdb")
        j = JaxIndex().load_unified_index(tmp_path / "a.rvdb")
        np.testing.assert_array_equal(t._dev_x[:n].numpy(), np.asarray(j._dev_x[:n]))
        np.testing.assert_array_equal(t._dev_scales[:n].numpy(),
                                      np.asarray(j._dev_scales[:n]))
        t.close()
        j.close()


def test_port_container_writes_int8_as_jax_does(tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((70, DIM)).astype(np.float32)
    for path, cls in ((tmp_path / "t.rvdb", IndexContainer), (tmp_path / "j.rvdb", JaxContainer)):
        with cls(path, "w", dim=DIM, dtype="int8", keep_fp=True) as c:
            c.append_embeddings(rows[:50])
            c.append_embeddings(rows[50:])
            c.append_metadata([_record(i) for i in range(70)])
            c.flush_checkpoint()
    with JaxContainer(tmp_path / "t.rvdb", "r") as a, JaxContainer(tmp_path / "j.rvdb", "r") as b:
        for x, y in zip(a.read_quantized(), b.read_quantized()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.read_fp_bits(), b.read_fp_bits())
        assert a.has_fp_rows and b.has_fp_rows
    with IndexContainer(tmp_path / "j.rvdb", "r") as c:
        np.testing.assert_array_equal(c.read_fp_rows(np.array([5, 3, 5])),
                                      native.bf16_to_f32(native.f32_to_bf16(rows[[5, 3, 5]])))
