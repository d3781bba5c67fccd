"""Parity of the port's IVF approximate mode with the JAX package's.

The same seeded numpy corpora go through ``ops.ann`` of both packages (the
JAX one on the CPU, as ``tests/test_ann.py`` runs it), through the ANN half
of both ``UnifiedIndex``es, the facades' index types, both CLIs and the
port's bench section. Builds: centroids within 1e-5, the bucket table, the
tail and the report equal. Searches over one JAX-built state carried across
as numpy: ids equal; int8 scores equal to the port's eager reference bit for
bit and within 2 ulps of the jitted JAX search (which multiplies by the
reciprocal of the query scale); float scores tie-aware within 5e-4.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intelligent_video_analysis_retrieval_system_tpu.index import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.index import (
    UnifiedIndex as JaxIndex,
)
from intelligent_video_analysis_retrieval_system_tpu.index import (
    UnifiedIndexConfig as JaxConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.ops import ann as jann
from intelligent_video_analysis_retrieval_system_tpu.ops.quant import (
    quantize_rows_int8,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
    ivf_candidate_reference,
    tie_aware_equal,
)

torch.set_num_threads(2)

ULP2 = 2  # int8 scores against the jitted JAX search


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_clusters=32, noise=0.35):
    centers = _normed(rng, n_clusters, d)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + (noise / d**0.5) * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _state(jstate) -> ann.IVFState:
    """A JAX-built state carried across as numpy."""
    return ann.IVFState(
        centroids=torch.from_numpy(np.array(jstate.centroids, np.float32)),
        bucket_ids=torch.from_numpy(np.array(jstate.bucket_ids, np.int32)),
        tail_ids=torch.from_numpy(np.array(jstate.tail_ids, np.int32)),
        tail_count=int(jstate.tail_count), ann_rows=int(jstate.ann_rows))


def _assert_build_equal(jstate, jrep, state, rep):
    np.testing.assert_allclose(state.centroids.numpy(), np.asarray(jstate.centroids), atol=1e-5)
    np.testing.assert_array_equal(state.bucket_ids.numpy(), np.asarray(jstate.bucket_ids))
    np.testing.assert_array_equal(state.tail_ids.numpy(), np.asarray(jstate.tail_ids))
    assert state.tail_count == int(jstate.tail_count)
    assert state.ann_rows == jstate.ann_rows
    assert rep._asdict() == jrep._asdict()


def _assert_buckets_near(jstate, state, x):
    """Bucket tables equal but for slots whose rows' similarities to the
    bucket's centroid are within 1e-6 of each other: two rows that near-tie
    (the products round differently in XLA and in torch) may trade places,
    and at a full bucket the spill."""
    jb, tb = np.asarray(jstate.bucket_ids), state.bucket_ids.numpy()
    cent = np.asarray(jstate.centroids, np.float64)
    for c in np.nonzero((jb != tb).any(axis=1))[0]:
        diff = jb[c] != tb[c]
        ids_j, ids_t = jb[c][diff], tb[c][diff]
        assert (ids_j >= 0).all() and (ids_t >= 0).all()
        sj = np.sort(x[ids_j].astype(np.float64) @ cent[c])
        st = np.sort(x[ids_t].astype(np.float64) @ cent[c])
        np.testing.assert_allclose(st, sj, atol=1e-6)
    assert (jb != tb).sum() <= 8


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def corpus():
    """The clustered corpus of tests/test_ann.py and queries near its rows."""
    rng = np.random.default_rng(7)
    x = _clustered(rng, 4096, 64)
    picks = rng.choice(len(x), size=20, replace=False)
    q = x[picks] + (0.5 / 64**0.5) * rng.standard_normal((20, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows, scales = quantize_rows_int8(x)
    return x, q, rows, scales


@pytest.fixture(scope="module")
def builds(corpus):
    x, _, rows, scales = corpus
    jf = jann.build_ivf(jnp.asarray(x), len(x), nlist=64, kmeans_iters=6, seed=0)
    tf = ann.build_ivf(torch.from_numpy(x), len(x), nlist=64, kmeans_iters=6, seed=0)
    j8 = jann.build_ivf(jnp.asarray(rows), len(x), x_scales=jnp.asarray(scales), nlist=64,
                        kmeans_iters=4)
    t8 = ann.build_ivf(torch.from_numpy(rows), len(x), x_scales=torch.from_numpy(scales),
                       nlist=64, kmeans_iters=4)
    return {"float32": (jf, tf), "int8": (j8, t8)}


# ---------------------------------------------------------------------------
# sizing helpers and constants
# ---------------------------------------------------------------------------


def test_constants_match_jax():
    for name in ("TAIL_MAX", "_SEL_CHUNK", "_MAX_PROGRAM_B", "_GATHER_BUDGET", "_ASSIGN_CHUNK"):
        assert getattr(ann, name) == getattr(jann, name), name


@pytest.mark.parametrize("n", [0, 1, 100, 4096, 10_000, 65_536, 1_000_000, 10_000_000, 10**9])
def test_default_nlist_matches_jax(n):
    assert ann.default_nlist(n) == jann.default_nlist(n)


@pytest.mark.parametrize("geom", [(8192, 2560, 768, 32, 1), (8192, 2560, 768, 32, 2),
                                  (64, 256, 64, 8, 4), (8192, 1920, 768, 16, 1),
                                  (8192, 1920, 768, 64, 1), (4096, 384, 768, 64, 2),
                                  (16384, 4096, 1024, 128, 4)])
def test_max_program_b_matches_jax(geom):
    assert ann._max_program_b(*geom) == jann._max_program_b(*geom)


@pytest.mark.parametrize("b", [0, 1, 2, 3, 5, 8, 9, 16, 17, 100])
def test_bucket_b_ann_matches_jax(b):
    assert ann._bucket_b_ann(b) == jann._bucket_b_ann(b)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_matches_jax(builds, dtype):
    (js, jr), (ts, tr) = builds[dtype]
    _assert_build_equal(js, jr, ts, tr)


def test_build_partition_invariant_and_geometry(corpus, builds):
    x = corpus[0]
    state, report = builds["float32"][1]
    bucket = state.bucket_ids.numpy()
    tail = state.tail_ids.numpy()[:state.tail_count]
    ids = np.concatenate([bucket[bucket >= 0].ravel(), tail])
    assert sorted(ids.tolist()) == list(range(len(x)))
    assert report.nlist == 64 and report.bucket_cap % 128 == 0
    np.testing.assert_allclose(np.linalg.norm(state.centroids.numpy(), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_build_top_a_equals_the_stable_sort(k):
    """The assignment's fast top-A gives what topk_lowest_index_first gives,
    rows with tied scores (across and at the k-th place) included."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_lowest_index_first,
    )

    rng = np.random.default_rng(k)
    s = torch.from_numpy(rng.integers(0, 6, size=(64, 9)).astype(np.float32))
    s[::3] += torch.from_numpy(rng.random((22, 9)).astype(np.float32))   # some rows untied
    got, want = ann._topk_low(s, k), topk_lowest_index_first(s, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_build_twice_is_bit_equal(corpus):
    x = torch.from_numpy(corpus[0])
    a, ra = ann.build_ivf(x, nlist=64, kmeans_iters=3, seed=5)
    b, rb = ann.build_ivf(x, nlist=64, kmeans_iters=3, seed=5)
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.bucket_ids, b.bucket_ids)
    assert torch.equal(a.tail_ids, b.tail_ids) and ra == rb


def test_build_overflow_widens_like_jax():
    """More rows than slots at the first capacity: the build widens the
    buckets to twice their capacity and re-buckets, leftovers in the tail."""
    rng = np.random.default_rng(3)
    x = _clustered(rng, 17_000, 16, n_clusters=8)
    js, jr = jann.build_ivf(jnp.asarray(x), nlist=64, cap_factor=0.5, kmeans_iters=2)
    ts, tr = ann.build_ivf(torch.from_numpy(x), nlist=64, cap_factor=0.5, kmeans_iters=2)
    assert tr.bucket_cap == 256 and tr.leftover > 0
    assert tr._asdict() == jr._asdict() and ts.tail_count == int(js.tail_count)
    np.testing.assert_allclose(ts.centroids.numpy(), np.asarray(js.centroids), atol=1e-5)
    _assert_buckets_near(js, ts, x)


def test_build_pathological_single_direction_like_jax():
    rng = np.random.default_rng(1)
    base = _normed(rng, 1, 32)
    x = np.repeat(base, 600, axis=0) + 1e-4 * rng.standard_normal((600, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    js, jr = jann.build_ivf(jnp.asarray(x), len(x), nlist=64, cap_factor=1.0, kmeans_iters=3)
    ts, tr = ann.build_ivf(torch.from_numpy(x), len(x), nlist=64, cap_factor=1.0,
                           kmeans_iters=3)
    # near-identical rows make every assignment a near tie, so the two
    # builds' centroids part after the first Lloyd step: the geometry and
    # the partition hold, not the layout
    assert tr._asdict() == jr._asdict()
    for state in (js, ts):
        bucket = np.asarray(state.bucket_ids)
        tail = np.asarray(state.tail_ids)[:int(state.tail_count)]
        ids = np.concatenate([bucket[bucket >= 0].ravel(), tail])
        assert sorted(ids.tolist()) == list(range(len(x)))


def test_build_duplicated_rows_sort_like_jax():
    """Rows repeated exactly tie on (cluster, similarity): the port orders
    them by row id, the reference's multi-key sort as it runs on the CPU."""
    rng = np.random.default_rng(9)
    x = np.repeat(_clustered(rng, 700, 32, n_clusters=8), 3, axis=0)
    js, jr = jann.build_ivf(jnp.asarray(x), nlist=64, cap_factor=1.0, kmeans_iters=3)
    ts, tr = ann.build_ivf(torch.from_numpy(x), nlist=64, cap_factor=1.0, kmeans_iters=3)
    _assert_build_equal(js, jr, ts, tr)


# ---------------------------------------------------------------------------
# search over one JAX-built state
# ---------------------------------------------------------------------------


def _queries(q, b):
    return q[:b] if b <= len(q) else np.concatenate([q, q[:b - len(q)]])


@pytest.mark.parametrize("nprobe", [1, 8, 64])
@pytest.mark.parametrize("b", [1, 3, 8, 16, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_topk_matches_jax(corpus, builds, dtype, b, nprobe):
    x, q, rows, scales = corpus
    js = builds["float32"][0][0]
    state = _state(js)
    qq = _queries(q, b)
    k = 16 if dtype == "bfloat16" else 10
    if dtype == "int8":
        want = jann.ivf_topk(jnp.asarray(rows), js, jnp.asarray(qq), k=k, nprobe=nprobe,
                             x_scales=jnp.asarray(scales))
        got = ann.ivf_topk(torch.from_numpy(rows), state, torch.from_numpy(qq), k=k,
                           nprobe=nprobe, x_scales=torch.from_numpy(scales))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert _ulps(got.scores.numpy(), np.asarray(want.scores)) <= ULP2
        ref_s, ref_i = ivf_candidate_reference(
            torch.from_numpy(rows), state, torch.from_numpy(qq), k, nprobe, len(x),
            x_scales=torch.from_numpy(scales))
        for i in range(b):   # the eager quantizer, bit for bit
            np.testing.assert_array_equal(got.scores[i].numpy(), ref_s[i])
            tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(), ref_i[i], ref_s[i],
                            atol=0.0)
        return
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = jann.ivf_topk(jx, js, jnp.asarray(qq), k=k, nprobe=nprobe)
    got = ann.ivf_topk(tx, state, torch.from_numpy(qq), k=k, nprobe=nprobe)
    assert got.indices.dtype == torch.int64 and got.scores.shape == (b, k)
    for i in range(b):
        tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                        np.asarray(want.indices[i]), np.asarray(want.scores[i]))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ivf_topk_masks_like_jax(corpus, builds, dtype):
    """Tombstones, n_valid below the rows and tail appends, as in JAX."""
    x, q, rows, scales = corpus
    js = builds["float32"][0][0]
    js = jann.tail_append(js, list(range(len(x) - 8, len(x))))
    state = _state(js)
    deleted = np.zeros((len(x), 1), np.int8)
    deleted[np.arange(0, len(x), 7)] = 1
    n_valid = len(x) - 3
    for nprobe in (2, 64):
        kw = dict(k=10, nprobe=nprobe, n_valid=n_valid)
        if dtype == "int8":
            want = jann.ivf_topk(jnp.asarray(rows), js, jnp.asarray(q), x_scales=jnp.asarray(
                scales), deleted=jnp.asarray(deleted), **kw)
            got = ann.ivf_topk(torch.from_numpy(rows), state, torch.from_numpy(q),
                               x_scales=torch.from_numpy(scales),
                               deleted=torch.from_numpy(deleted), **kw)
            np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
            assert _ulps(got.scores.numpy(), np.asarray(want.scores)) <= ULP2
        else:
            want = jann.ivf_topk(jnp.asarray(x), js, jnp.asarray(q),
                                 deleted=jnp.asarray(deleted), **kw)
            got = ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(q),
                               deleted=torch.from_numpy(deleted), **kw)
            for i in range(len(q)):
                tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                                np.asarray(want.indices[i]), np.asarray(want.scores[i]))
        ids = got.indices.numpy()
        assert not (deleted[ids.ravel(), 0]).any() and ids.max() < n_valid


def test_ivf_topk_k_above_candidates_and_empty_corpus(corpus, builds):
    x, q, _, _ = corpus
    js = builds["float32"][0][0]
    state = _state(js)
    want = jann.ivf_topk(jnp.asarray(x), js, jnp.asarray(q[:2]), k=300, nprobe=1)
    got = ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(q[:2]), k=300, nprobe=1)
    assert got.scores.shape == (2, 300)
    np.testing.assert_array_equal(np.isfinite(got.scores.numpy()),
                                  np.isfinite(np.asarray(want.scores)))
    fin = np.isfinite(got.scores.numpy())
    np.testing.assert_allclose(got.scores.numpy()[fin], np.asarray(want.scores)[fin], atol=5e-4)
    empty = ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(q), k=5, nprobe=4,
                         n_valid=0)
    assert empty.scores.shape == (len(q), 0) and empty.indices.shape == (len(q), 0)


def test_full_probe_is_exact(corpus, builds):
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import (
        topk_masked_reference,
    )

    x, q, _, _ = corpus
    state = builds["float32"][1][0]
    got = ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(q), k=10, nprobe=64)
    want = topk_masked_reference(torch.from_numpy(x), torch.from_numpy(q), 10, len(x))
    for i in range(len(q)):
        tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                        want.indices[i].numpy(), want.scores[i].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# tail, dedup, batching
# ---------------------------------------------------------------------------


def test_dedup_probes_matches_jax():
    from jax import jit

    rng = np.random.default_rng(0)
    for probes, nlist, u_slots in [(np.array([[3, 1, 3], [1, 2, 2], [7, 3, 1]]), 8, 9),
                                   (rng.integers(0, 4, size=(8, 3)), 4, 4),
                                   (rng.integers(0, 64, size=(16, 8)), 64, 64)]:
        want = jit(jann._dedup_probes, static_argnums=(1, 2))(
            jnp.asarray(probes, jnp.int32), nlist, u_slots)
        got = ann._dedup_probes(torch.from_numpy(probes).long(), nlist, u_slots)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tail_append_matches_jax_and_overflows(corpus, builds):
    x, q, _, _ = corpus
    js = builds["float32"][0][0]
    state = _state(js)
    new = np.concatenate([x, q[:3]]).astype(np.float32)
    ids = [len(x), len(x) + 1, len(x) + 2]
    js2, ts2 = jann.tail_append(js, ids), ann.tail_append(state, ids)
    assert state.tail_count == int(js.tail_count)      # the given state is unchanged
    np.testing.assert_array_equal(ts2.tail_ids.numpy(), np.asarray(js2.tail_ids))
    assert ts2.tail_count == int(js2.tail_count) and ts2.ann_rows == js2.ann_rows
    got = ann.ivf_topk(torch.from_numpy(new), ts2, torch.from_numpy(q[:3]), k=1, nprobe=1)
    np.testing.assert_array_equal(got.indices[:, 0].numpy(), ids)
    with pytest.raises(OverflowError):
        ann.tail_append(state, list(range(ann.TAIL_MAX + 1)))
    assert ann.tail_append(state, []) is state


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_batched_equals_single(corpus, builds, dtype):
    x, q, rows, scales = corpus
    state = builds["float32"][1][0]
    tx = torch.from_numpy(rows if dtype == "int8" else x)
    kw = {"x_scales": torch.from_numpy(scales)} if dtype == "int8" else {}
    qb = torch.from_numpy(q[:16])
    got = ann.ivf_topk(tx, state, qb, k=10, nprobe=8, **kw)
    for i in range(16):
        one = ann.ivf_topk(tx, state, qb[i:i + 1], k=10, nprobe=8, **kw)
        assert set(got.indices[i].tolist()) == set(one.indices[0].tolist())
        np.testing.assert_array_equal(np.sort(got.scores[i].numpy()),
                                      np.sort(one.scores[0].numpy()))


def test_batched_own_mask_bf16_small_nprobe(corpus, builds):
    """The union searcher's phase B must gather ``own``: without it 5 of
    these 8 queries differ from B=1 (the reference's recorded case)."""
    x, q, _, _ = corpus
    state = builds["float32"][1][0]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qb = torch.from_numpy(q[:8])
    got = ann.ivf_topk(xb, state, qb, k=16, nprobe=2)
    for i in range(8):
        one = ann.ivf_topk(xb, state, qb[i:i + 1], k=16, nprobe=2)
        assert set(got.indices[i].tolist()) == set(one.indices[0].tolist()), i
        np.testing.assert_allclose(np.sort(got.scores[i].numpy()),
                                   np.sort(one.scores[0].numpy()), atol=1e-5)


def test_batch_composition_invariance(corpus, builds):
    x, q, _, _ = corpus
    state = builds["float32"][1][0]
    tx = torch.from_numpy(x)
    a = ann.ivf_topk(tx, state, torch.from_numpy(q[[0, 1, 2, 3]]), k=5, nprobe=8)
    b = ann.ivf_topk(tx, state, torch.from_numpy(q[[0, 9, 12, 15]]), k=5, nprobe=8)
    assert a.indices[0].tolist() == b.indices[0].tolist()
    assert torch.equal(a.scores[0], b.scores[0])


def test_call_counter_counts_searcher_runs(corpus, builds):
    x, q, _, _ = corpus
    state = builds["float32"][1][0]
    before = ann.ivf_topk.calls
    ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(q[:1]), k=5, nprobe=4)
    ann.ivf_topk(torch.from_numpy(x), state, torch.from_numpy(_queries(q, 20)), k=5, nprobe=4)
    assert ann.ivf_topk.calls == before + 3    # 20 queries: two slices of 16


# ---------------------------------------------------------------------------
# UnifiedIndex: the ANN half against the JAX index
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big_corpus():
    rng = np.random.default_rng(11)
    x = _clustered(rng, 2048, 32)
    q = x[rng.choice(2048, 4, replace=False)]
    return x, q


def _write(path, x, dtype="float32"):
    with JaxContainer(path, "w", dim=x.shape[1], dtype=dtype) as c:
        c.append_embeddings(x)
        c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i, "row_id": i}
                           for i in range(len(x))])
        c.flush_checkpoint()


def _cfg(cls, **kw):
    args = dict(ann=True, ann_nlist=64, ann_nprobe=64)
    args.update(kw)
    return cls(**args)


def _pair(tmp_path, x, dtype="float32", **kw):
    """The same container opened by each package (each builds its own)."""
    _write(tmp_path / "j.rvdb", x, dtype)
    shutil.copy(tmp_path / "j.rvdb", tmp_path / "t.rvdb")
    j = JaxIndex(_cfg(JaxConfig, **kw)).load_unified_index(tmp_path / "j.rvdb", mode="a")
    t = UnifiedIndex(_cfg(UnifiedIndexConfig, **kw), device="cpu").load_unified_index(
        tmp_path / "t.rvdb", mode="a")
    return j, t


def _hits(hits):
    return [h.metadata.row_id for h in hits], [h.similarity_score for h in hits]


def _same(j, t, q, top_k=5, dtype="float32", **kw):
    for hj, ht in zip(j.search_vectors(q, top_k=top_k, **kw),
                      t.search_vectors(q, top_k=top_k, **kw)):
        (ij, sj), (it, st) = _hits(hj), _hits(ht)
        if dtype == "int8":
            assert it == ij and _ulps(st, sj) <= ULP2
        else:
            tie_aware_equal(it, st, ij, sj)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_index_builds_restores_and_serves_like_jax(tmp_path, big_corpus, dtype):
    """Build on open (recall guard included), full-probe exactness, the
    persisted group and a default-config reopen that restores it."""
    x, q = big_corpus
    j, t = _pair(tmp_path, x, dtype)
    assert j.ann_active and t.ann_active
    assert t.get_stats()["ann"] == j.get_stats()["ann"]
    if dtype == "int8":
        np.testing.assert_array_equal(t._ann.bucket_ids.numpy(), np.asarray(j._ann.bucket_ids))
    else:
        _assert_buckets_near(j._ann, t._ann, x)
    _same(j, t, q, dtype=dtype)
    _same(j, t, q, dtype=dtype, exact=True)
    for hits_a, hits_e in zip(t.search_vectors(q, top_k=5),
                              t.search_vectors(q, top_k=5, exact=True)):
        assert _hits(hits_a)[0] == _hits(hits_e)[0]
    j.close()
    t.close()
    j = JaxIndex().load_unified_index(tmp_path / "j.rvdb")
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "t.rvdb")
    assert t.ann_active and t.config.ann_nprobe == j.config.ann_nprobe
    assert t.get_stats()["ann"] == j.get_stats()["ann"]
    _same(j, t, q, dtype=dtype)
    j.close()
    t.close()


def test_index_append_delete_compact_like_jax(tmp_path, big_corpus):
    x, q = big_corpus
    j, t = _pair(tmp_path, x)
    new = _normed(np.random.default_rng(99), 4, x.shape[1])
    meta = [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i} for i in range(4)]
    for idx in (j, t):
        idx.incremental_update(new, meta)      # capacity is full: a reload, restore + tail
    assert t.ann_active and t.get_stats()["ann"] == j.get_stats()["ann"]
    got = [h[0].metadata.row_id for h in t.search_vectors(new, top_k=1)]
    assert got == [len(x) + i for i in range(4)]
    _same(j, t, q)
    top = t.search_vectors(q[:1], top_k=3)[0]
    for idx in (j, t):
        idx.delete_rows([h.metadata.row_id for h in top])
    assert not {h.metadata.row_id for h in t.search_vectors(q[:1], top_k=5)[0]} & \
        {h.metadata.row_id for h in top}
    _same(j, t, q)
    for idx in (j, t):
        assert idx.compact()["compacted"] == 3
        assert idx.ann_active                  # rebuilt on the post-compact reload
    _same(j, t, q)
    j.close()
    t.close()


def test_index_in_place_append_rides_tail(tmp_path, big_corpus):
    x, q = big_corpus
    j, t = _pair(tmp_path, x[:2000])
    assert t._capacity > 2004
    new = _normed(np.random.default_rng(5), 3, x.shape[1])
    meta = [{"folder": "m", "image": f"{i}.jpg", "frame_id": i} for i in range(3)]
    for idx in (j, t):
        idx.incremental_update(new, meta)
    assert t._ann.tail_count == int(j._ann.tail_count) >= 3
    np.testing.assert_array_equal(t._ann.tail_ids.numpy(), np.asarray(j._ann.tail_ids))
    assert [h[0].metadata.row_id for h in t.search_vectors(new, top_k=1)] == [2000, 2001, 2002]
    j.close()
    t.close()


def test_index_routing_and_nprobe_override(tmp_path, big_corpus):
    x, q = big_corpus
    idx = UnifiedIndex(_cfg(UnifiedIndexConfig, ann_max_batch=2, ann_target_recall=None),
                       device="cpu")
    _write(tmp_path / "r.rvdb", x)
    idx.load_unified_index(tmp_path / "r.rvdb", mode="a")
    qs = x[np.random.default_rng(3).choice(len(x), 6, replace=False)]
    start = ann.ivf_topk.calls

    def calls():
        return ann.ivf_topk.calls - start

    big = idx.search_vectors(qs, top_k=3)                       # 6 > cap 2: dense
    assert calls() == 0
    assert [_hits(h)[0] for h in big] == [_hits(h)[0] for h in
                                          idx.search_vectors(qs, top_k=3, exact=True)]
    idx.search_vectors(qs[:2], top_k=3)                         # within the cap: probes
    assert calls() == 1
    idx.search_vectors(qs, top_k=3, nprobe=64)                  # explicit: probes
    assert calls() == 2
    idx.search_vectors(qs[:1], top_k=3, exact=True)             # exact always wins
    assert calls() == 2 and idx.config.ann_nprobe == 64
    with pytest.raises(ValueError, match="nprobe"):
        idx.search_vectors(qs[:1], top_k=3, nprobe=0)
    idx.close()


def test_index_tune_and_crossover_persist_like_jax(tmp_path, big_corpus):
    x, _ = big_corpus
    j, t = _pair(tmp_path, x, ann_nprobe=1, ann_target_recall=None)
    rj = j.tune_nprobe(target_recall=0.95, sample=12, top_k=5, seed=4)
    rt = t.tune_nprobe(target_recall=0.95, sample=12, top_k=5, seed=4)
    assert rt == rj and t.config.ann_nprobe == rt["nprobe"] and rt["ladder"][0][0] == 4
    cx = t.measure_ann_crossover(batch_sizes=(1, 2, 4), repeats=1)
    assert not cx["raced_mutation"] and t.config.ann_max_batch == cx["max_batch"]
    wins = [r["batch"] for r in cx["ladder"] if r["ann_ms"] < r["dense_ms"]]
    assert cx["max_batch"] == (wins[-1] if wins else 0)
    j.close()
    t.close()
    re = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "t.rvdb")
    assert re.ann_active and re.config.ann_nprobe == rt["nprobe"]
    assert re.config.ann_max_batch == cx["max_batch"] and re._ann_crossover_measured
    re.close()
    with pytest.raises(RuntimeError, match="ANN not active"):
        UnifiedIndex(UnifiedIndexConfig(ann_restore=False), device="cpu").load_unified_index(
            tmp_path / "t.rvdb").tune_nprobe()


def test_index_recall_guard_like_jax(tmp_path):
    """A corpus without cluster structure: the guard climbs the ladder (as
    the JAX index does, to the same nprobe)."""
    x = _normed(np.random.default_rng(0), 2048, 32)
    j, t = _pair(tmp_path, x, ann_nlist=32, ann_nprobe=2, ann_max_batch=4)
    assert t.config.ann_nprobe == j.config.ann_nprobe > 2
    report = t.build_ann(check_recall=True)
    assert report["recall_check"]["nprobe"] == t.config.ann_nprobe
    j.close()
    t.close()


def test_index_restore_flag_drop_and_overflow_append(tmp_path, big_corpus):
    x, _ = big_corpus
    _, t = _pair(tmp_path, x)
    t.close()
    path = tmp_path / "t.rvdb"
    off = UnifiedIndex(UnifiedIndexConfig(ann_restore=False), device="cpu")
    assert not off.load_unified_index(path).ann_active
    off.close()
    re = UnifiedIndex(device="cpu").load_unified_index(path, mode="a")
    assert re.ann_active
    re._container.drop_ann()                  # nothing to restore after the reload
    new = _normed(np.random.default_rng(3), 4, x.shape[1])
    re.config.ann = True
    re.incremental_update(new, [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i}
                                for i in range(4)])
    assert not re.ann_active, "an overflow append ran a synchronous ANN rebuild"
    re.build_ann(check_recall=False)
    assert re.ann_active
    out = re.drop_ann()
    assert out == {"was_active": True, "persisted_removed": True} and not re.ann_active
    re.close()
    assert not UnifiedIndex(device="cpu").load_unified_index(path).ann_active


def test_index_off_lock_build_races(tmp_path, big_corpus, monkeypatch):
    """Appends during build_ann ride the fresh tail; a remap retries, three
    remaps in a row give up and keep the serving structure; an ANN swap or
    a mutation during tune_nprobe's ladder is not installed."""
    x, q = big_corpus
    idx = UnifiedIndex(_cfg(UnifiedIndexConfig, ann_target_recall=None), device="cpu")
    _write(tmp_path / "o.rvdb", x[:2032])
    idx.load_unified_index(tmp_path / "o.rvdb", mode="a")
    real = ann.build_ivf
    calls = []

    def patch(side_effect):
        calls.clear()

        def wrapper(*args, **kwargs):
            calls.append(1)
            side_effect(len(calls))
            return real(*args, **kwargs)
        monkeypatch.setattr(ann, "build_ivf", wrapper)

    new = _normed(np.random.default_rng(17), 3, x.shape[1])
    patch(lambda n: n == 1 and idx.incremental_update(
        new, [{"folder": "mid", "image": f"m{i}.jpg", "frame_id": i} for i in range(3)]))
    idx.build_ann(check_recall=False)
    assert len(calls) == 1 and idx._ann.tail_count >= 3
    assert [h[0].metadata.row_id for h in idx.search_vectors(new, top_k=1)] == [2032, 2033,
                                                                                  2034]
    patch(lambda n: n == 1 and setattr(idx, "_rows_gen", idx._rows_gen + 1))
    idx.build_ann(check_recall=False)
    assert len(calls) == 2 and idx.ann_active
    old = idx._ann
    patch(lambda n: setattr(idx, "_rows_gen", idx._rows_gen + 1))
    with pytest.raises(RuntimeError, match="mid-build"):
        idx.build_ann(check_recall=False)
    assert len(calls) == 3 and idx._ann is old
    monkeypatch.setattr(ann, "build_ivf", real)
    idx.config.ann_nprobe = 4
    search = idx.search_vectors
    for mutate in (lambda: setattr(idx, "generation", idx.generation + 1),
                   lambda: idx.build_ann(check_recall=False), idx.drop_ann):
        state = {"done": False}

        def racing(*args, _mutate=mutate, _state=state, **kwargs):
            out = search(*args, **kwargs)
            if not _state["done"]:
                _state["done"] = True
                _mutate()
            return out

        monkeypatch.setattr(idx, "search_vectors", racing)
        if not idx.ann_active:
            idx.build_ann(check_recall=False)
        rep = idx.tune_nprobe(target_recall=0.99, sample=8, top_k=5)
        assert rep["raced_mutation"] is True and idx.config.ann_nprobe == 4
    idx.close()


# ---------------------------------------------------------------------------
# a persisted ann group opens in the other package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persisted_group_opens_in_the_other_package(tmp_path, big_corpus, writer):
    x, q = big_corpus
    _write(tmp_path / "p.rvdb", x)
    cfg = dict(ann_nprobe=4, ann_target_recall=None)
    if writer == "jax":
        JaxIndex(_cfg(JaxConfig, **cfg)).load_unified_index(tmp_path / "p.rvdb",
                                                            mode="a").close()
    else:
        UnifiedIndex(_cfg(UnifiedIndexConfig, **cfg), device="cpu").load_unified_index(
            tmp_path / "p.rvdb", mode="a").close()
    shutil.copy(tmp_path / "p.rvdb", tmp_path / "p2.rvdb")
    j = JaxIndex().load_unified_index(tmp_path / "p.rvdb")
    t = UnifiedIndex(device="cpu").load_unified_index(tmp_path / "p2.rvdb")
    assert j.ann_active and t.ann_active and t.config.ann_nprobe == j.config.ann_nprobe == 4
    np.testing.assert_array_equal(t._ann.bucket_ids.numpy(), np.asarray(j._ann.bucket_ids))
    for hj, ht in zip(j.search_vectors(q, top_k=5), t.search_vectors(q, top_k=5)):
        assert _hits(ht)[0] == _hits(hj)[0]
    j.close()
    t.close()


# ---------------------------------------------------------------------------
# facade index types, CLI, bench
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index_type", ["flat", "exact", "IndexFlatIP", "IndexFlatL2", "ivf",
                                        "ann", "IndexIVFFlat", "IndexHNSW", "IndexLSH",
                                        "bogus"])
def test_facade_index_types_match_jax(tmp_path, index_type):
    from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
        create_system as jax_create_system,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        create_system,
    )

    over = {"index": {"index_type": index_type, "ann_nprobe": 8},
            "paths": {"cache_dir": str(tmp_path)}}
    want = jax_create_system(**over)._index_config()
    got = create_system(torch_device="cpu", **over)._index_config()
    for field in ("ann", "ann_nlist", "ann_nprobe", "ann_max_batch", "ann_target_recall",
                  "ann_restore", "temporal_window"):
        assert getattr(got, field) == getattr(want, field), field
    zero = create_system(torch_device="cpu", index={"index_type": "ivf",
                                                    "ann_target_recall": 0})._index_config()
    assert zero.ann_target_recall is None


def test_facade_load_builds_and_self_tunes_like_jax(tmp_path, big_corpus):
    from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
        create_system as jax_create_system,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        create_system,
    )

    x, q = big_corpus
    _write(tmp_path / "j.rvdb", x)
    shutil.copy(tmp_path / "j.rvdb", tmp_path / "t.rvdb")
    over = {"index": {"index_type": "IndexIVFFlat", "ann_nlist": 64},
            "paths": {"cache_dir": str(tmp_path)}}
    js, ts = jax_create_system(**over), create_system(torch_device="cpu", **over)
    js.load_system(tmp_path / "j.rvdb", writable=True)
    ts.load_system(tmp_path / "t.rvdb", writable=True)
    assert ts.index.ann_active and ts.get_system_stats()["index"]["ann_active"]
    assert ts.index.config.ann_nprobe == js.index.config.ann_nprobe
    _same(js.index, ts.index, q)
    js.cleanup()
    ts.cleanup()


def _cli_container(tmp_path, big_corpus):
    x, _ = big_corpus
    _write(tmp_path / "j.rvdb", x)
    shutil.copy(tmp_path / "j.rvdb", tmp_path / "t.rvdb")
    return tmp_path / "j.rvdb", tmp_path / "t.rvdb"


@pytest.mark.parametrize("extra", [["--search", "ann"], ["--search", "ann", "--nprobe", "16"],
                                   ["--tune-nprobe", "0.9"]])
def test_cli_evaluate_ann_matches_jax(tmp_path, big_corpus, monkeypatch, capsys, extra):
    from intelligent_video_analysis_retrieval_system_tpu import cli as jcli
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    jpath, tpath = _cli_container(tmp_path, big_corpus)
    monkeypatch.chdir(tmp_path)
    args = ["--queries", "16", "--noise", "0.3"] + extra
    assert jcli.main(["evaluate", str(jpath)] + args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["evaluate", str(tpath)] + args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want["index"] = got["index"]
    assert got["search"] == "ann" and "ann" in got
    assert got.keys() == want.keys()
    for key, value in want.items():   # float32 scores: the products round apart
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=1e-6), key
        else:
            assert got[key] == value, key


def test_cli_tune_matches_jax(tmp_path, big_corpus, monkeypatch, capsys):
    from intelligent_video_analysis_retrieval_system_tpu import cli as jcli
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    jpath, tpath = _cli_container(tmp_path, big_corpus)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["tune", str(tpath), "--device", "cpu"]) == 1
    assert "pass --build" in capsys.readouterr().out
    assert jcli.main(["tune", str(jpath), "--build", "--skip-crossover"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert cli.main(["tune", str(tpath), "--build", "--skip-crossover", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert cli.main(["tune", str(tpath), "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "ann_max_batch=" in said and "persisted" in said
    re = UnifiedIndex(device="cpu").load_unified_index(tpath)
    assert re.ann_active and re._ann_crossover_measured
    re.close()


def test_bench_ivf_section_small(monkeypatch):
    """The bench's IVF section at 4096 rows on the CPU: its keys, and every
    answer equal to the plain candidate-set reference bit for bit."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.bench import headline
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )

    checked = []

    def verify(section, x, scales, n_valid, queries, result, ivf=None):
        state, nprobe = ivf
        ref_s, ref_i = ivf_candidate_reference(x, state, queries, result.indices.shape[1],
                                               nprobe, n_valid, x_scales=scales)
        for i in range(len(queries)):
            np.testing.assert_array_equal(result.scores[i].numpy(), ref_s[i])
            tie_aware_equal(result.indices[i].numpy(), result.scores[i].numpy(), ref_i[i],
                            ref_s[i], atol=0.0)
        checked.append((section, nprobe, len(queries)))

    embedder = CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu")
    out = headline.ivf_10M(torch.device("cpu"), embedder, 4096, verify=verify)
    assert set(out) == {"ivf_build_10M_s", "ivf_nlist", "ivf_bucket_cap",
                        "latency_10M_int8_ivf_np16_p50_ms", "latency_10M_int8_ivf_np64_p50_ms",
                        "latency_10M_int8_sharded_ivf_np32_p50_ms"}
    assert out["ivf_nlist"] == ann.default_nlist(4096)
    # the sharded IVF point: the same state on a one-device mesh, nprobe 32
    assert checked == [("ivf_10M", 16, 100), ("ivf_10M", 64, 100),
                       ("sharded_ivf_10M", 32, 100)]
    assert "ivf_10M" not in headline.NOT_PORTED
