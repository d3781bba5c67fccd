"""Parity of the port's sharded IVF (``parallel/sharded_ann.py``) with the
JAX package's, on the CPU.

The twin of ``tests/test_sharded_ann.py``. One global ``IVFState`` is built
once by the JAX package and carried across as numpy arrays, so both
packages partition the same state: the partitions (bucket tables and tails
per shard) must equal JAX's exactly. ``sharded_ivf_topk`` over the port's
mesh of ``["cpu"] * 8`` must equal the port's single-device ``ivf_topk``
with the same state (int8 bit for bit, float tie-aware to 1e-6) and JAX's
``sharded_ivf_topk`` (ids; int8 scores within 2 ulps of the jitted JAX
program), and at full probe the dense sharded search. Then the mesh-backed
``UnifiedIndex``'s ANN life: a build over the shards equal to the
single-device build bit for bit, backend-portable persistence, tail appends,
tombstones, an overflow re-shard, routing by ``ann_max_batch``; and the
facade over a mesh behind the REST twin.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index import IndexContainer as JaxContainer
from intelligent_video_analysis_retrieval_system_tpu.ops import ann as jann
from intelligent_video_analysis_retrieval_system_tpu.ops.quant import quantize_rows_int8
from intelligent_video_analysis_retrieval_system_tpu.parallel import MeshSpec as JaxMeshSpec
from intelligent_video_analysis_retrieval_system_tpu.parallel import create_mesh as jax_mesh
from intelligent_video_analysis_retrieval_system_tpu.parallel import sharded_ann as jsa
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import ann
from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import TILE_N
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import MeshSpec, create_mesh
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import sharded_ann as tsa
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
    place_rows,
    sharded_topk,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

N_DEV = 8
N, D = 4096, 32
N_PAD = -(-N // (N_DEV * TILE_N)) * N_DEV * TILE_N
SR = N_PAD // N_DEV


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_clusters=32, noise=0.35):
    centers = _normed(rng, n_clusters, d)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + (noise / d**0.5) * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(js) -> ann.IVFState:
    """A JAX-built state carried across as numpy."""
    return ann.IVFState(centroids=_t(np.array(js.centroids, np.float32)),
                        bucket_ids=_t(np.array(js.bucket_ids, np.int32)),
                        tail_ids=_t(np.array(js.tail_ids, np.int32)),
                        tail_count=int(js.tail_count), ann_rows=int(js.ann_rows))


def _same(got, want, int8: bool) -> None:
    """Equal ids, and scores bit for bit (int8) or tie-aware to 1e-6."""
    if int8:
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.scores, want.scores)
        return
    for i in range(got.indices.shape[0]):
        tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                        want.indices[i].numpy(), want.scores[i].numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(MeshSpec(axis_names=("index",), shape=(N_DEV,)), devices=["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(JaxMeshSpec(axis_names=("index",), shape=(N_DEV,)))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    x = _clustered(rng, N, D)
    picks = rng.choice(N, size=6, replace=False)
    q = x[picks] + (0.5 / D**0.5) * rng.standard_normal((6, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.fixture(scope="module")
def placed(corpus, mesh):
    """The padded corpus, its shards, and one JAX-built global state (f32
    and int8) carried across."""
    x, _ = corpus
    host = np.zeros((N_PAD, D), np.float32)
    host[:N] = x
    q8, s8 = quantize_rows_int8(x)
    h8 = np.zeros((N_PAD, D), np.int8)
    h8[:N] = q8
    hs = np.zeros((N_PAD,), np.float32)
    hs[:N] = s8
    js, _ = jann.build_ivf(jnp.asarray(host), n_rows=N, nlist=64, kmeans_iters=6, seed=0)
    js8, _ = jann.build_ivf(jnp.asarray(h8), n_rows=N, x_scales=jnp.asarray(hs), nlist=64,
                            kmeans_iters=6, seed=0)
    return {
        "x": _t(host), "xs": place_rows(mesh, _t(host), N_PAD),
        "x8": _t(h8), "s8": _t(hs), "x8s": place_rows(mesh, _t(h8), N_PAD),
        "s8s": place_rows(mesh, _t(hs), N_PAD),
        "jstate": js, "jstate8": js8, "state": _state(js), "state8": _state(js8),
        "host": host, "h8": h8, "hs": hs,
    }


class TestPartition:
    @pytest.mark.parametrize("which", ["state", "state8"])
    def test_partitions_equal_jax(self, placed, which):
        js = placed["j" + which]
        args = (np.asarray(js.bucket_ids), np.asarray(js.tail_ids), int(js.tail_count),
                N_DEV, SR)
        for got, want in zip(tsa.partition_ivf_host(*args), jsa.partition_ivf_host(*args)):
            np.testing.assert_array_equal(got, want)

    def test_placed_partition_equals_jax_sharded_arrays(self, placed, mesh, jmesh):
        sivf = tsa.make_sharded_ivf(mesh, "index", placed["state"], SR)
        jsivf = jsa.make_sharded_ivf(jmesh, "index", placed["jstate"], SR)
        nlist = int(placed["state"].bucket_ids.shape[0])
        jtables = np.asarray(jsivf.bucket_ids).reshape(N_DEV, nlist, -1)
        np.testing.assert_array_equal(np.stack([t.numpy() for t in sivf.bucket_ids]), jtables)
        np.testing.assert_array_equal(np.stack([t.numpy() for t in sivf.tail_ids]),
                                      np.asarray(jsivf.tail_ids))
        assert list(sivf.tail_counts) == np.asarray(jsivf.tail_counts).tolist()
        assert sivf.shard_rows == jsivf.shard_rows and sivf.ann_rows == jsivf.ann_rows

    def test_every_live_row_exactly_once(self, placed):
        st = placed["state"]
        tables, tails, tcounts = tsa.partition_ivf_host(
            st.bucket_ids.numpy(), st.tail_ids.numpy(), st.tail_count, N_DEV, SR)
        seen = []
        for s in range(N_DEV):
            local = tables[s][tables[s] >= 0]
            assert local.max(initial=-1) < SR
            seen.extend((local + s * SR).tolist())
            seen.extend((tails[s][:tcounts[s]] + s * SR).tolist())
        g = st.bucket_ids.numpy()
        expect = set(g[g >= 0].tolist()) | set(st.tail_ids.numpy()[:st.tail_count].tolist())
        assert len(seen) == len(set(seen)) and set(seen) == expect


class TestSearchEquality:
    @pytest.mark.parametrize("nprobe", [4, 16, 64])
    @pytest.mark.parametrize("int8", [False, True])
    def test_matches_single_device_and_jax(self, placed, corpus, mesh, jmesh, nprobe, int8):
        _, q = corpus
        key = "state8" if int8 else "state"
        sivf = tsa.make_sharded_ivf(mesh, "index", placed[key], SR)
        if int8:
            got = tsa.sharded_ivf_topk(mesh, placed["x8s"], sivf, _t(q), 10, nprobe=nprobe,
                                       n_valid=N, scales_sharded=placed["s8s"])
            ref = ann.ivf_topk(placed["x8"], placed[key], _t(q), 10, nprobe=nprobe, n_valid=N,
                               x_scales=placed["s8"])
        else:
            got = tsa.sharded_ivf_topk(mesh, placed["xs"], sivf, _t(q), 10, nprobe=nprobe,
                                       n_valid=N)
            ref = ann.ivf_topk(placed["x"], placed[key], _t(q), 10, nprobe=nprobe, n_valid=N)
        _same(got, ref, int8)
        # and JAX's sharded program over the same state
        rows = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("index", None))
        jsivf = jsa.make_sharded_ivf(jmesh, "index", placed["j" + key], SR)
        if int8:
            jres = jsa.sharded_ivf_topk(
                jmesh, jax.device_put(jnp.asarray(placed["h8"]), rows), jsivf, jnp.asarray(q),
                10, nprobe=nprobe, n_valid=N,
                scales_sharded=jax.device_put(jnp.asarray(placed["hs"][:, None]), rows))
            np.testing.assert_array_equal(got.indices.numpy(), np.asarray(jres.indices))
            np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(jres.scores),
                                            maxulp=2)
        else:
            jres = jsa.sharded_ivf_topk(jmesh, jax.device_put(jnp.asarray(placed["host"]), rows),
                                        jsivf, jnp.asarray(q), 10, nprobe=nprobe, n_valid=N)
            for i in range(len(q)):
                tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                                np.asarray(jres.indices)[i], np.asarray(jres.scores)[i],
                                atol=1e-6)

    def test_full_probe_equals_dense_sharded(self, placed, corpus, mesh):
        _, q = corpus
        sivf = tsa.make_sharded_ivf(mesh, "index", placed["state"], SR)
        got = tsa.sharded_ivf_topk(mesh, placed["xs"], sivf, _t(q), 10, nprobe=64, n_valid=N)
        want = sharded_topk(mesh, placed["xs"], _t(q), 10, N)
        for i in range(len(q)):
            tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                            want.indices[i].numpy(), want.scores[i].numpy(), atol=1e-5)

    def test_tombstones(self, placed, corpus, mesh):
        _, q = corpus
        dead_rows = np.random.default_rng(5).choice(N, 300, replace=False)
        mask = np.zeros((N_PAD, 1), np.int8)
        mask[dead_rows, 0] = 1
        sivf = tsa.make_sharded_ivf(mesh, "index", placed["state8"], SR)
        got = tsa.sharded_ivf_topk(mesh, placed["x8s"], sivf, _t(q), 10, nprobe=16, n_valid=N,
                                   deleted_sharded=place_rows(mesh, mask, N_PAD),
                                   scales_sharded=placed["s8s"])
        ref = ann.ivf_topk(placed["x8"], placed["state8"], _t(q), 10, nprobe=16, n_valid=N,
                           deleted=_t(mask), x_scales=placed["s8"])
        _same(got, ref, True)
        assert not set(got.indices.reshape(-1).tolist()) & set(dead_rows.tolist())

    def test_tail_appends(self, placed, mesh):
        extra = _normed(np.random.default_rng(8), 32, D)
        host = placed["host"].copy()
        host[N:N + 32] = extra
        xs2 = place_rows(mesh, _t(host), N_PAD)
        state2 = ann.tail_append(placed["state"], list(range(N, N + 32)))
        sivf = tsa.make_sharded_ivf(mesh, "index", placed["state"], SR)
        sivf2 = tsa.retarget_tail(sivf, mesh, "index", state2.tail_ids.numpy(),
                                  state2.tail_count)
        assert sivf2.bucket_ids is sivf.bucket_ids
        got = tsa.sharded_ivf_topk(mesh, xs2, sivf2, _t(extra[:4]), 5, nprobe=8, n_valid=N + 32)
        ref = ann.ivf_topk(_t(host), state2, _t(extra[:4]), 5, nprobe=8, n_valid=N + 32)
        _same(got, ref, False)
        assert got.indices[:, 0].tolist() == [N, N + 1, N + 2, N + 3]


class TestShardedBatchComposition:
    @pytest.mark.parametrize("nprobe", [2, 16])
    def test_batch_vs_single_query(self, placed, corpus, mesh, nprobe):
        _, q = corpus
        sivf = tsa.make_sharded_ivf(mesh, "index", placed["state"], SR)
        batch = tsa.sharded_ivf_topk(mesh, placed["xs"], sivf, _t(q), 10, nprobe=nprobe,
                                     n_valid=N)
        for i in range(len(q)):
            one = tsa.sharded_ivf_topk(mesh, placed["xs"], sivf, _t(q[i:i + 1]), 10,
                                       nprobe=nprobe, n_valid=N)
            tie_aware_equal(batch.indices[i].numpy(), batch.scores[i].numpy(),
                            one.indices[0].numpy(), one.scores[0].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh-backed index's ANN life
# ---------------------------------------------------------------------------


def _write(path, x, dtype="float32"):
    with JaxContainer(path, "w", dim=x.shape[1], dtype=dtype) as c:
        c.append_embeddings(x)
        c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i, "row_id": i}
                           for i in range(len(x))])
        c.flush_checkpoint()
    return path


@pytest.fixture(scope="module")
def small_corpus():
    rng = np.random.default_rng(21)
    x = _clustered(rng, 2048, D)
    return x, x[rng.choice(2048, 3, replace=False)]


def _ids(results):
    return [[h.metadata.row_id for h in hits] for hits in results]


class TestUnifiedIndexMeshANN:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_build_matches_single_device_ann(self, tmp_path, small_corpus, mesh, dtype):
        x, q = small_corpus
        path = _write(tmp_path / f"m_{dtype}.rvdb", x, dtype)
        cfg = dict(ann=True, ann_nlist=32, ann_nprobe=8, ann_target_recall=None)
        idx_m = UnifiedIndex(UnifiedIndexConfig(**cfg), device="cpu",
                             mesh=mesh).load_unified_index(path)
        idx_s = UnifiedIndex(UnifiedIndexConfig(**cfg), device="cpu").load_unified_index(path)
        try:
            assert idx_m.ann_active and idx_m._sharded.ann_active
            assert idx_m.get_stats()["ann"]["nlist"] == 32
            # the build over the shards is the single-device build, bit for bit
            for a, b in zip(idx_m._ann[:3], idx_s._ann[:3]):
                assert torch.equal(a, b)
            assert idx_m._ann[3:] == idx_s._ann[3:]
            rm, rs = idx_m.search_vectors(q, top_k=10), idx_s.search_vectors(q, top_k=10)
            assert [[(h.metadata.row_id, h.similarity_score) for h in hits] for hits in rm] == \
                [[(h.metadata.row_id, h.similarity_score) for h in hits] for hits in rs]
        finally:
            idx_m.close()
            idx_s.close()

    def test_full_probe_matches_exact(self, tmp_path, small_corpus, mesh):
        x, q = small_corpus
        path = _write(tmp_path / "fp.rvdb", x)
        idx = UnifiedIndex(UnifiedIndexConfig(ann=True, ann_nlist=32, ann_nprobe=32),
                           device="cpu", mesh=mesh).load_unified_index(path)
        assert _ids(idx.search_vectors(q, top_k=5)) == \
            _ids(idx.search_vectors(q, top_k=5, exact=True))
        idx.close()

    def test_persistence_is_backend_portable(self, tmp_path, small_corpus, mesh):
        x, q = small_corpus
        path = _write(tmp_path / "port.rvdb", x)
        cfg = UnifiedIndexConfig(ann=True, ann_nlist=32, ann_nprobe=8, ann_target_recall=None)
        idx_m = UnifiedIndex(cfg, device="cpu", mesh=mesh).load_unified_index(path, mode="a")
        rm = _ids(idx_m.search_vectors(q, top_k=5))
        idx_m.close()
        idx_s = UnifiedIndex(device="cpu").load_unified_index(path)      # no rebuild
        assert idx_s.ann_active and idx_s.config.ann_nprobe == 8
        assert _ids(idx_s.search_vectors(q, top_k=5)) == rm
        idx_s.close()
        idx_m2 = UnifiedIndex(device="cpu", mesh=mesh).load_unified_index(path)
        assert idx_m2.ann_active and idx_m2._sharded.ann_active
        assert _ids(idx_m2.search_vectors(q, top_k=5)) == rm
        idx_m2.close()

    def test_append_tail_and_delete(self, tmp_path, small_corpus, mesh):
        x, _ = small_corpus
        path = _write(tmp_path / "mut.rvdb", x)
        idx = UnifiedIndex(UnifiedIndexConfig(ann=True, ann_nlist=32, ann_nprobe=8),
                           device="cpu", mesh=mesh).load_unified_index(path, mode="a")
        new = _normed(np.random.default_rng(77), 4, D)
        idx.incremental_update(new, [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i}
                                     for i in range(4)])
        assert idx.ann_active and idx._sharded.ann_active and idx._ann.tail_count >= 4
        assert sum(idx._sharded._ann.tail_counts) == idx._ann.tail_count
        got = [h[0].metadata.row_id for h in idx.search_vectors(new, top_k=1)]
        assert got == [len(x) + i for i in range(4)]
        idx.delete_rows(got)
        for hits in idx.search_vectors(new, top_k=3):
            assert not {h.metadata.row_id for h in hits} & set(got)
        idx.close()

    def test_capacity_overflow_reshard_repartitions(self, tmp_path, mesh):
        rng = np.random.default_rng(31)
        n0 = N_DEV * TILE_N - 64
        x = _clustered(rng, n0, D)
        path = _write(tmp_path / "ovf.rvdb", x)
        idx = UnifiedIndex(UnifiedIndexConfig(ann=True, ann_nlist=32, ann_nprobe=8,
                                              ann_target_recall=None),
                           device="cpu", mesh=mesh).load_unified_index(path, mode="a")
        cap = idx._capacity
        new = _normed(rng, 300, D)
        idx.incremental_update(new, [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i}
                                     for i in range(300)])
        assert idx._capacity > cap and idx.ann_active and idx._sharded.ann_active
        assert idx._sharded._ann.shard_rows == idx._capacity // N_DEV
        assert [h[0].metadata.row_id for h in idx.search_vectors(new[:3], top_k=1)] == \
            [n0, n0 + 1, n0 + 2]
        assert [h[0].metadata.row_id for h in idx.search_vectors(x[:2], top_k=1)] == [0, 1]
        idx.close()

    def test_large_batch_takes_the_dense_sweep(self, tmp_path, small_corpus, mesh):
        x, _ = small_corpus
        path = _write(tmp_path / "fb.rvdb", x)
        idx = UnifiedIndex(UnifiedIndexConfig(ann=True, ann_nlist=32, ann_nprobe=2,
                                              ann_max_batch=4, ann_target_recall=None),
                           device="cpu", mesh=mesh).load_unified_index(path)
        q = _normed(np.random.default_rng(13), 9, D)         # 9 > ann_max_batch
        calls = ann.ivf_topk.calls
        assert _ids(idx.search_vectors(q, top_k=5)) == \
            _ids(idx.search_vectors(q, top_k=5, exact=True))
        assert ann.ivf_topk.calls == calls
        idx.close()


class TestMeshServingStack:
    """The facade built on a mesh with the IVF index type, behind the REST
    twin: search, then build_ann and tune_ann over HTTP."""

    def test_facade_rest_over_mesh_ann(self, tmp_path, mesh):
        import socket

        from PIL import Image

        from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
            CLIPConfig,
        )
        from intelligent_video_analysis_retrieval_system_tpu_torch.serve.rest import (
            RetrievalServer,
        )
        from intelligent_video_analysis_retrieval_system_tpu_torch.system import facade
        from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
            CLIPEmbedder,
        )
        from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

        rng = np.random.default_rng(17)
        kf = tmp_path / "keyframes" / "v"
        kf.mkdir(parents=True)
        for n in range(20):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(
                kf / f"{n}.jpg")
        cfg = Config(config_file=None, base_dir=tmp_path, create_dirs=True, overrides={
            "index": {"chunk_size": 8, "dtype": "float32", "thumbnail_size": 32,
                      "index_type": "IndexIVFFlat", "ann_nlist": 4, "ann_nprobe": 4,
                      "ann_target_recall": 0.9},
            "logging": {"file": False}})
        system = facade.EnhancedRetrievalSystem(
            cfg, embedder=CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32",
                                       device="cpu"),
            device="cpu", mesh=mesh)
        system.build_system(tmp_path / "keyframes")
        assert system.index._sharded is not None, "not mesh-backed"
        assert system.index.ann_active and system.index._sharded.ann_active
        assert 1 <= system.index.config.ann_nprobe <= 4
        assert system.search("a frame", facade.SearchOptions(limit=3))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        server = RetrievalServer(system, host="127.0.0.1", port=port)
        server.run(block=False)

        def post(route, payload):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        try:
            code, res = post("/api/search", {"query": "scene", "limit": 3})
            assert code == 200 and res["success"] and res["count"] == 3
            code, out = post("/api/maintenance", {"action": "build_ann", "nlist": 4})
            assert code == 200 and out["report"]["nlist"] == 4
            assert system.index._sharded.ann_active
            code, out = post("/api/maintenance",
                             {"action": "tune_ann", "target_recall": 0.9, "sample": 4})
            assert code == 200 and out["report"]["nprobe"] >= 1
            code, res = post("/api/search", {"query": "again", "limit": 2})
            assert code == 200 and res["success"] and res["count"] == 2
        finally:
            server.stop()
            system.cleanup()
