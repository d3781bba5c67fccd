"""Parity of the port's multi-device search (``parallel/``) with the JAX
package's, on the CPU.

The twin of ``tests/test_parallel.py`` without its training and
checkpointing classes (``parallel/train.py`` is not ported yet). The JAX
side runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port on
a mesh of ``["cpu"] * 8`` (eight logical shards on the CPU, views of one
buffer). The same seeded numpy rows and queries go to both:

- ``sharded_topk``: ids equal and scores within 1e-6 of JAX's with
  ``use_pallas=False`` (f32 rows), tie-aware at 5e-4 for bf16, and equal to
  the port's single-device ``topk_search`` bit for bit;
- ``sharded_topk_int8``: ids equal to JAX's (``use_pallas=False``, and once
  with ``interpret=True``) and scores within 2 ulps (the jitted JAX search
  multiplies by the reciprocal of the query scale), and bit for bit the
  port's single-device ``topk_search_int8``; ties across shards go to the
  lower shard, as ``lax.top_k`` orders them;
- padding never wins; fewer live rows than ``k``; tombstones; in-place and
  overflowing appends (tombstones carried); ``stats``;
- the mesh-backed ``UnifiedIndex`` (f32, bf16, int8) against the JAX
  mesh-backed index over the same container, with appends and deletes; the
  facade on a mesh, ``create_system(mesh=...)`` and ``cli search --mesh``.

JAX's ``test_batch_sizes_share_one_compiled_program`` has no twin: the port
compiles nothing per batch size.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index import IndexContainer as JaxContainer
from intelligent_video_analysis_retrieval_system_tpu.index import UnifiedIndex as JaxIndex
from intelligent_video_analysis_retrieval_system_tpu.index import (
    UnifiedIndexConfig as JaxConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.ops import quant as jq
from intelligent_video_analysis_retrieval_system_tpu.parallel import MeshSpec as JaxMeshSpec
from intelligent_video_analysis_retrieval_system_tpu.parallel import (
    ShardedIndexSearcher as JaxSearcher,
)
from intelligent_video_analysis_retrieval_system_tpu.parallel import create_mesh as jax_mesh
from intelligent_video_analysis_retrieval_system_tpu.parallel import (
    device_info as jax_device_info,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant, topk
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import (
    Mesh,
    MeshSpec,
    ShardedIndexSearcher,
    create_mesh,
    device_info,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import distributed
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel.sharded_search import (
    place_rows,
    sharded_topk,
    sharded_topk_int8,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.results import (
    KeyframeMetadata,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

N_DEV = 8
ULP2 = 2


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(JaxMeshSpec(axis_names=("index",), shape=(N_DEV,)))


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(MeshSpec(axis_names=("index",), shape=(N_DEV,)),
                       devices=["cpu"] * N_DEV)


def _data(seed, n=5000, d=64, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    q = x[rng.integers(0, n, b)] + 0.01 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return x, q


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _single_int8(x, q, k, deleted=None):
    xq, xs = quant.quantize_rows_int8(x)
    xp, sp = quant.pad_rows_int8(xq, xs)
    return quant.topk_search_int8(_t(xp), _t(sp), _t(q), k, n_valid=len(x), deleted=deleted)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


class TestMesh:
    def test_create_default_shape(self):
        mesh = create_mesh(devices=["cpu"] * N_DEV)
        assert mesh.shape == {"data": 1, "index": N_DEV}
        assert mesh.shape["index"] == jax_mesh().shape["index"]
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)

    def test_default_needs_a_cuda_device(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh()

    def test_mixed_cpu_and_cuda_raises(self):
        with pytest.raises(ValueError, match="not both"):
            create_mesh(devices=["cpu", "cuda:0"])
        with pytest.raises(ValueError, match="not both"):
            Mesh(np.array([torch.device("cpu"), torch.device("cuda", 0)], dtype=object),
                 ("index",))

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError):
            create_mesh(MeshSpec(axis_names=("a",), shape=(3,)), devices=["cpu"] * 8)

    def test_device_info_has_the_jax_keys(self):
        info = device_info()
        assert set(info) == set(jax_device_info())
        assert info["num_processes"] == 1 and info["process_index"] == 0
        assert info["num_devices"] == info["num_local_devices"] == len(info["devices"])

    def test_shards_on_one_device_view_one_buffer(self, mesh):
        x = torch.zeros((N_DEV * topk.TILE_N, 4))
        placed = place_rows(mesh, x, x.shape[0])
        assert placed.buffer is x and len(placed.shards) == N_DEV
        assert all(s.data_ptr() == x[i * topk.TILE_N].data_ptr()
                   for i, s in enumerate(placed.shards))
        fresh = place_rows(mesh, x[:100].numpy(), x.shape[0])       # a copy, one buffer
        assert fresh.buffer is not None and fresh.buffer.data_ptr() == \
            fresh.shards[0].data_ptr()


# ---------------------------------------------------------------------------
# sharded_topk / sharded_topk_int8 against JAX and the single-device search
# ---------------------------------------------------------------------------


class TestShardedSearch:
    def test_matches_jax_and_single_device_f32(self, mesh, jmesh):
        x, q = _data(0)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        got = s.search(q, k=20)
        js = JaxSearcher(jmesh, dtype=jnp.float32)
        js.load(x)
        want = js.search(q, k=20, use_pallas=False)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
        single = topk.topk_search(_t(x), _t(q), 20)
        assert torch.equal(got.indices, single.indices)
        assert torch.equal(got.scores, single.scores)

    def test_matches_jax_bf16(self, mesh, jmesh):
        x, q = _data(1)
        s = ShardedIndexSearcher(mesh)                  # bf16 rows
        s.load(x)
        got = s.search(q, k=10)
        js = JaxSearcher(jmesh)
        js.load(x)
        want = js.search(q, k=10, use_pallas=False)
        for i in range(len(q)):
            tie_aware_equal(got.indices[i].numpy(), got.scores[i].numpy(),
                            np.asarray(want.indices)[i], np.asarray(want.scores)[i])
        xb = _t(x).to(torch.bfloat16)
        single = topk.topk_search(xb, _t(q).to(torch.bfloat16), 10)
        assert torch.equal(got.indices, single.indices)
        assert torch.equal(got.scores, single.scores)

    def test_batch_and_k_shapes(self, mesh):
        x, q = _data(2, n=2000, b=8)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        for b, k in ((1, 1), (3, 5), (8, 17)):
            res = s.search(q[:b], k=k)
            assert res.scores.shape == res.indices.shape == (b, k)
            single = topk.topk_search(_t(x), _t(q[:b]), k)
            assert torch.equal(res.indices, single.indices)

    @pytest.mark.parametrize("int8", [False, True])
    def test_pad_rows_never_win(self, mesh, jmesh, int8):
        # all-negative scores: zero pad rows would rank first if unmasked
        rng = np.random.default_rng(3)
        x = -np.abs(rng.standard_normal((1000, 64)).astype(np.float32))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        q = np.abs(rng.standard_normal((2, 64)).astype(np.float32))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        js = JaxSearcher(jmesh, dtype=jnp.float32)
        if int8:
            s.load_int8(*quant.quantize_rows_int8(x))
            js.load_int8(*jq.quantize_rows_int8(x))
        else:
            s.load(x)
            js.load(x)
        res = s.search(q, k=10)
        assert int(res.indices.max()) < 1000 and bool(torch.isfinite(res.scores).all())
        want = js.search(q, k=10, use_pallas=False)
        np.testing.assert_array_equal(res.indices.numpy(), np.asarray(want.indices))

    @pytest.mark.parametrize("int8", [False, True])
    def test_fewer_live_rows_than_k(self, mesh, jmesh, int8):
        """10 rows, 6 of them tombstoned, k=8: the JAX sharded searcher's
        answer: k columns, the live rows first (ids and scores equal), then
        -inf slots, which the index drops."""
        x, q = _data(4, n=10, b=2)
        dead = {0, 2, 3, 5, 7, 9}
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        js = JaxSearcher(jmesh, dtype=jnp.float32)
        if int8:
            s.load_int8(*quant.quantize_rows_int8(x), deleted_rows=dead)
            js.load_int8(*jq.quantize_rows_int8(x), deleted_rows=dead)
        else:
            s.load(x, deleted_rows=dead)
            js.load(x, deleted_rows=dead)
        got = s.search(q, k=8)
        want = js.search(q, k=8, use_pallas=False)
        assert got.scores.shape == np.asarray(want.scores).shape == (2, 8)
        live = np.isfinite(np.asarray(want.scores))
        np.testing.assert_array_equal(torch.isfinite(got.scores).numpy(), live)
        assert live.sum(axis=1).tolist() == [4, 4]
        np.testing.assert_array_equal(got.indices.numpy()[live], np.asarray(want.indices)[live])
        if int8:
            np.testing.assert_array_max_ulp(got.scores.numpy()[live],
                                            np.asarray(want.scores)[live], maxulp=ULP2)
        else:
            np.testing.assert_allclose(got.scores.numpy()[live],
                                       np.asarray(want.scores)[live], atol=1e-6)
        assert set(got.indices.numpy()[live].tolist()) <= {1, 4, 6, 8}

    def test_ties_across_shards_go_to_the_lower_shard(self, mesh, jmesh):
        """The same row in every shard: the merge keeps them lowest shard
        first, as lax.top_k does (torch.topk would not say)."""
        x, q = _data(5, n=N_DEV * topk.TILE_N, b=3)
        sr = topk.TILE_N
        for s in range(1, N_DEV):
            x[s * sr + 7] = x[7]
        q[0] = x[7]
        s8 = ShardedIndexSearcher(mesh)
        s8.load_int8(*quant.quantize_rows_int8(x))
        got = s8.search(q, k=12)
        js = JaxSearcher(jmesh)
        js.load_int8(*jq.quantize_rows_int8(x))
        want = js.search(q, k=12, use_pallas=False)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert got.indices[0, :N_DEV].tolist() == [s * sr + 7 for s in range(N_DEV)]

    def test_sharded_topk_functions_over_placed_rows(self, mesh):
        x, q = _data(6, n=3000)
        n_pad = N_DEV * topk.TILE_N
        xs = place_rows(mesh, x, n_pad, dtype=torch.float32)
        mask = np.zeros((n_pad, 1), np.int8)
        mask[[5, 77, 2999], 0] = 1
        dead = place_rows(mesh, mask, n_pad)
        got = sharded_topk(mesh, xs, _t(q), 9, 3000, deleted_sharded=dead)
        xp = np.zeros((n_pad, x.shape[1]), np.float32)
        xp[:3000] = x
        single = topk.topk_search(_t(xp), _t(q), 9, n_valid=3000, deleted=_t(mask))
        assert torch.equal(got.indices, single.indices)
        xq, xsc = quant.quantize_rows_int8(x)
        got8 = sharded_topk_int8(mesh, place_rows(mesh, xq, n_pad),
                                 place_rows(mesh, xsc, n_pad), _t(q), 9, 3000,
                                 deleted_sharded=dead)
        xp8, sp8 = np.zeros((n_pad, x.shape[1]), np.int8), np.zeros(n_pad, np.float32)
        xp8[:3000], sp8[:3000] = xq, xsc
        single8 = quant.topk_search_int8(_t(xp8), _t(sp8), _t(q), 9, n_valid=3000,
                                         deleted=_t(mask))
        assert torch.equal(got8.indices, single8.indices)
        assert torch.equal(got8.scores, single8.scores)

    def test_append_reshards(self, mesh):
        x, _ = _data(7, n=1000)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        extra, _ = _data(8, n=100)
        s.append(extra)
        assert s.n_valid == 1100
        assert int(s.search(extra[:1], k=1).indices[0, 0]) == 1000

    def test_stats_equal_jax(self, mesh, jmesh):
        x, _ = _data(9, n=1000)
        for int8 in (False, True):
            s = ShardedIndexSearcher(mesh, dtype=torch.float32)
            js = JaxSearcher(jmesh, dtype=jnp.float32)
            if int8:
                s.load_int8(*quant.quantize_rows_int8(x))
                js.load_int8(*jq.quantize_rows_int8(x))
            else:
                s.load(x)
                js.load(x)
            assert s.stats() == js.stats()


class TestShardedInt8:
    def test_matches_jax_and_single_device(self, mesh, jmesh):
        x, q = _data(10)
        s = ShardedIndexSearcher(mesh)
        s.load_int8(*quant.quantize_rows_int8(x))
        got = s.search(q, k=20)
        js = JaxSearcher(jmesh)
        js.load_int8(*jq.quantize_rows_int8(x))
        want = js.search(q, k=20, use_pallas=False)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(want.scores),
                                        maxulp=ULP2)
        single = _single_int8(x, q, 20)
        assert torch.equal(got.indices, single.indices)
        assert torch.equal(got.scores, single.scores)

    def test_jax_interpret_mode_composes_the_same(self, mesh, jmesh):
        # the JAX per-shard Pallas kernel in interpret mode, as
        # tests/test_parallel.py runs it
        x, q = _data(11, n=600, b=2)
        s = ShardedIndexSearcher(mesh)
        s.load_int8(*quant.quantize_rows_int8(x))
        js = JaxSearcher(jmesh)
        js.load_int8(*jq.quantize_rows_int8(x))
        want = js.search(q, k=5, use_pallas=False, interpret=True)
        got = s.search(q, k=5)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_max_ulp(got.scores.numpy(), np.asarray(want.scores),
                                        maxulp=ULP2)

    def test_deleted_rows_excluded(self, mesh, jmesh):
        x, q = _data(12, n=2000, b=2)
        s = ShardedIndexSearcher(mesh)
        s.load_int8(*quant.quantize_rows_int8(x))
        top = int(s.search(q[:1], k=1).indices[0, 0])
        s.set_deleted({top})
        res = s.search(q[:1], k=10)
        assert top not in res.indices[0].tolist()
        js = JaxSearcher(jmesh)
        js.load_int8(*jq.quantize_rows_int8(x), deleted_rows={top})
        np.testing.assert_array_equal(
            res.indices.numpy(), np.asarray(js.search(q[:1], k=10, use_pallas=False).indices))

    def test_append_inplace_equals_requantize_from_scratch(self, mesh):
        x, q = _data(13, n=900)
        extra, _ = _data(14, n=70)
        a = ShardedIndexSearcher(mesh)
        a.load_int8(*quant.quantize_rows_int8(x))
        buf = a._x.buffer
        a.append(extra)
        assert a._x.buffer is buf and a.capacity == N_DEV * topk.TILE_N   # in place
        assert a.n_valid == 970
        b = ShardedIndexSearcher(mesh)
        b.load_int8(*quant.quantize_rows_int8(np.concatenate([x, extra])))
        ra, rb = a.search(q, k=15), b.search(q, k=15)
        assert torch.equal(ra.indices, rb.indices) and torch.equal(ra.scores, rb.scores)
        top = a.search(extra[:3], k=1)
        assert top.indices[:, 0].tolist() == [900, 901, 902]

    def test_append_straddling_two_shards(self, mesh):
        """An in-place append whose rows cross a shard boundary lands in both."""
        n0 = topk.TILE_N - 30
        x, _ = _data(15, n=n0)
        extra, _ = _data(16, n=60)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        s.append(extra)
        assert s.n_valid == n0 + 60 and s.capacity == N_DEV * topk.TILE_N
        got = s.search(extra, k=1)
        assert got.indices[:, 0].tolist() == list(range(n0, n0 + 60))
        assert torch.equal(s._x.shards[1][:30], _t(extra[30:]))


class TestInPlaceAppend:
    def test_in_place_append_preserves_results(self, mesh):
        x, _ = _data(17, n=1000)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        cap = s.capacity
        extra, _ = _data(18, n=100)
        s.append(extra)
        assert s.n_valid == 1100 and s.capacity == cap
        full = np.concatenate([x, extra])
        got = s.search(full[1095:1100], k=10)
        want = topk.topk_exact_reference(_t(full), _t(full[1095:1100]), 10)
        assert torch.equal(got.indices, want.indices)

    def test_append_overflow_falls_back_to_reshard(self, mesh):
        x, _ = _data(19, n=100)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x)
        cap = s.capacity
        big, _ = _data(20, n=cap)
        s.append(big)
        assert s.n_valid == 100 + cap and s.capacity > cap
        assert int(s.search(big[:1], k=1).indices[0, 0]) == 100

    @pytest.mark.parametrize("int8", [False, True])
    def test_append_overflow_preserves_tombstones(self, mesh, int8):
        x, _ = _data(21, n=100)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        if int8:
            s.load_int8(*quant.quantize_rows_int8(x), deleted_rows={3})
        else:
            s.load(x, deleted_rows={3})
        cap = s.capacity
        big, _ = _data(22, n=cap)
        s.append(big)                                  # overflow -> re-shard
        assert s.capacity > cap
        assert int(s.search(x[3:4], k=1).indices[0, 0]) != 3, "tombstone lost"

    def test_append_with_tombstones_intact(self, mesh):
        x, _ = _data(23, n=500)
        s = ShardedIndexSearcher(mesh, dtype=torch.float32)
        s.load(x, deleted_rows={0})
        s.append(x[:1] + 0.0)                          # identical to the deleted row
        assert int(s.search(x[:1], k=1).indices[0, 0]) == 500


class TestDistributedHelpers:
    def test_initialize_noop_single_process(self):
        info = distributed.initialize_distributed()
        assert info["process_count"] == 1 and info["process_index"] == 0
        assert not distributed.is_multi_host()
        assert distributed.initialize_distributed() == info       # idempotent

    def test_host_row_range_single_host(self, mesh):
        assert distributed.host_row_range(1000, mesh) == (0, 1000)

    def test_make_global_sharded_array(self, mesh):
        rows = np.random.default_rng(24).standard_normal((1024, 16)).astype(np.float32)
        arr = distributed.make_global_sharded_array(rows, 1024, mesh)
        assert arr.shape == (N_DEV * topk.TILE_N, 16) and len(arr.shards) == N_DEV
        np.testing.assert_array_equal(arr.read(1024).numpy(), rows)
        bf = distributed.make_global_sharded_array(rows, 1024, mesh, dtype="bfloat16")
        assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the mesh-backed index, facade and CLI
# ---------------------------------------------------------------------------


def _write(path: Path, x: np.ndarray, dtype: str, keep_fp: bool = False) -> Path:
    with JaxContainer(path, "w", dim=x.shape[1], dtype=dtype, keep_fp=keep_fp) as c:
        c.append_embeddings(x)
        c.append_metadata([{"folder": f"v{i // 100}", "image": f"{i}.jpg", "frame_id": i,
                            "row_id": i} for i in range(len(x))])
        c.flush_checkpoint()
    return path


def _hits(results):
    return [[(h.metadata.row_id, h.similarity_score) for h in hits] for hits in results]


class TestMeshBackedIndex:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_mesh_index_matches_jax_mesh_index(self, mesh, jmesh, tmp_path, dtype):
        x, q = _data(30, n=3000, d=32, b=5)
        path = _write(tmp_path / f"m_{dtype}.rvdb", x, dtype)
        jidx = JaxIndex(JaxConfig(), mesh=jmesh).load_unified_index(path)
        idx = UnifiedIndex(UnifiedIndexConfig(), device="cpu", mesh=mesh).load_unified_index(path)
        single = UnifiedIndex(UnifiedIndexConfig(), device="cpu").load_unified_index(path)
        try:
            assert idx._sharded is not None and idx._sharded.stats() == jidx._sharded.stats()
            assert idx._capacity == jidx._capacity
            got, want = idx.search_vectors(q, top_k=10), jidx.search_vectors(q, top_k=10)
            for g, w in zip(_hits(got), _hits(want)):
                if dtype == "int8":
                    assert [r for r, _ in g] == [r for r, _ in w]
                    np.testing.assert_array_max_ulp(np.float32([s for _, s in g]),
                                                    np.float32([s for _, s in w]), maxulp=ULP2)
                else:
                    tie_aware_equal([r for r, _ in g], [s for _, s in g],
                                    [r for r, _ in w], [s for _, s in w])
            # and exactly the port's single-device index
            assert _hits(got) == _hits(single.search_vectors(q, top_k=10))
        finally:
            jidx.close()
            idx.close()
            single.close()

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_mesh_incremental_append_in_place(self, mesh, tmp_path, dtype):
        x, q = _data(31, n=700, d=32)
        path = _write(tmp_path / f"a_{dtype}.rvdb", x, dtype)
        idx = UnifiedIndex(UnifiedIndexConfig(), device="cpu", mesh=mesh)
        idx.load_unified_index(path, mode="a")
        searcher, cap = idx._sharded, idx._capacity
        new, _ = _data(32, n=3, d=32)
        idx.incremental_update(new, [KeyframeMetadata(folder="vx", image=f"{i}.jpg",
                                                      frame_id=i) for i in range(3)])
        assert idx._sharded is searcher and idx._capacity == cap     # no re-shard
        got = _hits(idx.search_vectors(np.concatenate([q, new]), top_k=8))
        idx.close()
        reloaded = UnifiedIndex(UnifiedIndexConfig(), device="cpu", mesh=mesh)
        reloaded.load_unified_index(path)
        want = _hits(reloaded.search_vectors(np.concatenate([q, new]), top_k=8))
        reloaded.close()
        assert got == want       # f32 and int8 alike: the same rows, the same sweep
        assert [g[0][0] for g in got[-3:]] == [700, 701, 702]

    def test_mesh_index_deletes_and_overflow_append(self, mesh, jmesh, tmp_path):
        x, q = _data(33, n=N_DEV * topk.TILE_N - 50, d=32, b=3)
        path = _write(tmp_path / "d.rvdb", x, "int8")
        jpath = _write(tmp_path / "dj.rvdb", x, "int8")
        idx = UnifiedIndex(UnifiedIndexConfig(), device="cpu", mesh=mesh)
        idx.load_unified_index(path, mode="a")
        jidx = JaxIndex(JaxConfig(), mesh=jmesh).load_unified_index(jpath, mode="a")
        top = idx.search_vectors(q, top_k=1)[0][0].metadata.row_id
        for index in (idx, jidx):
            index.delete_rows([top])
        hits = idx.search_vectors(q, top_k=5)
        assert all(h.metadata.row_id != top for h in hits[0])
        new, _ = _data(34, n=300, d=32)
        metas = [{"folder": "w", "image": f"n{i}.jpg", "frame_id": i} for i in range(300)]
        cap = idx._capacity
        for index in (idx, jidx):
            index.incremental_update(new, metas)
        assert idx._capacity == jidx._capacity > cap                 # re-sharded
        got = idx.search_vectors(np.concatenate([q, new[:2]]), top_k=6)
        want = jidx.search_vectors(np.concatenate([q, new[:2]]), top_k=6)
        assert [[r for r, _ in h] for h in _hits(got)] == [[r for r, _ in h]
                                                          for h in _hits(want)]
        assert all(h.metadata.row_id != top for h in got[0])         # tombstone carried
        idx.close()
        jidx.close()


def _keyframes(root: Path, n: int = 12) -> Path:
    from PIL import Image

    rng = np.random.default_rng(40)
    kf = root / "keyframes"
    for f in range(2):
        folder = kf / f"vid{f}"
        folder.mkdir(parents=True)
        for i in range(n // 2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(
                folder / f"{i}.jpg")
    return kf


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_facade_on_a_mesh_answers_as_the_single_device_facade(mesh, tmp_path, dtype):
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
        CLIPEmbedder,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        SearchOptions,
        create_system,
    )

    kf = _keyframes(tmp_path)
    embedder = CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu")
    over = dict(index={"dtype": dtype, "thumbnail_size": 32, "chunk_size": 8},
                logging={"file": False}, paths={"base_dir": str(tmp_path)})
    meshed = create_system(torch_device="cpu", mesh=mesh, **over)
    meshed.embedder = embedder
    meshed.build_system(kf, output_path=tmp_path / "m.rvdb")
    assert meshed.index._sharded is not None and meshed.index.mesh is mesh
    assert meshed.get_system_stats()["remote_indexes"] == 0
    single = create_system(torch_device="cpu", **over)
    single.embedder = embedder
    single.load_system(tmp_path / "m.rvdb")
    opts = SearchOptions(limit=5, use_cache=False)
    for query in ("a red car", "a person walking"):
        got, want = meshed.search(query, opts), single.search(query, opts)
        assert [(h["folder"], h["image"], h["similarity_score"]) for h in got] == \
            [(h["folder"], h["image"], h["similarity_score"]) for h in want]
    meshed.cleanup()
    single.cleanup()


def test_cli_search_mesh_answers_as_without(tmp_path, monkeypatch, capsys):
    import json

    from intelligent_video_analysis_retrieval_system_tpu_torch import cli
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig

    x, _ = _data(41, n=300, d=32)
    path = _write(tmp_path / "c.rvdb", x, "bfloat16")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(convert.CLIPConfig, "vit_l_14",
                        classmethod(lambda cls: CLIPConfig.tiny_test()))
    outs = []
    for extra in ([], ["--mesh"]):
        assert cli.main(["search", str(path), "a red car", "--device", "cpu", "--limit", "4",
                         "--json"] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert len(outs[0]) == 4 and outs[1] == outs[0]
    assert cli._build_parser().parse_args(["search", "i", "q", "--mesh"]).mesh
