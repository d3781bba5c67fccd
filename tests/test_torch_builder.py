"""The port's ``RAGBuilder`` against the JAX package's, on one keyframes tree.

Both builders get the same injected ``embed_fn`` (numpy: a seeded random
projection of the decoded pixels), so everything the build layer does
itself is held equal: scan order, content hashes, decode, metadata, frame
maps, the journal and the stored bits (bf16 and int8 containers bit for bit:
the quantizer is held exact in test_torch_quant.py). Each package then opens
the other's container and sidecar and answers the same queries (bf16
tie-aware with the repo's 5e-4; int8 the same ids, scores bit for bit at a
batch of 3 and to two f32 ulps at JAX's padded batch of 8). Resume, a corrupt file and a
torn tail behave as in the JAX builder.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from intelligent_video_analysis_retrieval_system_tpu.index.builder import (
    RAGBuilder as JaxBuilder,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndex as JaxIndex,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndexConfig as JaxIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch import native
from intelligent_video_analysis_retrieval_system_tpu_torch.index.builder import (
    BuildReport,
    RAGBuilder,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import (
    IndexContainer,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

torch.set_num_threads(2)

SIZE, DIM = 32, 48
FOLDERS = {"video_2": 7, "video_10": 9, "clip_a": 5}   # natural order: clip_a, 2, 10
N_FILES = sum(FOLDERS.values())
_PROJ = np.random.default_rng(11).standard_normal((SIZE * SIZE * 3, DIM)).astype(np.float32)


def embed_fn(batch: np.ndarray) -> np.ndarray:
    x = batch.reshape(len(batch), -1).astype(np.float32) / 255.0 - 0.5
    out = x @ _PROJ
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _make_tree(root):
    rng = np.random.default_rng(5)
    (root / "map").mkdir(parents=True)
    for folder, count in FOLDERS.items():
        (root / "keyframes" / folder).mkdir(parents=True)
        lines = ["n,pts_time,fps,frame_idx"]
        for n in range(1, count + 1):
            w, h = (48, 36) if n % 2 else (30, 44)       # both orientations: resize + crop
            cells = rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8)
            img = np.kron(cells, np.ones((4, 4, 1), np.uint8))
            Image.fromarray(img).save(root / "keyframes" / folder / f"{n}.jpg", quality=92)
            lines.append(f"{n},{n * 0.5},25.0,{n * 12}")
        if folder != "clip_a":                           # one folder without a map
            (root / "map" / f"{folder}.csv").write_text("\n".join(lines) + "\n")
    return root / "keyframes", root / "map"


def _build(kind, keyframes, map_dir, out, dtype, resume=True, **cfg):
    if kind == "jax":
        builder = JaxBuilder(embed_fn, DIM, input_size=SIZE,
                             config=JaxIndexConfig(chunk_size=8, dtype=dtype, **cfg))
    else:
        builder = RAGBuilder(embed_fn, DIM, input_size=SIZE,
                             config=UnifiedIndexConfig(chunk_size=8, dtype=dtype, **cfg),
                             device="cpu")
    return builder.build_index(keyframes, out, map_dir=map_dir, resume=resume)


def _contents(path):
    """Everything a build stores, read through the port's container."""
    with IndexContainer(path, mode="r") as c:
        out = {"n": c.num_rows, "dtype": c.dtype, "dim": c.dim,
               "meta": list(c.iter_metadata()), "journal": c.journal_hashes(),
               "maps": {f: c.get_map(f) for f in c.map_folders()},
               "thumbs": [c.get_thumbnail(i) for i in range(c.num_thumbnails)],
               "has_fp": c.has_fp_rows}
        build = dict(c.get_system("build"))
        build.pop("finished_at")
        out["build"] = build
        if c.dtype == "int8":
            q, s = c.read_quantized()
            out["rows"], out["scales"] = q.copy(), s.copy()
            if c.has_fp_rows:
                out["fp"] = c.read_fp_bits().copy()
        else:
            out["rows"] = c.read_embeddings().copy()
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _make_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="module")
def built(tree, tmp_path_factory):
    """{dtype: (jax path, port path, jax report, port report)}; indexes closed."""
    keyframes, map_dir = tree
    out = {}
    for dtype, cfg in (("bfloat16", {}), ("int8", {"int8_rescore": True})):
        root = tmp_path_factory.mktemp(f"built_{dtype}")
        jidx, jrep = _build("jax", keyframes, map_dir, root / "j.rvdb", dtype, **cfg)
        tidx, trep = _build("port", keyframes, map_dir, root / "t.rvdb", dtype, **cfg)
        assert tidx.ntotal == jidx.ntotal == N_FILES and tidx.device.type == "cpu"
        jidx.close()
        tidx.close()
        out[dtype] = (root / "j.rvdb", root / "t.rvdb", jrep, trep)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reports_and_stored_contents_equal(built, dtype):
    jpath, tpath, jrep, trep = built[dtype]
    assert isinstance(trep, BuildReport)
    for key in ("total_files", "processed", "skipped_resume", "failed", "chunks", "resumed",
                "failures"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert (trep.total_files, trep.processed, trep.failed, trep.chunks) == (N_FILES, N_FILES, 0, 3)
    want, got = _contents(jpath), _contents(tpath)
    assert got["n"] == want["n"] == N_FILES and got["dtype"] == want["dtype"] == dtype
    assert got["meta"] == want["meta"]
    assert [m["folder"] for m in got["meta"][:6]] == ["clip_a"] * 5 + ["video_2"]
    assert got["meta"][5]["frame_id"] == 12 and got["meta"][5]["pts_time"] == 0.5
    assert got["meta"][0]["frame_id"] == 1 and got["meta"][0]["pts_time"] == -1.0  # no map
    assert got["journal"] == want["journal"] and len(got["journal"]) == N_FILES
    assert got["maps"] == want["maps"] and set(got["maps"]) == {"video_2", "video_10"}
    assert got["thumbs"] == want["thumbs"] and len(got["thumbs"]) == N_FILES
    assert got["build"] == want["build"]
    np.testing.assert_array_equal(got["rows"], want["rows"])      # bit for bit
    if dtype == "int8":
        np.testing.assert_array_equal(got["scales"], want["scales"])
        assert got["has_fp"] and want["has_fp"]
        np.testing.assert_array_equal(got["fp"], want["fp"])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sidecars_equal(built, dtype):
    jpath, tpath, _, _ = built[dtype]
    suffix = ".flat8" if dtype == "int8" else ".flat"
    jside = jpath.with_name(jpath.name + suffix)
    tside = tpath.with_name(tpath.name + suffix)
    assert jside.is_file() and tside.is_file()
    assert jside.read_bytes() == tside.read_bytes()
    if dtype == "int8":
        n, d, norm = native.FlatInt8File(tside).header()
        assert (n, d, norm) == (N_FILES, DIM, True)
    else:
        assert native.FlatEmbeddingFile(tside).header() == (N_FILES, DIM, "bfloat16")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_each_package_opens_the_others_container(built, dtype):
    jpath, tpath, _, _ = built[dtype]
    queries = np.random.default_rng(9).standard_normal((5, DIM)).astype(np.float32)
    # the port serves the JAX build, the JAX package serves the port's build
    t = UnifiedIndex(device="cpu").load_unified_index(jpath)
    j = JaxIndex().load_unified_index(tpath)
    try:
        assert t.ntotal == j.ntotal == N_FILES
        # int8: a batch of 3 agrees bit for bit. At a batch of 5 (JAX pads it to
        # its bucket of 8) XLA compiles another program for this 21-row corpus
        # whose scale products land up to two f32 ulps away from the JAX index's own
        # answer at 3; the port's scores do not move with the batch size. Ids
        # are equal at both. test_torch_index.py holds the metric bit for bit
        # at serving sizes.
        if dtype == "int8":
            got, want = t.search_vectors(queries[:3], top_k=6), j.search_vectors(queries[:3], top_k=6)
            for g, w in zip(got, want):
                assert [(h.metadata.row_id, h.similarity_score) for h in g] == \
                    [(h.metadata.row_id, h.similarity_score) for h in w]
        got, want = t.search_vectors(queries, top_k=6), j.search_vectors(queries, top_k=6)
        for g, w in zip(got, want):
            assert len(g) == len(w) == 6
            gi = np.array([h.metadata.row_id for h in g])
            wi = np.array([h.metadata.row_id for h in w])
            gs = np.array([h.similarity_score for h in g], np.float32)
            ws = np.array([h.similarity_score for h in w], np.float32)
            if dtype == "int8":
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_max_ulp(gs, ws, maxulp=2)
            else:
                tie_aware_equal(gi, gs, wi, ws)
            assert [h.metadata.key for h in g] == [t.get_metadata(i).key for i in gi]
    finally:
        t.close()
        j.close()


def test_resume_skips_every_journaled_file(tree, tmp_path):
    keyframes, map_dir = tree
    calls = []

    def counting(batch):
        calls.append(len(batch))
        return embed_fn(batch)

    builder = RAGBuilder(counting, DIM, input_size=SIZE,
                         config=UnifiedIndexConfig(chunk_size=8), device="cpu")
    idx, rep = builder.build_index(keyframes, tmp_path / "r.rvdb", map_dir=map_dir)
    idx.close()
    assert calls == [8, 8, 5] and not rep.resumed       # one embed_fn call per chunk
    calls.clear()
    idx, rep = builder.build_index(keyframes, tmp_path / "r.rvdb", map_dir=map_dir)
    assert (rep.skipped_resume, rep.processed, rep.resumed) == (N_FILES, 0, True)
    assert calls == [] and idx.ntotal == N_FILES
    idx.close()
    # resume=False rebuilds from scratch
    idx, rep = builder.build_index(keyframes, tmp_path / "r.rvdb", map_dir=map_dir,
                                   resume=False)
    assert (rep.skipped_resume, rep.processed) == (0, N_FILES)
    idx.close()


def test_new_files_append_on_resume_and_progress_is_reported(tree, tmp_path):
    keyframes, map_dir = _make_tree(tmp_path / "t")
    seen = []
    builder = RAGBuilder(embed_fn, DIM, input_size=SIZE,
                         config=UnifiedIndexConfig(chunk_size=8), device="cpu",
                         progress_fn=lambda *a: seen.append(a))
    idx, _ = builder.build_index(keyframes, tmp_path / "a.rvdb", map_dir=map_dir)
    idx.close()
    assert seen == [("build", 8, N_FILES), ("build", 16, N_FILES), ("build", N_FILES, N_FILES)]
    Image.fromarray(np.full((40, 40, 3), 200, np.uint8)).save(keyframes / "video_2" / "8.jpg")
    idx, rep = builder.build_index(keyframes, tmp_path / "a.rvdb", map_dir=map_dir)
    assert (rep.skipped_resume, rep.processed) == (N_FILES, 1)
    assert idx.ntotal == N_FILES + 1 and idx.get_metadata(N_FILES).key == ("video_2", "8.jpg")
    idx.close()


def test_corrupt_file_is_counted_not_raised(tmp_path):
    keyframes, map_dir = _make_tree(tmp_path / "t")
    (keyframes / "video_10" / "4.jpg").write_bytes(b"not a jpeg at all")
    results = {}
    for kind in ("jax", "port"):
        idx, rep = _build(kind, keyframes, map_dir, tmp_path / f"{kind}.rvdb", "bfloat16")
        results[kind] = (rep.processed, rep.failed, len(rep.failures), idx.ntotal)
        idx.close()
    assert results["port"] == results["jax"] == (N_FILES - 1, 1, 1, N_FILES - 1)
    with IndexContainer(tmp_path / "port.rvdb", mode="r") as c:
        assert ("video_10", "4.jpg") not in {(m["folder"], m["image"])
                                             for m in c.iter_metadata()}


def test_torn_tail_is_repaired_on_resume(tree, tmp_path):
    keyframes, map_dir = tree
    idx, _ = _build("port", keyframes, map_dir, tmp_path / "torn.rvdb", "bfloat16")
    idx.close()
    # a crash between a chunk's embeddings and its metadata: rows ahead of records
    with IndexContainer(tmp_path / "torn.rvdb", mode="a") as c:
        c.append_embeddings(np.ones((3, DIM), np.float32))
        assert not c.consistency_report()["ok"]
    idx, rep = _build("port", keyframes, map_dir, tmp_path / "torn.rvdb", "bfloat16")
    assert rep.resumed and rep.skipped_resume == N_FILES and idx.ntotal == N_FILES
    idx.close()
    with IndexContainer(tmp_path / "torn.rvdb", mode="r") as c:
        assert c.consistency_report()["ok"] and c.num_rows == c.num_metadata == N_FILES


def test_unreadable_container_is_quarantined_and_rebuilt(tree, tmp_path):
    keyframes, map_dir = tree
    (tmp_path / "bad.rvdb").write_bytes(b"\x00" * 64)
    idx, rep = _build("port", keyframes, map_dir, tmp_path / "bad.rvdb", "bfloat16")
    assert rep.processed == N_FILES and not rep.resumed
    assert list(tmp_path.glob("bad.rvdb.corrupt-*"))
    idx.close()


def test_builder_defaults_to_the_card_and_refuses_what_is_not_ported():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            RAGBuilder(embed_fn, DIM)                    # device defaults to "cuda"
    # the mesh is ported (tests/test_torch_parallel.py): the built index shards over it
    from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import create_mesh

    mesh = create_mesh(devices=["cpu"] * 2)
    assert RAGBuilder(embed_fn, DIM, device="cpu", mesh=mesh).mesh is mesh
    builder = RAGBuilder(lambda b: np.zeros((len(b), DIM + 1), np.float32), DIM,
                         input_size=SIZE, device="cpu")
    assert builder.device.type == "cpu" and builder._ordinal_of("frame_0012.jpg") == 12
