"""The PyTorch port's serving slice against the JAX facade, end to end.

Both facades get the same carried-across tower params (a JAX init of
``CLIPConfig.tiny_test()`` through ``models.convert.from_jax_params``) and
the same ``.rvdb``, and answer the same text queries.

- f32 parity mode: the same keyframes in the same order, scores within 1e-5.
- bf16: tie-aware. The two frameworks round bf16 at different places (the
  JAX package itself differs between its jitted and eager attention by one
  bf16 step), so the query embeddings agree only to the towers' cosine
  gate. With unit rows a score can move by at most ``|q_jax - q_port|``, so
  scores are compared within that bound plus the 5e-4 of the repo's
  tie-aware rule.

- int8 (the capacity mode): both facades fed the same query vectors answer
  with the same keyframes and scores, exactly, with and without the exact
  rescore; ``cli evaluate`` prints the same report as the JAX CLI.

- build: ``build_system`` of both facades over one tree of JPEGs, with the
  same tower params: the same rows within the towers' difference, the same
  frames for text and image queries (tie-aware, 5e-4 plus the embeddings'
  own difference), the ``build_progress`` events in order, an int8 container
  from ``index.dtype="int8"``, and the CLI's ``build`` then ``search``.

Also here: the request layer and the micro-batcher around the port, a run
of the whole slice with JAX and the JAX package blocked from importing, the
CLI, and ``chip_smoke.py`` refusing to run without a card.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    SearchOptions as JaxOptions,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
    QueryBatcher,
    RequestHandler,
    format_results,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
    CLIPEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
    SearchOptions,
    create_system,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
    ATOL_TOPK,
    tie_aware_equal,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N, DIM = 2500, 32
QUERIES = ["a red car at night", "people walking on a beach", "xe máy trên phố",
           "a dog catching a frisbee", "sunset over the mountains"]


def _write_index(path: Path, dtype: str) -> None:
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    with JaxContainer(path, "w", dim=DIM, dtype=dtype) as c:
        c.append_embeddings(rows)
        c.append_metadata([{"folder": f"vid{i // 250}", "image": f"{i % 250}.jpg",
                            "frame_id": i % 250, "row_id": i} for i in range(N)])
        c.flush_checkpoint()


@pytest.fixture(scope="module")
def pair_factory(tmp_path_factory):
    """(jax_system, port_system) over one index, with shared params."""
    made: dict = {}

    def make(dtype: str, parity: bool):
        if (dtype, parity) in made:
            return made[dtype, parity]
        root = tmp_path_factory.mktemp(f"sys_{dtype}_{parity}")
        _write_index(root / "index.rvdb", dtype)
        cfg_over = {"index": {"dtype": dtype}}
        jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), parity_mode=parity)
        jsys = JaxSystem(Config(config_file=None, base_dir=root, overrides=cfg_over),
                         embedder=jemb)
        jsys.load_system(root / "index.rvdb")
        jemb.ensure_loaded()
        temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), parity_mode=parity, device="cpu")
        temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                         CLIPConfig.tiny_test()))
        tsys = EnhancedRetrievalSystem(
            Config(config_file=None, base_dir=root, overrides=cfg_over), embedder=temb,
            device="cpu")
        tsys.load_system(root / "index.rvdb")
        made[dtype, parity] = jsys, tsys
        return jsys, tsys

    yield make
    for pair in made.values():
        for system in pair:
            system.cleanup()


def _pairs(hits):
    return [(h["folder"], h["image"]) for h in hits], np.array(
        [h["similarity_score"] for h in hits])


@pytest.mark.parametrize("dtype,parity", [("float32", True), ("bfloat16", False)])
def test_facade_search_matches_jax(pair_factory, dtype, parity):
    jsys, tsys = pair_factory(dtype, parity)
    for query in QUERIES:
        for limit in (1, 10, 37):
            want = jsys.search(query, JaxOptions(limit=limit))
            got = tsys.search(query, SearchOptions(limit=limit))
            assert len(got) == len(want) == limit
            (gk, gs), (wk, ws) = _pairs(got), _pairs(want)
            if parity:
                assert gk == wk
                np.testing.assert_allclose(gs, ws, atol=1e-5)
                continue
            prompt = tsys._clip_prompt(query, SearchOptions())[0]
            qj = jsys.embedder.encode_text([prompt])[0]
            qt = tsys.embedder.encode_text([prompt])[0]
            assert float(qj @ qt) >= 0.999          # the towers' bf16 gate
            row = {k: i for i, k in enumerate(sorted(set(gk) | set(wk)))}
            tie_aware_equal([row[k] for k in gk], gs, [row[k] for k in wk], ws,
                            atol=ATOL_TOPK + float(np.linalg.norm(qj - qt)))
            assert [g["rank"] for g in got] == list(range(1, limit + 1))


def test_facade_options_match_jax(pair_factory):
    jsys, tsys = pair_factory("float32", True)
    for opts in (dict(folder_filter="vid3", limit=7),
                 dict(include_temporal=True, temporal_window=2, limit=4),
                 dict(include_explanations=True, min_similarity=0.2, limit=20),
                 dict(mode="llm_enhanced", limit=6),
                 dict(mode="hybrid", limit=6)):
        for query in QUERIES[:2]:
            want = jsys.search(query, JaxOptions(**opts))
            got = tsys.search(query, SearchOptions(**opts))
            assert _pairs(got)[0] == _pairs(want)[0]
            for g, w in zip(got, want):
                assert g.get("temporal_context") == w.get("temporal_context")
                assert g.get("explanation") == w.get("explanation")
    want = jsys.search_batch(QUERIES, JaxOptions(limit=9))
    got = tsys.search_batch(QUERIES, SearchOptions(limit=9))
    assert [_pairs(g)[0] for g in got] == [_pairs(w)[0] for w in want]


@pytest.mark.parametrize("size", [(32, 32), (40, 56)])   # as is; resized + cropped
def test_search_by_image_matches_jax(pair_factory, size):
    jsys, tsys = pair_factory("float32", True)
    img = np.random.default_rng(size[1]).integers(0, 256, (*size, 3)).astype(np.uint8)
    want = jsys.search_by_image(img, JaxOptions(limit=12))
    got = tsys.search_by_image(img, SearchOptions(limit=12))
    assert len(got) == len(want) == 12
    qj = jsys.embedder.encode_images(img[None])[0]
    qt = tsys.embedder.encode_images(img[None])[0]
    (gk, gs), (wk, ws) = _pairs(got), _pairs(want)
    row = {k: i for i, k in enumerate(sorted(set(gk) | set(wk)))}
    tie_aware_equal([row[k] for k in gk], gs, [row[k] for k in wk], ws,
                    atol=1e-5 + float(np.linalg.norm(qj - qt)))
    assert float(np.linalg.norm(qj - qt)) < 1e-4
    with pytest.raises(NotImplementedError):
        tsys.search_by_image("frame.jpg")


def test_request_layer_and_batcher_around_the_port(pair_factory):
    _, tsys = pair_factory("float32", True)
    handler = RequestHandler()
    ok, err = handler.validate_request("search", {"query": QUERIES[0], "limit": 5})
    assert ok and err is None
    assert not handler.validate_request("search", {"query": "", "limit": 5})[0]
    hits = tsys.search(QUERIES[0], SearchOptions(limit=5))
    minimal = format_results(hits, "minimal")
    assert len(minimal) == 5 and set(minimal[0]) == {"folder", "image",
                                                     "similarity_score", "rank"}
    batcher = QueryBatcher(tsys, window_ms=50.0, max_batch=8)
    batcher.start()
    answers = {}
    try:
        threads = [threading.Thread(
            target=lambda i=i: answers.__setitem__(i, batcher.search(QUERIES[i], top_k=6)))
            for i in range(len(QUERIES))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.stop()
    for i, query in enumerate(QUERIES):
        want = tsys.search(query, SearchOptions(limit=6, use_cache=False))
        assert _pairs(answers[i])[0] == _pairs(want)[0]
    assert tsys.health.comprehensive_health_check()["components"]["index"]["status"] == "ok"
    stats = tsys.get_system_stats()
    assert stats["index"]["ntotal"] == N and stats["device"] == "cpu"


_BLOCKED_SLICE = r"""
import sys
# JAX, and the packages the card's machine lacks apart from h5py (which
# the container this script writes needs)
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "aiohttp", "msgpack",
             "PIL", "transformers", "zstandard",
             "intelligent_video_analysis_retrieval_system_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.container import IndexContainer
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.serve import (
    QueryBatcher, RequestHandler, format_results)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    SearchOptions, create_system)
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

root = sys.argv[1]
assert Config(config_file=None).get("index.chunk_size") == 1024
rows = np.random.default_rng(0).standard_normal((3000, 32)).astype(np.float32)
with IndexContainer(root + "/i.rvdb", "w", dim=32, dtype="bfloat16") as c:
    c.append_embeddings(rows)
    c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i}
                       for i in range(3000)])
    c.flush_checkpoint()
system = create_system(torch_device="cpu", paths={"cache_dir": root + "/c",
                                                  "temp_dir": root + "/t"})
system.embedder._config_override = CLIPConfig.tiny_test()
system.load_system(root + "/i.rvdb")
assert RequestHandler().validate_request("search", {"query": "a car"})[0]
hits = format_results(system.search("a car", SearchOptions(limit=4)), "standard")
assert len(hits) == 4, hits
assert [len(h) for h in system.search_batch(["a", "b"], SearchOptions(limit=3))] == [3, 3]
b = QueryBatcher(system)
b.start()
assert len(b.search("a boat", top_k=2)) == 2
b.stop()
system.cleanup()
with IndexContainer(root + "/i8.rvdb", "w", dim=32, dtype="int8", keep_fp=True) as c:
    c.append_embeddings(rows)
    c.append_metadata([{"folder": "v", "image": f"{i}.jpg", "frame_id": i}
                       for i in range(3000)])
    c.flush_checkpoint()
system = create_system(torch_device="cpu", paths={"cache_dir": root + "/c8",
                                                  "temp_dir": root + "/t8"},
                       index={"int8_rescore": True})
system.embedder._config_override = CLIPConfig.tiny_test()
system.load_system(root + "/i8.rvdb")
assert system.index._dev_x.dtype == torch.int8
assert len(system.search("a car", SearchOptions(limit=5))) == 5
system.cleanup()
bad = [m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "intelligent_video_analysis_retrieval_system_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("SLICE_OK")
"""


def test_slice_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SLICE, str(tmp_path)],
                          capture_output=True, text=True, cwd=tmp_path, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SLICE_OK" in proc.stdout


def test_port_never_imports_jax():
    pkg = ROOT / "intelligent_video_analysis_retrieval_system_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "flax", "jaxlib"), (path, line)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300, env={"PATH": os.environ["PATH"]})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_device_time_unions_intervals():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 100, "name": "int8_chunk_max_kernel"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 50, "dur": 100, "name": "Memcpy DtoH"},
          {"ph": "X", "cat": "kernel", "ts": 60, "dur": 10, "name": "void chunk_max_bf16_kernel"},
          {"ph": "X", "cat": "cuda_runtime", "ts": 0, "dur": 500, "name": "cudaLaunchKernel"},
          {"ph": "X", "cat": "kernel", "ts": 400, "dur": 20, "name": "elementwise"}]
    busy, ops, per_kernel = chip_smoke.device_time({"traceEvents": ev})
    assert busy == pytest.approx(0.17) and ops == 4   # µs -> ms; runtime calls are host
    assert per_kernel == pytest.approx({"b1": 0.01, "b2": 0.1, "b3": 0.0, "b4": 0.0,
                                        "b5": 0.0})


def test_cli_search(tmp_path, monkeypatch, capsys):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert

    _write_index(tmp_path / "cli.rvdb", "bfloat16")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(convert.CLIPConfig, "vit_l_14", classmethod(
        lambda cls: CLIPConfig.tiny_test()))
    assert cli.main(["search", str(tmp_path / "cli.rvdb"), "a red car", "--device",
                     "cpu", "--limit", "3", "--json"]) == 0
    hits = json.loads(capsys.readouterr().out)
    assert len(hits) == 3 and hits[0]["rank"] == 1


def _write_int8_index(path: Path) -> None:
    """A JAX-written int8 index with the bf16 copy (keep_fp); rows 3, 40
    and 2000 duplicate row 11 (exact int8 ties)."""
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    rows[[3, 40, 2000]] = rows[11]
    with JaxContainer(path, "w", dim=DIM, dtype="int8", keep_fp=True) as c:
        c.append_embeddings(rows)
        c.append_metadata([{"folder": f"vid{i // 250}", "image": f"{i % 250}.jpg",
                            "frame_id": i % 250, "row_id": i} for i in range(N)])
        c.flush_checkpoint()


@pytest.mark.parametrize("rescore", [False, True])
def test_int8_facade_matches_jax_bit_for_bit(tmp_path, rescore):
    """Both facades over one int8 index, fed the same query vectors (the
    port's text tower encodes for both, so the query quantization sees the
    same bits): the same keyframes and the same scores, exactly."""
    _write_int8_index(tmp_path / "i8.rvdb")
    over = {"index": {"dtype": "int8", "int8_rescore": rescore}}
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), parity_mode=True)
    jsys = JaxSystem(Config(config_file=None, base_dir=tmp_path, overrides=over),
                     embedder=jemb)
    jsys.load_system(tmp_path / "i8.rvdb")
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), parity_mode=True, device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    tsys = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path, overrides=over), embedder=temb,
        device="cpu")
    tsys.load_system(tmp_path / "i8.rvdb")
    assert tsys.index._dev_x.dtype == torch.int8
    assert tsys.index.config.int8_rescore is rescore
    jemb.encode_text = lambda texts: temb.encode_text(texts)
    for query in QUERIES:
        for limit in (1, 10, 37):
            want = jsys.search(query, JaxOptions(limit=limit))
            got = tsys.search(query, SearchOptions(limit=limit))
            assert len(got) == len(want) == limit
            (gk, gs), (wk, ws) = _pairs(got), _pairs(want)
            assert gk == wk
            np.testing.assert_array_equal(gs, ws)
    want = jsys.search_batch(QUERIES, JaxOptions(limit=9))
    got = tsys.search_batch(QUERIES, SearchOptions(limit=9))
    for g, w in zip(got, want):
        assert _pairs(g)[0] == _pairs(w)[0]
        np.testing.assert_array_equal(_pairs(g)[1], _pairs(w)[1])
    # the tie group comes back lowest row first, in both
    qvec = tsys.index.read_rows_f32(11, 12)
    hits = tsys.index.search_vectors(qvec, top_k=4)[0]
    jhits = jsys.index.search_vectors(qvec, top_k=4)[0]
    assert [h.metadata.row_id for h in hits] == [h.metadata.row_id for h in jhits]
    if not rescore:
        assert [h.metadata.row_id for h in hits] == [3, 11, 40, 2000]
    for system in (jsys, tsys):
        system.cleanup()


@pytest.mark.parametrize("search", ["exact", "int8_rescore"])
def test_cli_evaluate_matches_jax(tmp_path, monkeypatch, capsys, search):
    from intelligent_video_analysis_retrieval_system_tpu import cli as jcli
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    _write_int8_index(tmp_path / "ev.rvdb")
    monkeypatch.chdir(tmp_path)
    args = ["evaluate", str(tmp_path / "ev.rvdb"), "--search", search, "--queries", "16",
            "--noise", "0.3"]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["dtype"] == "int8" and got["queries"] == 16


def test_cli_stats_and_ann_evaluate(tmp_path, monkeypatch, capsys):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    _write_int8_index(tmp_path / "st.rvdb")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["stats", str(tmp_path / "st.rvdb"), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["ntotal"] == N and stats["container"]["dtype"] == "int8"
    with pytest.raises(NotImplementedError):
        cli.main(["evaluate", str(tmp_path / "st.rvdb"), "--search", "ann",
                  "--device", "cpu"])


def test_unported_entry_points_raise(tmp_path):
    system = create_system(torch_device="cpu", paths={"cache_dir": str(tmp_path)})
    for call in (lambda: system.chat("hi"),
                 lambda: system.start_server(), lambda: system.index_videos([]),
                 lambda: system.export_portable_index(tmp_path),
                 lambda: CLIPEmbedder(compute_dtype="int8", device="cpu"),
                 lambda: EnhancedRetrievalSystem(device="cpu", mesh=object()),
                 lambda: create_system(torch_device="cpu",
                                       index={"index_type": "IndexIVFFlat"})._index_config()):
        with pytest.raises(NotImplementedError):
            call()


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        create_system(torch_device="cuda")
    with pytest.raises(RuntimeError):
        CLIPEmbedder(device="cuda")
    # and "cuda" is every entry point's default: the caller asks for the CPU
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.metadata import (
        MetadataManager,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
        quick_search,
    )

    for entry in (create_system, EnhancedRetrievalSystem, CLIPEmbedder, UnifiedIndex,
                  MetadataManager, lambda: quick_search("none.rvdb", "a car")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


# ---------------------------------------------------------------------------
# build_system
# ---------------------------------------------------------------------------


def _write_keyframes(root: Path, folders=(("video_1", 7), ("video_2", 6))) -> tuple[Path, Path]:
    from PIL import Image

    rng = np.random.default_rng(8)
    (root / "map").mkdir(parents=True)
    for folder, count in folders:
        (root / "keyframes" / folder).mkdir(parents=True)
        lines = ["n,pts_time,fps,frame_idx"]
        for n in range(1, count + 1):
            cells = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
            Image.fromarray(np.kron(cells, np.ones((8, 8, 1), np.uint8))).save(
                root / "keyframes" / folder / f"{n}.jpg", quality=92)
            lines.append(f"{n},{n * 0.4},25.0,{n * 10}")
        (root / "map" / f"{folder}.csv").write_text("\n".join(lines) + "\n")
    return root / "keyframes", root / "map"


def _build_pair(root: Path, parity: bool, index_over: dict | None = None):
    """(jax system, port system, jax events, port events), each built from
    the tree under ``root`` with the same tower params."""
    keyframes, map_dir = _write_keyframes(root / "data")
    over = {"index": {"chunk_size": 4, **(index_over or {})}}
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), parity_mode=parity)
    jsys = JaxSystem(Config(config_file=None, base_dir=root / "j", overrides=over),
                     embedder=jemb)
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), parity_mode=parity, device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    tsys = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=root / "t", overrides=over), embedder=temb,
        device="cpu")
    events = {"j": [], "t": []}
    jsys.on("build_progress", lambda **kw: events["j"].append(kw))
    tsys.on("build_progress", lambda **kw: events["t"].append(kw))
    jout = jsys.build_system(keyframes, map_dir=map_dir, output_path=root / "j" / "i.rvdb")
    tout = tsys.build_system(keyframes, map_dir=map_dir, output_path=root / "t" / "i.rvdb")
    return jsys, tsys, events, jout, tout, keyframes


@pytest.mark.parametrize("parity", [True, False])
def test_build_system_matches_jax(tmp_path, parity):
    jsys, tsys, events, jout, tout, keyframes = _build_pair(tmp_path, parity)
    try:
        for key in ("total_files", "processed", "skipped_resume", "failed", "chunks", "resumed"):
            assert tout["report"][key] == jout["report"][key], key
        assert tout["report"]["processed"] == 13 and tout["report"]["chunks"] == 4
        assert tout["index_path"] == str(tmp_path / "t" / "i.rvdb") and tsys.is_built
        # the events of the six-step build, in order, as the JAX facade emits them
        assert events["t"] == events["j"]
        assert [e["stage"] for e in events["t"]] == \
            ["validate", "build", "build", "build", "build", "index", "done"]
        assert events["t"][4] == {"stage": "build", "done": 13, "total": 13}
        assert [m.key for m in tsys.index._metadata] == [m.key for m in jsys.index._metadata]
        assert tsys.index.get_metadata(8).frame_id == 20
        # the rows: within the towers' own difference (f32 1e-4; bf16 cosine gate)
        rj, rt = jsys.index.read_rows_f32(), tsys.index.read_rows_f32()
        rj = rj / np.linalg.norm(rj, axis=-1, keepdims=True)
        rt = rt / np.linalg.norm(rt, axis=-1, keepdims=True)
        d_rows = float(np.linalg.norm(rj - rt, axis=-1).max())
        if parity:
            assert d_rows < 1e-4
        else:
            assert np.sum(rj * rt, axis=-1).min() >= 0.999
        # served: the same frames for text and image queries
        from PIL import Image

        img = np.asarray(Image.open(keyframes / "video_2" / "3.jpg").convert("RGB"))
        cases = [(lambda s, o: s.search(QUERIES[0], o),
                  lambda s: s.embedder.encode_text([tsys._clip_prompt(
                      QUERIES[0], SearchOptions())[0]])[0]),
                 (lambda s, o: s.search_by_image(img, o),
                  lambda s: s.embedder.encode_images(img[None])[0])]
        for ask, encode in cases:
            want, got = ask(jsys, JaxOptions(limit=6)), ask(tsys, SearchOptions(limit=6))
            assert len(got) == len(want) == 6
            d_q = float(np.linalg.norm(encode(jsys) - encode(tsys)))
            (gk, gs), (wk, ws) = _pairs(got), _pairs(want)
            row = {k: i for i, k in enumerate(sorted(set(gk) | set(wk)))}
            tie_aware_equal([row[k] for k in gk], gs, [row[k] for k in wk], ws,
                            atol=ATOL_TOPK + d_q + d_rows)
        top = tsys.search_by_image(img, SearchOptions(limit=1))[0]
        assert (top["folder"], top["image"]) == ("video_2", "3.jpg")
        # a second build resumes and skips everything
        again = tsys.build_system(keyframes, map_dir=tmp_path / "data" / "map",
                                  output_path=tmp_path / "t" / "i.rvdb")
        assert again["report"]["skipped_resume"] == 13 and tsys.index.ntotal == 13
    finally:
        jsys.cleanup()
        tsys.cleanup()


def test_build_system_int8_dtype_builds_an_int8_container(tmp_path):
    keyframes, map_dir = _write_keyframes(tmp_path / "data")
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), device="cpu")
    tsys = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=tmp_path, overrides={
            "index": {"dtype": "int8", "int8_rescore": True, "chunk_size": 8}}),
        embedder=temb, device="cpu")
    cfg = tsys._index_config()
    assert (cfg.dtype, cfg.chunk_size, cfg.int8_rescore, cfg.store_thumbnails) == \
        ("int8", 8, True, True)
    out = tsys.build_system(keyframes, map_dir=map_dir)      # default output path
    try:
        assert out["index_path"] == str(tsys.config.path("index_dir") / "index.rvdb")
        assert tsys.index._dev_x.dtype == torch.int8 and tsys.index._dev_scales is not None
        assert tsys.index._container.dtype == "int8" and tsys.index._container.has_fp_rows
        assert Path(out["index_path"] + ".flat8").is_file()
        assert len(tsys.search("a red car", SearchOptions(limit=5))) == 5
        # a JAX system loads what the port built
        jsys = JaxSystem(Config(config_file=None, base_dir=tmp_path / "j"),
                         embedder=JaxEmbedder(config=JaxCLIPConfig.tiny_test()))
        tsys.cleanup()
        jsys.load_system(out["index_path"])
        assert jsys.index.ntotal == 13
        jsys.cleanup()
    finally:
        tsys.cleanup()
    with pytest.raises(ValueError):
        tsys.build_system(tmp_path / "nowhere")


def test_cli_build_then_search(tmp_path, monkeypatch, capsys):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli
    from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert

    keyframes, map_dir = _write_keyframes(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(convert.CLIPConfig, "vit_l_14", classmethod(
        lambda cls: CLIPConfig.tiny_test()))
    out = tmp_path / "out" / "cli.rvdb"
    assert cli.main(["build", str(keyframes), "--output", str(out), "--map-dir", str(map_dir),
                     "--chunk-size", "5", "--dtype", "int8", "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "indexed 13 images" in said and "0 failures" in said and str(out) in said
    with JaxContainer(out, "r") as c:
        assert c.num_rows == 13 and c.dtype == "int8"
    assert cli.main(["build", str(keyframes), "--output", str(out), "--map-dir", str(map_dir),
                     "--dtype", "int8", "--device", "cpu"]) == 0
    assert "skipped 13 already-processed" in capsys.readouterr().out
    assert cli.main(["search", str(out), "a red car", "--device", "cpu", "--limit", "3",
                     "--json"]) == 0
    hits = json.loads(capsys.readouterr().out)
    assert len(hits) == 3 and hits[0]["rank"] == 1 and hits[0]["folder"].startswith("video_")
    with pytest.raises(NotImplementedError):
        cli.main(["build", str(keyframes), "--output", str(tmp_path / "w.rvdb"),
                  "--compute-dtype", "int8", "--device", "cpu"])
    assert cli._build_parser().parse_args(["build", "k"]).device == "cuda"
