"""The small completions of the ported index, metadata manager, facade and
temporal analysis, each against its JAX counterpart on the same inputs.

- ``UnifiedIndex``: ``delete_keys``, ``is_deleted``, ``augmented_search``
  (the ``temporal_window`` config field), ``get_thumbnail``,
  ``get_full_image`` and ``_resolve_row`` over one JAX-written container.
- ``MetadataManager``: ``get``, ``folders``, ``get_temporal_neighbors``,
  ``get_similar_frames``, ``get_scene_boundaries``.
- the facade: ``chat`` (the greeting, then ``chat_search``), ``export_data``
  (json, csv), ``optimize``; f32 parity-mode towers carried across.
- ``retrieval.temporal``: f32 within 1e-5 of the jitted JAX functions.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.index.metadata import (
    MetadataManager as JaxMetadataManager,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndex as JaxIndex,
)
from intelligent_video_analysis_retrieval_system_tpu.index.unified import (
    UnifiedIndexConfig as JaxConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.retrieval import temporal as jtemporal
from intelligent_video_analysis_retrieval_system_tpu.retrieval.results import (
    KeyframeMetadata as JaxMeta,
)
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config
from intelligent_video_analysis_retrieval_system_tpu_torch.index.metadata import (
    MetadataManager,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval import temporal
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.results import (
    KeyframeMetadata,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (
    CLIPEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
)

torch.set_num_threads(2)

N, DIM = 600, 32


def _record(i: int, path: str = "") -> dict:
    # frame gaps of 3 with a jump every 40 frames: scene boundaries to find
    return {"folder": f"vid{i // 100}", "image": f"{i % 100:03d}.jpg",
            "frame_id": (i % 100) * 3 + 20 * ((i % 100) // 40), "row_id": i, "path": path}


def _write(path: Path, original: Path) -> np.ndarray:
    rows = np.random.default_rng(3).standard_normal((N, DIM)).astype(np.float32)
    with JaxContainer(path, "w", dim=DIM, dtype="float32") as c:
        c.append_embeddings(rows)
        c.append_metadata([_record(i, str(original) if i == 7 else "") for i in range(N)])
        c.append_thumbnails([b"thumb%d" % i for i in range(N)])
        c.flush_checkpoint()
    return rows


@pytest.fixture()
def index_pair(tmp_path):
    original = tmp_path / "frame7.jpg"
    original.write_bytes(b"original bytes of frame 7")
    rows = _write(tmp_path / "a.rvdb", original)
    shutil.copy(tmp_path / "a.rvdb", tmp_path / "b.rvdb")
    j = JaxIndex(JaxConfig(temporal_window=3)).load_unified_index(tmp_path / "a.rvdb", mode="a")
    t = UnifiedIndex(UnifiedIndexConfig(temporal_window=3), device="cpu").load_unified_index(
        tmp_path / "b.rvdb", mode="a")
    yield j, t, rows
    j.close()
    t.close()


def test_delete_keys_and_is_deleted_match_jax(index_pair):
    j, t, rows = index_pair
    keys = [("vid0", "005.jpg"), ("vid2", "010.jpg"), ("nope", "x.jpg")]
    assert t.delete_keys(keys) == j.delete_keys(keys) == {"deleted": 2, "num_live": N - 2}
    # a key named twice tombstones its row once (the JAX index counts it twice)
    assert t.delete_keys([("vid3", "001.jpg")] * 2)["deleted"] == 1
    j.delete_keys([("vid3", "001.jpg")])
    for row in (5, 210, 6):
        assert t.is_deleted(row) == j.is_deleted(row)
    q = rows[[5, 210, 300]]
    for hj, ht in zip(j.search_vectors(q, top_k=8), t.search_vectors(q, top_k=8)):
        assert [h.metadata.row_id for h in ht] == [h.metadata.row_id for h in hj]


def test_augmented_search_matches_jax(index_pair):
    j, t, rows = index_pair
    t.delete_rows([41])
    j.delete_rows([41])
    for window in (None, 1):
        want = j.augmented_search(rows[40], top_k=4, temporal_window=window)
        got = t.augmented_search(rows[40], top_k=4, temporal_window=window)
        assert [h.metadata.row_id for h in got] == [h.metadata.row_id for h in want]
        assert [h.temporal_context for h in got] == [h.temporal_context for h in want]
        assert len(got[0].temporal_context) == (2 * 3 - 1 if window is None else 1)


def test_assets_and_resolve_row_match_jax(index_pair):
    j, t, _ = index_pair
    for args in ((3,), ("vid1", "017.jpg"), (599,)):
        assert t.get_thumbnail(*args) == j.get_thumbnail(*args)
        assert t.get_full_image(*args) == j.get_full_image(*args)
    assert t.get_full_image("vid0", "007.jpg") == b"original bytes of frame 7"
    assert t._resolve_row("vid5", "099.jpg") == j._resolve_row("vid5", "099.jpg") == 599
    with pytest.raises(KeyError):
        t._resolve_row("vid9", "000.jpg")


def _managers():
    rng = np.random.default_rng(4)
    records = [_record(i) for i in range(300)]
    feats = rng.standard_normal((300, DIM)).astype(np.float32)
    feats[1::2] = feats[::2] + 0.2 * rng.standard_normal((150, DIM)).astype(np.float32)
    order = rng.permutation(300)   # records arrive in any order
    jm, tm = JaxMetadataManager(), MetadataManager(device="cpu")
    jm.build_metadata([JaxMeta.from_dict(records[i]) for i in order], feats)
    tm.build_metadata([KeyframeMetadata.from_dict(records[i]) for i in order], feats)
    return jm, tm


def test_metadata_readers_match_jax():
    jm, tm = _managers()
    assert tm.folders() == jm.folders() == ["vid0", "vid1", "vid2"]
    assert tm.get("vid1", "042.jpg").to_dict() == jm.get("vid1", "042.jpg").to_dict()
    assert tm.get("vid1", "missing.jpg") is None is jm.get("vid1", "missing.jpg")
    for folder, image in (("vid0", "000.jpg"), ("vid1", "050.jpg"), ("vid2", "099.jpg"),
                          ("vid3", "000.jpg")):
        for window in (1, 3):
            assert [m.image for m in tm.get_temporal_neighbors(folder, image, window)] == \
                [m.image for m in jm.get_temporal_neighbors(folder, image, window)]
        sim_t, sim_j = tm.get_similar_frames(folder, image), jm.get_similar_frames(folder, image)
        assert [n for n, _ in sim_t] == [n for n, _ in sim_j]
        np.testing.assert_allclose([s for _, s in sim_t], [s for _, s in sim_j], atol=1e-5)
    for folder in ("vid0", "vid2", "none"):
        assert tm.get_scene_boundaries(folder) == jm.get_scene_boundaries(folder)
    assert tm.get_scene_boundaries("vid0") == [0, 40, 80]


@pytest.fixture(scope="module")
def system_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("chat")
    original = root / "frame7.jpg"
    original.write_bytes(b"x")
    _write(root / "index.rvdb", original)
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), parity_mode=True)
    jsys = JaxSystem(Config(config_file=None, base_dir=root), embedder=jemb)
    jsys.load_system(root / "index.rvdb")
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), parity_mode=True, device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    tsys = EnhancedRetrievalSystem(Config(config_file=None, base_dir=root), embedder=temb,
                                   device="cpu")
    tsys.load_system(root / "index.rvdb")
    yield jsys, tsys
    jsys.cleanup()
    tsys.cleanup()


@pytest.mark.parametrize("message", ["hi", "  Xin chào ", "a red car at night",
                                     "people walking on a beach"])
def test_chat_matches_jax(system_pair, message):
    jsys, tsys = system_pair
    want, got = jsys.chat(message), tsys.chat(message)
    assert got["method"] == want["method"] and got["response"] == want["response"]
    assert [(r["folder"], r["image"]) for r in got["search_results"]] == \
        [(r["folder"], r["image"]) for r in want["search_results"]]


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_export_data_matches_jax(system_pair, tmp_path, fmt):
    jsys, tsys = system_pair
    results = tsys.search("a red car at night")[:6]
    want = jsys.export_data(results, tmp_path / f"j.{fmt}")
    got = tsys.export_data(results, tmp_path / "t" / f"t.{fmt}")
    assert got.read_bytes() == want.read_bytes()
    if fmt == "json":
        assert [r["image"] for r in json.loads(got.read_text())] == [r["image"] for r in results]
    with pytest.raises(ValueError):
        tsys.export_data(results, tmp_path / "t.bin", fmt="bin")


def test_optimize_matches_jax(system_pair):
    jsys, tsys = system_pair
    want, got = jsys.optimize(), tsys.optimize()
    assert got.keys() == want.keys() and got["temp_removed"] == want["temp_removed"] == 0
    assert got["cache"].keys() == want["cache"].keys()


def _sequence(seed: int = 0) -> np.ndarray:
    """Three scenes of 12, 3 and 15 frames, rows near their scene's centre."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((3, DIM)).astype(np.float32)
    lengths = (12, 3, 15)
    return np.concatenate([centres[i] + 0.1 * rng.standard_normal((n, DIM)).astype(np.float32)
                           for i, n in enumerate(lengths)])


def test_temporal_analyzer_matches_jax():
    feats = _sequence()
    ja, ta = jtemporal.TemporalAnalyzer(), temporal.TemporalAnalyzer(device="cpu")
    np.testing.assert_allclose(ta.adjacent_similarities(feats), ja.adjacent_similarities(feats),
                               atol=1e-5)
    assert [(s.start, s.end, s.length) for s in ta.detect_scene_boundaries(feats)] == \
        [(s.start, s.end, s.length) for s in ja.detect_scene_boundaries(feats)]
    np.testing.assert_array_equal(ta.assign_shot_ids(feats), ja.assign_shot_ids(feats))
    assert ta.extract_transition_frames(feats) == ja.extract_transition_frames(feats)
    for n in (0, 1):
        assert ta.detect_scene_boundaries(feats[:n]) == [
            temporal.SceneBoundary(s.start, s.end, s.length)
            for s in ja.detect_scene_boundaries(feats[:n])]
    query = feats[20:24] + 0.01
    want = ja.find_similar_sequences(feats, query, top_k=3)
    got = ta.find_similar_sequences(feats, query, top_k=3)
    assert [(g["start"], g["end"]) for g in got] == [(w["start"], w["end"]) for w in want]
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want], atol=1e-5)
    assert ta.find_similar_sequences(feats[:2], query) == []
    scores_j = np.asarray(jtemporal._windowed_sequence_scores(feats, query, 4))
    scores_t = temporal._windowed_sequence_scores(torch.from_numpy(feats),
                                                  torch.from_numpy(query), 4).numpy()
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-5)
    for ids in ([], [5], [0, 10, 20, 35], np.array([9, 3, 27, 30])):
        assert ta.frame_interval_stats(ids) == ja.frame_interval_stats(ids)
