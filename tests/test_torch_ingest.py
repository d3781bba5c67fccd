"""The port's keyframe ingest against the JAX package's, end to end on the CPU.

- Stage 1: ``FrameFilter.extract_frames`` of both packages over the same
  cv2-written videos (64 x 64, static scenes with per-frame noise, as
  ``tests/test_ingest_pipeline.py`` makes them) with the default pixel
  embedder: the same keyframe JPEGs byte for byte and the same map CSVs,
  with the phash prefilter, with batches shorter than a scene (the carry),
  with frame sampling and with duplicate stems; ``extract_frames_parallel``
  with two spawned workers writes the same bytes as the sequential path.
- Stage 2: ``apply_filters`` in place, in copy mode, with the map rewrite,
  with clustering and with the three presets: the same reports and the same
  survivors as the JAX package, on keyframes whose quality scores lie at
  least 1e-5 (relative) from their percentile thresholds and whose dedup
  similarities lie at least 1e-5 from theirs, computed in f64 and asserted.
- ``index_videos`` of both facades (tiny CLIP towers with the same weights)
  and the CLI's ``extract`` and ``filter`` against the JAX CLI.

Every test needs cv2 (the JAX package's ingest tests skip without it too).
"""

import hashlib
import shutil
from dataclasses import asdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from PIL import Image  # noqa: E402

from intelligent_video_analysis_retrieval_system_tpu import cli as jcli  # noqa: E402
from intelligent_video_analysis_retrieval_system_tpu.ingest import (  # noqa: E402
    FrameFilter as JaxFilter,
)
from intelligent_video_analysis_retrieval_system_tpu.ingest import (  # noqa: E402
    FrameFilterConfig as JaxFilterConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.ingest import (  # noqa: E402
    VideoReader as JaxVideoReader,
)
from intelligent_video_analysis_retrieval_system_tpu.ingest import (  # noqa: E402
    probe_video as jax_probe_video,
)
from intelligent_video_analysis_retrieval_system_tpu.models.clip import (  # noqa: E402
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (  # noqa: E402
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (  # noqa: E402
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import (  # noqa: E402
    Config as JaxConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch import cli  # noqa: E402
from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import (  # noqa: E402
    FrameFilter,
    FrameFilterConfig,
    VideoReader,
    probe_video,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ingest.frames import (  # noqa: E402
    default_pixel_embedder,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (  # noqa: E402
    CLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quality  # noqa: E402
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import (  # noqa: E402
    CLIPEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (  # noqa: E402
    EnhancedRetrievalSystem,
    SearchOptions,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import (  # noqa: E402
    Config,
)

torch.set_num_threads(2)

MARGIN = 1e-5


def make_video(path: Path, n_scenes: int, frames_per_scene: int = 30, size: int = 64,
               seed: int = 0) -> None:
    """Static scenes with small per-frame noise (dedup keeps ~1 frame each)."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size))
    for _ in range(n_scenes):
        base = rng.integers(0, 200, (size, size, 3)).astype(np.uint8)
        for _ in range(frames_per_scene):
            writer.write(cv2.add(base, rng.integers(0, 3, base.shape).astype(np.uint8)))
    writer.release()


def tree_digest(root: Path) -> dict[str, str]:
    """Relative path -> sha256 of every file under ``root``."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    paths = []
    for i in range(3):
        make_video(d / f"vid{i}.mp4", n_scenes=3 + i, seed=i)
        paths.append(d / f"vid{i}.mp4")
    return paths


def _report_fields(reports):
    return [(r.video, r.frames_seen, r.frames_kept, r.phash_dropped, r.fps) for r in reports]


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------


def test_video_copy_reads_what_the_original_reads(videos):
    assert asdict(probe_video(videos[1])) == asdict(jax_probe_video(videos[1]))
    for kw in ({"batch_size": 16}, {"batch_size": 7, "sample_every": 3, "max_frames": 20}):
        ours, theirs = list(VideoReader(videos[1], **kw)), list(JaxVideoReader(videos[1], **kw))
        assert len(ours) == len(theirs) > 1
        for (ia, fa), (ib, fb) in zip(ours, theirs):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(fa, fb)
    with pytest.raises(IOError):
        probe_video(videos[0].parent / "missing.mp4")


EXTRACT_CASES = {
    "default": {"frame_batch": 16},
    "phash": {"frame_batch": 16, "use_phash_prefilter": True},
    "carry": {"frame_batch": 8},
    "sampled": {"frame_batch": 16, "sample_every": 3, "dedup_resize": 32},
}


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_frames_matches_jax_byte_for_byte(videos, tmp_path, case):
    kw = EXTRACT_CASES[case]
    want = JaxFilter(JaxFilterConfig(**kw)).extract_frames_batch(
        videos, tmp_path / "j" / "kf", tmp_path / "j" / "map")
    got = FrameFilter(FrameFilterConfig(**kw), device="cpu").extract_frames_batch(
        videos, tmp_path / "t" / "kf", tmp_path / "t" / "map")
    assert _report_fields(got) == _report_fields(want)
    digest = tree_digest(tmp_path / "t")
    assert digest == tree_digest(tmp_path / "j")
    assert sum(name.endswith(".jpg") for name in digest) == sum(r.frames_kept for r in got)
    if case == "phash":
        assert sum(r.phash_dropped for r in got) > 0
    if case in ("default", "carry"):   # one keyframe per static scene
        assert [r.frames_kept for r in got] == [3, 4, 5]
    text = (tmp_path / "t" / "map" / "vid0.csv").read_text().splitlines()
    assert text[0] == "n,pts_time,fps,frame_idx" and text[1].startswith("0,0.0,25.0,0")


def test_extract_frames_batch_uniquifies_duplicate_stems_as_jax(tmp_path):
    for sub in ("d1", "d2"):
        (tmp_path / sub).mkdir()
        make_video(tmp_path / sub / "clip.mp4", n_scenes=2, frames_per_scene=8,
                   seed=len(sub) + (sub == "d2"))
    paths = [tmp_path / "d1" / "clip.mp4", tmp_path / "d2" / "clip.mp4"]
    JaxFilter(JaxFilterConfig(frame_batch=16)).extract_frames_batch(
        paths, tmp_path / "j" / "kf", tmp_path / "j" / "map")
    got = FrameFilter(FrameFilterConfig(frame_batch=16), device="cpu").extract_frames_batch(
        paths, tmp_path / "t" / "kf", tmp_path / "t" / "map")
    assert [r.video for r in got] == ["clip", "clip_2"]
    assert (tmp_path / "t" / "map" / "clip_2.csv").is_file()
    assert tree_digest(tmp_path / "t") == tree_digest(tmp_path / "j")


@pytest.mark.parametrize("phash", [False, True])
def test_parallel_workers_write_what_the_sequential_path_writes(videos, tmp_path, phash):
    cfg = FrameFilterConfig(frame_batch=32, dedup_resize=32, use_phash_prefilter=phash)
    ff = FrameFilter(cfg, device="cpu")
    seq = ff.extract_frames_batch(videos, tmp_path / "seq" / "kf", tmp_path / "seq" / "map")
    par = ff.extract_frames_batch(videos, tmp_path / "par" / "kf", tmp_path / "par" / "map",
                                  workers=2)
    assert _report_fields(par) == _report_fields(seq)
    assert tree_digest(tmp_path / "par") == tree_digest(tmp_path / "seq")
    JaxFilter(JaxFilterConfig(frame_batch=32, dedup_resize=32, use_phash_prefilter=phash)
              ).extract_frames_batch(videos, tmp_path / "j" / "kf", tmp_path / "j" / "map")
    assert tree_digest(tmp_path / "par") == tree_digest(tmp_path / "j")


def test_parallel_bad_video_raises_after_finishing_the_rest(videos, tmp_path):
    bogus = tmp_path / "broken.mp4"
    bogus.write_bytes(b"not a video at all")
    ff = FrameFilter(FrameFilterConfig(frame_batch=32, dedup_resize=32), device="cpu")
    with pytest.raises(RuntimeError, match="broken"):
        ff.extract_frames_batch([videos[0], bogus], tmp_path / "kf", tmp_path / "map",
                                workers=2)
    assert (tmp_path / "map" / "vid0.csv").is_file()
    assert any((tmp_path / "kf" / "vid0").glob("*.jpg"))


def test_dedup_step_masks_equal_the_scan_over_the_same_embeddings(videos):
    """The fused step (embed on the device, then the carried scan) keeps what
    the scan keeps over the embedder's own output, batch after batch."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.dedup import (
        sequential_dedup_carry,
    )

    ff = FrameFilter(FrameFilterConfig(frame_batch=16), device="cpu")
    carry, ref_carry, kept = None, torch.zeros(192), 0
    for _, frames in VideoReader(videos[2], batch_size=16):
        small = ff._host_shrink(frames, 64)
        keep, carry = ff.dedup_step(small, carry)
        want, ref_carry = sequential_dedup_carry(
            torch.from_numpy(ff.embed_fn(small)), ref_carry, 0.98)
        np.testing.assert_array_equal(keep, want.numpy())
        kept += int(keep.sum())
    assert kept == 5


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------


def _write_keyframes(root: Path) -> Path:
    """Two folders of 256 x 256 JPEGs: sharp random frames in near-duplicate
    groups of 3-4 (jitter of +-2), a run of flat (blurry, edgeless) frames,
    and map CSVs."""
    rng = np.random.default_rng(3)
    (root / "map").mkdir(parents=True)
    for folder, groups in (("vid_a", (4, 1, 3, 1, 4)), ("vid_b", (3, 3, 1))):
        out = root / "keyframes" / folder
        out.mkdir(parents=True)
        n = 0
        for size in groups:
            base = rng.integers(0, 255, (256, 256, 3))
            for _ in range(size):
                jitter = np.clip(base + rng.integers(-2, 3, base.shape), 0, 255)
                Image.fromarray(jitter.astype(np.uint8)).save(out / f"{n}.jpg", quality=95)
                n += 1
        for grey in (96, 128):
            Image.fromarray(np.full((256, 256, 3), grey, np.uint8)).save(out / f"{n}.jpg",
                                                                          quality=95)
            n += 1
        lines = ["n,pts_time,fps,frame_idx"] + [f"{i},{i * 0.5},25.0,{i * 12}"
                                                 for i in range(n)]
        (root / "map" / f"{folder}.csv").write_text("\n".join(lines) + "\n")
    return root / "keyframes"


def _assert_margins(keyframes: Path, cfg: FrameFilterConfig) -> None:
    """Scores clear of their percentile thresholds and similarities clear of
    the dedup threshold by at least the margin, in f64."""
    ff = FrameFilter(cfg, device="cpu")
    for folder, images in ff.fm.scan_keyframes(keyframes).items():
        pixels = ff._load_uniform([keyframes / folder / img for img in images])
        metrics = quality.quality_metrics(torch.from_numpy(pixels))
        for key, p in (("blur", cfg.blur_drop_percentile), ("edges", cfg.edge_drop_percentile)):
            scores = metrics[key].numpy().astype(np.float64)
            thr = np.percentile(scores, p)
            gap = np.abs(scores - thr) / max(abs(thr), 1e-30)
            assert np.all((gap >= MARGIN) | (scores == thr)), (folder, key)
        emb = default_pixel_embedder(device="cpu")(pixels).astype(np.float64)
        unit = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        sims = unit @ unit.T
        for thr in (cfg.in_scene_similarity, 1.0 - cfg.cluster_eps, cfg.scene_threshold):
            assert np.abs(sims - thr).min() >= MARGIN


FILTER_CASES = {
    "in_place": ({"blur_drop_percentile": 15.0, "edge_drop_percentile": 15.0}, False, False),
    "copy": ({"blur_drop_percentile": 15.0, "edge_drop_percentile": 15.0}, True, False),
    "copy_map": ({}, True, True),
    "in_place_map": ({}, False, True),
    "cluster": ({"use_clustering": True}, True, True),
    "gentle": ("gentle", True, False),
    "ultra_gentle": ("ultra_gentle", True, False),
    "similarity_only": ("similarity_only", True, True),
}


def _config(cls, spec):
    return getattr(cls, spec)() if isinstance(spec, str) else cls(**spec)


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_apply_filters_matches_jax(tmp_path, case):
    spec, copy_mode, with_map = FILTER_CASES[case]
    for side in ("j", "t"):
        _write_keyframes(tmp_path / side)
    cfg = _config(FrameFilterConfig, spec)
    _assert_margins(tmp_path / "t" / "keyframes", cfg)
    reports = {}
    for side, ff in (("j", JaxFilter(_config(JaxFilterConfig, spec))),
                     ("t", FrameFilter(cfg, device="cpu"))):
        root = tmp_path / side
        reports[side] = ff.apply_filters(
            root / "keyframes",
            output_dir=root / "out" if copy_mode else None,
            map_dir=root / "map" if with_map else None,
            output_map_dir=root / "out_map" if (with_map and copy_mode) else None,
        ).as_dict()
    assert reports["t"] == reports["j"]
    rep = reports["t"]
    assert rep["folders"] == 2 and rep["frames_in"] == 24
    assert rep["frames_out"] < rep["frames_in"]
    assert rep["dropped_similarity"] > 0
    assert tree_digest(tmp_path / "t") == tree_digest(tmp_path / "j")
    if copy_mode:   # the sources stay; survivors are copied
        assert len(list((tmp_path / "t" / "keyframes").rglob("*.jpg"))) == 24
        assert len(list((tmp_path / "t" / "out").rglob("*.jpg"))) == rep["frames_out"]
    else:
        assert len(list((tmp_path / "t" / "keyframes").rglob("*.jpg"))) == rep["frames_out"]
    if with_map:
        maps = tmp_path / "t" / ("out_map" if copy_mode else "map")
        rows = sum(len(p.read_text().splitlines()) - 1 for p in maps.glob("*.csv"))
        assert rows == rep["frames_out"]


def test_presets_are_the_reference_presets():
    for name in ("gentle", "ultra_gentle", "similarity_only"):
        ours, theirs = getattr(FrameFilterConfig, name)(), getattr(JaxFilterConfig, name)()
        assert {k: getattr(ours, k) for k in FrameFilterConfig.__dataclass_fields__} == \
            {k: getattr(theirs, k) for k in JaxFilterConfig.__dataclass_fields__}


# ---------------------------------------------------------------------------
# index_videos and the CLI
# ---------------------------------------------------------------------------


def test_index_videos_matches_jax(videos, tmp_path):
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), parity_mode=True)
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), parity_mode=True, device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    over = {"ingest": {"frame_batch": 16}, "index": {"chunk_size": 8}}
    jsys = JaxSystem(JaxConfig(config_file=None, base_dir=tmp_path / "j", overrides=over),
                     embedder=jemb)
    tsys = EnhancedRetrievalSystem(Config(config_file=None, base_dir=tmp_path / "t",
                                          overrides=over), embedder=temb, device="cpu")
    try:
        want = jsys.index_videos(videos[:2])
        got = tsys.index_videos(videos[:2])
        keys = ("video", "frames_seen", "frames_kept", "phash_dropped", "fps")
        assert [{k: r[k] for k in keys} for r in got["extract"]] == \
            [{k: r[k] for k in keys} for r in want["extract"]]
        for key in ("total_files", "processed", "failed", "chunks"):
            assert got["report"][key] == want["report"][key], key
        assert got["report"]["processed"] == 7 and tsys.is_built
        kf_t, kf_j = (s.config.path("keyframes_dir") for s in (tsys, jsys))
        assert tree_digest(kf_t) == tree_digest(kf_j)
        assert tree_digest(tsys.config.path("map_dir")) == tree_digest(jsys.config.path("map_dir"))
        rows_t, rows_j = tsys.index.read_rows_f32(), jsys.index.read_rows_f32()
        assert [m.key for m in tsys.index._metadata] == [m.key for m in jsys.index._metadata]
        np.testing.assert_allclose(rows_t, rows_j, atol=1e-4)
        img = np.asarray(Image.open(kf_t / "vid1" / "2.jpg").convert("RGB"))
        top = tsys.search_by_image(img, SearchOptions(limit=1))[0]
        assert (top["folder"], top["image"]) == ("vid1", "2.jpg")
        # a second run resumes: the same keyframes, nothing embedded again
        again = tsys.index_videos(videos[:2])
        assert again["report"]["skipped_resume"] == 7 and tsys.index.ntotal == 7
    finally:
        jsys.cleanup()
        tsys.cleanup()


def test_cli_extract_and_filter_match_the_jax_cli(videos, tmp_path, capsys):
    out = {}
    for side, main, extra in (("j", jcli.main, []), ("t", cli.main, ["--device", "cpu"])):
        root = tmp_path / side
        assert main(["extract", *map(str, videos), "--keyframes-dir", str(root / "kf"),
                     "--map-dir", str(root / "map"), "--batch", "16", "--phash", *extra]) == 0
        extracted = capsys.readouterr().out.splitlines()
        assert main(["filter", str(root / "kf"), "--output-dir", str(root / "refined"),
                     "--map-dir", str(root / "map"), "--output-map-dir",
                     str(root / "refined_map"), "--similarity-only", *extra]) == 0
        # the extract lines end with a rate, which differs from run to run
        out[side] = [line.split(" (")[0] for line in extracted] + \
            capsys.readouterr().out.splitlines()
    assert out["t"] == out["j"]
    assert out["t"][0] == "vid0: kept 3/90 frames"
    assert out["t"][3].startswith("3 folders: 12 -> ")
    assert tree_digest(tmp_path / "t") == tree_digest(tmp_path / "j")
    shutil.rmtree(tmp_path / "j")
