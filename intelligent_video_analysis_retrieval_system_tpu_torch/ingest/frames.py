"""FrameFilter: keyframe extraction and refinement (port of ``ingest/frames.py``).

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ingest/frames.py``.

Stage 1 — ``extract_frames``: video -> batched decode (OpenCV) -> host
shrink to ``dedup_resize`` -> (optional perceptual-hash prefilter) -> the
batch embedded and deduplicated on the device (keep iff cosine < threshold
against the last kept frame, carried across batches; only the (B,) keep
mask comes back) -> ``keyframes/<video>/<n>.jpg`` (``cv2.imwrite``, as the
reference writes them) + ``map/<video>.csv`` (``n,pts_time,fps,frame_idx``).

Stage 2 — ``apply_filters``: per folder, the quality percentile drop
(Laplacian blur + edge density), then in-scene windowed dedup or per-scene
density clustering over the survivors' embeddings, all on the device.

The embedder is injected. The default is a cheap pixel-statistics
embedding; :func:`dino_embedder` is the reference's DINO ViT-S/16 tower
(normalize through kernel B5 and attention through kernel B3 on a card).
An embedder's ``device_fn`` takes a batch already on the device and keeps
its embeddings there, so embed + dedup run without a round trip.

Every entry point runs on the filter's ``device`` (default ``"cuda"``,
which raises where CUDA is missing; ``"cpu"`` runs the plain versions).
torch is imported inside the functions that use it, so that the decode
workers of :mod:`ingest.pipeline`, which import this package, stay cv2 and
numpy only.
"""

from __future__ import annotations

import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from ..utils.files import FileManager
from .video import VideoReader

if TYPE_CHECKING:  # pragma: no cover
    import torch

__all__ = ["FrameFilter", "FrameFilterConfig", "ExtractReport", "FilterReport",
           "default_pixel_embedder", "dino_embedder"]

EmbedFn = Callable[[np.ndarray], np.ndarray]


@dataclass(slots=True)
class FrameFilterConfig:
    # stage 1 (video_frame_filter.py:63-70)
    dedup_threshold: float = 0.98
    frame_batch: int = 128
    sample_every: int = 1
    jpeg_quality: int = 95
    use_phash_prefilter: bool = False
    phash_threshold: int = 5           # filter_research_update.py:43
    # host-side shrink edge before the upload for dedup embedding/phash
    # (full-res frames only matter for the written JPEGs). Set to the
    # embedder's input size for DINO (224); 0 disables.
    dedup_resize: int = 64
    # stage 2 (filter.py:16-21,178-316)
    blur_drop_percentile: float = 10.0
    edge_drop_percentile: float = 10.0
    scene_threshold: float = 0.75
    min_scene_length: int = 5
    in_scene_similarity: float = 0.95
    dedup_window: int = 5
    # alternative stage-2 similarity mode: per-scene density clustering with
    # centroid-nearest representatives (filter_research_update.py:113-155)
    use_clustering: bool = False
    cluster_eps: float = 0.05

    # presets mirroring the reference CLI modes (filter.py:648-739)
    @classmethod
    def gentle(cls) -> "FrameFilterConfig":
        return cls(blur_drop_percentile=5.0, edge_drop_percentile=5.0,
                   in_scene_similarity=0.97)

    @classmethod
    def ultra_gentle(cls) -> "FrameFilterConfig":
        return cls(blur_drop_percentile=2.0, edge_drop_percentile=2.0,
                   in_scene_similarity=0.99)

    @classmethod
    def similarity_only(cls) -> "FrameFilterConfig":
        return cls(blur_drop_percentile=0.0, edge_drop_percentile=0.0)


@dataclass(slots=True)
class ExtractReport:
    video: str
    frames_seen: int = 0
    frames_kept: int = 0
    phash_dropped: int = 0
    fps: float = 0.0
    duration_s: float = 0.0
    frames_per_s: float = 0.0

    def as_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}  # type: ignore[attr-defined]


@dataclass(slots=True)
class FilterReport:
    folders: int = 0
    frames_in: int = 0
    frames_out: int = 0
    dropped_quality: int = 0
    dropped_similarity: int = 0
    per_folder: dict[str, dict[str, int]] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}  # type: ignore[attr-defined]


def _upload(array: np.ndarray, device: "torch.device") -> "torch.Tensor":
    import torch

    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def default_pixel_embedder(size: int = 8, device: "torch.device | str" = "cuda") -> EmbedFn:
    """Cheap embedding: the frame resized to ``size`` x ``size`` (antialiased
    bilinear), flattened, minus its mean. Good enough for near-duplicate
    detection; swap in a tower for semantically aware dedup."""
    import torch

    from ..index.unified import resolve_device
    from ..ops.preprocess import resize_bilinear

    dev = resolve_device(device)

    def device_fn(batch: torch.Tensor) -> torch.Tensor:
        small = resize_bilinear(batch.float(), size, size)     # (B, s, s, 3)
        flat = small.reshape(batch.shape[0], -1)
        return flat - flat.mean(dim=1, keepdim=True)

    def embed(batch: np.ndarray) -> np.ndarray:
        return device_fn(_upload(batch, dev)).cpu().numpy()

    embed.device_fn = device_fn
    return embed


def dino_embedder(
    model_path: str | None = None, dtype: str = "bfloat16", batch_pad: int = 8,
    device: "torch.device | str" = "cuda",
) -> EmbedFn:
    """DINO ViT-S/16 embedding function (the reference's dedup tower):
    bicubic resize to 224, normalize with the ImageNet mean/std (kernel B5 on
    a card), then the tower (attention through kernel B3 on a card in bf16).

    Loads a local ``facebook/dino-vits16`` checkpoint from ``model_path``
    (nothing is downloaded); without one the tower is seeded (still a
    consistent near-duplicate metric). ``embed.tower`` is the module."""
    import torch

    from ..index.unified import resolve_device
    from ..models.convert import load_dino
    from ..models.dino import DINO_IMAGE_MEAN, DINO_IMAGE_STD, DINOConfig, DINOTower
    from ..ops.preprocess import normalize_images, resize_bilinear

    dev = resolve_device(device)
    cfg, state = load_dino(model_path, DINOConfig.vit_s_16(), device=dev)
    compute = torch.float32 if dtype == "float32" else torch.bfloat16
    with torch.device("meta"):
        tower = DINOTower(cfg, dtype=compute)
    tower = tower.to_empty(device=dev)
    tower.load_state_dict(state)
    tower.eval()

    @torch.no_grad()
    def device_fn(batch: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(batch.float(), cfg.image_size, cfg.image_size,
                            method="bicubic")
        x = normalize_images(x, mean=DINO_IMAGE_MEAN, std=DINO_IMAGE_STD, dtype=compute)
        return tower(x).float()

    def embed(batch: np.ndarray) -> np.ndarray:
        b = len(batch)
        b_pad = -(-max(b, batch_pad) // batch_pad) * batch_pad
        if b_pad != b:
            batch = np.concatenate(
                [batch, np.zeros((b_pad - b, *batch.shape[1:]), batch.dtype)])
        return device_fn(_upload(batch, dev))[:b].cpu().numpy()

    embed.device_fn = device_fn
    embed.tower = tower
    return embed


class FrameFilter:
    """Keyframe extraction + refinement over batched device ops."""

    def __init__(
        self,
        config: FrameFilterConfig | None = None,
        embed_fn: EmbedFn | None = None,
        file_manager: FileManager | None = None,
        device: "torch.device | str" = "cuda",
    ) -> None:
        from ..index.unified import resolve_device

        self.config = config or FrameFilterConfig()
        self.device = resolve_device(device)
        self.embed_fn = embed_fn or default_pixel_embedder(device=self.device)
        self.fm = file_manager or FileManager()

    # -- stage 1: extraction ------------------------------------------------

    def dedup_step(self, batch: np.ndarray, carry: "torch.Tensor | None",
                   active: np.ndarray | None = None) -> tuple[np.ndarray, "torch.Tensor"]:
        """One batch of stage 1 on the device: embed (through the embedder's
        ``device_fn`` where it has one, else its host function), then the
        carried dedup scan. ``carry`` None starts a video (zeros). Returns
        the keep mask (one read to the host) and the new carry."""
        import torch

        from ..ops.dedup import sequential_dedup_carry, sequential_dedup_carry_masked

        device_fn = getattr(self.embed_fn, "device_fn", None)
        if device_fn is not None:
            emb = device_fn(_upload(batch, self.device)).float()
        else:
            emb = _upload(np.asarray(self.embed_fn(batch), np.float32), self.device)
        if carry is None:
            carry = torch.zeros((emb.shape[1],), dtype=torch.float32, device=self.device)
        thr = self.config.dedup_threshold
        if active is None:
            keep, carry = sequential_dedup_carry(emb, carry, threshold=thr)
        else:
            keep, carry = sequential_dedup_carry_masked(
                emb, carry, _upload(active, self.device), threshold=thr)
        return keep.cpu().numpy(), carry

    def phash_batch(self, small: np.ndarray) -> np.ndarray:
        """(B, 64) uint8 perceptual-hash bits of a batch, on the device."""
        from ..ops.phash import perceptual_hash

        return perceptual_hash(_upload(small, self.device)).cpu().numpy()

    def extract_frames(
        self,
        video_path: str | Path,
        keyframes_dir: str | Path,
        map_dir: str | Path | None = None,
        video_name: str | None = None,
    ) -> ExtractReport:
        """One video -> deduplicated keyframe JPEGs + frame map CSV."""
        import cv2

        cfg = self.config
        video_path = Path(video_path)
        name = video_name or video_path.stem
        out_dir = Path(keyframes_dir) / name
        out_dir.mkdir(parents=True, exist_ok=True)

        reader = VideoReader(
            video_path, batch_size=cfg.frame_batch, sample_every=cfg.sample_every
        )
        fps = reader.info.fps
        report = ExtractReport(video=name, fps=fps)
        t0 = time.perf_counter()

        carry = None
        last_hash: np.ndarray | None = None
        kept_n = 0
        map_rows: list[dict[str, Any]] = []
        for indices, frames in reader:
            report.frames_seen += len(frames)
            batch = frames
            batch_indices = indices
            # shrink on the host before any upload: the device only needs the
            # small view; full-res frames stay on the host for the JPEGs
            small = self._host_shrink(batch, cfg.dedup_resize)
            if cfg.use_phash_prefilter:
                hashes = self.phash_batch(small)
                keep_hash = self._phash_keep(hashes, last_hash, cfg.phash_threshold)
                if keep_hash.any():
                    last_hash = hashes[np.nonzero(keep_hash)[0][-1]]
                report.phash_dropped += int((~keep_hash).sum())
                batch = batch[keep_hash]
                small = small[keep_hash]
                batch_indices = batch_indices[keep_hash]
                if len(batch) == 0:
                    continue
            # pad to the fixed batch size with copies of the last frame: they
            # can never be kept and never move the carry
            b = len(small)
            if b < cfg.frame_batch:
                pad = np.repeat(small[-1:], cfg.frame_batch - b, axis=0)
                emb_in = np.concatenate([small, pad])
            else:
                emb_in = small
            keep, carry = self.dedup_step(emb_in, carry)
            keep = keep[:b]
            for i in np.nonzero(keep)[0]:
                frame_idx = int(batch_indices[i])
                bgr = cv2.cvtColor(batch[i], cv2.COLOR_RGB2BGR)
                cv2.imwrite(
                    str(out_dir / f"{kept_n}.jpg"), bgr,
                    [cv2.IMWRITE_JPEG_QUALITY, cfg.jpeg_quality],
                )
                map_rows.append(
                    {
                        "n": kept_n,
                        "pts_time": frame_idx / fps if fps > 0 else -1.0,
                        "fps": fps,
                        "frame_idx": frame_idx,
                    }
                )
                kept_n += 1
        report.frames_kept = kept_n
        if map_dir is not None:
            Path(map_dir).mkdir(parents=True, exist_ok=True)
            self.fm.save_csv_mapping(Path(map_dir) / f"{name}.csv", map_rows)
        report.duration_s = time.perf_counter() - t0
        if report.duration_s > 0:
            report.frames_per_s = report.frames_seen / report.duration_s
        return report

    def extract_frames_batch(
        self,
        video_paths: list[str | Path],
        keyframes_dir: str | Path,
        map_dir: str | Path | None = None,
        workers: int = 0,
    ) -> list[ExtractReport]:
        """``extract_frames`` over several videos. ``workers >= 2`` runs the
        multi-process decode pipeline (``ingest.pipeline``): worker processes
        decode, shrink and write while this process runs every device step;
        the decisions are those of the sequential path."""
        # unique output names: "a/clip.mp4" and "b/clip.mp4" must not write
        # into one keyframes/<stem>/ directory
        names: list[str] = []
        seen: dict[str, int] = {}
        for p in video_paths:
            stem = Path(p).stem
            seen[stem] = seen.get(stem, 0) + 1
            names.append(stem if seen[stem] == 1 else f"{stem}_{seen[stem]}")

        if workers >= 2 and len(video_paths) > 1:
            from .pipeline import extract_frames_parallel

            return extract_frames_parallel(
                self, video_paths, keyframes_dir, map_dir, workers=workers,
                names=names,
            )
        return [
            self.extract_frames(p, keyframes_dir, map_dir, video_name=n)
            for p, n in zip(video_paths, names)
        ]

    @staticmethod
    def _host_shrink(batch: np.ndarray, edge: int) -> np.ndarray:
        """cv2 downscale on the host: cuts the upload by ~(H*W)/(edge^2)."""
        if not edge or (batch.shape[1] <= edge and batch.shape[2] <= edge):
            return batch
        import cv2

        out = np.empty((len(batch), edge, edge, 3), batch.dtype)
        for i, frame in enumerate(batch):
            out[i] = cv2.resize(frame, (edge, edge), interpolation=cv2.INTER_AREA)
        return out

    @staticmethod
    def _phash_keep(
        hashes: np.ndarray, last_hash: np.ndarray | None, threshold: int
    ) -> np.ndarray:
        keep = np.ones(len(hashes), dtype=bool)
        prev = last_hash
        for i in range(len(hashes)):
            if prev is not None and int(np.sum(hashes[i] != prev)) <= threshold:
                keep[i] = False
            else:
                prev = hashes[i]
        return keep

    # -- stage 2: refinement --------------------------------------------------

    def apply_filters(
        self,
        keyframes_dir: str | Path,
        output_dir: str | Path | None = None,
        map_dir: str | Path | None = None,
        output_map_dir: str | Path | None = None,
    ) -> FilterReport:
        """Refine extracted keyframes: drop low-quality frames and in-scene
        near-duplicates. In place when ``output_dir`` is None (originals of
        dropped frames are deleted); otherwise survivors copy to
        ``output_dir`` and the sources are untouched."""
        from ..ops.dedup import windowed_dedup_mask
        from ..ops.quality import adaptive_quality_mask, quality_metrics

        cfg = self.config
        keyframes_dir = Path(keyframes_dir)
        in_place = output_dir is None
        report = FilterReport()
        scanned = self.fm.scan_keyframes(keyframes_dir)

        for folder, images in scanned.items():
            report.folders += 1
            report.frames_in += len(images)
            paths = [keyframes_dir / folder / img for img in images]
            pixels = self._load_uniform(paths)
            keep = np.ones(len(images), dtype=bool)

            # quality stage (skipped entirely at 0 percentiles)
            dropped_q = 0
            if cfg.blur_drop_percentile > 0 or cfg.edge_drop_percentile > 0:
                metrics = quality_metrics(_upload(pixels, self.device))
                qmask = adaptive_quality_mask(
                    metrics["blur"], metrics["edges"],
                    cfg.blur_drop_percentile, cfg.edge_drop_percentile,
                ).cpu().numpy()
                dropped_q = int((~qmask).sum())
                keep &= qmask

            # similarity stage over survivors
            dropped_s = 0
            survivor_idx = np.nonzero(keep)[0]
            if len(survivor_idx) > 1:
                emb = np.asarray(self.embed_fn(pixels[survivor_idx]), dtype=np.float32)
                if cfg.use_clustering:
                    smask = self._cluster_dedup(emb, cfg)
                else:
                    smask = windowed_dedup_mask(
                        _upload(emb, self.device),
                        threshold=cfg.in_scene_similarity,
                        window=cfg.dedup_window,
                    ).cpu().numpy()
                dropped_s = int((~smask).sum())
                keep[survivor_idx[~smask]] = False

            report.dropped_quality += dropped_q
            report.dropped_similarity += dropped_s
            kept_images = [img for img, k in zip(images, keep) if k]
            report.frames_out += len(kept_images)
            report.per_folder[folder] = {
                "in": len(images),
                "out": len(kept_images),
                "dropped_quality": dropped_q,
                "dropped_similarity": dropped_s,
            }

            self._write_survivors(
                keyframes_dir, folder, images, keep, output_dir, in_place
            )
            # in place: the source maps track the filtered sources; copy mode:
            # maps go only to output_map_dir and the sources stay untouched
            map_dest = map_dir if in_place else output_map_dir
            self._rewrite_map(folder, images, keep, map_dir, map_dest)
        return report

    def _cluster_dedup(self, emb: np.ndarray, cfg: FrameFilterConfig) -> np.ndarray:
        """Scene-aware density clustering: split frames into scenes by
        adjacent cosine, then keep one centroid-nearest representative per
        in-scene cluster."""
        from ..ops.dedup import cluster_representatives_mask
        from ..ops.normalize import l2_normalize

        n = len(emb)
        emb_dev = _upload(emb, self.device)
        normed = l2_normalize(emb_dev).cpu().numpy()
        adjacent = np.sum(normed[:-1] * normed[1:], axis=-1) if n > 1 else []
        boundaries = [0] + [
            i + 1 for i, sim in enumerate(adjacent) if sim < cfg.scene_threshold
        ] + [n]
        keep = np.zeros(n, bool)
        for start, end in zip(boundaries[:-1], boundaries[1:]):
            if end > start:
                keep[start:end] = cluster_representatives_mask(
                    emb_dev[start:end], eps=cfg.cluster_eps
                )
        return keep

    def _load_uniform(self, paths: list[Path]) -> np.ndarray:
        """Decode images to a uniform (N, S, S, 3) stack (S = 256)."""
        from PIL import Image

        arrays = []
        for p in paths:
            with Image.open(p) as img:
                img = img.convert("RGB")
                if img.size != (256, 256):
                    img = img.resize((256, 256), Image.BILINEAR)
                arrays.append(np.asarray(img, np.uint8))
        return np.stack(arrays) if arrays else np.zeros((0, 256, 256, 3), np.uint8)

    def _write_survivors(
        self,
        keyframes_dir: Path,
        folder: str,
        images: list[str],
        keep: np.ndarray,
        output_dir: str | Path | None,
        in_place: bool,
    ) -> None:
        if in_place:
            for img, k in zip(images, keep):
                if not k:
                    (keyframes_dir / folder / img).unlink(missing_ok=True)
        else:
            out = Path(output_dir) / folder
            out.mkdir(parents=True, exist_ok=True)
            for img, k in zip(images, keep):
                if k:
                    shutil.copy2(keyframes_dir / folder / img, out / img)

    def _rewrite_map(
        self,
        folder: str,
        images: list[str],
        keep: np.ndarray,
        map_dir: str | Path | None,
        output_map_dir: str | Path | None,
    ) -> None:
        """Drop rows of removed frames from the folder's CSV map (the
        reference rewrites the CSV too, ``filter.py:456-486``)."""
        if map_dir is None or output_map_dir is None:
            return
        mapping = self.fm.load_folder_mapping(map_dir, folder)
        if not mapping:
            return
        kept_ordinals = set()
        for img, k in zip(images, keep):
            if k:
                stem = Path(img).stem
                digits = "".join(c for c in stem if c.isdigit())
                if digits:
                    kept_ordinals.add(int(digits))
        rows = [
            {"n": n, **fields}
            for n, fields in sorted(mapping.items())
            if n in kept_ordinals
        ]
        Path(output_map_dir).mkdir(parents=True, exist_ok=True)
        self.fm.save_csv_mapping(Path(output_map_dir) / f"{folder}.csv", rows)
