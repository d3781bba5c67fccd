"""RAGBuilder: chunked, resumable index construction.

Port of ``intelligent_video_analysis_retrieval_system_tpu/index/builder.py``
(keep the two in step): the same scan, journal, decode, transactions and
sidecars, so a container written by either package opens in the other. What
differs: the returned index lives on an explicit ``torch.device`` (default
``"cuda"``), and a mesh is refused until multi-device search is ported.

Replaces the reference build pipeline (``unified_index.py:94-335`` +
``unified_builder.py:39-188``) with the batched-device design:

- images are decoded on host worker threads but embedded in **whole-batch
  device calls** — the reference embedded batch-of-1 per image inside its
  thread pool (``unified_index.py:828``), the single biggest throughput sin
  identified in SURVEY.md §3.1;
- every chunk appends embeddings/metadata/thumbnails/journal in one
  container transaction; a checkpoint flush every N chunks bounds lost work
  (reference semantics, ``unified_index.py:298-313``);
- resume skips files whose content hash is already journaled
  (``unified_index.py:140-167,1520-1544``), then repairs any torn tail via
  ``repair_to_consistent`` — the corruption self-repair the reference
  needed (``unified_index.py:996-1065``) cannot happen by construction.

The embedder is injected (``embed_fn``) so this layer has no model
dependency; ``system.facade`` wires the CLIP tower in (on a card: the
normalize kernel B5, fused attention B3 and, with ``fused_mlp``, the fused
LN+MLP kernel B4, once per chunk's device batches).
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..retrieval.results import KeyframeMetadata
from ..utils.files import FileManager, natural_key
from .container import IndexContainer
from .unified import (
    UnifiedIndex,
    UnifiedIndexConfig,
    _fold_norm_into_scales,
    resolve_device,
)

__all__ = ["RAGBuilder", "BuildReport"]

# Type of the injected embedding function: uint8 (B, S, S, 3) -> (B, D) f32.
EmbedFn = Callable[[np.ndarray], np.ndarray]


@dataclass(slots=True)
class BuildReport:
    total_files: int = 0
    processed: int = 0
    skipped_resume: int = 0
    failed: int = 0
    chunks: int = 0
    duration_s: float = 0.0
    images_per_s: float = 0.0
    resumed: bool = False
    failures: list[str] = field(default_factory=list)

    def as_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}  # type: ignore[attr-defined]


def _hash_all(paths: list[Path], threads: int) -> list[str | None]:
    """Bulk content hashing — native multithreaded C++ when available."""
    from .. import native

    return native.hash_files(paths, threads=threads)


class RAGBuilder:
    """Builds a UnifiedIndex container from a keyframes directory."""

    def __init__(
        self,
        embed_fn: EmbedFn,
        embed_dim: int,
        input_size: int = 224,
        config: UnifiedIndexConfig | None = None,
        decode_workers: int = 8,
        file_manager: FileManager | None = None,
        progress_fn: Callable[[str, int, int], None] | None = None,
        mesh: Any | None = None,
        device: torch.device | str = "cuda",
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "multi-device search is ported in a later change")
        self.device = resolve_device(device)
        self.embed_fn = embed_fn
        self.embed_dim = embed_dim
        self.input_size = input_size
        self.config = config or UnifiedIndexConfig()
        self.decode_workers = decode_workers
        self.fm = file_manager or FileManager()
        self.progress_fn = progress_fn

    # -- public API (BASELINE.json name) ------------------------------------

    def build_index(
        self,
        keyframes_dir: str | Path,
        output_path: str | Path,
        map_dir: str | Path | None = None,
        resume: bool = True,
    ) -> tuple[UnifiedIndex, BuildReport]:
        """keyframes/<video>/<n>.jpg tree -> single searchable index file."""
        t0 = time.perf_counter()
        keyframes_dir = Path(keyframes_dir)
        output_path = Path(output_path)
        report = BuildReport()

        files = self._scan_files(keyframes_dir)
        report.total_files = len(files)

        container, done_hashes = self._open_container(output_path, resume)
        report.resumed = bool(done_hashes)

        maps = self._load_maps(map_dir, {f[0] for f in files})

        digests = _hash_all([f[2] for f in files], threads=self.decode_workers)

        chunk: list[tuple[str, str, Path, str]] = []
        since_checkpoint = 0
        for (folder, image, path), digest in zip(files, digests):
            if digest is None:
                report.failed += 1
                continue
            if digest in done_hashes:
                report.skipped_resume += 1
                continue
            chunk.append((folder, image, path, digest))
            if len(chunk) >= self.config.chunk_size:
                self._process_chunk(container, chunk, maps, report)
                chunk = []
                since_checkpoint += 1
                if since_checkpoint >= self.config.checkpoint_every_chunks:
                    container.flush_checkpoint()
                    since_checkpoint = 0
        if chunk:
            self._process_chunk(container, chunk, maps, report)

        # finalize: store frame maps + build config
        for folder, mapping in maps.items():
            if mapping:
                rows = [
                    {"n": n, **fields} for n, fields in sorted(mapping.items())
                ]
                import csv as _csv
                import io as _io

                buf = _io.StringIO()
                w = _csv.writer(buf)
                w.writerow(["n", "pts_time", "fps", "frame_idx"])
                for r in rows:
                    w.writerow([r.get("n"), r.get("pts_time"), r.get("fps"),
                                r.get("frame_idx")])
                container.put_map(folder, buf.getvalue())
        container.put_system(
            "build",
            {
                "keyframes_dir": str(keyframes_dir),
                "input_size": self.input_size,
                "embed_dim": self.embed_dim,
                "finished_at": time.time(),
            },
        )
        container.flush_checkpoint()
        self._write_flat_sidecar(container, output_path,
                                 normalize=self.config.normalize)

        report.duration_s = time.perf_counter() - t0
        if report.duration_s > 0:
            report.images_per_s = report.processed / report.duration_s

        index = UnifiedIndex(self.config, device=self.device).attach_container(
            container
        )
        return index, report

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _write_flat_sidecar(container: IndexContainer, output_path: Path,
                            normalize: bool = True) -> None:
        """Flat rows sidecar for instant cold loads (consumed by
        UnifiedIndex when present and row-count fresh): ``.flat8`` (rows +
        folded serving scales) for int8 containers, raw-bits ``.flat``
        otherwise — matching what the load path actually reads. (The old
        version wrote a dequantized-f32 ``.flat`` for int8 containers that
        the int8 load path never consults, and round-tripped bf16 bits
        through f32.)"""
        try:
            from .. import native

            if container.num_rows == 0:
                return
            if container.dtype == "int8":
                rows, scales = container.read_quantized()
                if normalize:
                    scales = _fold_norm_into_scales(rows, scales)
                native.FlatInt8File.write(
                    output_path.with_name(output_path.name + ".flat8"),
                    rows, scales, normalized=normalize,
                )
                return
            raw = container.read_embeddings()  # raw storage bits
            if container.dtype == "float16":
                # rare storage mode: keep the f32-converted classic write
                native.FlatEmbeddingFile.write(
                    output_path.with_name(output_path.name + ".flat"),
                    container.read_embeddings(as_float32=True), "float32",
                )
                return
            dtype = "bfloat16" if container.dtype == "bfloat16" else "float32"
            native.FlatEmbeddingFile.write_raw(
                output_path.with_name(output_path.name + ".flat"), raw, dtype
            )
        except Exception:
            pass  # sidecar is an optimization, never a build failure

    def _scan_files(self, keyframes_dir: Path) -> list[tuple[str, str, Path]]:
        """Deterministic (folder, image, path) ordering: folder-sorted then
        frame order — row ids double as temporal ordinals."""
        out: list[tuple[str, str, Path]] = []
        scanned = self.fm.scan_keyframes(keyframes_dir)
        for folder in sorted(scanned, key=natural_key):
            for image in scanned[folder]:
                out.append((folder, image, keyframes_dir / folder / image))
        return out

    def _open_container(
        self, output_path: Path, resume: bool
    ) -> tuple[IndexContainer, set[str]]:
        if resume and output_path.is_file():
            try:
                container = IndexContainer(
                    output_path, mode="a", dim=self.embed_dim,
                    dtype=self.config.dtype,
                    keep_fp=getattr(self.config, "int8_rescore", False),
                )
                container.repair_to_consistent()
                return container, container.journal_hashes()
            except (OSError, ValueError):
                # a hard kill mid-HDF5-write can corrupt the file beyond
                # opening (bad superblock); quarantine it and rebuild fresh
                # rather than failing the build
                quarantine = output_path.with_name(
                    output_path.name + f".corrupt-{int(time.time())}"
                )
                output_path.replace(quarantine)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        if output_path.is_file():
            output_path.unlink()
        container = IndexContainer(
            output_path, mode="w", dim=self.embed_dim,
            dtype=self.config.dtype,
            keep_fp=getattr(self.config, "int8_rescore", False),
        )
        return container, set()

    def _load_maps(
        self, map_dir: str | Path | None, folders: set[str]
    ) -> dict[str, dict[int, dict[str, float]]]:
        maps: dict[str, dict[int, dict[str, float]]] = {}
        if map_dir is None:
            return {f: {} for f in folders}
        for folder in folders:
            maps[folder] = self.fm.load_folder_mapping(map_dir, folder)
        return maps

    def _process_chunk(
        self,
        container: IndexContainer,
        chunk: Sequence[tuple[str, str, Path, str]],
        maps: dict[str, dict[int, dict[str, float]]],
        report: BuildReport,
    ) -> None:
        """Decode in parallel on host, embed in one device batch, append."""
        decoded: list[tuple[int, np.ndarray, bytes]] = []
        with cf.ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            futures = {
                pool.submit(self._decode_one, path): i
                for i, (_, _, path, _) in enumerate(chunk)
            }
            for fut in cf.as_completed(futures):
                i = futures[fut]
                try:
                    pixels, thumb = fut.result()
                    decoded.append((i, pixels, thumb))
                except Exception as exc:  # tolerate bad files (reference does)
                    report.failed += 1
                    if len(report.failures) < 20:
                        report.failures.append(f"{chunk[i][2]}: {exc}")
        if not decoded:
            return
        decoded.sort(key=lambda t: t[0])
        batch = np.stack([d[1] for d in decoded])
        embeddings = np.asarray(self.embed_fn(batch), dtype=np.float32)
        if embeddings.shape != (len(decoded), self.embed_dim):
            raise ValueError(
                f"embed_fn returned {embeddings.shape}, expected "
                f"({len(decoded)}, {self.embed_dim})"
            )

        start_row = container.num_rows
        records, thumbs, hashes = [], [], []
        for slot, (i, _, thumb) in enumerate(decoded):
            folder, image, path, digest = chunk[i]
            frame_id = self._frame_id_of(folder, image, maps)
            mapping = maps.get(folder, {}).get(self._ordinal_of(image), {})
            meta = KeyframeMetadata(
                folder=folder,
                image=image,
                frame_id=frame_id,
                row_id=start_row + slot,
                path=str(path),
                pts_time=float(mapping.get("pts_time", -1.0)),
                fps=float(mapping.get("fps", -1.0)),
            )
            records.append(meta.to_dict())
            thumbs.append(thumb)
            hashes.append(digest)

        container.append_embeddings(embeddings)
        container.append_metadata(records)
        if self.config.store_thumbnails:
            container.append_thumbnails(thumbs)
        container.append_journal(hashes)
        report.processed += len(decoded)
        report.chunks += 1
        if self.progress_fn is not None:
            self.progress_fn("build", report.processed, report.total_files)

    @staticmethod
    def _ordinal_of(image: str) -> int:
        stem = Path(image).stem
        digits = "".join(ch for ch in stem if ch.isdigit())
        return int(digits) if digits else -1

    def _frame_id_of(
        self, folder: str, image: str,
        maps: dict[str, dict[int, dict[str, float]]],
    ) -> int:
        """CSV frame mapping first, filename-number fallback (reference
        behaviour, ``core.py:1678-1745``)."""
        ordinal = self._ordinal_of(image)
        mapping = maps.get(folder, {})
        entry = mapping.get(ordinal)
        if entry and "frame_idx" in entry:
            return int(entry["frame_idx"])
        return max(ordinal, 0)

    def _decode_one(self, path: Path) -> tuple[np.ndarray, bytes]:
        """PIL decode -> HF-style resize/crop to input_size + thumbnail JPEG.

        Host-side resize matches HF CLIPImageProcessor (shortest side to S,
        bicubic antialias, center crop) so folder builds and the on-device
        video path produce the same embeddings.
        """
        from PIL import Image

        with Image.open(path) as img:
            img = img.convert("RGB")
            s = self.input_size
            w, h = img.size
            if w <= h:
                nw, nh = s, max(s, round(h * s / w))
            else:
                nw, nh = max(s, round(w * s / h)), s
            img = img.resize((nw, nh), Image.BICUBIC)
            left, top = (nw - s) // 2, (nh - s) // 2
            img = img.crop((left, top, left + s, top + s))
            pixels = np.asarray(img, dtype=np.uint8)
            thumb = b""
            if self.config.store_thumbnails:
                t = self.config.thumbnail_size
                timg = img if s == t else img.resize((t, t), Image.BILINEAR)
                buf = io.BytesIO()
                timg.save(buf, format="JPEG", quality=85)
                thumb = buf.getvalue()
        return pixels, thumb
