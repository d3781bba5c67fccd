"""Multi-process ingest pipeline: parallel decode feeding one device stream.

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ingest/pipeline.py``.
Host decode is what bounds ingest long before the card does, so the work
splits:

- **Worker processes** (cv2 and numpy only: no torch, so no CUDA state):
  each takes whole videos from a task queue, decodes with OpenCV, shrinks
  frames to the dedup edge and writes the kept JPEGs. A decode thread
  inside each worker prefetches the next batch while the worker waits for
  its keep mask, so decode overlaps the device step.
- **The main process owns the card**: it receives fixed-shape shrunken
  batches from all workers over one queue and runs
  :meth:`FrameFilter.dedup_step` (embed + masked dedup scan on the device,
  one read of the mask) per batch, with one dedup carry (and phash carry)
  per worker. Order within a video is kept because one worker owns one
  video at a time.

Only the small (B, edge, edge, 3) views and (B,) masks cross process
boundaries. The keep masks, and so the keyframes and maps, are those of
the sequential :meth:`FrameFilter.extract_frames`.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as queue_mod
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .frames import ExtractReport, FrameFilter

__all__ = ["extract_frames_parallel"]


# ---------------------------------------------------------------------------
# Worker side (pure cv2/numpy: must not import torch)
# ---------------------------------------------------------------------------


def _decode_thread(path: str, sample_every: int, frame_batch: int,
                   out_q: "queue_mod.Queue") -> None:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        frames: list[np.ndarray] = []
        indices: list[int] = []
        idx = 0
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            if idx % sample_every == 0:
                frames.append(bgr)
                indices.append(idx)
                if len(frames) >= frame_batch:
                    out_q.put((indices, frames))
                    frames, indices = [], []
            idx += 1
        if frames:
            out_q.put((indices, frames))
    finally:
        cap.release()
        out_q.put(None)


def _worker_main(wid: int, task_q, batch_q, mask_q, opts: dict) -> None:
    """One worker: videos -> decoded batches out, keep masks in, JPEGs out."""
    import cv2

    frame_batch = opts["frame_batch"]
    sample_every = opts["sample_every"]
    edge = opts["dedup_resize"]
    jpeg_quality = opts["jpeg_quality"]

    while True:
        task = task_q.get()
        if task is None:
            batch_q.put(("worker_done", wid))
            return
        video_path, name, out_dir = task
        try:
            t0 = time.perf_counter()
            out_path = Path(out_dir)
            out_path.mkdir(parents=True, exist_ok=True)
            cap = cv2.VideoCapture(video_path)
            opened = cap.isOpened()
            fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
            frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            cap.release()
            if not opened or frame_count <= 0:
                raise IOError(f"cannot open video: {video_path}")

            local: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
            t = threading.Thread(
                target=_decode_thread,
                args=(video_path, sample_every, frame_batch, local),
                daemon=True,
            )
            t.start()

            kept_n = 0
            frames_seen = 0
            map_rows: list[dict[str, Any]] = []
            seq = 0
            while True:
                item = local.get()
                if item is None:
                    break
                indices, frames_bgr = item
                b = len(frames_bgr)
                frames_seen += b
                h, w = frames_bgr[0].shape[:2]
                e = edge if edge and (h > edge or w > edge) else None
                if e:
                    small = np.empty((frame_batch, e, e, 3), np.uint8)
                    for i in range(b):
                        # resize first (cheap on the small output), then
                        # BGR->RGB as a channel flip
                        small[i] = cv2.resize(
                            frames_bgr[i], (e, e),
                            interpolation=cv2.INTER_AREA,
                        )[..., ::-1]
                else:
                    small = np.empty((frame_batch, h, w, 3), np.uint8)
                    for i in range(b):
                        small[i] = frames_bgr[i][..., ::-1]
                if b < frame_batch:
                    small[b:] = small[b - 1]  # pad rows: masked out in main
                batch_q.put(("batch", wid, seq, b, small))
                keep = mask_q.get()
                if keep is None:  # main aborted
                    break
                for i in np.nonzero(keep[:b])[0]:
                    frame_idx = int(indices[i])
                    cv2.imwrite(
                        str(out_path / f"{kept_n}.jpg"), frames_bgr[i],
                        [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
                    )
                    map_rows.append({
                        "n": kept_n,
                        "pts_time": frame_idx / fps if fps > 0 else -1.0,
                        "fps": fps,
                        "frame_idx": frame_idx,
                    })
                    kept_n += 1
                seq += 1
            batch_q.put(("video_done", wid, {
                "video": name,
                "fps": fps,
                "frames_seen": frames_seen,
                "frames_kept": kept_n,
                "duration_s": time.perf_counter() - t0,
                "map_rows": map_rows,
            }))
        except Exception:
            batch_q.put(("video_error", wid, name, traceback.format_exc()))


# ---------------------------------------------------------------------------
# Main-process device loop
# ---------------------------------------------------------------------------


def extract_frames_parallel(
    frame_filter: "FrameFilter",
    video_paths: list[str | Path],
    keyframes_dir: str | Path,
    map_dir: str | Path | None = None,
    workers: int = 4,
    names: list[str] | None = None,
) -> list["ExtractReport"]:
    """Parallel multi-video ``extract_frames`` with identical decisions.

    ``workers`` decode processes (started with ``spawn``); the calling
    process runs every device step. Raises RuntimeError listing failed
    videos (after finishing the rest); partial outputs of failed videos are
    left for inspection."""
    from .frames import ExtractReport

    cfg = frame_filter.config
    workers = max(1, min(workers, len(video_paths)))
    keyframes_dir = Path(keyframes_dir)
    if names is None:
        names = [Path(vp).stem for vp in video_paths]
    if not len(names) == len(set(names)) == len(video_paths):
        raise ValueError("output names must be unique per video (extract_frames_batch "
                         "uniquifies duplicate stems)")

    # spawn re-imports the parent's __main__ from its file path; where the
    # caller is a heredoc or a pipe that path does not exist and every worker
    # would die at start: run the sequential path instead
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    if main_file is not None and not Path(main_file).exists():
        logging.getLogger(__name__).warning(
            "multi-process ingest unavailable: __main__ was loaded from %r, which "
            "spawn workers cannot re-import. Running the sequential path instead "
            "(run from a real script or use the CLI for parallel ingest).", main_file,
        )
        return [
            frame_filter.extract_frames(p, keyframes_dir, map_dir, video_name=n)
            for p, n in zip(video_paths, names)
        ]

    # spawn: workers start from a fresh interpreter (no CUDA or thread state
    # forked); a calling script needs the `if __name__ == "__main__"` guard
    ctx = mp.get_context("spawn")
    batch_q = ctx.Queue()
    task_qs = [ctx.Queue() for _ in range(workers)]
    mask_qs = [ctx.Queue() for _ in range(workers)]
    opts = {
        "frame_batch": cfg.frame_batch,
        "sample_every": cfg.sample_every,
        "dedup_resize": cfg.dedup_resize,
        "jpeg_quality": cfg.jpeg_quality,
    }
    procs = [
        ctx.Process(
            target=_worker_main,
            args=(w, task_qs[w], batch_q, mask_qs[w], opts),
            daemon=True,
        )
        for w in range(workers)
    ]
    for p in procs:
        p.start()
    for i, (vp, name) in enumerate(zip(video_paths, names)):
        task_qs[i % workers].put((str(vp), name, str(keyframes_dir / name)))
    for q in task_qs:
        q.put(None)

    carries: dict[int, Any] = {}
    last_hashes: dict[int, np.ndarray | None] = {}
    phash_count: dict[int, int] = {}
    reports: dict[str, ExtractReport] = {}
    errors: list[tuple[str, str]] = []
    done_workers = 0
    dead_seen: set[int] = set()
    try:
        while done_workers < workers:
            try:
                msg = batch_q.get(timeout=5.0)
            except queue_mod.Empty:
                # a worker that died without its "worker_done" message
                # (bootstrap crash, OOM kill) must not hang the pipeline
                for i, p in enumerate(procs):
                    if not p.is_alive() and i not in dead_seen:
                        dead_seen.add(i)
                        done_workers += 1
                        errors.append(
                            (f"worker{i}",
                             f"worker process died (exitcode={p.exitcode}) "
                             "before finishing its videos")
                        )
                continue
            kind = msg[0]
            if kind == "worker_done":
                dead_seen.add(msg[1])
                done_workers += 1
                continue
            if kind == "video_error":
                _, wid, name, tb = msg
                errors.append((name, tb))
                carries.pop(wid, None)
                continue
            if kind == "video_done":
                _, wid, info = msg
                rep = ExtractReport(
                    video=info["video"], fps=info["fps"],
                    frames_seen=info["frames_seen"],
                    frames_kept=info["frames_kept"],
                    phash_dropped=phash_count.pop(wid, 0),
                    duration_s=info["duration_s"],
                )
                if rep.duration_s > 0:
                    rep.frames_per_s = rep.frames_seen / rep.duration_s
                reports[info["video"]] = rep
                if map_dir is not None:
                    Path(map_dir).mkdir(parents=True, exist_ok=True)
                    frame_filter.fm.save_csv_mapping(
                        Path(map_dir) / f"{info['video']}.csv", info["map_rows"])
                carries.pop(wid, None)
                continue

            _, wid, seq, b, small = msg
            if seq == 0:  # a new video on this worker: fresh carries
                carries[wid] = None
                last_hashes[wid] = None
                phash_count[wid] = 0
            active = np.zeros((cfg.frame_batch,), bool)
            active[:b] = True
            if cfg.use_phash_prefilter:
                hashes = frame_filter.phash_batch(small[:b])
                keep_hash = frame_filter._phash_keep(
                    hashes, last_hashes.get(wid), cfg.phash_threshold
                )
                if keep_hash.any():
                    last_hashes[wid] = hashes[np.nonzero(keep_hash)[0][-1]]
                phash_count[wid] = phash_count.get(wid, 0) + int((~keep_hash).sum())
                active[:b] &= keep_hash
            keep, carries[wid] = frame_filter.dedup_step(small, carries[wid], active)
            mask_qs[wid].put(keep & active)
    finally:
        for q in mask_qs:
            q.put(None)
        deadline = time.time() + 10
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()

    if errors:
        detail = "; ".join(f"{n}: {tb.splitlines()[-1]}" for n, tb in errors)
        raise RuntimeError(f"ingest failed for {len(errors)} video(s): {detail}")
    return [reports[n] for n in names if n in reports]
