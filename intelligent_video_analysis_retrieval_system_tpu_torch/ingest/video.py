"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/ingest/video.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Host-side video decode with batched frame delivery.

Wraps OpenCV capture (the reference's decode path,
``video_frame_filter.py:36-87``) behind a batch iterator sized for the
device pipeline: the TPU consumes (B, H, W, 3) uint8 blocks while the host
decodes the next block — decode and device work overlap naturally because
device calls are async.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

__all__ = ["VideoReader", "VideoInfo", "probe_video"]


@dataclass(slots=True)
class VideoInfo:
    path: str
    fps: float
    frame_count: int
    width: int
    height: int
    duration_s: float


def probe_video(path: str | Path) -> VideoInfo:
    if cv2 is None:
        raise RuntimeError("OpenCV (cv2) is required for video decode")
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        return VideoInfo(
            path=str(path),
            fps=float(fps),
            frame_count=count,
            width=width,
            height=height,
            duration_s=count / fps if fps > 0 else 0.0,
        )
    finally:
        cap.release()


class VideoReader:
    """Iterate RGB frame batches: yields (frame_indices, (B,H,W,3) uint8)."""

    def __init__(
        self,
        path: str | Path,
        batch_size: int = 128,
        sample_every: int = 1,
        max_frames: int | None = None,
    ) -> None:
        if cv2 is None:
            raise RuntimeError("OpenCV (cv2) is required for video decode")
        self.path = Path(path)
        self.batch_size = batch_size
        self.sample_every = max(1, sample_every)
        self.max_frames = max_frames
        self.info = probe_video(path)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        cap = cv2.VideoCapture(str(self.path))
        try:
            frames: list[np.ndarray] = []
            indices: list[int] = []
            yielded = 0
            frame_idx = 0
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                if frame_idx % self.sample_every == 0:
                    frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                    indices.append(frame_idx)
                    if self.max_frames is not None and (
                        yielded + len(frames) >= self.max_frames
                    ):
                        break
                    if len(frames) >= self.batch_size:
                        yield np.asarray(indices), np.stack(frames)
                        yielded += len(frames)
                        frames, indices = [], []
                frame_idx += 1
            if frames:
                yield np.asarray(indices), np.stack(frames)
        finally:
            cap.release()
