"""Ingest layer: video decode -> keyframe extraction -> filtering.

PyTorch port of ``intelligent_video_analysis_retrieval_system_tpu/ingest``:
host decode workers feed whole-batch device calls for embedding, quality
metrics, perceptual hashing and dedup decisions.
"""

from .frames import ExtractReport, FilterReport, FrameFilter, FrameFilterConfig
from .video import VideoReader, probe_video

__all__ = [
    "FrameFilter",
    "FrameFilterConfig",
    "ExtractReport",
    "FilterReport",
    "VideoReader",
    "probe_video",
]
