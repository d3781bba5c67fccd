"""What the drivers share: the run's context and outcome, the program's
objects built from the harness's weights and rows, and the arithmetic of
percentiles and samples."""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .. import data, weights
from ..trace import Tracer


@dataclass
class Context:
    root: Path
    workload: Mapping
    config: Mapping
    traffic: Mapping
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tracer: Tracer
    t_start: float
    setup_s: float | None = None

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def log(self, msg: str) -> None:
        """A line on standard error with the seconds since the process began."""
        print(f"[perfbench {time.perf_counter() - self.t_start:8.3f} s] {msg}", file=sys.stderr,
              flush=True)

    def slice_bounds(self) -> tuple[float, float]:
        """(start, length) in seconds after the window opens of the traced
        slice: the traffic's ``trace_slice``, kept inside the window."""
        ts = self.traffic.get("trace_slice", {"start": 0.4, "seconds": 3.0})
        start = ts["start"] * self.seconds
        return start, min(ts["seconds"], 0.5 * self.seconds)


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict[str, float]
    numbers: dict[str, float]
    records: dict[str, Any] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)
    memory_peak_bytes: int = 0


def clip_config(cfg: Mapping):
    """The port's ``CLIPConfig`` of a configuration file."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import (
        CLIPConfig, CLIPTextConfig, CLIPVisionConfig)

    t, v = cfg["text_config"], cfg["vision_config"]
    return CLIPConfig(
        vision=CLIPVisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
            num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
            mlp_ratio=v["intermediate_size"] // v["hidden_size"],
            projection_dim=cfg["projection_dim"]),
        text=CLIPTextConfig(
            vocab_size=t["vocab_size"], max_length=t["max_position_embeddings"],
            hidden_size=t["hidden_size"], num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            mlp_ratio=t["intermediate_size"] // t["hidden_size"],
            projection_dim=cfg["projection_dim"]),
        logit_scale_init=weights.LOGIT_SCALE)


def embedder(ctx: Context, compute_dtype: str | None = None):
    """The program's ``CLIPEmbedder`` at the configuration's widths, loaded
    through its public path and then handed the seeded weights."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder

    cfg = clip_config(ctx.config)
    emb = CLIPEmbedder(config=cfg, device=ctx.device,
                       compute_dtype=compute_dtype or ctx.config["dtype"],
                       image_batch_size=int(ctx.traffic.get("batch", 256)))
    emb.ensure_loaded()
    ctx.log("embedder loaded (its own seeded init)")
    emb.load_params(weights.make(ctx.config, ctx.seed, ctx.device))
    return emb


class LazyMetas:
    """Keyframe records of ``n`` rows made on access: row ``i`` is frame
    ``i`` of video ``v{i // 1000}``, so an answer names its row."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.results import (
            KeyframeMetadata)

        if not 0 <= i < self.n:
            raise IndexError(i)
        return KeyframeMetadata(folder=f"v{i // 1000}", image=f"{i % 1000:06d}.jpg",
                                frame_id=i, row_id=i)


def index_over(ctx: Context, rows: torch.Tensor, n: int, scales: torch.Tensor | None = None):
    """A ``UnifiedIndex`` serving the device rows as they are (after the
    program's ``bench/served.py``): no container opened, no per-row
    metadata walk."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import (
        UnifiedIndex, UnifiedIndexConfig)

    index = UnifiedIndex(UnifiedIndexConfig(dtype="int8" if scales is not None else "bfloat16"),
                         device=ctx.device)
    index._dev_x = rows
    index._dev_scales = scales
    index._n_valid = n
    index._capacity = int(rows.shape[0])
    index._metadata = LazyMetas(n)
    return index


def hits(answers) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, scores, counts) of ranked ``SearchResult`` lists, padded with
    zeros to the longest."""
    k = max(len(h) for h in answers)
    ids = np.array([[r.metadata.row_id for r in h] + [0] * (k - len(h)) for h in answers])
    sc = np.array([[r.similarity_score for r in h] + [0.0] * (k - len(h)) for h in answers])
    return ids, sc, np.array([len(h) for h in answers])


def padded(n: int) -> int:
    """Rows the index holds for ``n`` live rows (a multiple of its tile)."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.topk import TILE_N

    return -(-n // TILE_N) * TILE_N


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def nearest_rank(values: list[float], pct: float) -> float:
    """The ``pct`` percentile by nearest rank (a failed request, infinity,
    sorts last)."""
    v = sorted(values)
    return v[max(0, math.ceil(pct / 100 * len(v)) - 1)]


def before_slice(records: Mapping, bounds: tuple[float, float] | None) -> tuple[int, float] | None:
    """(calls, seconds) of the window before the traced slice opened: the
    calls that ended before it, over the time from the window's start to
    the last of their ends; the whole window where no slice was taken. The
    profiler slows the host, so a rate of the traced run is read here."""
    ends = sorted(records.get("call_ends") or ())
    if bounds is not None:
        ends = [e for e in ends if e <= bounds[0]]
    if not ends or ends[-1] <= records["t0"]:
        return None
    return len(ends), ends[-1] - records["t0"]


def slice_note(records: Mapping, bounds: tuple[float, float] | None) -> str | None:
    """Calls a second before the traced slice and inside it: what the
    profiler costs the host."""
    before = before_slice(records, bounds)
    if bounds is None or before is None or bounds[1] <= bounds[0]:
        return None
    inside = sum(1 for e in records["call_ends"] if bounds[0] < e <= bounds[1])
    return (f"profiler: {before[0] / before[1]:.3f} calls/s before the slice, "
            f"{inside / (bounds[1] - bounds[0]):.3f} inside it")


def sample(count: int, size: int, seed: int, must: int | None = None) -> np.ndarray:
    """``size`` distinct positions of ``count``, drawn from ``seed``, with
    ``must`` among them."""
    rng = np.random.default_rng(data.seed64(seed) ^ 0xC0FFEE)
    pick = rng.choice(count, min(size, count), replace=False)
    if must is not None and must not in pick:
        pick[0] = must
    return np.sort(pick)
