"""Timing for the bench: wall percentiles per call and device time.

PyTorch returns from a launch before the card has finished, so every timed
call ends in ``torch.cuda.synchronize``; the device's own time of the same
calls comes from CUDA events recorded around each one. On the CPU there is
no device time: the host clock is all there is, and the device fields are
``None``.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

__all__ = ["MIN_CALLS", "percentile_wall", "median_ms"]

MIN_CALLS = 100   # fewer calls give no honest p95
WARMUP = 3
# median_ms: samples, and runs per sample (spreads the events' own cost)
SAMPLES = 20
BURST = 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile_wall(fn: Callable[[int], object], n: int, device: torch.device) -> dict:
    """Time ``fn(i)`` for ``i`` in ``range(n)`` (``n >= 100``), each call
    ended by a synchronize.

    Returns ``p50_ms`` and ``p95_ms`` of the per-call wall, ``calls``, and
    ``device_p50_ms``: the median of the same calls' CUDA-event times (None
    on the CPU): the span of the call on the stream, idle gaps between its
    launches included. ``fn`` gets the call's number, so that every call can
    be given fresh input; the warm-up calls get negative numbers.
    """
    if n < MIN_CALLS:
        raise ValueError(f"percentiles over {n} calls: need at least {MIN_CALLS}")
    on_card = device.type == "cuda"
    for i in range(WARMUP):
        fn(-1 - i)
    _sync(device)
    wall, events = [], []
    for i in range(n):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(i)
        if on_card:
            end.record()
            events.append((start, end))
        _sync(device)
        wall.append((time.perf_counter() - t0) * 1e3)
    dev = [s.elapsed_time(e) for s, e in events]
    return {
        "p50_ms": float(np.percentile(wall, 50)),
        "p95_ms": float(np.percentile(wall, 95)),
        "calls": n,
        "device_p50_ms": float(np.median(dev)) if dev else None,
    }


def median_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Median milliseconds per run of ``fn`` over 20 samples, each a burst of
    5 runs, after one warm-up: CUDA events on a card (the device's time), the
    host clock on the CPU."""
    fn()
    _sync(device)
    out = []
    for _ in range(SAMPLES):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(BURST):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end) / BURST)
        else:
            t0 = time.perf_counter()
            for _ in range(BURST):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / BURST)
    return float(np.median(out))
