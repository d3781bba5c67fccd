"""Spans of the harness and the device trace of a steady slice of the window.

The harness wraps its calls into the program's layers in :meth:`Tracer.span`
(the host clock, always on: an append to a list). With ``--trace 1``,
:meth:`Tracer.slice` runs ``torch.profiler`` over a few seconds in the middle
of the window, and :meth:`Tracer.finish`, after the window, reduces its
Chrome trace to: the device intervals
(kernels, copies, sets) inside the slice, the busy seconds (their union),
the slice's seconds, the device operations that took most time, and the
idle gaps between device work by the harness span the host was in (the
innermost one around the middle of the gap; ``outside_harness_spans``
where none was).

On a card the profiler records device activity alone, so that the host's
own work runs as it does untraced. The slice is then bounded by two marker
kernels (``torch.cuda._sleep``) launched on a stream of their own, each
right after the host clock is read, which also ties the two clocks. On the
CPU the slice's own annotation does both.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import torch

SLICE_MARK = "perfbench.slice"
MARKER_KERNEL = "spin_kernel"     # what ``torch.cuda._sleep`` launches
MARKER_CYCLES = 1000
TOP = 10
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclass
class Summary:
    kernels: list[tuple[str, float, float]] = field(default_factory=list)  # name, start s, dur s
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list[list] = field(default_factory=list)
    idle_gaps: list[list] = field(default_factory=list)
    host_start: float = 0.0   # the slice on the host clock
    host_end: float = 0.0
    tie: str = "markers"      # how the slice was bounded: its markers, or the device work's extent

    def seconds_of(self, pattern: str) -> tuple[int, float]:
        """(launches, device seconds) of kernels whose name holds ``pattern``."""
        hits = [d for n, _, d in self.kernels if pattern in n]
        return len(hits), sum(hits)


class Tracer:
    def __init__(self, enabled: bool, device: torch.device) -> None:
        self.enabled = enabled
        self.device = device
        self.spans: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()
        self._taken = None
        self.summary: Summary | None = None
        self.host_bounds: tuple[float, float] | None = None   # the slice on the host clock

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str):
        """Put ``obj.attr`` in a span of ``name``; returns a function that
        takes the wrapper off."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)
        return lambda: delattr(obj, attr)

    @contextlib.contextmanager
    def slice(self):
        """Profile the body (a steady part of the window) when enabled. The
        trace is reduced later, by :meth:`finish`, once the window is over."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.device.type != "cuda":
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.start()
            with record_function(SLICE_MARK):
                t0 = time.perf_counter()
                yield
                t1 = time.perf_counter()
            prof.stop()
            self._taken = (prof, t0, t1)
            self.host_bounds = (t0, t1)
            return
        side = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t0 = self._marker(side)
        yield
        t1 = self._marker(side)
        torch.cuda.synchronize(self.device)
        prof.stop()
        self._taken = (prof, t0, t1)
        self.host_bounds = (t0, t1)

    def _marker(self, stream) -> float:
        """Read the host clock and launch a marker kernel at once."""
        with torch.cuda.stream(stream):
            t = time.perf_counter()
            torch.cuda._sleep(MARKER_CYCLES)
        return t

    @property
    def taken(self) -> bool:
        return self._taken is not None or self.summary is not None

    def finish(self) -> None:
        """Export the slice's trace and reduce it to :class:`Summary`."""
        if self._taken is None:
            return
        prof, t0, t1 = self._taken
        self._taken = None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = self._reduce(events, t0, t1)

    def _reduce(self, events: list[dict], h0: float, h1: float) -> Summary:
        tie = "markers"
        mark = next((e for e in events if e.get("name") == SLICE_MARK and "dur" in e), None)
        if mark is not None:
            ts0 = mark["ts"] * 1e-6       # trace seconds of the slice's start
            ts1 = ts0 + mark["dur"] * 1e-6
        else:
            marks = sorted(e["ts"] for e in events
                           if MARKER_KERNEL in e.get("name", "") and e.get("cat") == "kernel")
            if len(marks) >= 2:
                ts0, ts1 = marks[0] * 1e-6, marks[-1] * 1e-6
            else:   # no marker recorded: the extent of the device work
                dev = [e for e in events if e.get("cat") in _DEVICE_CATS and "dur" in e]
                if not dev:
                    raise RuntimeError("the traced slice recorded no device work")
                ts0 = min(e["ts"] for e in dev) * 1e-6
                ts1 = max(e["ts"] + e["dur"] for e in dev) * 1e-6
                tie = "extent"
        offset = ts0 - h0                 # trace seconds minus host seconds
        kern = []
        for e in events:
            if MARKER_KERNEL in e.get("name", ""):
                continue
            if e.get("cat") in _DEVICE_CATS and "dur" in e:
                s = e["ts"] * 1e-6
                d = e["dur"] * 1e-6
                if s + d > ts0 and s < ts1:
                    kern.append((e.get("name", "?"), s, d, e.get("cat")))
        kern.sort(key=lambda k: k[1])
        merged: list[list[float]] = []
        for _, s, d, _ in kern:
            s, e = max(s, ts0), min(s + d, ts1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        by_op: dict[str, float] = {}
        for name, _, d, _ in kern:
            by_op[name] = by_op.get(name, 0.0) + d
        gaps: dict[str, float] = {}
        spans = [(n, a + offset, b + offset) for n, a, b in self.spans]
        edges = [ts0] + [x for iv in merged for x in iv] + [ts1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [(sa, n) for n, sa, sb in spans if sa <= mid <= sb]
            name = max(inside)[1] if inside else "outside_harness_spans"
            gaps[name] = gaps.get(name, 0.0) + (b - a)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        return Summary(
            kernels=[(n, s, d) for n, s, d, c in kern if c == "kernel"],
            window_s=ts1 - ts0, busy_s=busy,
            device_ops=[[n, d] for n, d in top],
            idle_gaps=[[n, g] for n, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
            host_start=h0, host_end=h1, tie=tie)
