"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/perf.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Performance monitoring: op timers, aggregates, slow-op tracking.

Parity with the reference ``PerformanceMonitor`` (``utils.py:2438-2865``):
context-manager and explicit start/end timers keyed by operation + thread,
per-operation aggregates, slow-operation log against a configurable
threshold, error counters, uptime. Emits JSON lines through
:meth:`Logger.log_performance`.

Differs from the original in one place: the optional trace capture around a
timed block (``profile_dir`` config) uses ``torch.profiler`` and writes a
chrome trace per block.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from .logging import Logger

__all__ = ["PerformanceMonitor"]


@dataclass
class _OpStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    errors: int = 0

    def record(self, duration: float, error: bool = False) -> None:
        self.count += 1
        self.total_s += duration
        self.min_s = min(self.min_s, duration)
        self.max_s = max(self.max_s, duration)
        if error:
            self.errors += 1

    def as_dict(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "avg_s": round(self.total_s / self.count, 6) if self.count else 0.0,
            "min_s": round(self.min_s, 6) if self.count else 0.0,
            "max_s": round(self.max_s, 6),
            "errors": self.errors,
        }


@dataclass
class _SlowOp:
    operation: str
    duration_s: float
    ts: float
    context: dict[str, Any] = field(default_factory=dict)


class PerformanceMonitor:
    """Thread-safe operation timing and aggregation."""

    def __init__(
        self,
        logger: Logger | None = None,
        slow_op_threshold_s: float = 5.0,
        profile_dir: str | None = None,
        max_slow_ops: int = 100,
    ) -> None:
        self.logger = logger
        self.slow_op_threshold_s = slow_op_threshold_s
        self.profile_dir = profile_dir
        self.max_slow_ops = max_slow_ops
        self._stats: dict[str, _OpStats] = {}
        self._active: dict[tuple[str, int], float] = {}
        self._slow: list[_SlowOp] = []
        self._lock = threading.RLock()
        self._started_at = time.time()

    # -- explicit timers (reference utils.py:2481-2556) -------------------

    def start_timer(self, operation: str) -> None:
        key = (operation, threading.get_ident())
        with self._lock:
            self._active[key] = time.perf_counter()

    def end_timer(self, operation: str, error: bool = False, **context: Any) -> float:
        key = (operation, threading.get_ident())
        with self._lock:
            start = self._active.pop(key, None)
        if start is None:
            return 0.0
        duration = time.perf_counter() - start
        self._record(operation, duration, error=error, **context)
        return duration

    @contextmanager
    def timer(self, operation: str, **context: Any) -> Iterator[None]:
        start = time.perf_counter()
        error = False
        try:
            yield
        except Exception:
            error = True
            raise
        finally:
            self._record(operation, time.perf_counter() - start, error=error, **context)

    @contextmanager
    def profiled(self, operation: str, **context: Any) -> Iterator[None]:
        """Timer that also captures a torch.profiler trace when configured
        (``<profile_dir>/<operation>-<ns>.json``, chrome trace format)."""
        if self.profile_dir:
            from pathlib import Path

            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                with self.timer(operation, **context):
                    yield
            Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(Path(self.profile_dir) / f"{operation}-{time.time_ns()}.json"))
        else:
            with self.timer(operation, **context):
                yield

    def _record(self, operation: str, duration: float, error: bool, **context: Any) -> None:
        with self._lock:
            stats = self._stats.setdefault(operation, _OpStats())
            stats.record(duration, error=error)
            if duration >= self.slow_op_threshold_s:
                self._slow.append(_SlowOp(operation, duration, time.time(), context))
                del self._slow[: -self.max_slow_ops]
        if self.logger is not None:
            self.logger.log_performance(operation, duration, error=error, **context)

    # -- reporting ---------------------------------------------------------

    def record_error(self, operation: str) -> None:
        with self._lock:
            self._stats.setdefault(operation, _OpStats()).errors += 1

    def get_stats(self, operation: str | None = None) -> dict[str, Any]:
        with self._lock:
            if operation is not None:
                op = self._stats.get(operation)
                return op.as_dict() if op else {}
            return {name: s.as_dict() for name, s in self._stats.items()}

    def get_slow_operations(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {
                    "operation": s.operation,
                    "duration_s": round(s.duration_s, 3),
                    "ts": s.ts,
                    **s.context,
                }
                for s in self._slow
            ]

    def uptime_s(self) -> float:
        return time.time() - self._started_at

    def summary(self) -> dict[str, Any]:
        return {
            "uptime_s": round(self.uptime_s(), 1),
            "operations": self.get_stats(),
            "slow_operations": self.get_slow_operations(),
        }
