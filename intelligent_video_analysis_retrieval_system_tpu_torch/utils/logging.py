"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/utils/logging.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Structured logging + JSON-lines performance log.

Parity with the reference ``Logger`` (``utils.py:547-806``): console plus a
rotating file handler, a separate ``performance.log`` JSON-lines stream,
kwargs-structured messages, and UTF-8 safety for Vietnamese text. The
reference's Windows-specific chcp handling is dropped (TPU hosts are Linux);
UTF-8 is enforced on the stream handler instead.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import sys
import threading
import time
from pathlib import Path
from typing import Any, Mapping

__all__ = ["Logger", "get_logger"]

_LOGGERS: dict[str, "Logger"] = {}
_LOCK = threading.Lock()


class _KwargsFormatter(logging.Formatter):
    """Append structured kwargs (stored in ``record.extra_kv``) to messages."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        kv = getattr(record, "extra_kv", None)
        if kv:
            pairs = " ".join(f"{k}={v}" for k, v in kv.items())
            return f"{base} | {pairs}"
        return base


class Logger:
    """Console + rotating-file logger with a JSON-lines perf stream."""

    def __init__(
        self,
        name: str = "ivars",
        logs_dir: str | Path | None = None,
        level: int | str = logging.INFO,
        console: bool = True,
        file: bool = True,
        max_bytes: int = 10 * 1024 * 1024,
        backup_count: int = 5,
        performance_log: bool = True,
    ) -> None:
        self.name = name
        self.logs_dir = Path(logs_dir) if logs_dir else None
        self._logger = logging.getLogger(name)
        self._logger.setLevel(level)
        self._logger.propagate = False
        # Idempotent handler setup (re-instantiation must not duplicate).
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
        fmt = _KwargsFormatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s", "%H:%M:%S"
        )
        if console:
            sh = logging.StreamHandler(sys.stderr)
            sh.setFormatter(fmt)
            self._logger.addHandler(sh)
        self._perf_path: Path | None = None
        if self.logs_dir is not None:
            self.logs_dir.mkdir(parents=True, exist_ok=True)
            if file:
                fh = logging.handlers.RotatingFileHandler(
                    self.logs_dir / f"{name}.log",
                    maxBytes=max_bytes,
                    backupCount=backup_count,
                    encoding="utf-8",
                )
                fh.setFormatter(fmt)
                self._logger.addHandler(fh)
            if performance_log:
                self._perf_path = self.logs_dir / "performance.log"
        self._perf_lock = threading.Lock()

    # -- structured message API (reference utils.py:680-723) -------------

    def _log(self, level: int, msg: str, **kwargs: Any) -> None:
        self._logger.log(level, msg, extra={"extra_kv": kwargs} if kwargs else {})

    def debug(self, msg: str, **kw: Any) -> None:
        self._log(logging.DEBUG, msg, **kw)

    def info(self, msg: str, **kw: Any) -> None:
        self._log(logging.INFO, msg, **kw)

    def warning(self, msg: str, **kw: Any) -> None:
        self._log(logging.WARNING, msg, **kw)

    def error(self, msg: str, **kw: Any) -> None:
        self._log(logging.ERROR, msg, **kw)

    def exception(self, msg: str, **kw: Any) -> None:
        self._logger.exception(msg, extra={"extra_kv": kw} if kw else {})

    # -- JSON-lines performance log (reference utils.py:725-745) ---------

    def log_performance(self, operation: str, duration_s: float, **fields: Any) -> None:
        record: dict[str, Any] = {
            "ts": time.time(),
            "operation": operation,
            "duration_s": round(float(duration_s), 6),
        }
        record.update(fields)
        line = json.dumps(record, ensure_ascii=False, default=str)
        if self._perf_path is not None:
            try:
                with self._perf_lock, self._perf_path.open(
                    "a", encoding="utf-8"
                ) as f:
                    f.write(line + "\n")
            except OSError:
                # best-effort stream: a displaced logger whose logs dir was
                # deleted (multi-system process) must degrade, not crash
                self._log(logging.DEBUG, f"perf {line}")
        else:
            self._log(logging.DEBUG, f"perf {line}")

    def close(self) -> None:
        """Close and detach file handlers (called when the registry
        rebinds this name to a new logs_dir — otherwise every rebind
        leaks an open rotating-file fd)."""
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            try:
                h.close()
            except Exception:
                pass

    def health_check(self) -> Mapping[str, Any]:
        """Logger self-check (reference utils.py:781-806)."""
        ok_handlers = all(h.stream is not None for h in self._logger.handlers
                          if isinstance(h, logging.StreamHandler))
        return {
            "name": self.name,
            "level": logging.getLevelName(self._logger.level),
            "handlers": len(self._logger.handlers),
            "perf_log": str(self._perf_path) if self._perf_path else None,
            "healthy": ok_handlers,
        }


def get_logger(name: str = "ivars", **kwargs: Any) -> Logger:
    """Named Logger registry (lazy, thread-safe).

    A cached logger is REBUILT when the caller asks for a different
    ``logs_dir`` than the cached instance writes to — otherwise a second
    system constructed in one process (new base dir) keeps appending to
    the first system's log files, and crashes once that directory is
    deleted (seen in the multi-system lifecycle dryrun).
    """
    with _LOCK:
        logger = _LOGGERS.get(name)
        want_dir = kwargs.get("logs_dir")
        if logger is not None and want_dir is not None:
            have = getattr(logger, "logs_dir", None)
            if have is None or str(have) != str(want_dir):
                logger.close()  # release the old dir's file handlers
                logger = None
        if logger is None:
            logger = Logger(name=name, **kwargs)
            _LOGGERS[name] = logger
        return logger
