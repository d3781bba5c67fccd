"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/serve/handlers.py``:
the port imports nothing of the JAX package, so it keeps its own copy of this
framework-free module. Keep the two in step.

Request validation, rate limiting, and response formatting.

Parity with the reference's ``RateLimiter`` / ``RequestHandler``
(``api.py:1811-2260``): sliding-window per-client limits, per-endpoint
schema validation, the four detail levels (minimal/standard/rich/full),
and a uniform error envelope.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

__all__ = ["RateLimiter", "RequestHandler", "format_results", "error_envelope"]

DETAIL_LEVELS = ("minimal", "standard", "rich", "full")
SEARCH_MODES = ("clip_only", "llm_enhanced", "hybrid")

# per-endpoint required fields + optional field domains
_SCHEMAS: dict[str, dict[str, Any]] = {
    "search": {
        "required": {"query": str},
        "optional": {
            "mode": SEARCH_MODES,
            "limit": (1, 1000),
            "detail_level": DETAIL_LEVELS,
            "folder": str,
            "include_temporal": bool,
        },
    },
    "search_batch": {
        "required": {"queries": list},
        "optional": {
            "mode": SEARCH_MODES,
            "limit": (1, 1000),
            "detail_level": DETAIL_LEVELS,
            "folder": str,
        },
    },
    "image_search": {
        "required": {"image_base64": str},
        "optional": {"limit": (1, 1000), "detail_level": DETAIL_LEVELS},
    },
    "chat": {
        "required": {"message": str},
        "optional": {"context_frames": list},
    },
    "translate": {
        "required": {"text": str},
        "optional": {},
    },
    "metadata": {
        "required": {"folder": str, "image": str},
        "optional": {},
    },
}


class RateLimiter:
    """Sliding-window limiter keyed by client id (reference api.py:1811)."""

    def __init__(self, limit_per_minute: int = 100, window_s: float = 60.0):
        self.limit = limit_per_minute
        self.window_s = window_s
        self._hits: dict[str, deque[float]] = {}
        self._lock = threading.Lock()

    def allow(self, client_id: str) -> bool:
        now = time.monotonic()
        with self._lock:
            hits = self._hits.setdefault(client_id, deque())
            cutoff = now - self.window_s
            while hits and hits[0] < cutoff:
                hits.popleft()
            if len(hits) >= self.limit:
                return False
            hits.append(now)
            return True

    def remaining(self, client_id: str) -> int:
        now = time.monotonic()
        with self._lock:
            hits = self._hits.get(client_id)
            if not hits:
                return self.limit
            cutoff = now - self.window_s
            live = sum(1 for h in hits if h >= cutoff)
            return max(0, self.limit - live)

    def reset(self, client_id: str | None = None) -> None:
        with self._lock:
            if client_id is None:
                self._hits.clear()
            else:
                self._hits.pop(client_id, None)


class RequestHandler:
    """Validation against per-endpoint schemas (reference api.py:1919-2004)."""

    def __init__(self, rate_limiter: RateLimiter | None = None):
        self.rate_limiter = rate_limiter or RateLimiter()

    def validate_request(
        self, endpoint: str, payload: dict[str, Any], client_id: str = "anon"
    ) -> tuple[bool, str | None]:
        """Returns (ok, error message)."""
        if not self.rate_limiter.allow(client_id):
            return False, "rate limit exceeded"
        schema = _SCHEMAS.get(endpoint)
        if schema is None:
            return False, f"unknown endpoint: {endpoint}"
        if not isinstance(payload, dict):
            return False, "payload must be a JSON object"
        for field_name, typ in schema["required"].items():
            if field_name not in payload:
                return False, f"missing required field: {field_name}"
            if not isinstance(payload[field_name], typ):
                return False, f"field {field_name} must be {typ.__name__}"
            if typ is str and not payload[field_name].strip():
                return False, f"field {field_name} must be non-empty"
        for field_name, domain in schema["optional"].items():
            if field_name not in payload:
                continue
            value = payload[field_name]
            if isinstance(domain, tuple) and len(domain) == 2 and all(
                isinstance(d, int) for d in domain
            ):
                if not isinstance(value, int) or not domain[0] <= value <= domain[1]:
                    return False, (
                        f"field {field_name} must be an int in "
                        f"[{domain[0]}, {domain[1]}]"
                    )
            elif isinstance(domain, tuple):
                if value not in domain:
                    return False, f"field {field_name} must be one of {domain}"
            elif isinstance(domain, type):
                if not isinstance(value, domain):
                    return False, f"field {field_name} must be {domain.__name__}"
        return True, None


def format_results(
    results: list[dict[str, Any]], detail_level: str = "standard"
) -> list[dict[str, Any]]:
    """Project result dicts to a detail level (reference api.py:2006-2221).

    Results arriving from the facade are 'rich' dicts; this trims or keeps
    fields per level.
    """
    if detail_level not in DETAIL_LEVELS:
        detail_level = "standard"
    keys_by_level = {
        "minimal": ("folder", "image", "similarity_score", "rank"),
        "standard": (
            "folder", "image", "similarity_score", "rank", "frame_id",
            "pts_time", "path",
        ),
        "rich": (
            "folder", "image", "similarity_score", "rank", "frame_id",
            "pts_time", "path", "fps", "shot_id", "tags", "source",
            "explanation", "temporal_context",
        ),
    }
    if detail_level == "full":
        return results
    keys = keys_by_level[detail_level]
    return [{k: r[k] for k in keys if k in r} for r in results]


def error_envelope(message: str, code: int = 400, **extra: Any) -> dict[str, Any]:
    """Uniform error shape (reference api.py:2222-2260)."""
    return {
        "success": False,
        "error": {"message": message, "code": code, **extra},
        "ts": time.time(),
    }
