"""Serving layer of the port: request validation, response formatting and
query micro-batching.

These are the JAX package's framework-free modules ``serve/handlers.py``
and ``serve/batching.py``, imported as they are (they import neither JAX
nor the JAX facade) and run around this port's facade. The REST/WebSocket
server is ported in a later change.
"""

from intelligent_video_analysis_retrieval_system_tpu.serve.batching import QueryBatcher
from intelligent_video_analysis_retrieval_system_tpu.serve.handlers import (
    RateLimiter,
    RequestHandler,
    error_envelope,
    format_results,
)

__all__ = [
    "QueryBatcher",
    "RateLimiter",
    "RequestHandler",
    "error_envelope",
    "format_results",
]
