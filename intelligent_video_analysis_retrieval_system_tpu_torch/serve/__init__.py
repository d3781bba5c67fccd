"""Serving layer of the port: request validation, response formatting and
query micro-batching (``handlers.py`` and ``batching.py``, the port's own
copies of the JAX package's framework-free modules), run around this port's
facade. The REST/WebSocket server is ported in a later change.
"""

from .batching import QueryBatcher
from .handlers import RateLimiter, RequestHandler, error_envelope, format_results

__all__ = [
    "QueryBatcher",
    "RateLimiter",
    "RequestHandler",
    "error_envelope",
    "format_results",
]
