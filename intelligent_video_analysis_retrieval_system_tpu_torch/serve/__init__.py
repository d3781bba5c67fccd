"""Serving layer of the port: the REST/WebSocket server (``rest.py``, on the
standard library, with its WebSocket framing in ``websocket.py``), request
validation, response formatting and query micro-batching (``handlers.py`` and
``batching.py``, the port's own copies of the JAX package's framework-free
modules), run around this port's facade.
"""

from .batching import QueryBatcher
from .handlers import RateLimiter, RequestHandler, error_envelope, format_results
from .rest import RetrievalServer

__all__ = [
    "QueryBatcher",
    "RateLimiter",
    "RequestHandler",
    "RetrievalServer",
    "error_envelope",
    "format_results",
]
