"""Spans and counters inside the program, for finding where a call's time goes.

The port's own module (the JAX package has none). Off by default:

    from intelligent_video_analysis_retrieval_system_tpu_torch import trace

    trace.enable()
    index.search_vectors(q, top_k=20)
    for s in trace.take():
        print(s.name, s.end - s.start, s.parent, s.attrs, s.counts)

- :func:`span` is a context manager around one part of a call. It records
  its name, start and end on ``time.perf_counter()``, the id of the span it
  opened inside (``parent``), the id of the outermost span of the call
  (``root``, shared by every span of one top-level call), the thread, and
  the keyword attributes given (more with :meth:`Span.note`).
- :func:`count` adds to a counter of the innermost open span of the calling
  thread; a count made outside any span is not kept. A loop counts once per
  call with the number of its items, never once per item.
- While off, :func:`span` tests one flag and returns a shared context that
  does nothing, and :func:`count` returns at once: no clock read and no
  object made. While on, finished spans go to one list of at most ``CAP``
  spans; past it they are counted in :func:`dropped` and not kept.
- Each thread keeps its own stack of open spans, so a call made from a
  worker thread (the serving batcher's) nests under its own root.

Spans open in the layer they time: ``index.*`` in
``index/unified.py`` ``search_vectors``, ``quant.*`` in ``ops/quant.py``
``topk_search_int8``, ``embed.*`` in ``system/embedder.py``.
``time.perf_counter()`` is the clock that a profiler's trace can be tied to
by a marker launched right after a reading, so the spans can be laid over
the device's timeline to say what the host was doing while the card idled.
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter
from typing import Any

__all__ = ["Span", "count", "disable", "dropped", "enable", "enabled", "span", "take"]

# finished spans kept until taken (~470 bytes each: ~47 MB in all)
CAP = 100_000

_on = False
_spans: list[Span] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One timed part of a call (a context manager, and the record it
    leaves). ``start`` and ``end`` are ``time.perf_counter()`` seconds;
    ``parent`` is ``None`` for the outermost span of a call, whose ``root``
    is its own ``id``."""

    __slots__ = ("name", "attrs", "counts", "id", "parent", "root", "thread", "start", "end")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.counts: dict[str, int] = {}
        self.id = next(_ids)
        self.parent: int | None = None
        self.root = self.id
        self.thread = threading.get_ident()
        self.start = self.end = 0.0

    def note(self, **attrs: Any) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            self.root = stack[0].root
        stack.append(self)
        self.start = perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self.end = perf_counter()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        global _dropped
        with _lock:
            if len(_spans) < CAP:
                _spans.append(self)
            else:
                _dropped += 1


class _Off:
    """The span handed out while recording is off: it records nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def note(self, **attrs: Any) -> None:
        return None


_OFF = _Off()


def span(name: str, **attrs: Any) -> Span | _Off:
    """A context manager that records ``name`` from entry to exit."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _on:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def enable() -> None:
    """Record from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still finish and are kept."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def dropped() -> int:
    """Spans finished past the cap since the last :func:`take`."""
    return _dropped


def take() -> list[Span]:
    """The finished spans in the order they ended. The recorder keeps none
    of them, and its count of dropped spans starts again at 0."""
    global _spans, _dropped
    with _lock:
        out, _spans, _dropped = _spans, [], 0
    return out
