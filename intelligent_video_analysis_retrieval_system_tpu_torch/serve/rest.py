"""REST + WebSocket server over the port's EnhancedRetrievalSystem, on the
standard library.

Port of ``intelligent_video_analysis_retrieval_system_tpu/serve/rest.py``,
an aiohttp app. The machine the port serves on has no aiohttp, so this twin
stands on ``http.server.ThreadingHTTPServer``: one thread per connection,
HTTP/1.1 with keep-alive. Every response carries ``Content-Length``; a
request body is read to exactly its length, and a body a handler left
unread is drained before the connection takes its next request. Routes,
methods, status codes and JSON envelopes are the JAX server's:

    GET  /api/health
    POST /api/search            {query, mode?, limit?, detail_level?, folder?}
    POST /api/search_batch      {queries: [..], mode?, limit?, detail_level?}
    POST /api/image_search      {image_base64, limit?, detail_level?}
    POST /api/chat              {message, context_frames?}
    POST /api/translate         {text}
    GET  /api/metadata/{folder}/{image}
    GET  /api/thumbnail/{folder}/{image}      (JPEG)
    GET  /api/image/{folder}/{image}          (JPEG)
    GET  /api/similar/{folder}/{image}?limit=
    GET  /api/stats
    POST /api/export            {results, format}
    POST /api/build             {keyframes_dir, resume?}   (build wizard)
    GET  /api/build/status
    POST /api/filter            {action, input_dir, ...}   (filter launcher)
    POST /api/open              {path, writable?}          (smart load)
    POST /api/maintenance       {action, ...}
    POST /api/network/discover  {wait_s?}                  (network panel)
    GET  /api/network/peers
    POST /api/network/connect   {host, port}
    POST /api/network/load_remote    {host, port, index_id}
    POST /api/network/unload_remote  {index_id?}
    GET  /                      the console page

WebSocket at /ws (``serve/websocket.py`` frames it): JSON messages
``{event, data, request_id?}`` with the events ``ping`` / ``search`` /
``chat`` / ``translate`` / ``system_stats`` / ``image_search`` /
``metadata_query`` / ``semantic_search``, ``request_id`` echoed; the server
pushes ``build_progress`` / ``build_done`` / ``build_error`` and
``filter_progress`` / ``filter_done`` / ``filter_error`` to every open socket
from the job's thread. The same events and pushes run over the Socket.IO
wire at ``/socket.io/`` (``serve/socketio.py``). The network panel's routes
drive the P2P layer (``serve/p2p.py``): discovery listens without
announcing, and a loaded peer index joins ``system.remote_indexes``.

Where the framework alone makes the two servers differ: an unknown path
answers 404 and a known path asked with another method 405, a body over the
64 MiB cap 413, each with a JSON envelope (aiohttp answers these in plain
text). ``/ws`` has the JAX
server's heartbeat (``WS_HEARTBEAT_S``): a ping every 30 s, and a socket
whose pong has not come half an interval later is dropped. Facade work holds one of ``api.executor_workers`` slots (default
128), the width of the JAX server's executor.
"""

from __future__ import annotations

import base64
import hmac
import io
import json
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable
from urllib.parse import parse_qsl, unquote, urlsplit

from . import websocket as wsf
from .handlers import RateLimiter, RequestHandler, error_envelope, format_results

if TYPE_CHECKING:
    from ..system.facade import EnhancedRetrievalSystem

__all__ = ["RetrievalServer"]

MAX_BODY = 64 * 1024 * 1024   # aiohttp's client_max_size in the JAX server
KEEPALIVE_S = 75.0            # an idle keep-alive connection closes after this
LINGER_S = 10.0               # at most this long to drain a body left unread
# /ws heartbeat, the JAX server's WebSocketResponse(heartbeat=30): a ping this
# often, and a socket whose pong has not come half an interval later is
# closed and no longer gets broadcasts (aiohttp's rule)
WS_HEARTBEAT_S = 30.0


def _with_ann_warm(index, action, **kwargs):
    """Run an ANN maintenance action, then run the IVF searcher at the
    batch sizes it (re)keys before returning: batch 1..ann_max_batch (powers
    of two) x the common serving k values (10 and the API default 20), as
    the JAX server does. There it compiles the new programs; here it builds
    the kernels and the allocator's pools off the request path."""
    import numpy as np

    report = action(**kwargs)
    if index.ann_active and index.ntotal:
        probe = np.zeros((1, index.dim), np.float32)
        probe[0, 0] = 1.0
        for top_k in (10, 20):
            b = 1
            while True:
                index.search_vectors(np.tile(probe, (b, 1)), top_k=top_k)
                if b >= max(index.config.ann_max_batch, 1):
                    break
                b *= 2
    return report


class Response:
    """Status, body bytes and content type of one HTTP response."""

    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: dict[str, str] | None = None) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def json_response(obj: Any, status: int = 200,
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    return Response(status, dumps(obj).encode(), "application/json; charset=utf-8")


def _dumps(obj: Any) -> str:
    return json.dumps(obj, ensure_ascii=False, default=str)


class _BodyTooLarge(Exception):
    pass


class Request:
    """What a route handler sees: headers, the peer, path parameters, the
    query, and the body, read on first use to exactly its length."""

    def __init__(self, conn: "_Connection", match_info: dict[str, str],
                 query: dict[str, str]) -> None:
        self.headers = conn.headers
        self.remote = conn.client_address[0]
        self.match_info = match_info
        self.query = query
        self.conn = conn
        self._body: bytes | None = None

    def read(self) -> bytes:
        if self._body is None:
            self._body = self.conn.read_body(MAX_BODY)
        return self._body

    def json(self) -> dict[str, Any] | None:
        """The body as a JSON object, else None (as the JAX server's ``_json``)."""
        try:
            data = json.loads(self.read().decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        return data if isinstance(data, dict) else None


class _Connection(BaseHTTPRequestHandler):
    """One client connection; every request is handed to the server's app."""

    protocol_version = "HTTP/1.1"
    server_version = "ivars-torch"
    sys_version = ""
    disable_nagle_algorithm = True
    timeout = KEEPALIVE_S

    def setup(self) -> None:
        super().setup()
        self.server.app._track(self.connection, add=True)

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            self.server.app._track(self.connection, add=False)

    def do_GET(self) -> None:
        self.server.app._dispatch(self, "GET")

    def do_HEAD(self) -> None:
        self.server.app._dispatch(self, "HEAD")

    def do_POST(self) -> None:
        self.server.app._dispatch(self, "POST")

    def do_PUT(self) -> None:
        self.server.app._dispatch(self, "PUT")

    def do_DELETE(self) -> None:
        self.server.app._dispatch(self, "DELETE")

    def do_PATCH(self) -> None:
        self.server.app._dispatch(self, "PATCH")

    def log_message(self, format: str, *args: Any) -> None:
        pass   # no access log, as aiohttp's unconfigured access logger

    # -- the request body ------------------------------------------------------

    def begin_body(self) -> bool:
        """Read the body's framing from the headers; False if it is malformed."""
        self._chunked = "chunked" in self.headers.get("Transfer-Encoding", "").lower()
        self._chunks_done = not self._chunked
        try:
            self._left = 0 if self._chunked else int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return False
        return self._left >= 0

    def _next_chunk(self) -> bytes:
        line = self.rfile.readline(65537)
        size = int(line.split(b";")[0].strip() or b"0", 16)
        if size == 0:
            while self.rfile.readline(65537) not in (b"\r\n", b"\n", b""):
                pass   # trailers
            self._chunks_done = True
            return b""
        data = self.rfile.read(size)
        self.rfile.read(2)
        if len(data) < size:
            raise ConnectionError("connection closed inside a chunk")
        return data

    def read_body(self, limit: int) -> bytes:
        if not self._chunked:
            if self._left > limit:
                raise _BodyTooLarge
            data = self.rfile.read(self._left)
            if len(data) < self._left:
                raise ConnectionError("connection closed inside the body")
            self._left = 0
            return data
        parts, size = [], 0
        while not self._chunks_done:
            part = self._next_chunk()
            size += len(part)
            if size > limit:
                raise _BodyTooLarge
            parts.append(part)
        return b"".join(parts)

    def drain(self) -> bool:
        """Discard what is left of the body; False if that took too long."""
        deadline = time.monotonic() + LINGER_S
        try:
            while self._left > 0:
                got = len(self.rfile.read(min(self._left, 1 << 20)) or b"")
                if got == 0:
                    return False
                self._left -= got
                if time.monotonic() > deadline:
                    return False
            while not self._chunks_done:
                self._next_chunk()
                if time.monotonic() > deadline:
                    return False
        except (OSError, ValueError):
            return False
        return True

    def respond(self, resp: Response, head_only: bool) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for name, value in resp.headers.items():
            self.send_header(name, value)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        if not head_only:
            self.wfile.write(resp.body)


class _HTTPServer(ThreadingHTTPServer):
    block_on_close = False   # stop() closes the connections; no thread is joined
    request_queue_size = 1024   # the listen backlog (socketserver's 5 resets bursts)
    app: "RetrievalServer"

    def server_bind(self) -> None:
        # HTTPServer.server_bind asks the resolver for a name (getfqdn), which
        # can wait on a machine without DNS; the name is never used here
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    def handle_error(self, request: Any, client_address: Any) -> None:
        pass   # a client that went away mid-request; the app logs its own errors


def _match(template: list[str], segments: list[str]) -> dict[str, str] | None:
    if len(template) != len(segments):
        return None
    out = {}
    for t, s in zip(template, segments):
        if t.startswith("{"):
            if not s:
                return None
            out[t[1:-1]] = s
        elif t != s:
            return None
    return out


class HTTPApp:
    """Routes, dispatch and connection tracking of an app served by
    ``_HTTPServer`` (the REST server and the P2P peer server)."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, list[str], Callable[[Request], Response | None]]] = []
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    def _log_exception(self, message: str) -> None:
        import logging

        logging.getLogger(__name__).exception(message)

    def _add(self, method: str, path: str, fn: Callable[[Request], Response | None]) -> None:
        self._routes.append((method, path.split("/"), fn))

    def _dispatch(self, conn: _Connection, method: str) -> None:
        url = urlsplit(conn.path)
        segments = [unquote(s) for s in url.path.split("/")]
        found, allowed = None, []
        for route_method, template, fn in self._routes:
            match = _match(template, segments)
            if match is None:
                continue
            if route_method == method or (route_method == "GET" and method == "HEAD"):
                found = fn, match
                break
            allowed.append(route_method)
        if not conn.begin_body():
            conn.close_connection = True
            resp = json_response(error_envelope("malformed Content-Length"), 400)
        elif allowed and found is None:
            resp = json_response(error_envelope(f"method {method} not allowed", 405), 405)
            resp.headers["Allow"] = ", ".join(allowed)
        elif found is None:
            resp = json_response(error_envelope(f"not found: {url.path}", 404), 404)
        else:
            query: dict[str, str] = {}
            for key, value in parse_qsl(url.query, keep_blank_values=True):
                query.setdefault(key, value)
            fn, match = found
            try:
                resp = fn(Request(conn, match, query))
            except _BodyTooLarge:
                resp = json_response(
                    error_envelope(f"request body exceeds {MAX_BODY} bytes", 413), 413)
            except ConnectionError:
                conn.close_connection = True
                return
            except Exception as exc:
                self._log_exception(f"handler failed: {method} {url.path}")
                resp = json_response(
                    error_envelope(f"{type(exc).__name__}: {exc}", 500), 500)
            if resp is None:   # the websocket had the connection and is done with it
                conn.close_connection = True
                return
        if not conn.drain():
            conn.close_connection = True
        conn.respond(resp, head_only=method == "HEAD")

    def _track(self, sock: socket.socket, add: bool) -> None:
        with self._conns_lock:
            if add:
                self._conns.add(sock)
            else:
                self._conns.discard(sock)

    def _shutdown_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def accept_websocket(request: Request) -> "wsf.WebSocket | Response":
    """Answer a WebSocket upgrade on the request's connection: the open
    socket, or a 400 where the request is no valid upgrade."""
    headers = request.headers
    key = headers.get("Sec-WebSocket-Key")
    if (headers.get("Upgrade", "").lower() != "websocket"
            or "upgrade" not in headers.get("Connection", "").lower() or not key
            or headers.get("Sec-WebSocket-Version") != "13"):
        return json_response(error_envelope("websocket upgrade required"), 400)
    conn = request.conn
    conn.send_response(101)
    conn.send_header("Upgrade", "websocket")
    conn.send_header("Connection", "Upgrade")
    conn.send_header("Sec-WebSocket-Accept", wsf.accept_key(key))
    conn.end_headers()
    conn.connection.settimeout(None)   # an idle socket stays open
    return wsf.WebSocket(conn.connection, conn.rfile, client=False, max_size=MAX_BODY)


class RetrievalServer(HTTPApp):
    def __init__(
        self,
        system: "EnhancedRetrievalSystem",
        host: str = "0.0.0.0",
        port: int = 5000,
        rate_limit_per_minute: int | None = None,
    ) -> None:
        super().__init__()
        self.system = system
        self.host = host
        self.port = port
        limit = rate_limit_per_minute or system.config.get(
            "api.rate_limit_per_minute", 100
        )
        self.handler = RequestHandler(RateLimiter(limit))
        self.batcher = None
        if system.config.get("api.batching", False):
            from .batching import QueryBatcher

            self.batcher = QueryBatcher(
                system,
                window_ms=float(system.config.get("api.batching_window_ms", 3.0)),
                max_batch=int(system.config.get("api.batching_max_batch", 64)),
            )
            self.batcher.start()
        # the JAX server runs facade work on a pool of this many threads;
        # here each connection has its thread, and facade work holds a slot
        self._slots = threading.BoundedSemaphore(
            int(system.config.get("api.executor_workers", 128)))
        self._discovery = None           # lazy serve.p2p.NetworkDiscovery
        self._net_client = None          # lazy serve.p2p.NetworkClient
        self._setup_routes()
        self._httpd: _HTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._life = threading.Lock()
        self.started_at = time.time()
        # console build wizard state (reference GUI smart build)
        self._ws_clients: set[wsf.WebSocket] = set()
        self._build_lock = threading.Lock()
        self._build_state: dict[str, Any] = {"status": "idle"}
        self._build_thread: threading.Thread | None = None
        self._build_cb_registered = False

    # -- routes ---------------------------------------------------------------

    def _setup_routes(self) -> None:
        add = self._add
        add("GET", "/api/health", self._health)
        add("POST", "/api/search", self._search)
        add("POST", "/api/search_batch", self._search_batch)
        add("POST", "/api/image_search", self._image_search)
        add("POST", "/api/chat", self._chat)
        add("POST", "/api/translate", self._translate)
        add("GET", "/api/metadata/{folder}/{image}", self._metadata)
        add("GET", "/api/thumbnail/{folder}/{image}", self._thumbnail)
        add("GET", "/api/image/{folder}/{image}", self._image)
        add("GET", "/api/similar/{folder}/{image}", self._similar)
        add("GET", "/api/stats", self._stats)
        add("POST", "/api/export", self._export)
        add("POST", "/api/build", self._build)
        add("GET", "/api/build/status", self._build_status)
        add("POST", "/api/filter", self._filter)
        add("POST", "/api/open", self._open)
        add("POST", "/api/maintenance", self._maintenance)
        add("POST", "/api/network/discover", self._net_discover)
        add("GET", "/api/network/peers", self._net_peers)
        add("POST", "/api/network/connect", self._net_connect)
        add("POST", "/api/network/load_remote", self._net_load_remote)
        add("POST", "/api/network/unload_remote", self._net_unload_remote)
        add("GET", "/ws", self._websocket)
        # the Socket.IO wire: reference clients connect to /socket.io/ unchanged
        from .socketio import SocketIOAdapter

        self._sio = SocketIOAdapter(self)
        self._sio.register(self)
        add("GET", "/", self._console)

    def _log_exception(self, message: str) -> None:
        self.system.logger.exception(message)

    @staticmethod
    def _client_id(request: Request) -> str:
        return str(request.remote or "unknown")

    def _run_sync(self, fn, *args, **kwargs):
        """Facade work, in one of ``api.executor_workers`` slots. Batched
        searches spend their slot blocked on the batcher, so many more slots
        than cores is right (the JAX server's note on its executor)."""
        with self._slots:
            return fn(*args, **kwargs)

    # -- REST handlers --------------------------------------------------------

    def _admin_denied(self, request: Request) -> Response | None:
        """Optional auth gate for the mutation surface (/api/open,
        /api/maintenance, /api/build, /api/filter). When ``api.admin_token``
        is configured, requests must carry it in ``X-Admin-Token`` or
        ``Authorization: Bearer``; unset keeps the reference's LAN-trust
        model."""
        token = self.system.config.get("api.admin_token")
        if not token:
            return None
        got = request.headers.get("X-Admin-Token")
        if got is None:
            auth = request.headers.get("Authorization", "")
            got = auth[7:] if auth.startswith("Bearer ") else None
        if got is not None and hmac.compare_digest(str(got), str(token)):
            return None
        return json_response(error_envelope("admin token required", 401), 401)

    def _open_path_denied(self, path) -> Response | None:
        """When ``api.open_root`` is configured, /api/open may only load
        paths under that directory."""
        root = self.system.config.get("api.open_root")
        if not root:
            return None
        try:
            Path(path).resolve().relative_to(Path(root).resolve())
            return None
        except ValueError:
            return json_response(
                error_envelope("path outside the configured api.open_root", 403), 403)

    def _degraded_note(self) -> str | None:
        """One-line warning when text search runs with degraded semantics
        (hash-fallback tokenizer and/or random-init weights), attached to
        search responses."""
        emb = getattr(self.system, "embedder", None)
        if emb is None or not getattr(emb, "_loaded", False):
            return None
        notes = []
        if getattr(emb.tokenizer, "kind", None) == "hash_fallback":
            notes.append(
                "hash-fallback tokenizer (no CLIP vocab files) — text "
                "semantics do not match real CLIP; set model.vocab_dir"
            )
        if not emb.using_pretrained:
            notes.append(
                "random-initialized towers (no checkpoint at model.path)"
            )
        return "; ".join(notes) if notes else None

    def _rejected(self, endpoint: str, payload: dict, request: Request) -> Response | None:
        ok, err = self.handler.validate_request(endpoint, payload, self._client_id(request))
        if ok:
            return None
        status = 429 if err == "rate limit exceeded" else 400
        return json_response(error_envelope(err, status), status)

    def _health(self, request: Request) -> Response:
        report = self._run_sync(self.system.health.comprehensive_health_check)
        emb_stats = self.system.embedder.get_stats()
        return json_response(
            {
                "success": True,
                "status": report["overall"],
                "uptime_s": round(time.time() - self.started_at, 1),
                "index_loaded": self.system.index is not None
                and self.system.index.is_loaded,
                "tokenizer_kind": emb_stats.get("tokenizer"),
                "weights": (
                    None if not emb_stats.get("loaded")
                    else ("pretrained" if emb_stats.get("pretrained")
                          else "random_init")
                ),
                "components": {
                    name: {
                        "status": comp.get("status"),
                        "detail": comp.get("detail")
                        if isinstance(comp.get("detail"), (str, list))
                        else "ok",
                    }
                    for name, comp in report.get("components", {}).items()
                },
            }
        )

    def _search(self, request: Request) -> Response:
        payload = request.json()
        if payload is None:
            return json_response(error_envelope("invalid JSON body"), 400)
        rejected = self._rejected("search", payload, request)
        if rejected is not None:
            return rejected

        from ..system.facade import SearchOptions

        options = SearchOptions(
            mode=payload.get("mode", "clip_only"),
            limit=payload.get("limit", 20),
            folder_filter=payload.get("folder"),
            include_temporal=payload.get("include_temporal", False),
        )
        t0 = time.perf_counter()
        # micro-batched fast path for plain clip_only queries under load
        try:
            if (
                self.batcher is not None
                and self.batcher.is_running
                and options.mode == "clip_only"
                and not options.folder_filter
                and not options.include_temporal
            ):
                results = self._run_sync(
                    self.batcher.search, payload["query"], options.limit
                )
            else:
                results = self._run_sync(
                    self.system.search, payload["query"], options
                )
        except Exception as exc:
            # a failed batch (the index swapped mid-flight by /api/open) answers
            # with a JSON envelope, not a raw 500
            return json_response(error_envelope(f"search unavailable: {exc}", 503), 503)
        body = {
            "success": True,
            "query": payload["query"],
            "count": len(results),
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "results": format_results(
                results, payload.get("detail_level", "standard")
            ),
        }
        note = self._degraded_note()
        if note:
            body["warning"] = note
        return json_response(body)

    def _search_batch(self, request: Request) -> Response:
        """Explicit client-side batch: one tower forward and one sweep for all
        queries (``facade.search_batch``); per-query result lists in order."""
        payload = request.json()
        if payload is None:
            return json_response(error_envelope("invalid JSON body"), 400)
        rejected = self._rejected("search_batch", payload, request)
        if rejected is not None:
            return rejected
        queries = payload["queries"]
        if not all(isinstance(q, str) for q in queries):
            return json_response(error_envelope("queries must be a list of strings"), 400)
        if len(queries) > 256:
            return json_response(error_envelope("at most 256 queries per batch"), 400)

        from ..system.facade import SearchOptions

        options = SearchOptions(
            mode=payload.get("mode", "clip_only"),
            limit=payload.get("limit", 20),
            folder_filter=payload.get("folder"),
        )
        t0 = time.perf_counter()
        batches = self._run_sync(self.system.search_batch, queries, options)
        detail = payload.get("detail_level", "standard")
        body = {
            "success": True,
            "count": sum(len(b) for b in batches),
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "results": [format_results(b, detail) for b in batches],
        }
        note = self._degraded_note()
        if note:
            body["warning"] = note
        return json_response(body)

    @staticmethod
    def _decode_image(b64: str):
        import numpy as np
        from PIL import Image

        raw = base64.b64decode(b64)
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))

    def _image_search(self, request: Request) -> Response:
        payload = request.json()
        if payload is None:
            return json_response(error_envelope("invalid JSON body"), 400)
        rejected = self._rejected("image_search", payload, request)
        if rejected is not None:
            return rejected
        try:
            img = self._decode_image(payload["image_base64"])
        except Exception:
            return json_response(
                error_envelope("image_base64 is not a decodable image"), 400)

        from ..system.facade import SearchOptions

        options = SearchOptions(limit=payload.get("limit", 20))
        results = self._run_sync(self.system.search_by_image, img, options)
        return json_response(
            {
                "success": True,
                "count": len(results),
                "results": format_results(
                    results, payload.get("detail_level", "standard")
                ),
            }
        )

    def _chat(self, request: Request) -> Response:
        payload = request.json()
        if payload is None:
            return json_response(error_envelope("invalid JSON body"), 400)
        rejected = self._rejected("chat", payload, request)
        if rejected is not None:
            return rejected
        out = self._run_sync(
            self.system.chat, payload["message"], payload.get("context_frames")
        )
        return json_response({"success": True, **out})

    def _translate(self, request: Request) -> Response:
        payload = request.json()
        if payload is None:
            return json_response(error_envelope("invalid JSON body"), 400)
        rejected = self._rejected("translate", payload, request)
        if rejected is not None:
            return rejected
        result = self._run_sync(
            self.system.translator.translate_query, payload["text"]
        )
        return json_response({"success": True, **result.to_dict()})

    def _metadata(self, request: Request) -> Response:
        folder = request.match_info["folder"]
        image = request.match_info["image"]
        index = self.system.index
        if index is None:
            return json_response(error_envelope("no index loaded", 404), 404)
        row = index.row_for(folder, image)
        if row is None:
            return json_response(
                error_envelope(f"unknown keyframe {folder}/{image}", 404), 404)
        return json_response(
            {"success": True, "metadata": index.get_metadata(row).to_dict()}
        )

    def _thumbnail(self, request: Request) -> Response:
        return self._asset(request, full=False)

    def _image(self, request: Request) -> Response:
        return self._asset(request, full=True)

    def _asset(self, request: Request, full: bool) -> Response:
        folder = request.match_info["folder"]
        image = request.match_info["image"]
        index = self.system.index
        if index is None:
            return json_response(error_envelope("no index loaded", 404), 404)
        try:
            data = self._run_sync(
                index.get_full_image if full else index.get_thumbnail, folder, image
            )
        except KeyError:
            return json_response(
                error_envelope(f"unknown keyframe {folder}/{image}", 404), 404)
        if not data:
            return json_response(error_envelope("asset unavailable", 404), 404)
        return Response(200, data, "image/jpeg")

    def _similar(self, request: Request) -> Response:
        """Frames similar to an indexed keyframe (``search_by_row``)."""
        folder = request.match_info["folder"]
        image = request.match_info["image"]
        index = self.system.index
        if index is None:
            return json_response(error_envelope("no index loaded", 404), 404)
        row = index.row_for(folder, image)
        if row is None:
            return json_response(
                error_envelope(f"unknown keyframe {folder}/{image}", 404), 404)
        try:
            limit = min(int(request.query.get("limit", 10)), 100)
        except ValueError:
            limit = 10
        hits = self._run_sync(index.search_by_row, row, limit)
        return json_response(
            {
                "success": True,
                "count": len(hits),
                "results": [h.to_dict("standard") for h in hits],
            }
        )

    def _stats(self, request: Request) -> Response:
        stats = self._run_sync(self.system.get_system_stats)
        return json_response({"success": True, "stats": stats}, dumps=_dumps)

    def _export(self, request: Request) -> Response:
        payload = request.json()
        if payload is None or "results" not in payload:
            return json_response(error_envelope("body must include results"), 400)
        fmt = payload.get("format", "json")
        if fmt not in ("json", "csv"):
            return json_response(
                error_envelope(f"unsupported export format {fmt}"), 400)
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            out = Path(td) / f"export.{fmt}"
            self._run_sync(self.system.export_data, payload["results"], out, fmt)
            body = out.read_bytes()
        return Response(200, body, "application/json" if fmt == "json" else "text/csv")

    def _open(self, request: Request) -> Response:
        """Open an existing index with smart autodetect: a portable package
        dir (``manifest.json``), a ``.rvdb`` file, or a directory scanned
        (non-recursively, plus its ``index/`` subdir) for the newest
        ``.rvdb``."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        payload = request.json()
        if payload is None or not payload.get("path"):
            return json_response(error_envelope("missing 'path'"), 400)
        path = Path(str(payload["path"])).expanduser()
        denied = self._open_path_denied(path)
        if denied is not None:
            return denied
        writable = bool(payload.get("writable", False))

        def do_open() -> str:
            if path.is_dir() and (path / "manifest.json").is_file():
                self.system.load_portable_index(path)
                return "portable"
            if path.is_file() and path.suffix == ".rvdb":
                self.system.load_system(path, writable=writable)
                return "rvdb"
            if path.is_dir():
                candidates = [
                    p for pat in ("*.rvdb", "index/*.rvdb")
                    for p in path.glob(pat)
                ]
                if candidates:
                    newest = max(candidates, key=lambda p: p.stat().st_mtime)
                    self.system.load_system(newest, writable=writable)
                    return f"rvdb:{newest.name}"
            raise FileNotFoundError(f"no index found at {path}")

        try:
            kind = self._run_sync(do_open)
        except FileNotFoundError as exc:
            return json_response(error_envelope(str(exc), 404), 404)
        except Exception as exc:
            return json_response(error_envelope(f"{type(exc).__name__}: {exc}", 500), 500)
        index = self.system.index
        return json_response({
            "success": True,
            "kind": kind,
            "ntotal": index.ntotal if index is not None else 0,
            "path": str(index.path) if index is not None and index.path
            else str(path),
        })

    def _maintenance(self, request: Request) -> Response:
        """Maintenance actions: ``optimize`` (temp + cache trim),
        ``compact`` (drop tombstoned rows), ``clear_cache``, and the IVF
        mode's ``build_ann``, ``tune_ann`` and ``measure_crossover``, each
        followed by ``_with_ann_warm``."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        payload = request.json() or {}
        action = payload.get("action")
        no_index = json_response(error_envelope("no index loaded", 404), 404)
        try:
            if action == "optimize":
                report = self._run_sync(self.system.optimize)
            elif action == "compact":
                index = self.system.index
                if index is None:
                    return no_index
                report = self._run_sync(index.compact)
            elif action == "clear_cache":
                self._run_sync(self.system.cache.clear)
                report = {"cleared": True}
            elif action == "build_ann":
                index = self.system.index
                if index is None:
                    return no_index
                kwargs = {}
                if payload.get("nlist"):
                    kwargs["nlist"] = int(payload["nlist"])
                report = self._run_sync(_with_ann_warm, index, index.build_ann, **kwargs)
            elif action == "tune_ann":
                index = self.system.index
                if index is None:
                    return no_index
                kwargs = {}
                if payload.get("target_recall"):
                    kwargs["target_recall"] = float(payload["target_recall"])
                if payload.get("sample"):
                    kwargs["sample"] = int(payload["sample"])
                try:
                    report = self._run_sync(_with_ann_warm, index, index.tune_nprobe,
                                            **kwargs)
                except RuntimeError as exc:
                    # a precondition (no ANN structure yet), not a server fault
                    return json_response(error_envelope(str(exc), 409), 409)
            elif action == "measure_crossover":
                index = self.system.index
                if index is None:
                    return no_index
                kwargs = {}
                if payload.get("batch_sizes"):
                    try:
                        sizes = tuple(int(b) for b in payload["batch_sizes"])
                    except (TypeError, ValueError):
                        sizes = ()
                    if (not sizes or len(sizes) > 12
                            or any(b < 1 or b > 1024 for b in sizes)):
                        return json_response(
                            error_envelope("batch_sizes must be 1-12 ints in 1..1024"), 400)
                    kwargs["batch_sizes"] = sizes
                if payload.get("repeats"):
                    reps = int(payload["repeats"])
                    if reps < 1 or reps > 16:
                        return json_response(error_envelope("repeats must be in 1..16"), 400)
                    kwargs["repeats"] = reps
                try:
                    report = self._run_sync(_with_ann_warm, index,
                                            index.measure_ann_crossover, **kwargs)
                except RuntimeError as exc:
                    return json_response(error_envelope(str(exc), 409), 409)
            else:
                return json_response(
                    error_envelope(
                        "action must be optimize | compact | clear_cache"
                        " | build_ann | tune_ann | measure_crossover"
                    ),
                    400,
                )
        except PermissionError as exc:
            return json_response(error_envelope(str(exc), 403), 403)
        except Exception as exc:
            return json_response(error_envelope(f"{type(exc).__name__}: {exc}", 500), 500)
        return json_response({"success": True, "action": action, "report": report})

    def _console(self, request: Request) -> Response:
        return Response(200, _CONSOLE_HTML.encode(), "text/html; charset=utf-8")

    # -- network panel (the P2P layer, serve/p2p.py) ----------------------------

    def _get_net_client(self):
        if self._net_client is None:
            from .p2p import NetworkClient

            self._net_client = NetworkClient()
        return self._net_client

    def _net_discover(self, request: Request) -> Response:
        data = request.json() or {}
        try:
            wait_s = float(data.get("wait_s", 2.0))
        except (TypeError, ValueError):
            return json_response(error_envelope("wait_s must be a number"), 400)
        # peers announce every 15 s, so allow waiting one full period
        wait_s = min(max(wait_s, 0.0), 20.0)
        if self._discovery is None:
            from .p2p import NetworkDiscovery

            # listen only: this server has no peer endpoints to announce;
            # nodes accumulate in the background across discover calls
            self._discovery = NetworkDiscovery(service_port=self.port, listen_only=True)
            self._discovery.start_discovery()
        disc = self._discovery

        def probe():
            time.sleep(wait_s)
            return disc.get_nodes()

        return json_response({"success": True, "nodes": self._run_sync(probe)}, dumps=_dumps)

    def _net_peers(self, request: Request) -> Response:
        nodes = self._discovery.get_nodes() if self._discovery else []
        connected = list(self._net_client.connected.values()) if self._net_client else []
        remotes = [{"index_id": r.index_id, "base": r.base, "ntotal": r.ntotal}
                   for r in self.system.remote_indexes]
        return json_response({"success": True, "discovered": nodes, "connected": connected,
                              "remote_indexes": remotes}, dumps=_dumps)

    def _net_connect(self, request: Request) -> Response:
        data = request.json() or {}
        host, port = data.get("host"), data.get("port")
        if not host or not isinstance(port, int):
            return json_response(error_envelope("host (str) and port (int) required"), 400)
        client = self._get_net_client()
        try:
            info = self._run_sync(client.connect_to_server, host, port)
            indexes = self._run_sync(client.list_remote_indexes, host, port)
        except Exception as exc:
            return json_response(error_envelope(f"connect failed: {exc}"), 502)
        return json_response({"success": True, "node": info, "indexes": indexes},
                             dumps=_dumps)

    def _net_load_remote(self, request: Request) -> Response:
        data = request.json() or {}
        host, port = data.get("host"), data.get("port")
        index_id = data.get("index_id")
        if not host or not isinstance(port, int) or not index_id:
            return json_response(error_envelope("host, port, index_id required"), 400)
        base = f"http://{host}:{port}"
        for r in self.system.remote_indexes:
            if r.base == base and r.index_id == index_id:
                return json_response({"success": True, "already_loaded": True,
                                      "ntotal": r.ntotal})
        client = self._get_net_client()
        try:
            remote = self._run_sync(client.load_remote_index, host, port, index_id)
        except Exception as exc:
            return json_response(error_envelope(f"load failed: {exc}"), 502)
        self.system.remote_indexes.append(remote)
        return json_response({"success": True, "index_id": index_id, "ntotal": remote.ntotal},
                             dumps=_dumps)

    def _net_unload_remote(self, request: Request) -> Response:
        data = request.json() or {}
        index_id = data.get("index_id")
        before = len(self.system.remote_indexes)
        if index_id:
            self.system.remote_indexes[:] = [r for r in self.system.remote_indexes
                                             if r.index_id != index_id]
        else:
            self.system.remote_indexes.clear()
        return json_response({"success": True,
                              "removed": before - len(self.system.remote_indexes)})

    # -- build wizard -----------------------------------------------------------

    def _broadcast(self, payload: dict[str, Any]) -> None:
        """Push an event to every open WebSocket and every Socket.IO session,
        from any thread (each socket's send lock keeps the frame whole)."""
        with self._conns_lock:
            clients = list(self._ws_clients)
        for client in clients:
            try:
                client.send_json(payload, dumps=_dumps)
            except OSError:
                with self._conns_lock:
                    self._ws_clients.discard(client)
        self._sio.broadcast(payload.get("event", "message"), payload)

    def _on_build_progress(self, **payload: Any) -> None:
        self._build_state.update(status="running", **payload)
        self._broadcast({"event": "build_progress", **payload})

    def _build_worker(self, keyframes_dir: str, resume: bool) -> None:
        try:
            out = self.system.build_system(keyframes_dir, resume=resume)
            report = out.get("report", {})
            self._build_state.update(
                status="done",
                index_path=out.get("index_path"),
                processed=report.get("processed"),
                skipped=report.get("skipped_resume"),
                failed=report.get("failed"),
            )
            self._broadcast({"event": "build_done", **{
                k: self._build_state.get(k)
                for k in ("processed", "skipped", "failed", "index_path")
            }})
        except Exception as exc:
            self._build_state.update(status="error", error=str(exc))
            self._broadcast({"event": "build_error", "error": str(exc)})

    def _build(self, request: Request) -> Response:
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        data = request.json() or {}
        keyframes_dir = data.get("keyframes_dir")
        if not keyframes_dir or not isinstance(keyframes_dir, str):
            return json_response(error_envelope("keyframes_dir required"), 400)
        if not Path(keyframes_dir).is_dir():
            return json_response(error_envelope(f"not a directory: {keyframes_dir}"), 400)
        with self._build_lock:
            if self._build_state.get("status") == "running":
                return json_response(error_envelope("a build is already running"), 409)
            if not self._build_cb_registered:
                self.system.on("build_progress", self._on_build_progress)
                self._build_cb_registered = True
            self._build_state = {
                "status": "running", "keyframes_dir": keyframes_dir,
                "started_at": time.time(),
            }
            self._build_thread = threading.Thread(
                target=self._build_worker,
                args=(keyframes_dir, bool(data.get("resume", True))),
                daemon=True,
            )
            self._build_thread.start()
        return json_response({"success": True, "status": "running"})

    def _build_status(self, request: Request) -> Response:
        return json_response({"success": True, **self._build_state})

    # -- filter-tool launcher ---------------------------------------------------

    def _filter_worker(self, action: str, params: dict[str, Any]) -> None:
        from ..ingest import FrameFilter, FrameFilterConfig

        device = self.system.device
        try:
            if action == "extract":
                exts = {".mp4", ".avi", ".mkv", ".mov", ".webm"}
                src = Path(params["input_dir"])
                videos = sorted(
                    p for p in src.iterdir()
                    if p.suffix.lower() in exts and p.is_file()
                )
                if not videos:
                    raise ValueError(f"no video files in {src}")
                kf = Path(params.get("keyframes_dir") or src / "keyframes")
                mp = Path(params.get("map_dir") or src / "map")
                ff = FrameFilter(device=device)
                saved = 0
                for i, v in enumerate(videos):
                    self._build_state.update(stage=f"extract {v.name}",
                                             done=i, total=len(videos))
                    self._broadcast({"event": "filter_progress",
                                     "stage": v.name, "done": i,
                                     "total": len(videos)})
                    rep = ff.extract_frames(v, kf, map_dir=mp)
                    saved += rep.frames_kept
                report = {"videos": len(videos), "frames_kept": saved,
                          "keyframes_dir": str(kf), "map_dir": str(mp)}
            else:  # refine
                preset = params.get("preset") or "default"
                if preset == "gentle":
                    cfg = FrameFilterConfig.gentle()
                elif preset == "ultra_gentle":
                    cfg = FrameFilterConfig.ultra_gentle()
                elif preset == "similarity_only":
                    cfg = FrameFilterConfig.similarity_only()
                else:
                    cfg = FrameFilterConfig()
                self._build_state.update(stage="refine", done=0, total=1)
                self._broadcast({"event": "filter_progress",
                                 "stage": "refine", "done": 0, "total": 1})
                rep = FrameFilter(cfg, device=device).apply_filters(
                    params["input_dir"],
                    output_dir=params.get("output_dir"),
                    map_dir=params.get("map_dir"),
                    output_map_dir=params.get("output_map_dir"),
                )
                report = rep.as_dict()
                report.pop("per_folder", None)
            self._build_state.update(status="done", job="filter", **report)
            self._broadcast({"event": "filter_done", **report})
        except Exception as exc:
            self._build_state.update(status="error", job="filter", error=str(exc))
            self._broadcast({"event": "filter_error", "error": str(exc)})

    def _filter(self, request: Request) -> Response:
        """Run the ingest filter tool on a server-side directory:
        ``action="extract"`` (every video in ``input_dir`` to keyframes + map
        CSVs) or ``"refine"`` (quality/dedup refinement; presets default,
        gentle, ultra_gentle, similarity_only). Progress as WS
        ``filter_progress`` events; one job at a time with the build wizard."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        data = request.json() or {}
        action = data.get("action", "extract")
        if action not in ("extract", "refine"):
            return json_response(error_envelope(f"unknown filter action: {action}"), 400)
        input_dir = data.get("input_dir")
        if not input_dir or not Path(str(input_dir)).is_dir():
            return json_response(
                error_envelope("input_dir must be an existing directory"), 400)
        with self._build_lock:
            if self._build_state.get("status") == "running":
                return json_response(
                    error_envelope("a build/filter job is already running"), 409)
            self._build_state = {
                "status": "running", "job": "filter", "action": action,
                "input_dir": str(input_dir), "started_at": time.time(),
            }
            self._build_thread = threading.Thread(
                target=self._filter_worker, args=(action, dict(data)), daemon=True,
            )
            self._build_thread.start()
        return json_response({"success": True, "status": "running"})

    # -- websocket (the socketio event surface) ---------------------------------

    def _websocket(self, request: Request) -> Response | None:
        sock = accept_websocket(request)
        if isinstance(sock, Response):
            return sock
        with self._conns_lock:
            self._ws_clients.add(sock)
        stop = threading.Event()
        threading.Thread(target=self._ws_heartbeat, args=(sock, stop, WS_HEARTBEAT_S),
                         name="ws-heartbeat", daemon=True).start()
        try:
            self._ws_loop(sock, self._client_id(request))
        finally:
            stop.set()
            with self._conns_lock:
                self._ws_clients.discard(sock)
            sock.close()
        return None

    def _ws_heartbeat(self, sock: wsf.WebSocket, stop: threading.Event,
                      interval: float) -> None:
        """Ping ``sock`` every ``interval`` seconds; where no pong has come
        half an interval after a ping, drop the socket from the broadcast set
        and abort it (its receive loop then ends)."""
        while not stop.wait(interval):
            sent = time.monotonic()
            try:
                sock.send(wsf.PING, b"")
            except OSError:
                return
            if stop.wait(interval / 2):
                return
            if sock.pong_at < sent:
                with self._conns_lock:
                    self._ws_clients.discard(sock)
                sock.abort()
                return

    def _ws_loop(self, sock: wsf.WebSocket, client: str) -> None:
        while True:
            try:
                opcode, payload = sock.receive()
            except wsf.ProtocolError as exc:
                sock.close(exc.code, str(exc))
                return
            except OSError:
                return
            if opcode == wsf.CLOSE:
                return
            if opcode != wsf.TEXT:
                continue
            try:
                envelope = json.loads(payload.decode("utf-8"))
                event = envelope.get("event")
                data = envelope.get("data") or {}
                request_id = envelope.get("request_id")
            except (json.JSONDecodeError, UnicodeDecodeError, AttributeError):
                sock.send_json(error_envelope("invalid message"))
                continue
            try:
                reply = self._dispatch_ws(event, data, client)
            except Exception:
                self.system.logger.exception(f"websocket event failed: {event}")
                sock.close(1011, "internal error")
                return
            if request_id is not None:
                reply["request_id"] = request_id
            sock.send_json(reply, dumps=_dumps)

    def _dispatch_ws(self, event: str, data: dict[str, Any], client: str) -> dict[str, Any]:
        from ..system.facade import SearchOptions

        if event == "ping":
            return {"event": "pong", "ts": time.time()}
        if event == "search":
            ok, err = self.handler.validate_request("search", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            options = SearchOptions(
                mode=data.get("mode", "clip_only"), limit=data.get("limit", 20)
            )
            results = self._run_sync(self.system.search, data["query"], options)
            return {
                "event": "result",
                "success": True,
                "count": len(results),
                "results": format_results(results, data.get("detail_level", "standard")),
            }
        if event == "chat":
            ok, err = self.handler.validate_request("chat", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            out = self._run_sync(self.system.chat, data["message"], data.get("context_frames"))
            return {"event": "chat_response", "success": True, **out}
        if event == "translate":
            ok, err = self.handler.validate_request("translate", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            result = self._run_sync(self.system.translator.translate_query, data["text"])
            return {"event": "translated_text", "success": True, **result.to_dict()}
        if event == "system_stats":
            stats = self._run_sync(self.system.get_system_stats)
            return {"event": "system_stats", "success": True, "stats": stats}
        if event == "image_search":
            ok, err = self.handler.validate_request("image_search", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            try:
                img = self._decode_image(data["image_base64"])
            except Exception:
                return {"event": "error", **error_envelope("image_base64 not decodable")}
            options = SearchOptions(limit=data.get("limit", 20))
            results = self._run_sync(self.system.search_by_image, img, options)
            return {
                "event": "result",
                "success": True,
                "count": len(results),
                "results": format_results(results, data.get("detail_level", "standard")),
            }
        if event == "metadata_query":
            ok, err = self.handler.validate_request("metadata", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            index = self.system.index
            row = (
                index.row_for(data["folder"], data["image"])
                if index is not None else None
            )
            if row is None:
                return {"event": "error", **error_envelope("unknown keyframe", 404)}
            return {
                "event": "metadata",
                "success": True,
                "metadata": index.get_metadata(row).to_dict(),
            }
        if event == "semantic_search":
            # reference alias: semantic search == llm_enhanced text search
            ok, err = self.handler.validate_request("search", data, client)
            if not ok:
                return {"event": "error", **error_envelope(err)}
            options = SearchOptions(mode="llm_enhanced", limit=data.get("limit", 20))
            results = self._run_sync(self.system.search, data["query"], options)
            return {
                "event": "result",
                "success": True,
                "count": len(results),
                "results": format_results(results, data.get("detail_level", "standard")),
            }
        return {"event": "error", **error_envelope(f"unknown event: {event}")}

    # -- lifecycle ----------------------------------------------------------------

    def run(self, block: bool = True) -> None:
        """Start serving: in this thread until :meth:`stop` (``block``), or
        in a thread of its own. The socket is bound before this returns
        (``port=0`` takes a free port, written back to ``self.port``)."""
        with self._life:
            if self._httpd is not None:
                raise RuntimeError("the server is already running")
            if self.batcher is not None and not self.batcher.is_running:
                self.batcher.start()
            httpd = _HTTPServer((self.host, self.port), _Connection)
            httpd.app = self
            self.port = httpd.server_address[1]
            self._httpd = httpd
            if not block:
                self._thread = threading.Thread(target=httpd.serve_forever,
                                                name="ivars-rest", daemon=True)
                self._thread.start()
                return
        try:
            httpd.serve_forever()
        finally:
            with self._life:
                if self._httpd is httpd:
                    self._httpd = None
                    self._close_connections()
                    httpd.server_close()

    def stop(self) -> None:
        """Stop the batcher and the network panel's discovery, stop
        accepting, close every open connection (WebSockets with 1001) and
        every Socket.IO session, and release the port; :meth:`run` may start
        the server again."""
        if self.batcher is not None:
            self.batcher.stop()
        if self._discovery is not None:
            self._discovery.stop_discovery()
            self._discovery = None
        with self._life:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
            if httpd is None:
                return
            httpd.shutdown()
            httpd.server_close()
            self._close_connections()
        if thread is not None:
            thread.join(timeout=5)

    def _close_connections(self) -> None:
        with self._conns_lock:
            sockets, self._ws_clients = list(self._ws_clients), set()
        for ws_sock in sockets:
            ws_sock.close(1001, "server shutting down")
        self._sio.close()
        self._shutdown_connections()


# the console page: the JAX server's, byte for byte
_CONSOLE_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>IVARS-TPU Console</title>
<style>
 :root{--fg:#1a1a2e;--mut:#777;--acc:#3452c4;--bg:#f7f8fb;--card:#fff}
 body{font-family:system-ui;margin:0;background:var(--bg);color:var(--fg)}
 header{background:var(--card);padding:.8rem 1.5rem;border-bottom:1px solid #e3e6ef;
        display:flex;gap:1.5rem;align-items:center}
 header h1{font-size:1.05rem;margin:0}
 nav button{border:0;background:none;padding:.45rem .9rem;cursor:pointer;
            border-radius:6px;font-size:.95rem;color:var(--mut)}
 nav button.on{background:var(--acc);color:#fff}
 main{max-width:1040px;margin:1.2rem auto;padding:0 1rem}
 .panel{display:none}.panel.on{display:block}
 .row{display:flex;gap:.6rem;margin-bottom:1rem}
 input[type=text]{flex:1;padding:.55rem .8rem;border:1px solid #ccd2e0;
        border-radius:8px;font-size:1rem}
 select{padding:.45rem;border-radius:8px;border:1px solid #ccd2e0}
 button.go{background:var(--acc);color:#fff;border:0;border-radius:8px;
           padding:.55rem 1.2rem;cursor:pointer}
 .meta{color:var(--mut);font-size:.85rem;margin:.3rem 0 .8rem}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(170px,1fr));gap:.8rem}
 .hit{background:var(--card);border-radius:10px;padding:.5rem;text-align:center;
      font-size:.78rem;box-shadow:0 1px 3px rgba(20,30,60,.08)}
 .hit img{width:100%;border-radius:6px;aspect-ratio:1;object-fit:cover}
 .hit .s{color:var(--acc);font-weight:600}
 #chatlog{background:var(--card);border-radius:10px;padding:1rem;min-height:220px;
          max-height:420px;overflow:auto;margin-bottom:.8rem}
 .msg{margin:.4rem 0;padding:.5rem .8rem;border-radius:10px;max-width:85%}
 .me{background:var(--acc);color:#fff;margin-left:auto;width:fit-content}
 .bot{background:#eef0f7;width:fit-content}
 pre{background:var(--card);border-radius:10px;padding:1rem;overflow:auto;
     font-size:.8rem}
</style></head>
<body>
<header><h1>IVARS-TPU</h1>
<nav>
 <button class="on" data-p="search">Search</button>
 <button data-p="image">Image search</button>
 <button data-p="chat">Chat</button>
 <button data-p="build">Build</button>
 <button data-p="staging">CSV list (<span id="stagecount">0</span>)</button>
 <button data-p="network">Network</button>
 <button data-p="stats">Stats</button>
</nav></header>
<main>
<section id="search" class="panel on">
 <div class="row"><input id="q" type="text" placeholder="a red car at night… / người đang chạy…">
 <select id="mode"><option>clip_only</option><option>hybrid</option>
 <option>llm_enhanced</option></select>
 <button class="go" onclick="doSearch()">Search</button></div>
 <div class="meta" id="smeta"></div><div class="grid" id="sout"></div>
</section>
<section id="image" class="panel">
 <div class="row"><input type="file" id="file" accept="image/*">
 <button class="go" onclick="doImage()">Find similar</button></div>
 <div class="meta" id="imeta"></div><div class="grid" id="iout"></div>
</section>
<section id="chat" class="panel">
 <div id="chatlog"></div>
 <div class="row"><input id="cmsg" type="text" placeholder="ask about the videos…">
 <button class="go" onclick="doChat()">Send</button></div>
</section>
<section id="build" class="panel">
 <div class="row"><input id="bdir" type="text" placeholder="/path/to/keyframes">
 <label><input id="bresume" type="checkbox" checked> resume</label>
 <button class="go" onclick="doBuild()">Build index</button></div>
 <div class="meta" id="bmeta">idle</div>
 <div style="background:#e3e6ef;border-radius:6px;height:10px;overflow:hidden">
  <div id="bbar" style="background:var(--acc);width:0%;height:100%"></div></div>
 <h3 style="margin-top:1.4rem">Open existing index</h3>
 <div class="row"><input id="opath" type="text"
  placeholder="/path/to/index.rvdb, portable package dir, or a folder to scan">
 <label><input id="owrit" type="checkbox"> writable</label>
 <button class="go" onclick="doOpen()">Open</button></div>
 <div class="meta" id="ometa">smart-load: .rvdb file, portable dir
  (manifest.json), or newest .rvdb inside a folder</div>
 <h3 style="margin-top:1.4rem">Filter tool</h3>
 <div class="row"><input id="fdir" type="text"
  placeholder="/path/to/videos (extract) or /path/to/keyframes (refine)">
 <select id="fact"><option value="extract">extract keyframes</option>
  <option value="refine">refine keyframes</option></select>
 <select id="fpreset"><option value="default">default</option>
  <option value="gentle">gentle</option>
  <option value="ultra_gentle">ultra gentle</option>
  <option value="similarity_only">similarity only</option></select>
 <button class="go" onclick="doFilter()">Run</button></div>
 <div class="meta" id="fmeta">extract: video files -&gt; keyframes/ + map/
  CSVs; refine: drop blurry + near-duplicate frames (preset applies to
  refine)</div>
</section>
<section id="staging" class="panel">
 <div class="meta">Staged frames ("+csv" on any result card — the
  reference GUI's CSV list, gui.py:756-1666). Export writes the
  competition submission format: <code>&lt;folder&gt;.csv,&lt;frame_idx&gt;
  [,"qa"]</code>. "Use in chat" sends staged frames as chat context.</div>
 <div class="row"><input id="qadata" type="text"
  placeholder='optional QA answer column (quoted in the CSV)'>
 <button class="go" onclick="exportStaged()">Export submission CSV</button>
 <button class="go" onclick="stageToChat()">Use in chat</button>
 <button class="go" onclick="clearStaged()">Clear all</button></div>
 <div class="grid" id="stout"></div>
</section>
<section id="network" class="panel">
 <div class="row"><button class="go" onclick="doDiscover()">Discover peers</button>
 <input id="nhost" type="text" placeholder="host" style="max-width:160px">
 <input id="nport" type="text" placeholder="port" style="max-width:90px">
 <button class="go" onclick="doConnect()">Connect</button></div>
 <div class="meta" id="nmeta"></div><pre id="nout">no peers yet</pre>
</section>
<section id="stats" class="panel">
 <div class="row">
  <button class="go" onclick="doExport('json')">Export JSON</button>
  <button class="go" onclick="doExport('csv')">Export CSV</button>
  <button class="go" onclick="doMaint('optimize')">Optimize</button>
  <button class="go" onclick="doMaint('compact')">Compact index</button>
  <button class="go" onclick="doMaint('clear_cache')">Clear cache</button>
  <button class="go" onclick="doMaint('build_ann')">Build ANN (IVF)</button>
  <button class="go" onclick="doMaint('tune_ann')">Tune ANN recall</button>
  <button class="go" onclick="doMaint('measure_crossover')">Measure ANN crossover</button></div>
 <pre id="statout">loading…</pre></section>
</main>
<div id="zoom" style="display:none;position:fixed;inset:0;z-index:50;
 background:rgba(10,14,30,.88);cursor:zoom-out;overflow:hidden">
 <img id="zoomimg" style="position:absolute;left:50%;top:48%;
  transform:translate(-50%,-50%) scale(1);max-width:92vw;max-height:86vh;
  border-radius:8px;transition:transform .08s">
 <div id="zoomcap" style="position:absolute;bottom:1rem;left:0;right:0;
  text-align:center;color:#dde3f5;font-size:.9rem"></div>
</div>
<script>
document.querySelectorAll('nav button').forEach(b=>b.onclick=()=>{
  document.querySelectorAll('nav button').forEach(x=>x.classList.remove('on'));
  document.querySelectorAll('.panel').forEach(x=>x.classList.remove('on'));
  b.classList.add('on');document.getElementById(b.dataset.p).classList.add('on');
  if(b.dataset.p==='stats')loadStats();
});
function esc(s){return String(s).replace(/[&<>"']/g,c=>({'&':'&amp;',
  '<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));}
function card(h){
  // folder/image come from index metadata (untrusted at LAN trust level):
  // escape into data- attributes, never into inline JS
  const f=encodeURIComponent(h.folder),i=encodeURIComponent(h.image);
  return `<div class="hit"><img src="/api/thumbnail/${f}/${i}"
   class="zoomable" style="cursor:zoom-in"
   data-f="${esc(h.folder)}" data-i="${esc(h.image)}"
   onerror="this.style.display='none'">${esc(h.folder)}/${esc(h.image)}<br>
   <span class="s">${h.similarity_score.toFixed(3)}</span>
   <a href="#" class="sim" data-f="${esc(h.folder)}"
    data-i="${esc(h.image)}">similar</a>
   <a href="#" class="stage" data-f="${esc(h.folder)}"
    data-i="${esc(h.image)}">+csv</a></div>`;
}
let staged=[];
function renderStaged(){
  stagecount.textContent=staged.length;
  stout.innerHTML=staged.map((h,ix)=>{
    const f=encodeURIComponent(h.folder),i=encodeURIComponent(h.image);
    return `<div class="hit"><img src="/api/thumbnail/${f}/${i}"
     onerror="this.style.display='none'">${esc(h.folder)}/${esc(h.image)}<br>
     <a href="#" class="unstage" data-ix="${ix}">remove</a></div>`;}).join('');
  stout.querySelectorAll('a.unstage').forEach(a=>{a.onclick=e=>{
    e.preventDefault();staged.splice(parseInt(a.dataset.ix),1);renderStaged();};});
}
function stageFrame(f,i){
  if(staged.length>=100){fmeta&&(fmeta.textContent='CSV list full (100)');return;}
  if(staged.some(h=>h.folder===f&&h.image===i))return;
  staged.push({folder:f,image:i});renderStaged();
}
function exportStaged(){
  if(!staged.length)return;
  const qa=(qadata.value||'').trim();
  const lines=staged.map(h=>{
    const idx=h.image.replace(/\\.[^.]+$/,'');
    return qa?`${h.folder}.csv,${idx},"${qa.replace(/"/g,'""')}"`
             :`${h.folder}.csv,${idx}`;});
  const a=document.createElement('a');
  a.href=URL.createObjectURL(new Blob([lines.join('\\n')],{type:'text/csv'}));
  a.download='submission.csv';a.click();
}
let chatContext=null;
function stageToChat(){
  if(!staged.length)return;
  chatContext=staged.slice(0,5);
  document.querySelector('nav button[data-p=chat]').click();
  chatlog.innerHTML+=`<div class="msg bot">${chatContext.length} staged `
    +`frame(s) attached as context for your next message</div>`;
}
function clearStaged(){staged=[];renderStaged();}
async function post(url, body){
  const r=await fetch(url,{method:'POST',headers:{'content-type':'application/json'},
    body:JSON.stringify(body)});return r.json();
}
let lastResults=[];
async function doSearch(){
  const d=await post('/api/search',{query:q.value,limit:24,mode:mode.value});
  smeta.textContent=d.success?`${d.count} hits in ${d.latency_ms} ms`
    :JSON.stringify(d.error);
  lastResults=d.results||[];
  sout.innerHTML=lastResults.map(card).join('');
}
async function doExport(fmt){
  if(!lastResults.length){statout.textContent='run a search first — export '
    +'saves the last search results';return;}
  const r=await fetch('/api/export',{method:'POST',
    headers:{'content-type':'application/json'},
    body:JSON.stringify({results:lastResults,format:fmt})});
  const blob=await r.blob();const a=document.createElement('a');
  a.href=URL.createObjectURL(blob);a.download='results.'+fmt;a.click();
}
let bws=null;
function buildWS(){
  if(bws&&bws.readyState<2)return;
  bws=new WebSocket((location.protocol==='https:'?'wss':'ws')+'://'
    +location.host+'/ws');
  bws.onmessage=e=>{const d=JSON.parse(e.data);
    if(d.event==='build_progress'){
      bmeta.textContent=`${d.stage||''} ${d.done||0}/${d.total||0}`;
      if(d.total)bbar.style.width=(100*d.done/d.total)+'%';}
    if(d.event==='build_done'){bmeta.textContent=
      `done — processed ${d.processed}, skipped ${d.skipped}, failed ${d.failed}`;
      bbar.style.width='100%';}
    if(d.event==='build_error')bmeta.textContent='ERROR: '+d.error;
    if(d.event==='filter_progress')
      fmeta.textContent=`${d.stage||''} ${d.done||0}/${d.total||0}`;
    if(d.event==='filter_done')
      fmeta.textContent='done: '+JSON.stringify(d).slice(0,200);
    if(d.event==='filter_error')fmeta.textContent='ERROR: '+d.error;};
}
async function doFilter(){
  buildWS();
  const d=await post('/api/filter',{action:fact.value,input_dir:fdir.value,
    preset:fpreset.value});
  fmeta.textContent=d.success?'filter job started…'
    :JSON.stringify(d.error||d);
}
async function doBuild(){
  buildWS();
  const d=await post('/api/build',{keyframes_dir:bdir.value,
    resume:bresume.checked});
  bmeta.textContent=d.success?'build started…':JSON.stringify(d.error||d);
  if(d.success)bbar.style.width='2%';
}
async function doDiscover(){
  nmeta.textContent='listening for announcements…';
  const d=await post('/api/network/discover',{wait_s:2});
  nmeta.textContent=`${(d.nodes||[]).length} peer(s) discovered`;
  renderPeers(d.nodes||[],[]);
}
function renderPeers(nodes,indexes){
  // peer names/hosts/index ids arrive from UNAUTHENTICATED UDP/HTTP —
  // escape everything, and never splice ids into inline JS
  let html='';
  nodes.forEach(n=>{html+=`${esc(n.node_name||n.node_id)} @ `
    +`${esc(n.host||n.ip)}:${esc(n.service_port)}\\n`;});
  indexes.forEach(i=>{const id=String(i.index_id||i.id);
    html+=`  index ${esc(id)}: ${esc(i.ntotal||'?')} rows `
    +`<button data-idx="${esc(id)}" class="loadremote">load</button>\\n`;});
  nout.innerHTML=html||'no peers yet';
  nout.querySelectorAll('button.loadremote').forEach(b=>{
    b.onclick=()=>loadRemote(b.dataset.idx);});
}
async function doConnect(){
  const d=await post('/api/network/connect',
    {host:nhost.value,port:parseInt(nport.value)});
  if(!d.success){nmeta.textContent=JSON.stringify(d.error);return;}
  nmeta.textContent=`connected: ${(d.node||{}).node_name||nhost.value}`;
  renderPeers([],d.indexes||[]);
}
async function loadRemote(id){
  const d=await post('/api/network/load_remote',
    {host:nhost.value,port:parseInt(nport.value),index_id:id});
  nmeta.textContent=d.success?`remote index ${id} loaded (${d.ntotal} rows) — `
    +`searches now fan out to it`:JSON.stringify(d.error);
}
async function doImage(){
  const f=file.files[0];if(!f)return;
  const b64=await new Promise(res=>{const r=new FileReader();
    r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(f);});
  const d=await post('/api/image_search',{image_base64:b64,limit:24});
  imeta.textContent=d.success?`${d.count} hits`:JSON.stringify(d.error);
  iout.innerHTML=(d.results||[]).map(card).join('');
}
async function doChat(){
  const m=cmsg.value;if(!m)return;cmsg.value='';
  chatlog.innerHTML+=`<div class="msg me">${esc(m)}</div>`;
  const body={message:m};
  if(chatContext){body.context_frames=chatContext;chatContext=null;}
  const d=await post('/api/chat',body);
  chatlog.innerHTML+=`<div class="msg bot">${esc(d.response||'(no reply)')}</div>`;
  if((d.search_results||[]).length)
    chatlog.innerHTML+=`<div class="grid">${d.search_results.slice(0,6)
      .map(card).join('')}</div>`;
  chatlog.scrollTop=chatlog.scrollHeight;
}
async function loadStats(){
  const r=await fetch('/api/stats');statout.textContent=
    JSON.stringify(await r.json(),null,2);
}
async function doOpen(){
  ometa.textContent='opening…';
  const d=await post('/api/open',{path:opath.value,writable:owrit.checked});
  ometa.textContent=d.success?
    `opened ${esc(d.kind)} — ${d.ntotal} rows (${esc(d.path)})`
    :('ERROR: '+JSON.stringify(d.error));
}
async function doMaint(action){
  statout.textContent=action+'…';
  const d=await post('/api/maintenance',{action});
  statout.textContent=JSON.stringify(d,null,2);
}
async function doSimilar(f,i){
  // similar-frame click-through (reference GUI similarity navigation):
  // results land in the Search panel grid
  document.querySelector('nav button[data-p=search]').click();
  smeta.textContent=`frames similar to ${f}/${i}…`;
  const r=await fetch(`/api/similar/${encodeURIComponent(f)}/`
    +`${encodeURIComponent(i)}?limit=24`);
  const d=await r.json();
  smeta.textContent=d.success?`${d.count} frames similar to ${f}/${i}`
    :JSON.stringify(d.error);
  lastResults=d.results||[];
  sout.innerHTML=lastResults.map(card).join('');
}
let zscale=1;
function openZoom(f,i){
  zscale=1;zoomimg.style.transform='translate(-50%,-50%) scale(1)';
  zoomimg.src=`/api/image/${encodeURIComponent(f)}/${encodeURIComponent(i)}`;
  zoomimg.onerror=()=>{zoomimg.onerror=null;
    zoomimg.src=`/api/thumbnail/${encodeURIComponent(f)}/`
      +`${encodeURIComponent(i)}`;};
  zoomcap.textContent=f+'/'+i+' — scroll to zoom, click or Esc to close';
  zoom.style.display='block';
}
zoom.addEventListener('click',e=>{if(e.target!==zoomimg)
  zoom.style.display='none';});
zoom.addEventListener('wheel',e=>{e.preventDefault();
  zscale=Math.min(8,Math.max(.3,zscale*(e.deltaY<0?1.15:1/1.15)));
  zoomimg.style.transform=`translate(-50%,-50%) scale(${zscale})`;},
  {passive:false});
document.addEventListener('keydown',e=>{if(e.key==='Escape')
  zoom.style.display='none';});
document.addEventListener('click',e=>{
  const z=e.target.closest&&e.target.closest('img.zoomable');
  if(z){openZoom(z.dataset.f,z.dataset.i);return;}
  const s=e.target.closest&&e.target.closest('a.sim');
  if(s){e.preventDefault();doSimilar(s.dataset.f,s.dataset.i);return;}
  const g=e.target.closest&&e.target.closest('a.stage');
  if(g){e.preventDefault();stageFrame(g.dataset.f,g.dataset.i);}
});
q.addEventListener('keydown',e=>{if(e.key==='Enter')doSearch()});
cmsg.addEventListener('keydown',e=>{if(e.key==='Enter')doChat()});
</script></body></html>
"""
