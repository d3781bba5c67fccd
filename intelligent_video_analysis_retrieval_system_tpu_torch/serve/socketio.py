"""Socket.IO wire compatibility for the REST server, on the standard library.

Port of ``intelligent_video_analysis_retrieval_system_tpu/serve/socketio.py``
(an aiohttp handler there). The reference exposes its realtime surface
through python-socketio: events ``search``, ``translated_text``,
``translate``, ``image_search``, ``chat``, ``metadata_query``,
``semantic_search``, ``system_stats``; replies emitted as ``connected`` /
``result`` / ``translation_result`` / ``image_search_result`` /
``chat_response`` / ``metadata_result`` / ``semantic_search_result`` /
``system_stats`` / ``error``. This module serves the same wire at
``/socket.io/``: Engine.IO v4 + Socket.IO v5, the protocol current
python-socketio and socket.io-client speak, so reference clients connect
unchanged. It runs on the port's threaded server (``serve/rest.py``, one
thread per connection) and ``serve/websocket.py``'s framing; neither
machine the port runs on has a ``socketio`` package.

Transports: HTTP long-polling (a GET blocks on the session's queue for up
to ``PING_INTERVAL_S``, then drains it; a POST carries packets joined by
``\\x1e``), direct WebSocket, and the polling -> WebSocket upgrade
(``2probe`` / ``3probe`` / ``5``). Events dispatch through the server's
``_dispatch_ws``, the same as ``/ws``, so validation, rate limits and
answers are the same on both wires; the server's pushes (build and filter
progress) reach every connected session beside the ``/ws`` clients.

Engine.IO packet types: 0 open, 1 close, 2 ping, 3 pong, 4 message,
5 upgrade, 6 noop. Socket.IO packets (inside EIO ``4``): 0 connect,
1 disconnect, 2 event (``42<ack-id?>["name", data]``), 3 ack. A malformed
packet gets an ``error`` event or is ignored; the session lives on.
"""

from __future__ import annotations

import json
import queue
import secrets
import threading
import time
from typing import TYPE_CHECKING, Any

from . import websocket as wsf
from .rest import Request, Response, _dumps, accept_websocket

if TYPE_CHECKING:  # pragma: no cover
    from .rest import RetrievalServer

__all__ = ["SocketIOAdapter"]

_RS = "\x1e"  # Engine.IO polling record separator
# read at each use, so that tests may shorten them
PING_INTERVAL_S = 25.0
PING_TIMEOUT_S = 20.0
SESSION_TTL_S = 120.0
_TEXT = "text/plain; charset=utf-8"

# socket.io reply event name per request event (the reference's emit sites)
_REPLY_EVENT = {
    "search": "result",
    "translated_text": "result",
    "translate": "translation_result",
    "image_search": "image_search_result",
    "chat": "chat_response",
    "metadata_query": "metadata_result",
    "semantic_search": "semantic_search_result",
    "system_stats": "system_stats",
}


class _Session:
    __slots__ = ("sid", "queue", "ws", "upgraded", "connected_ns",
                 "last_seen", "client", "lock")

    def __init__(self, sid: str, client: str):
        self.sid = sid
        self.queue: queue.Queue[str] = queue.Queue()
        self.ws: wsf.WebSocket | None = None   # the live socket once upgraded
        self.upgraded = False
        self.connected_ns = False  # socket.io "40" namespace connect seen
        self.last_seen = time.time()
        self.client = client
        # a push and the upgrade take it, so that no packet is queued for
        # polling after the queue was flushed onto the socket
        self.lock = threading.Lock()

    def upgrade(self, ws: wsf.WebSocket) -> None:
        """Move the session onto ``ws`` and send it what polling left queued."""
        with self.lock:
            self.ws = ws
            self.upgraded = True
            while True:
                try:
                    packet = self.queue.get_nowait()
                except queue.Empty:
                    return
                try:
                    ws.send(wsf.TEXT, packet.encode())
                except OSError:
                    return


def _text(body: str, status: int = 200) -> Response:
    return Response(status, body.encode(), _TEXT)


class SocketIOAdapter:
    """Engine.IO v4 / Socket.IO v5 endpoint bridging to the server's
    ``_dispatch_ws`` event surface."""

    def __init__(self, server: "RetrievalServer"):
        self.server = server
        self.sessions: dict[str, _Session] = {}
        self._lock = threading.Lock()   # the session table: connection threads share it

    def register(self, app) -> None:
        app._add("GET", "/socket.io/", self.handle_get)
        app._add("POST", "/socket.io/", self.handle_post)

    # -- helpers ------------------------------------------------------------

    def _open_packet(self, sid: str) -> str:
        return "0" + json.dumps({
            "sid": sid,
            "upgrades": ["websocket"],
            "pingInterval": int(PING_INTERVAL_S * 1000),
            "pingTimeout": int(PING_TIMEOUT_S * 1000),
            "maxPayload": 1_000_000,
        })

    def _emit_packet(self, event: str, data: Any) -> str:
        return "42" + _dumps([event, data])

    def _new_session(self, client: str) -> _Session:
        sess = _Session(secrets.token_urlsafe(16), client)
        with self._lock:
            self.sessions[sess.sid] = sess
        return sess

    def _session(self, sid: str) -> _Session | None:
        with self._lock:
            return self.sessions.get(sid)

    def _drop(self, sid: str) -> None:
        with self._lock:
            self.sessions.pop(sid, None)

    def _push(self, sess: _Session, packet: str) -> None:
        """Deliver one EIO packet to the session on its live transport (a
        socket that broke takes nothing more)."""
        with sess.lock:
            ws = sess.ws
            if not sess.upgraded:
                sess.queue.put(packet)
            elif ws is not None and not ws.closed:
                try:
                    ws.send(wsf.TEXT, packet.encode())
                except OSError:
                    pass

    def broadcast(self, event: str, data: dict[str, Any]) -> None:
        """Fan a server-initiated event to every connected session (the
        payloads the ``/ws`` broadcast carries), from any thread."""
        packet = self._emit_packet(event, data)
        with self._lock:
            sessions = list(self.sessions.values())
        for sess in sessions:
            if sess.connected_ns:
                self._push(sess, packet)

    def close(self) -> None:
        """End every session: a close packet to each poller, a close frame
        on each upgraded socket."""
        with self._lock:
            sessions = list(self.sessions.values())
            self.sessions.clear()
        for sess in sessions:
            if sess.ws is not None:
                sess.ws.close(1001, "server shutting down")
            sess.queue.put("1")

    def _gc(self) -> None:
        now = time.time()
        with self._lock:
            for sid in [s for s, sess in self.sessions.items()
                        if not sess.upgraded and now - sess.last_seen > SESSION_TTL_S]:
                del self.sessions[sid]

    # -- socket.io packet handling ---------------------------------------------

    def _handle_sio(self, sess: _Session, payload: str) -> None:
        """One Socket.IO packet (the body of an EIO ``4`` message)."""
        if payload.startswith("0"):  # connect to namespace (default "/")
            sess.connected_ns = True
            self._push(sess, "40" + json.dumps({"sid": sess.sid}))
            # the reference greets on connect
            self._push(sess, self._emit_packet("connected", {
                "message": "Connected to Enhanced Retrieval System",
                "server_version": "2.0",
                "capabilities": ["search", "translate", "chat",
                                 "image_search"],
            }))
            return
        if payload.startswith("1"):  # namespace disconnect
            sess.connected_ns = False
            return
        if payload.startswith("2"):  # event: 2<ack-id?>["name", data?]
            body = payload[1:]
            i = 0
            while i < len(body) and body[i].isdigit():
                i += 1
            ack_id = body[:i] or None
            try:
                arr = json.loads(body[i:])
                if not isinstance(arr, list) or not arr \
                        or not isinstance(arr[0], str):
                    raise ValueError("socket.io event must be "
                                     '["name", data?]')
                event = arr[0]
                data = arr[1] if len(arr) > 1 else {}
                if not isinstance(data, dict):
                    data = {"value": data}
            except (json.JSONDecodeError, ValueError):
                self._push(sess, self._emit_packet(
                    "error", {"success": False, "error": "invalid packet"}
                ))
                return
            reply = self.server._dispatch_ws(event, data, sess.client)
            is_err = reply.get("event") == "error"
            name = "error" if is_err else _REPLY_EVENT.get(
                event, reply.get("event", "result")
            )
            out = {k: v for k, v in reply.items() if k != "event"}
            if ack_id is not None:
                self._push(sess, "43" + ack_id + _dumps([out]))
            self._push(sess, self._emit_packet(name, out))

    def _handle_eio(self, sess: _Session, packet: str) -> None:
        sess.last_seen = time.time()
        if not packet:
            return
        kind, body = packet[0], packet[1:]
        if kind == "4":      # message -> socket.io layer
            self._handle_sio(sess, body)
        elif kind == "3":    # pong: liveness only
            pass
        elif kind == "2":    # client-initiated ping (EIO3 style): pong back
            self._push(sess, "3" + body)
        elif kind == "1":    # close
            self._drop(sess.sid)

    # -- HTTP transports ---------------------------------------------------------

    def handle_post(self, request: Request) -> Response:
        sess = self._session(request.query.get("sid", ""))
        if sess is None:
            return _text("unknown sid", 400)
        body = request.read().decode("utf-8", errors="replace")
        for packet in body.split(_RS):
            self._handle_eio(sess, packet)
        return _text("ok")

    def handle_get(self, request: Request) -> Response | None:
        if request.query.get("transport", "polling") == "websocket":
            return self._websocket(request)
        self._gc()
        sid = request.query.get("sid", "")
        if not sid:  # handshake
            sess = self._new_session(request.remote or "unknown")
            return _text(self._open_packet(sess.sid))
        sess = self._session(sid)
        if sess is None:
            return _text("unknown sid", 400)
        if sess.upgraded:
            return _text("6")
        # long-poll: the first packet blocks (bounded), then drain
        packets = []
        try:
            packets.append(sess.queue.get(timeout=PING_INTERVAL_S))
            while True:
                packets.append(sess.queue.get_nowait())
        except queue.Empty:
            if not packets:
                packets.append("2")  # a server ping keeps the session alive
        sess.last_seen = time.time()
        return _text(_RS.join(packets))

    def _websocket(self, request: Request) -> Response | None:
        ws = accept_websocket(request)
        if isinstance(ws, Response):
            return ws
        sid = request.query.get("sid", "")
        if sid:
            # upgrade of an existing polling session: the probe exchange
            sess = self._session(sid)
            if sess is None:
                ws.close()
                return None
        else:
            sess = self._new_session(request.remote or "unknown")
            ws.send(wsf.TEXT, self._open_packet(sess.sid).encode())
        stop = threading.Event()
        threading.Thread(target=self._ping_loop, args=(sess, ws, stop),
                         name="socketio-ping", daemon=True).start()
        try:
            self._ws_loop(sess, ws)
        finally:
            stop.set()
            self._drop(sess.sid)
            ws.close()
        return None

    def _ws_loop(self, sess: _Session, ws: wsf.WebSocket) -> None:
        while True:
            try:
                opcode, payload = ws.receive()
            except wsf.ProtocolError as exc:
                ws.close(exc.code, str(exc))
                return
            except OSError:
                return
            if opcode == wsf.CLOSE:
                return
            if opcode != wsf.TEXT:
                continue
            packet = payload.decode("utf-8", errors="replace")
            sess.last_seen = time.time()
            if packet == "2probe":       # upgrade probe
                ws.send(wsf.TEXT, b"3probe")
                continue
            if packet == "5":            # upgrade commit
                sess.upgrade(ws)
                continue
            if not sess.upgraded:
                sess.upgrade(ws)
            try:
                self._handle_eio(sess, packet)
            except Exception:
                self.server._log_exception(f"socket.io packet failed: {packet[:64]!r}")
                ws.close(1011, "internal error")
                return

    def _ping_loop(self, sess: _Session, ws: wsf.WebSocket, stop: threading.Event) -> None:
        while not stop.wait(PING_INTERVAL_S):
            if sess.upgraded and not ws.closed:
                try:
                    ws.send(wsf.TEXT, b"2")
                except OSError:
                    return
