"""WebSocket framing (RFC 6455) on the standard library.

The server half of ``serve/rest.py``'s ``/ws`` endpoint and a small blocking
client (the tests, ``chip_smoke.py`` and anyone without a WebSocket library).
The machine the port serves on has neither ``aiohttp`` nor ``websockets``, so
the port frames its own messages:

- the opening handshake's ``Sec-WebSocket-Accept``: base64 of the SHA-1 of the
  client's key followed by the RFC's GUID;
- frames with 7-, 16- and 64-bit lengths, masked from the client and unmasked
  from the server (a frame masked the wrong way is a protocol error);
- text, binary, close, ping and pong, and data messages in continuation
  frames, up to a size cap (past it the connection closes with 1009).

No extension (no per-message deflate) is offered or accepted.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
import time
from typing import Any, BinaryIO, Callable

__all__ = ["GUID", "CONT", "TEXT", "BINARY", "CLOSE", "PING", "PONG", "ProtocolError",
           "accept_key", "encode_frame", "read_frame", "WebSocket", "WebSocketClient"]

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
CONT, TEXT, BINARY, CLOSE, PING, PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
MAX_MESSAGE = 64 * 1024 * 1024   # the REST server's body cap


class ProtocolError(Exception):
    """A frame this end must refuse; ``code`` is the close code to send."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def _masked(data: bytes, key: bytes) -> bytes:
    """``data`` XOR the 4-byte ``key`` repeated (masking and unmasking)."""
    n = len(data)
    if n == 0:
        return data
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(pad, "little")).to_bytes(
        n, "little")


def encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    """One final frame; a client masks (``mask``) with a fresh random key."""
    n = len(payload)
    bit = 0x80 if mask else 0
    head = bytearray([0x80 | opcode])
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + _masked(payload, key)
    return bytes(head) + payload


def _read_exact(rfile: BinaryIO, n: int) -> bytes:
    data = rfile.read(n)
    if data is None or len(data) < n:
        raise ConnectionError("connection closed inside a frame")
    return data


def read_frame(rfile: BinaryIO, max_size: int, from_client: bool) -> tuple[bool, int, bytes]:
    """``(fin, opcode, payload)`` of the next frame, unmasked. ``from_client``:
    the frame must be masked (a server reads it), else it must not be."""
    b0, b1 = _read_exact(rfile, 2)
    if b0 & 0x70:
        raise ProtocolError(1002, "reserved bits set")
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    masked, n = bool(b1 & 0x80), b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", _read_exact(rfile, 2))[0]
    elif n == 127:
        n = struct.unpack("!Q", _read_exact(rfile, 8))[0]
    if opcode not in (CONT, TEXT, BINARY, CLOSE, PING, PONG):
        raise ProtocolError(1002, f"unknown opcode {opcode:#x}")
    if opcode >= CLOSE and (n > 125 or not fin):
        raise ProtocolError(1002, "control frames are final and at most 125 bytes")
    if masked != from_client:
        raise ProtocolError(1002, "client frames are masked, server frames are not")
    if n > max_size:
        raise ProtocolError(1009, f"frame of {n} bytes exceeds {max_size}")
    key = _read_exact(rfile, 4) if masked else b""
    payload = _read_exact(rfile, n)
    return fin, opcode, _masked(payload, key) if masked else payload


class WebSocket:
    """One open connection, seen from either end.

    :meth:`send` holds a lock, so that a frame sent from another thread (a
    server's broadcast) never interleaves with a reply on the wire.
    :meth:`receive` returns the next whole data message, answering pings on
    the way and noting when a pong came (``pong_at``, ``time.monotonic``);
    a close frame is answered once and returned as ``(CLOSE, payload)``.
    :meth:`abort` drops the connection without a close frame.
    """

    def __init__(self, sock: socket.socket, rfile: BinaryIO, client: bool,
                 max_size: int = MAX_MESSAGE) -> None:
        self.sock = sock
        self.rfile = rfile
        self.client = client
        self.max_size = max_size
        self.closed = False
        self.pong_at = time.monotonic()
        self._send_lock = threading.Lock()

    def send(self, opcode: int, payload: bytes) -> None:
        frame = encode_frame(opcode, payload, mask=self.client)
        with self._send_lock:
            if self.closed:
                raise ConnectionError("websocket closed")
            self.sock.sendall(frame)

    def send_json(self, obj: Any, dumps: Callable[[Any], str] = json.dumps) -> None:
        self.send(TEXT, dumps(obj).encode())

    def receive(self) -> tuple[int, bytes]:
        opcode, parts, size = None, [], 0
        while True:
            fin, op, payload = read_frame(self.rfile, self.max_size, from_client=not self.client)
            if op == PING:
                self.send(PONG, payload)
                continue
            if op == PONG:
                self.pong_at = time.monotonic()
                continue
            if op == CLOSE:
                code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1000
                self.close(code)
                return CLOSE, payload
            if (op == CONT) != (opcode is not None):
                raise ProtocolError(1002, "continuation frame out of place")
            opcode = opcode if op == CONT else op
            size += len(payload)
            if size > self.max_size:
                raise ProtocolError(1009, f"message exceeds {self.max_size} bytes")
            parts.append(payload)
            if fin:
                return opcode, b"".join(parts)

    def close(self, code: int = 1000, reason: str = "") -> None:
        """Send the close frame (once; later sends raise)."""
        with self._send_lock:
            if self.closed:
                return
            self.closed = True
            try:
                self.sock.sendall(encode_frame(
                    CLOSE, struct.pack("!H", code) + reason.encode()[:123], mask=self.client))
            except OSError:
                pass


    def abort(self) -> None:
        """Drop the connection at once, without a close frame (later sends
        raise; a blocked :meth:`receive` sees the end of the stream)."""
        with self._send_lock:
            self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


class WebSocketClient(WebSocket):
    """A blocking client: ``WebSocketClient(host, port)`` opens ``/ws``.

    ``receive_json`` returns the next text message parsed; a close from the
    server raises ``ConnectionError``. Use as a context manager, or call
    :meth:`shutdown`."""

    def __init__(self, host: str, port: int, path: str = "/ws", timeout: float = 60.0) -> None:
        sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
                      ).encode())
        rfile = sock.makefile("rb")
        status = rfile.readline().decode("latin-1").split()
        headers = {}
        while True:
            line = rfile.readline().decode("latin-1").strip()
            if not line:
                break
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        if len(status) < 2 or status[1] != "101" or \
                headers.get("sec-websocket-accept") != accept_key(key):
            sock.close()
            raise ConnectionError(f"websocket handshake refused: {' '.join(status)}")
        super().__init__(sock, rfile, client=True)

    def receive_json(self) -> Any:
        opcode, payload = self.receive()
        if opcode == CLOSE:
            raise ConnectionError("the server closed the websocket")
        return json.loads(payload)

    def shutdown(self) -> None:
        """Close the handshake (wait briefly for the server's close), then the socket."""
        try:
            if not self.closed:
                self.close()
                self.sock.settimeout(5.0)
                while read_frame(self.rfile, self.max_size, from_client=False)[1] != CLOSE:
                    pass
        except (OSError, ProtocolError):
            pass
        finally:
            self.rfile.close()
            self.sock.close()

    def __enter__(self) -> "WebSocketClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
