"""The port's Socket.IO wire (``serve/socketio.py``: Engine.IO v4 + Socket.IO
v5 at ``/socket.io/`` on the standard library) against the JAX package's,
on the CPU.

Both servers of ``tests/test_torch_rest.py``'s pair (the JAX aiohttp server
and the port's, over one ``.rvdb`` with the same tower weights) are driven
by one raw Engine.IO client: long-polling with ``urllib``, WebSocket with
the port's ``serve.websocket.WebSocketClient``. There is no python-socketio
on either machine, so the tests speak the wire format raw, which also pins
its bytes. The same packets go to both servers, and the events must agree:
the reply names, the acks, the envelopes, and the hits under the f32 rule
(tie-aware, atol 5e-4).

- Twins of the JAX tests of ``TestSocketIOWire`` (``tests/test_serve.py``):
  polling connect and search, ack / stats / error, direct WebSocket,
  hostile wire input, the polling -> WebSocket upgrade.
- Every event through both servers; the server's pushes (build progress)
  reaching polling and upgraded sessions; the long-poll's ping, the
  session TTL and ``stop`` closing the sessions (the port's, with its
  intervals shortened).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
from test_torch_rest import (
    Pair,
    free_port,
    jpeg_b64,
    make_corpus,
    same_hits,
)

from intelligent_video_analysis_retrieval_system_tpu_torch.serve import rest, socketio
from intelligent_video_analysis_retrieval_system_tpu_torch.serve.websocket import (
    WebSocketClient,
)

RS = "\x1e"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    corpus = make_corpus(tmp_path_factory.mktemp("sio"))
    p = Pair(corpus, "served", corpus["rvdb"])
    yield p
    p.close()


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def _post(url: str, body: str) -> str:
    req = urllib.request.Request(url, data=body.encode(),
                                 headers={"Content-Type": "text/plain;charset=UTF-8"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


class Poller:
    """One Engine.IO session over long-polling."""

    def __init__(self, port: int) -> None:
        self.port = port
        text = _get(f"http://127.0.0.1:{port}/socket.io/?EIO=4&transport=polling")
        assert text.startswith("0"), text
        self.hello = json.loads(text[1:])
        assert "websocket" in self.hello["upgrades"]
        self.sid = self.hello["sid"]
        self.url = f"http://127.0.0.1:{port}/socket.io/?EIO=4&transport=polling&sid={self.sid}"

    def post(self, body: str) -> str:
        return _post(self.url, body)

    def drain(self) -> list[str]:
        return _get(self.url).split(RS)

    def connect(self) -> list[str]:
        assert self.post("40") == "ok"
        return self.drain()

    def ask(self, packet: str, want: int = 1) -> list[str]:
        """Post one packet; drain until ``want`` packets came (a reply may
        arrive after the first poll returns)."""
        self.post(packet)
        got: list[str] = []
        deadline = time.time() + 60
        while len(got) < want and time.time() < deadline:
            got += [p for p in self.drain() if p != "2"]
        return got


def ws_client(port: int, sid: str | None = None) -> WebSocketClient:
    path = "/socket.io/?EIO=4&transport=websocket" + (f"&sid={sid}" if sid else "")
    return WebSocketClient("127.0.0.1", port, path=path, timeout=60)


def receive_text(ws: WebSocketClient) -> str:
    opcode, payload = ws.receive()
    assert opcode == 1, (opcode, payload)
    return payload.decode()


def event(packet: str) -> tuple[str, dict]:
    assert packet.startswith("42"), packet
    name, data = json.loads(packet[2:])
    return name, data


def same_event(jpacket: str, ppacket: str) -> tuple[str, dict]:
    """The two servers' events agree (see the module docstring)."""
    (jname, jdata), (pname, pdata) = event(jpacket), event(ppacket)
    assert pname == jname, (pname, jname)
    assert set(pdata) == set(jdata), (sorted(pdata), sorted(jdata))
    if "error" in jdata:
        assert pdata["error"] == jdata["error"]
    for key in ("success", "count", "metadata", "clip_prompt", "response", "method",
                "message", "capabilities", "server_version"):
        if key in jdata:
            assert pdata[key] == jdata[key], key
    for key in ("results", "search_results"):
        if key in jdata:
            same_hits(jdata[key], pdata[key])
    return pname, pdata


# -- twins of the JAX package's TestSocketIOWire ---------------------------------------------


def test_polling_connect_and_search(pair):
    replies = []
    for port in (pair.jport, pair.tport):
        p = Poller(port)
        packets = p.connect()
        assert packets[0].startswith("40"), packets   # the namespace connect ack
        assert json.loads(packets[0][2:])["sid"]
        connected = event(packets[1])
        assert connected[0] == "connected" and "search" in connected[1]["capabilities"]
        found = p.ask('42["search", {"query": "a scene", "limit": 2}]')
        name, data = event(found[0])
        assert name == "result" and data["success"] and data["count"] == 2
        assert data["results"][0]["similarity_score"] > 0
        replies.append((packets, found))
    same_event(replies[0][0][1], replies[1][0][1])
    same_event(replies[0][1][0], replies[1][1][0])


def test_polling_ack_stats_and_error(pair):
    replies = []
    for port in (pair.jport, pair.tport):
        p = Poller(port)
        p.connect()
        packets = p.ask('427["system_stats", {}]', want=2)   # ack id 7: 437[...] + the event
        acks = [x for x in packets if x.startswith("437")]
        events = [x for x in packets if x.startswith("42")]
        assert acks and json.loads(acks[0][3:])[0]["success"]
        name, data = event(events[0])
        assert name == "system_stats" and "stats" in data
        assert set(json.loads(acks[0][3:])[0]) == set(data)
        err = p.ask('42["no_such_event", {}]')
        name, data = event(err[0])
        assert name == "error" and not data["success"]
        replies.append((events[0], err[0]))
    for j, t in zip(*replies):
        same_event(j, t)
    jstats, tstats = (event(r[0])[1]["stats"] for r in replies)
    assert set(tstats) == set(jstats) | {"device"}


def test_direct_websocket_transport(pair):
    replies = []
    for port in (pair.jport, pair.tport):
        with ws_client(port) as ws:
            hello = receive_text(ws)
            assert hello.startswith("0") and json.loads(hello[1:])["upgrades"] == ["websocket"]
            ws.send(1, b"40")
            assert receive_text(ws).startswith("40")
            name, _ = event(receive_text(ws))
            assert name == "connected"
            ws.send(1, b'42["semantic_search", {"query": "x", "limit": 2}]')
            reply = receive_text(ws)
            name, data = event(reply)
            assert name == "semantic_search_result" and data["count"] == 2
            replies.append(reply)
    same_event(*replies)


HOSTILE = [
    '42{"a": 1}',            # object, not array
    '42"just a string"',
    "42[123]",               # non-string event name
    "42[]",                  # empty array
    "42[null]",
    '42[["nested"], {}]',
    "42" + "9" * 200,        # huge ack id, no payload
    "4",                     # empty socket.io packet
    "2",                     # eio ping
    "5",                     # upgrade packet over polling
    "9",                     # unknown eio type
    "\x00\x01\x02",          # binary junk
    "4" * 5000,              # long garbage
    "43[]",                  # unsolicited ack
]


def test_hostile_wire_input_never_kills_session(pair):
    """Malformed packets get an error event or are ignored; never a 5xx, and
    the session still searches afterwards. Both servers queue the same
    packets for the same input."""
    queued = []
    for port in (pair.jport, pair.tport):
        p = Poller(port)
        p.connect()
        for payload in HOSTILE:
            try:
                p.post(payload)
            except urllib.error.HTTPError as e:
                assert e.code < 500, (payload, e.code)
        queued.append(p.drain())     # the error events and the pong, in order
        found = p.ask('42["search", {"query": "still alive", "top_k": 2}]')
        assert any('"result"' in x for x in found), found
        with pytest.raises(urllib.error.HTTPError) as err:   # a bad sid is a 400
            _post(f"http://127.0.0.1:{port}/socket.io/?EIO=4&transport=polling&sid=bogus",
                  "40")
        assert err.value.code == 400
    assert queued[1] == queued[0]


def test_polling_to_websocket_upgrade(pair):
    replies = []
    for port in (pair.jport, pair.tport):
        p = Poller(port)
        p.connect()
        with ws_client(port, p.sid) as ws:
            ws.send(1, b"2probe")
            assert receive_text(ws) == "3probe"
            ws.send(1, b"5")                    # upgrade commit
            ws.send(1, '42["translate", {"text": "xin chào"}]'.encode())
            reply = receive_text(ws)
            name, data = event(reply)
            assert name == "translation_result" and data["success"], (name, data)
            assert p.drain() == ["6"]           # a poll after the upgrade: noop
            replies.append(reply)
    same_event(*replies)


# -- every event through both servers ----------------------------------------------------------

EVENTS = [
    ("search", '42["search", {"query": "a red car at night", "limit": 5}]'),
    ("search_detail", '42["search", {"query": "a person", "limit": 3, '
                      '"detail_level": "full"}]'),
    ("search_invalid", '42["search", {"limit": 2}]'),
    ("translated_text", '42["translated_text", {"query": "a beach", "limit": 4}]'),
    ("translate", '42["translate", {"text": "xe máy trên phố"}]'),
    ("image_search", '42["image_search", {"image_base64": "' + jpeg_b64(9) + '", "limit": 3}]'),
    ("image_search_bad", '42["image_search", {"image_base64": "AAAA"}]'),
    ("chat", '42["chat", {"message": "a red car"}]'),
    ("chat_greeting", '42["chat", {"message": "hello"}]'),
    ("metadata_query", '42["metadata_query", {"folder": "vid1", "image": "4.jpg"}]'),
    ("metadata_unknown", '42["metadata_query", {"folder": "vid1", "image": "99.jpg"}]'),
    ("semantic_search", '42["semantic_search", {"query": "a beach", "limit": 4}]'),
    ("system_stats", '42["system_stats"]'),
    ("ping", '42["ping", {}]'),
    ("data_not_an_object", '42["search", "a red car"]'),
    ("ack_search", '4212["search", {"query": "a dog", "limit": 2}]'),
]


@pytest.mark.parametrize("name,packet", EVENTS, ids=[e[0] for e in EVENTS])
def test_event_answers_as_the_jax_server(pair, name, packet):
    replies = []
    for port in (pair.jport, pair.tport):
        p = Poller(port)
        p.connect()
        replies.append(p.ask(packet, want=2 if name.startswith("ack") else 1))
    jgot, tgot = replies
    assert len(tgot) == len(jgot)
    for j, t in zip(jgot, tgot):
        if j.startswith("43"):
            assert t[:4] == j[:4] == "4312"
            jack, tack = json.loads(j[4:])[0], json.loads(t[4:])[0]
            assert set(tack) == set(jack)
            same_hits(jack["results"], tack["results"])
        else:
            same_event(j, t)


# -- pushes, intervals, lifecycle (the port's wire) -------------------------------------------


def test_server_pushes_reach_polling_and_upgraded_sessions(pair):
    """A broadcast (build and filter progress) reaches every connected
    session on either transport, beside the /ws clients, as the JAX
    server's does; a session that never sent 40 gets none."""
    payload = {"event": "build_progress", "stage": "embed", "processed": 3, "total": 9}
    for server, port in ((pair.jserver, pair.jport), (pair.tserver, pair.tport)):
        polled, silent, upgraded = Poller(port), Poller(port), Poller(port)
        polled.connect()
        upgraded.connect()
        with ws_client(port, upgraded.sid) as ws, WebSocketClient("127.0.0.1", port) as plain:
            ws.send(1, b"2probe")
            assert receive_text(ws) == "3probe"
            ws.send(1, b"5")
            time.sleep(0.2)
            server._broadcast(payload)
            name, data = event(receive_text(ws))
            assert (name, data) == ("build_progress", payload)
            assert plain.receive_json() == payload
        got = [x for x in polled.drain() if x != "2"]
        assert [event(x) for x in got] == [("build_progress", payload)]
        silent.post("2")                 # no namespace connect: only the pong
        assert silent.drain() == ["3"]


def test_long_poll_pings_and_idle_sessions_expire(pair, monkeypatch):
    monkeypatch.setattr(socketio, "PING_INTERVAL_S", 0.3)
    monkeypatch.setattr(socketio, "SESSION_TTL_S", 0.5)
    p = Poller(pair.tport)
    assert p.hello["pingInterval"] == 300
    p.connect()
    t0 = time.monotonic()
    assert p.drain() == ["2"]            # nothing queued: a server ping after the interval
    assert 0.25 < time.monotonic() - t0 < 5
    p.post("3")                          # the pong keeps it alive
    time.sleep(0.8)
    Poller(pair.tport)                   # any handshake collects expired sessions
    assert p.sid not in pair.tserver._sio.sessions
    with pytest.raises(urllib.error.HTTPError) as err:
        p.drain()
    assert err.value.code == 400


def test_stop_closes_the_sessions_and_run_serves_again(pair):
    server = rest.RetrievalServer(pair.tsys, host="127.0.0.1", port=free_port())
    server.run(block=False)
    try:
        p = Poller(server.port)
        p.connect()
        answer: list = []

        def wait() -> None:
            try:
                answer.append(p.drain())
            except OSError:          # the connection closed before the answer
                pass

        waiter = threading.Thread(target=wait, daemon=True)
        waiter.start()
        time.sleep(0.3)
        server.stop()
        waiter.join(timeout=10)
        assert answer in ([["1"]], []) and not waiter.is_alive()
        assert not server._sio.sessions
        server.run(block=False)
        assert Poller(server.port).connect()[0].startswith("40")
    finally:
        server.stop()


def test_concurrent_sessions_lose_no_packet(pair):
    """24 sessions in 24 threads (more than the cores), half of them upgrading
    to WebSocket while 5 broadcasts go out, with a short switch interval:
    every session gets its own search answer and every broadcast, in order."""
    import sys

    n, pushes = 24, 5
    ready, go = threading.Barrier(n + 1, timeout=60), threading.Event()
    got: dict[int, list] = {}

    def session(i: int) -> None:
        p = Poller(pair.tport)
        p.connect()
        ready.wait()
        go.wait(timeout=60)
        p.post("42" + json.dumps(["search", {"query": f"session {i}", "limit": 2}]))
        packets: list[str] = []
        if i % 2:
            with ws_client(pair.tport, p.sid) as ws:
                ws.send(1, b"2probe")
                assert receive_text(ws) == "3probe"
                ws.send(1, b"5")
                while len(packets) < pushes + 1:
                    packets.append(receive_text(ws))
        else:
            deadline = time.time() + 60
            while len(packets) < pushes + 1 and time.time() < deadline:
                packets += [x for x in p.drain() if x != "2"]
        got[i] = packets

    threads = [threading.Thread(target=session, args=(i,), daemon=True) for i in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        ready.wait()
        go.set()
        for k in range(pushes):
            pair.tserver._broadcast({"event": "build_progress", "k": k})
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert sorted(got) == list(range(n))
    for i, packets in got.items():
        events = [event(x) for x in packets]
        assert [d["k"] for name, d in events if name == "build_progress"] == list(range(pushes))
        results = [d for name, d in events if name == "result"]
        assert len(results) == 1 and results[0]["count"] == 2, (i, packets)
