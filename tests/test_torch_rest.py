"""The port's REST/WebSocket server (``serve/rest.py``, standard library)
against the JAX package's aiohttp server, on the CPU.

One tiny corpus: seeded JPEG keyframes indexed by the JAX facade
(``CLIPConfig.tiny_test()``, f32). The port's facade gets the JAX tower
weights through ``models.convert.from_jax_params`` and opens the same
``.rvdb``. Both servers run on loopback ports; the client is the standard
library's (``http.client``, and ``serve.websocket.WebSocketClient`` for
``/ws``). The same request goes to both, and the answers must agree:

- the status, and the envelope's keys, counts and error messages;
- the hits: the same keyframes under the f32 parity rule (tie-aware, atol
  5e-4), ranks 1..n, the same fields per hit;
- thumbnails, images, exports and ``GET /`` byte for byte.

Where only the framework differs (an unknown path, a method the route does
not take, a body over the 64 MiB cap: aiohttp answers in plain text, the
port with a JSON envelope) the statuses are compared. Also here: the ``/ws``
events, the build wizard with its progress pushed on the port's socket, the
filter tool's refine, ``/api/open`` and ``/api/maintenance`` on indexes of
their own, the admin gate, the rate limit, keep-alive across error paths,
the network panel's routes against a P2P peer of each package,
``start_server`` / ``stop`` / ``cleanup`` and ``cli serve``. The Socket.IO
wire of the same two servers is ``tests/test_torch_socketio.py``.
"""

import base64
import http.client
import io
import json
import shutil
import socket
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.serve import rest as jax_rest
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config as JaxConfig
from intelligent_video_analysis_retrieval_system_tpu_torch import cli
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.serve import rest
from intelligent_video_analysis_retrieval_system_tpu_torch.serve.websocket import (
    WebSocketClient,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import (
    ATOL_TOPK,
    tie_aware_equal,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.utils.config import Config

torch.set_num_threads(2)

FOLDERS, PER_FOLDER = 2, 8
OVERRIDES = {"index": {"dtype": "float32", "thumbnail_size": 32},
             "logging": {"file": False}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(port: int, method: str, path: str, payload=None, raw: bytes | None = None,
         headers: dict | None = None) -> tuple[int, str, bytes]:
    """One request on a fresh connection: (status, content type, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = raw if raw is not None else (
            None if payload is None else json.dumps(payload).encode())
        conn.request(method, path, body, {"Content-Type": "application/json",
                                          **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), resp.read()
    finally:
        conn.close()


def parsed(answer):
    status, ctype, data = answer
    return status, json.loads(data) if ctype.startswith("application/json") else data


def same_hits(jhits: list[dict], phits: list[dict]) -> None:
    assert len(phits) == len(jhits)
    assert [set(h) for h in phits] == [set(h) for h in jhits]
    if not jhits:
        return
    key = {k: i for i, k in enumerate(sorted({(h["folder"], h["image"])
                                             for h in jhits + phits}))}
    tie_aware_equal([key[h["folder"], h["image"]] for h in phits],
                    [h["similarity_score"] for h in phits],
                    [key[h["folder"], h["image"]] for h in jhits],
                    [h["similarity_score"] for h in jhits], atol=ATOL_TOPK)
    if "rank" in jhits[0]:
        assert [h["rank"] for h in phits] == [h["rank"] for h in jhits]


def assert_same(jax_answer, port_answer, status_only: bool = False) -> dict | bytes:
    """The port's answer agrees with the JAX server's (see the module
    docstring); returns the port's body."""
    (js, jb), (ps, pb) = parsed(jax_answer), parsed(port_answer)
    assert ps == js, (pb, jb)
    if status_only:
        return pb
    assert port_answer[1] == jax_answer[1]            # content type
    if not isinstance(jb, dict):                       # assets and exports
        assert port_answer[2] == jax_answer[2]
        return port_answer[2]
    assert set(pb) == set(jb), (sorted(pb), sorted(jb))
    if jb.get("success") is False:
        assert pb["error"]["message"] == jb["error"]["message"]
        assert pb["error"]["code"] == jb["error"]["code"]
    for k in ("count", "query", "kind", "ntotal", "action", "event", "request_id",
              "index_loaded", "tokenizer_kind", "weights", "metadata", "method"):
        if k in jb:
            assert pb[k] == jb[k], k
    for k in ("results", "search_results"):
        if k in jb:
            if jb[k] and isinstance(jb[k][0], list):      # search_batch: a list per query
                assert len(pb[k]) == len(jb[k])
                for p, j in zip(pb[k], jb[k]):
                    same_hits(j, p)
            else:
                same_hits(jb[k], pb[k])
    return pb


def jpeg_b64(seed: int, size: int = 32) -> str:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (size, size, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=95)
    return base64.b64encode(buf.getvalue()).decode()


class Pair:
    """A JAX system and a port system sharing the corpus's towers, each
    behind its own server."""

    def __init__(self, corpus, name: str, index_path=None) -> None:
        base = corpus["root"] / name
        self.jsys = JaxSystem(JaxConfig(config_file=None, base_dir=base / "jax",
                                        create_dirs=True, overrides=OVERRIDES),
                              embedder=corpus["jemb"])
        self.tsys = EnhancedRetrievalSystem(
            Config(config_file=None, base_dir=base / "port", create_dirs=True,
                   overrides=OVERRIDES),
            embedder=corpus["temb"], device="cpu")
        if index_path is not None:
            self.jsys.load_system(index_path)
            self.tsys.load_system(index_path)
        self.jport, self.tport = free_port(), free_port()
        self.jserver = self.jsys.start_server(host="127.0.0.1", port=self.jport, block=False)
        self.tserver = self.tsys.start_server(host="127.0.0.1", port=self.tport, block=False)

    def both(self, method: str, path: str, payload=None, raw=None, headers=None,
             jpayload=None):
        """The same request to both (``jpayload``: the JAX server's own payload
        where a path in it must differ)."""
        return (call(self.jport, method, path, payload if jpayload is None else jpayload,
                     raw, headers),
                call(self.tport, method, path, payload, raw, headers))

    def close(self) -> None:
        self.jserver.stop()
        self.jsys.cleanup()
        self.tsys.cleanup()


def make_corpus(root: Path) -> dict:
    """Seeded JPEG keyframes under ``root``, indexed by the JAX facade; the
    JAX embedder and the port's carrying the same tower weights."""
    keyframes = root / "keyframes"
    rng = np.random.default_rng(2)
    for f in range(FOLDERS):
        folder = keyframes / f"vid{f}"
        folder.mkdir(parents=True)
        for n in range(PER_FOLDER):
            Image.fromarray(rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)).save(
                folder / f"{n}.jpg", quality=95)
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), compute_dtype="float32")
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32", device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    temb.using_pretrained = False     # the JAX tower's random init, as JAX reports it
    builder = JaxSystem(JaxConfig(config_file=None, base_dir=root / "built", create_dirs=True,
                                  overrides=OVERRIDES), embedder=jemb)
    rvdb = Path(builder.build_system(keyframes)["index_path"])
    builder.cleanup()
    return {"root": root, "keyframes": keyframes, "jemb": jemb, "temb": temb, "rvdb": rvdb}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("rest"))


@pytest.fixture(scope="module")
def pair(corpus):
    p = Pair(corpus, "served", corpus["rvdb"])
    yield p
    p.close()


def _search_results(pair):
    return json.loads(call(pair.tport, "POST", "/api/search",
                           {"query": "a person", "limit": 4})[2])["results"]


# (id, method, path, payload or raw bytes, status_only)
CASES = [
    ("health", "GET", "/api/health", None, False),
    ("search_minimal", "POST", "/api/search",
     {"query": "a person", "limit": 3, "detail_level": "minimal"}, False),
    ("search_standard", "POST", "/api/search", {"query": "a red car at night", "limit": 5},
     False),
    ("search_full", "POST", "/api/search",
     {"query": "xe máy trên phố", "limit": 16, "detail_level": "full"}, False),
    ("search_folder", "POST", "/api/search", {"query": "a dog", "limit": 4, "folder": "vid1"},
     False),
    ("search_llm_enhanced", "POST", "/api/search",
     {"query": "sunset over the mountains", "limit": 6, "mode": "llm_enhanced"}, False),
    ("search_temporal", "POST", "/api/search",
     {"query": "a beach", "limit": 3, "include_temporal": True, "detail_level": "rich"}, False),
    ("search_invalid_json", "POST", "/api/search", b"{not json", False),
    ("search_not_an_object", "POST", "/api/search", b"[1, 2]", False),
    ("search_missing_query", "POST", "/api/search", {"limit": 3}, False),
    ("search_bad_mode", "POST", "/api/search", {"query": "x", "mode": "bogus"}, False),
    ("search_bad_limit", "POST", "/api/search", {"query": "x", "limit": 9999}, False),
    ("search_batch", "POST", "/api/search_batch",
     {"queries": ["a person", "a red car", "a beach at dusk"], "limit": 4}, False),
    ("search_batch_not_strings", "POST", "/api/search_batch", {"queries": ["a", 3]}, False),
    ("search_batch_too_many", "POST", "/api/search_batch", {"queries": ["q"] * 257}, False),
    ("image_search", "POST", "/api/image_search",
     {"image_base64": jpeg_b64(5), "limit": 6}, False),
    ("image_search_undecodable", "POST", "/api/image_search",
     {"image_base64": base64.b64encode(b"not an image").decode()}, False),
    ("chat_greeting", "POST", "/api/chat", {"message": "hello"}, False),
    ("chat_search", "POST", "/api/chat", {"message": "a red car at night"}, False),
    ("chat_missing_message", "POST", "/api/chat", {"text": "hi"}, False),
    ("translate", "POST", "/api/translate", {"text": "xe máy trên phố"}, False),
    ("translate_empty", "POST", "/api/translate", {"text": "  "}, False),
    ("metadata", "GET", "/api/metadata/vid0/3.jpg", None, False),
    ("metadata_unknown", "GET", "/api/metadata/vid0/99.jpg", None, False),
    ("thumbnail", "GET", "/api/thumbnail/vid0/3.jpg", None, False),
    ("thumbnail_unknown", "GET", "/api/thumbnail/vid9/3.jpg", None, False),
    ("image", "GET", "/api/image/vid1/2.jpg", None, False),
    ("similar", "GET", "/api/similar/vid0/3.jpg?limit=3", None, False),
    ("similar_bad_limit", "GET", "/api/similar/vid1/0.jpg?limit=abc", None, False),
    ("similar_unknown", "GET", "/api/similar/vid0/99.jpg", None, False),
    ("stats", "GET", "/api/stats", None, False),
    ("export_json", "POST", "/api/export", "results:json", False),
    ("export_csv", "POST", "/api/export", "results:csv", False),
    ("export_bad_format", "POST", "/api/export", {"results": [], "format": "xml"}, False),
    ("export_missing_results", "POST", "/api/export", {"format": "json"}, False),
    ("build_status", "GET", "/api/build/status", None, False),
    ("build_missing_dir", "POST", "/api/build", {}, False),
    ("build_not_a_dir", "POST", "/api/build", {"keyframes_dir": "/nonexistent/kf"}, False),
    ("filter_bad_action", "POST", "/api/filter", {"action": "melt", "input_dir": "."}, False),
    ("filter_missing_input", "POST", "/api/filter", {"action": "refine"}, False),
    ("open_missing_path", "POST", "/api/open", {}, False),
    ("open_not_found", "POST", "/api/open", {"path": "/nonexistent/index.rvdb"}, False),
    ("maintenance_bogus", "POST", "/api/maintenance", {"action": "bogus"}, False),
    ("maintenance_tune_without_ann", "POST", "/api/maintenance", {"action": "tune_ann"},
     False),
    ("maintenance_crossover_without_ann", "POST", "/api/maintenance",
     {"action": "measure_crossover"}, False),
    ("maintenance_bad_ladder", "POST", "/api/maintenance",
     {"action": "measure_crossover", "batch_sizes": [0, 2]}, False),
    ("maintenance_bad_repeats", "POST", "/api/maintenance",
     {"action": "measure_crossover", "repeats": 99}, False),
    ("unknown_route", "GET", "/api/nope", None, True),
    ("wrong_method", "POST", "/api/health", None, True),
    ("websocket_without_upgrade", "GET", "/ws", None, True),
    ("network_discover_now", "POST", "/api/network/discover", {"wait_s": 0}, False),
    ("network_discover_bad_wait", "POST", "/api/network/discover", {"wait_s": "abc"}, False),
    ("network_peers", "GET", "/api/network/peers", None, False),
    ("network_connect_missing", "POST", "/api/network/connect", {"host": "127.0.0.1"}, False),
    ("network_connect_port_not_int", "POST", "/api/network/connect",
     {"host": "127.0.0.1", "port": "80"}, False),
    ("network_load_remote_missing", "POST", "/api/network/load_remote",
     {"host": "127.0.0.1", "port": 1}, False),
    ("network_unload_remote_unknown", "POST", "/api/network/unload_remote",
     {"index_id": "nope"}, False),
    ("network_unload_remote_all", "POST", "/api/network/unload_remote", None, False),
]


@pytest.mark.parametrize("name,method,path,payload,status_only", CASES,
                         ids=[c[0] for c in CASES])
def test_route_answers_as_the_jax_server(pair, name, method, path, payload, status_only):
    raw = None
    if isinstance(payload, bytes):
        payload, raw = None, payload
    elif isinstance(payload, str):                     # export of a live answer
        payload = {"results": _search_results(pair), "format": payload.split(":")[1]}
    jax_answer, port_answer = pair.both(method, path, payload, raw)
    body = assert_same(jax_answer, port_answer, status_only)
    if name == "health":
        assert body["index_loaded"] and set(body["components"]) == set(
            json.loads(jax_answer[2])["components"])
    if name == "metadata":
        assert body["metadata"]["folder"] == "vid0" and body["metadata"]["image"] == "3.jpg"
    if name in ("thumbnail", "image", "export_json", "export_csv"):
        assert isinstance(body, bytes) and len(body) > 20


def test_console_page_is_the_jax_page_byte_for_byte(pair):
    assert rest._CONSOLE_HTML == jax_rest._CONSOLE_HTML
    jax_answer, port_answer = pair.both("GET", "/")
    assert port_answer == jax_answer
    assert port_answer[0] == 200 and b"IVARS-TPU Console" in port_answer[2]


def test_a_body_over_64_mib_answers_413(pair):
    raw = b" " * (rest.MAX_BODY + 1)
    jax_answer, port_answer = pair.both("POST", "/api/search", raw=raw)
    assert port_answer[0] == jax_answer[0] == 413
    assert json.loads(port_answer[2])["error"]["code"] == 413


def test_keep_alive_survives_the_error_paths(pair):
    """One persistent connection: a 400 whose body was read, a 401 and a 413
    whose bodies were not (drained), a 404 and a 502 (a peer that is not
    there) leave it usable; so does a body sent in chunks."""
    tsys = pair.tsys
    conn = http.client.HTTPConnection("127.0.0.1", pair.tport, timeout=60)
    tsys.config.set("api.admin_token", "tok")
    try:
        answers = []
        for path, body in (("/api/search", b"{not json"),
                           ("/api/open", json.dumps({"path": "/x"}).encode()),
                           ("/api/search", b"x" * (rest.MAX_BODY + 1)),
                           ("/api/nope", b"{}"),
                           ("/api/network/connect", json.dumps(
                               {"host": "127.0.0.1", "port": free_port()}).encode()),
                           ("/api/search", json.dumps({"query": "a person",
                                                       "limit": 2}).encode())):
            conn.request("GET" if body is None else "POST", path, body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            assert resp.getheader("Content-Length") == str(len(data))
            assert resp.getheader("Connection") is None
            if not answers:
                sock = conn.sock
            assert conn.sock is sock                   # the same TCP connection
            answers.append((resp.status, json.loads(data)))
        assert [a[0] for a in answers] == [400, 401, 413, 404, 502, 200]
        assert answers[-1][1]["count"] == 2
        conn.request("POST", "/api/search", iter([b'{"query": "a per', b'son", "limit": 3}']),
                     {"Content-Type": "application/json"}, encode_chunked=True)
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["count"] == 3
        conn.request("POST", "/api/search", iter([b"x" * (1 << 20)] * 65),
                     {"Content-Type": "application/json"}, encode_chunked=True)
        resp = conn.getresponse()
        assert resp.status == 413 and json.loads(resp.read())["error"]["code"] == 413
        conn.request("GET", "/api/build/status")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["success"]
        assert conn.sock is sock
    finally:
        tsys.config.set("api.admin_token", None)
        conn.close()


def test_rate_limit_answers_429(pair):
    jserver = jax_rest.RetrievalServer(pair.jsys, host="127.0.0.1", port=free_port(),
                                       rate_limit_per_minute=2)
    tserver = rest.RetrievalServer(pair.tsys, host="127.0.0.1", port=free_port(),
                                   rate_limit_per_minute=2)
    jserver.run(block=False)
    tserver.run(block=False)
    try:
        for i in range(3):
            payload = {"query": f"rate {i}", "limit": 2}
            assert_same(call(jserver.port, "POST", "/api/search", payload),
                        call(tserver.port, "POST", "/api/search", payload))
        status, body = parsed(call(tserver.port, "POST", "/api/translate", {"text": "x"}))
        assert status == 429 and body["error"] == {"message": "rate limit exceeded",
                                                   "code": 429}
    finally:
        jserver.stop()
        tserver.stop()


def test_admin_gate_and_open_root(pair, tmp_path):
    for system in (pair.jsys, pair.tsys):
        system.config.set("api.admin_token", "s3cret")
        system.config.set("api.open_root", str(tmp_path))
    try:
        cases = [({}, 401), ({"X-Admin-Token": "wrong"}, 401),
                 ({"Authorization": "Bearer wrong"}, 401),
                 ({"X-Admin-Token": "s3cret"}, 200), ({"Authorization": "Bearer s3cret"}, 200)]
        for headers, status in cases:
            j, p = pair.both("POST", "/api/maintenance", {"action": "clear_cache"},
                             headers=headers)
            assert p[0] == status
            assert_same(j, p)
        for path in ("/api/build", "/api/filter", "/api/open"):
            assert_same(*pair.both("POST", path, {}))          # 401 before the body
        # inside the token, outside open_root: 403 even with the token
        assert_same(*pair.both("POST", "/api/open", {"path": str(pair.tsys.index.path)},
                               headers={"X-Admin-Token": "s3cret"}))
        # search is never gated
        assert parsed(call(pair.tport, "POST", "/api/search", {"query": "x"}))[0] == 200
    finally:
        for system in (pair.jsys, pair.tsys):
            system.config.set("api.admin_token", None)
            system.config.set("api.open_root", None)


def test_network_routes_answer_501_and_socketio_is_absent(pair):
    """The state this test pinned is gone: the five network routes answer as
    the JAX server's (none of them 501), and ``/socket.io/`` answers the
    Engine.IO handshake as the JAX server's does."""
    for method, path, payload, ok in (
            ("POST", "/api/network/discover", {"wait_s": 0}, True),
            ("GET", "/api/network/peers", None, True),
            ("POST", "/api/network/connect", {}, False),
            ("POST", "/api/network/load_remote", {}, False),
            ("POST", "/api/network/unload_remote", {"index_id": "x"}, True)):
        body = assert_same(*pair.both(method, path, payload))
        assert body["success"] is ok
    for port in (pair.jport, pair.tport):
        status, ctype, data = call(port, "GET", "/socket.io/?EIO=4&transport=polling")
        hello = json.loads(data.decode()[1:])
        assert status == 200 and ctype.startswith("text/plain") and data.startswith(b"0")
        assert hello["upgrades"] == ["websocket"] and hello["pingInterval"] == 25000


# -- twins of the JAX package's network panel tests ---------------------------------


@pytest.fixture()
def peers_of_both(corpus):
    """A P2P peer of each package sharing the corpus's index as ``sharedB``."""
    from intelligent_video_analysis_retrieval_system_tpu.serve.p2p import (
        NetworkServer as JaxNetworkServer,
    )
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve.p2p import NetworkServer

    jpeer = JaxNetworkServer("127.0.0.1", free_port(), node_name="peerB",
                             enable_discovery=False)
    tpeer = NetworkServer("127.0.0.1", free_port(), node_name="peerB", enable_discovery=False,
                          device="cpu")
    for peer in (jpeer, tpeer):
        peer.register_index_file("sharedB", str(corpus["rvdb"]))
        peer.start_server()
    yield jpeer, tpeer
    jpeer.stop_server()
    tpeer.stop_server()


def test_network_panel_roundtrip(pair, peers_of_both):
    """connect -> load_remote (then again: already_loaded) -> peers ->
    a search that fans in -> unload_remote, on each server against its own
    package's peer, with the same answers."""
    answers = []
    for port, system, peer in ((pair.jport, pair.jsys, peers_of_both[0]),
                               (pair.tport, pair.tsys, peers_of_both[1])):
        got = {}
        peer_at = {"host": "127.0.0.1", "port": peer.port}
        got["connect"] = call(port, "POST", "/api/network/connect", peer_at)
        status, body = parsed(got["connect"])
        assert status == 200 and body["success"], body
        assert body["indexes"][0]["index_id"] == "sharedB"
        assert body["node"]["info"]["node_name"] == "peerB"
        got["load"] = call(port, "POST", "/api/network/load_remote",
                           {**peer_at, "index_id": "sharedB"})
        status, body = parsed(got["load"])
        assert status == 200 and body["success"] and body["ntotal"] == FOLDERS * PER_FOLDER
        got["again"] = call(port, "POST", "/api/network/load_remote",
                            {**peer_at, "index_id": "sharedB"})
        assert parsed(got["again"])[1].get("already_loaded")
        got["peers"] = call(port, "GET", "/api/network/peers")
        body = parsed(got["peers"])[1]
        assert body["remote_indexes"] == [{"index_id": "sharedB", "ntotal": 16,
                                           "base": f"http://127.0.0.1:{peer.port}"}]
        assert len(system.remote_indexes) == 1
        got["search"] = call(port, "POST", "/api/search",
                             {"query": "a person", "limit": 6, "detail_level": "rich"})
        got["unload"] = call(port, "POST", "/api/network/unload_remote",
                             {"index_id": "sharedB"})
        assert parsed(got["unload"])[1]["removed"] == 1 and not system.remote_indexes
        answers.append(got)
    for key in answers[0]:
        assert_same(answers[0][key], answers[1][key])
    # the fan-in: each local keyframe came back twice (the peer shares the
    # same index), merged into one hit per keyframe
    hits = parsed(answers[1]["search"])[1]["results"]
    assert len({(h["folder"], h["image"]) for h in hits}) == len(hits) == 6


def test_network_discover_validates_wait_s(pair):
    for port in (pair.jport, pair.tport):
        status, body = parsed(call(port, "POST", "/api/network/discover", {"wait_s": "abc"}))
        assert status == 400 and not body["success"]
        status, body = parsed(call(port, "POST", "/api/network/discover", {"wait_s": -5}))
        assert status == 200 and body["success"] and isinstance(body["nodes"], list)
    assert pair.tserver._discovery.listen_only and pair.tserver._discovery.is_running


def test_console_escapes_peer_controlled_html(pair):
    for port in (pair.jport, pair.tport):
        html = call(port, "GET", "/")[2].decode()
        assert "&quot;" in html and "esc(n.node_name" in html
        assert "onclick=\"loadRemote('" not in html


def test_network_connect_failure_is_502(pair):
    dead = {"host": "127.0.0.1", "port": free_port()}
    jax_answer, port_answer = pair.both("POST", "/api/network/connect", dead)
    (js, jb), (ps, pb) = parsed(jax_answer), parsed(port_answer)
    assert ps == js == 502 and not pb["success"]
    assert pb["error"]["message"].startswith("connect failed:")
    jax_answer, port_answer = pair.both("POST", "/api/network/load_remote",
                                        {**dead, "index_id": "x"})
    assert port_answer[0] == jax_answer[0] == 502


WS_CASES = [
    ("ping", {"event": "ping", "request_id": "r1"}),
    ("search", {"event": "search", "data": {"query": "a cat", "limit": 2}, "request_id": 7}),
    ("search_invalid", {"event": "search", "data": {"limit": 2}}),
    ("chat", {"event": "chat", "data": {"message": "a red car"}}),
    ("translate", {"event": "translate", "data": {"text": "xe máy trên phố"}}),
    ("system_stats", {"event": "system_stats"}),
    ("image_search", {"event": "image_search", "data": {"image_base64": jpeg_b64(9),
                                                         "limit": 3}}),
    ("image_search_bad", {"event": "image_search", "data": {"image_base64": "AAAA"}}),
    ("metadata_query", {"event": "metadata_query", "data": {"folder": "vid1", "image": "4.jpg"},
                        "request_id": "m"}),
    ("metadata_unknown", {"event": "metadata_query", "data": {"folder": "vid1",
                                                              "image": "99.jpg"}}),
    ("semantic_search", {"event": "semantic_search", "data": {"query": "a beach", "limit": 4}}),
    ("unknown_event", {"event": "bogus", "data": {}}),
    ("invalid_message", "{not json"),
    ("not_an_object", "[1, 2]"),
]


@pytest.mark.parametrize("name,message", WS_CASES, ids=[c[0] for c in WS_CASES])
def test_ws_event_answers_as_the_jax_server(pair, name, message):
    replies = []
    for port in (pair.jport, pair.tport):
        with WebSocketClient("127.0.0.1", port, timeout=60) as ws:
            if isinstance(message, str):
                ws.send(1, message.encode())
            else:
                ws.send_json(message)
            replies.append(ws.receive_json())
    jreply, preply = replies
    assert set(preply) == set(jreply)
    assert preply.get("event") == jreply.get("event")
    if "request_id" in jreply:
        assert preply["request_id"] == jreply["request_id"]
    if "error" in jreply:
        assert preply["error"]["message"] == jreply["error"]["message"]
        assert preply["error"]["code"] == jreply["error"]["code"]
    for key in ("count", "metadata", "clip_prompt", "response", "method"):
        if key in jreply:
            assert preply[key] == jreply[key], key
    for key in ("results", "search_results"):
        if key in jreply:
            same_hits(jreply[key], preply[key])
    if name == "system_stats":
        assert set(preply["stats"]) >= {"built", "embedder", "cache", "performance",
                                        "metadata", "index"}


def test_stats_keys_are_the_jax_servers(pair):
    """``stats`` of ``GET /api/stats`` and of the ``/ws`` ``system_stats``
    event carry the JAX server's keys (``remote_indexes`` among them, 0 with
    no peers), plus the port's ``device``."""
    (_, jb), (_, pb) = (parsed(a) for a in pair.both("GET", "/api/stats"))
    assert set(pb["stats"]) == set(jb["stats"]) | {"device"}
    assert pb["stats"]["remote_indexes"] == jb["stats"]["remote_indexes"] == 0
    replies = []
    for port in (pair.jport, pair.tport):
        with WebSocketClient("127.0.0.1", port, timeout=60) as ws:
            ws.send_json({"event": "system_stats"})
            replies.append(ws.receive_json())
    assert set(replies[1]["stats"]) == set(replies[0]["stats"]) | {"device"}


def _ws_registered(server, want: int, within: float) -> bool:
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        with server._conns_lock:
            if len(server._ws_clients) == want:
                return True
        time.sleep(0.02)
    return False


def test_ws_heartbeat_drops_a_client_that_never_answers_pings(pair, monkeypatch):
    """The JAX server's ``/ws`` heartbeat (aiohttp ``heartbeat=30``): a ping
    every interval, and a socket whose pong does not come is closed and
    leaves the broadcast set; a client that answers stays."""
    interval = 0.2
    monkeypatch.setattr(rest, "WS_HEARTBEAT_S", interval, raising=False)
    server = pair.tserver
    assert _ws_registered(server, 0, 5.0)
    silent = WebSocketClient("127.0.0.1", pair.tport, timeout=10)   # never reads
    answering = WebSocketClient("127.0.0.1", pair.tport, timeout=10)
    seen: list = []

    def answer() -> None:           # receive() answers each ping with a pong
        try:
            seen.append(answering.receive())
        except OSError as exc:
            seen.append(exc)

    import threading

    reader = threading.Thread(target=answer, daemon=True)
    reader.start()
    try:
        assert _ws_registered(server, 2, 5.0)
        t0 = time.monotonic()
        assert _ws_registered(server, 1, 2.5 * interval + 1.0), "silent client not dropped"
        assert time.monotonic() - t0 < 2.5 * interval + 1.0
        # the silent client got pings, then the end of the stream
        silent.sock.settimeout(5.0)
        frames = []
        while True:
            chunk = silent.sock.recv(4096)
            if not chunk:
                break
            frames.append(chunk)
        assert frames and frames[0][0] == 0x89          # a final ping frame
        time.sleep(3 * interval)                        # the answering one stays
        with server._conns_lock:
            assert len(server._ws_clients) == 1
        assert not seen
    finally:
        silent.rfile.close()
        silent.sock.close()
        answering.shutdown()
        reader.join(timeout=5)


def test_open_autodetect_matches_jax(corpus, tmp_path):
    """/api/open on a .rvdb, a directory scan and a portable package."""
    scan = tmp_path / "scan"
    (scan / "index").mkdir(parents=True)
    shutil.copy(corpus["rvdb"], scan / "index" / "copy.rvdb")
    exporter = JaxSystem(JaxConfig(config_file=None, base_dir=tmp_path / "exp",
                                   create_dirs=True, overrides=OVERRIDES),
                         embedder=corpus["jemb"])
    exporter.load_system(scan / "index" / "copy.rvdb")
    package = exporter.export_portable_index(tmp_path / "pkg")
    exporter.cleanup()
    p = Pair(corpus, "open")
    try:
        assert_same(*p.both("POST", "/api/search", {"query": "a person", "limit": 3}))
        for path, kind in ((corpus["rvdb"], "rvdb"), (scan, "rvdb:copy.rvdb"),
                           (package, "portable")):
            body = assert_same(*p.both("POST", "/api/open", {"path": str(path)}))
            assert body["success"] and body["kind"] == kind and body["ntotal"] == 16
            assert_same(*p.both("POST", "/api/search", {"query": "a person", "limit": 3}))
        assert_same(*p.both("POST", "/api/open", {"path": str(tmp_path / "nothing")}))
    finally:
        p.close()


def test_maintenance_actions_match_jax(corpus, tmp_path):
    """Every action on a writable copy per server (the IVF ones persist into
    the container)."""
    copies = {}
    for side in ("jax", "port"):
        copies[side] = tmp_path / f"{side}.rvdb"
        shutil.copy(corpus["rvdb"], copies[side])
    p = Pair(corpus, "maint")
    try:
        body = assert_same(*p.both("POST", "/api/open", {"path": str(copies["port"]),
                                                         "writable": True},
                                   jpayload={"path": str(copies["jax"]), "writable": True}))
        assert body["kind"] == "rvdb"
        for payload in ({"action": "tune_ann"}, {"action": "optimize"},
                        {"action": "clear_cache"}, {"action": "compact"}):
            body = assert_same(*p.both("POST", "/api/maintenance", payload))
        assert body["report"]["compacted"] == 0
        body = assert_same(*p.both("POST", "/api/maintenance",
                                   {"action": "build_ann", "nlist": 2}))
        assert body["report"]["nlist"] == 2 and p.tsys.index.ann_active
        body = assert_same(*p.both("POST", "/api/maintenance",
                                   {"action": "tune_ann", "target_recall": 0.9, "sample": 4}))
        assert body["report"]["nprobe"] == p.tsys.index.config.ann_nprobe >= 1
        body = assert_same(*p.both("POST", "/api/maintenance",
                                   {"action": "measure_crossover", "batch_sizes": [1, 2],
                                    "repeats": 1}))
        assert p.tsys.index.config.ann_max_batch == body["report"]["max_batch"]
        assert_same(*p.both("POST", "/api/maintenance",
                            {"action": "measure_crossover", "batch_sizes": [1, 2000]}))
        assert_same(*p.both("POST", "/api/search", {"query": "a person", "limit": 3}))
    finally:
        p.close()


def test_build_wizard_pushes_progress_on_ws_as_jax_does(corpus):
    p = Pair(corpus, "build")
    try:
        events = {}
        with WebSocketClient("127.0.0.1", p.jport) as jws, \
                WebSocketClient("127.0.0.1", p.tport) as tws:
            body = assert_same(*p.both("POST", "/api/build",
                                       {"keyframes_dir": str(corpus["keyframes"])}))
            assert body == {"success": True, "status": "running"} or body["status"] == "running"
            for side, ws in (("jax", jws), ("port", tws)):
                got = [ws.receive_json()]
                while got[-1]["event"] == "build_progress":
                    got.append(ws.receive_json())
                events[side] = got
        assert [(e["event"], e.get("stage")) for e in events["port"]] == \
            [(e["event"], e.get("stage")) for e in events["jax"]]
        assert events["port"][0] == {"event": "build_progress", "stage": "validate", "done": 1,
                                     "total": 6}
        assert events["port"][-1]["event"] == "build_done"
        assert events["port"][-1]["processed"] == FOLDERS * PER_FOLDER
        statuses = [parsed(call(port, "GET", "/api/build/status"))[1]
                    for port in (p.jport, p.tport)]
        assert statuses[1]["status"] == statuses[0]["status"] == "done"
        assert set(statuses[1]) == set(statuses[0])
        assert statuses[1]["processed"] == statuses[0]["processed"] == FOLDERS * PER_FOLDER
        assert_same(*p.both("POST", "/api/search", {"query": "a person", "limit": 5}))
        # one job at a time: a job still marked running answers 409
        for server in (p.jserver, p.tserver):
            server._build_state["status"] = "running"
        assert_same(*p.both("POST", "/api/build", {"keyframes_dir": str(corpus["keyframes"])}))
        assert_same(*p.both("POST", "/api/filter", {"action": "refine",
                                                    "input_dir": str(corpus["keyframes"])}))
        for server in (p.jserver, p.tserver):
            server._build_state["status"] = "done"
    finally:
        p.close()


def test_filter_refine_matches_jax(corpus, tmp_path):
    p = Pair(corpus, "filter", corpus["rvdb"])
    try:
        for side, port in (("jax", p.jport), ("port", p.tport)):
            status, body = parsed(call(port, "POST", "/api/filter", {
                "action": "refine", "input_dir": str(corpus["keyframes"]),
                "output_dir": str(tmp_path / side), "preset": "similarity_only"}))
            assert status == 200 and body["status"] == "running"
        reports = []
        for port in (p.jport, p.tport):
            deadline = time.time() + 60
            while time.time() < deadline:
                state = parsed(call(port, "GET", "/api/build/status"))[1]
                if state["status"] in ("done", "error"):
                    break
                time.sleep(0.05)
            reports.append(state)
        jrep, prep = reports
        assert prep["status"] == jrep["status"] == "done" and prep["job"] == "filter"
        assert set(prep) == set(jrep)
        for key in ("frames_in", "frames_out", "folders", "dropped_quality",
                    "dropped_similarity"):
            assert prep[key] == jrep[key], key
        assert sorted(q.relative_to(tmp_path / "port").as_posix()
                      for q in (tmp_path / "port").rglob("*.jpg")) == \
            sorted(q.relative_to(tmp_path / "jax").as_posix()
                   for q in (tmp_path / "jax").rglob("*.jpg"))
    finally:
        p.close()


def test_start_server_stop_restart_and_cleanup(corpus):
    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=corpus["root"] / "life", create_dirs=True,
               overrides=dict(OVERRIDES, api={"batching": True})),
        embedder=corpus["temb"], device="cpu")
    system.load_system(corpus["rvdb"])
    port = free_port()
    server = system.start_server(host="127.0.0.1", port=port, block=False)
    assert system._server is server and server.batcher.is_running
    assert parsed(call(port, "GET", "/api/stats"))[0] == 200
    server.stop()
    assert not server.batcher.is_running
    with pytest.raises(OSError):
        call(port, "GET", "/api/stats")
    server.run(block=False)                            # the same port again
    status, body = parsed(call(port, "POST", "/api/search", {"query": "a person", "limit": 3}))
    assert status == 200 and body["count"] == 3 and server.batcher.stats.requests >= 1
    system.cleanup()                                   # stops the server
    with pytest.raises(OSError):
        call(port, "GET", "/api/stats")
    assert system.index is None


def test_concurrent_searches_through_the_batcher_equal_serial_answers(corpus):
    from intelligent_video_analysis_retrieval_system_tpu_torch.bench.served import fire

    system = EnhancedRetrievalSystem(
        Config(config_file=None, base_dir=corpus["root"] / "conc", create_dirs=True,
               overrides=dict(OVERRIDES, api={"batching": True, "batching_window_ms": 20.0})),
        embedder=corpus["temb"], device="cpu")
    system.load_system(corpus["rvdb"])
    server = system.start_server(host="127.0.0.1", port=free_port(), block=False)
    try:
        texts = [f"concurrent {i}: a person walking" for i in range(24)]
        _, _, together = fire(server.port, texts, concurrency=8, limit=5)
        _, _, alone = fire(server.port, texts, concurrency=1, limit=5)
        assert server.batcher.stats.max_batch_seen > 1
        for a, b in zip(together, alone):
            same_hits(b["results"], a["results"])
    finally:
        system.cleanup()


def test_cli_serve_starts_the_server_on_the_asked_device(corpus, monkeypatch, capsys):
    monkeypatch.setattr(CLIPConfig, "vit_l_14", classmethod(lambda cls: CLIPConfig.tiny_test()))
    seen = {}
    run = rest.RetrievalServer.run

    def run_then_probe(self, block=True):
        run(self, block=False)                         # serve, ask, return
        seen["block"] = block
        seen["health"] = parsed(call(self.port, "GET", "/api/health"))
        seen["search"] = parsed(call(self.port, "POST", "/api/search",
                                     {"query": "a person", "limit": 2}))
        seen["device"] = str(self.system.device)
        seen["sharded"] = self.system.index._sharded is not None

    monkeypatch.setattr(rest.RetrievalServer, "run", run_then_probe)
    monkeypatch.chdir(corpus["root"])
    port = free_port()
    assert cli.main(["serve", str(corpus["rvdb"]), "--host", "127.0.0.1", "--port", str(port),
                     "--device", "cpu"]) == 0
    assert f"serving on http://127.0.0.1:{port}" in capsys.readouterr().out
    assert seen["block"] is True and seen["device"] == "cpu"
    assert seen["health"][0] == 200 and seen["health"][1]["index_loaded"]
    assert seen["search"][0] == 200 and seen["search"][1]["count"] == 2
    assert not seen["sharded"]
    with pytest.raises(OSError):                       # cleanup stopped it
        call(port, "GET", "/api/health")
    # --mesh: the index shards over a mesh (one CPU shard) and answers alike
    assert cli.main(["serve", str(corpus["rvdb"]), "--host", "127.0.0.1", "--port",
                     str(free_port()), "--device", "cpu", "--mesh"]) == 0
    assert seen["search"][0] == 200 and seen["search"][1]["count"] == 2 and seen["sharded"]
    args = cli._build_parser().parse_args(["serve"])
    assert (args.device, args.host, args.port, args.index_path) == ("cuda", "0.0.0.0", 5000,
                                                                   None)
