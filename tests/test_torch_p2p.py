"""The port's P2P layer (``serve/p2p.py``: discovery, the peer server on the
standard library, the ``urllib`` client) and the facade's remote fan-in,
against the JAX package's, on the CPU.

One tiny corpus: seeded JPEG keyframes indexed by the JAX facade
(``CLIPConfig.tiny_test()``, f32); the port's facade gets the JAX tower
weights through ``models.convert.from_jax_params`` and opens the same
``.rvdb``. A JAX peer (aiohttp) and a port peer share the same file.

- Twins of the JAX tests of ``TestP2P``, ``TestSharedFolders`` and
  ``TestFolderUpload`` (``tests/test_serve.py``), on the port's classes.
- Every peer route asked of both peers: the same status, and the same body
  (hits under the f32 rule: tie-aware, atol 5e-4; asset bytes equal).
- Cross-wire: the port's client against the JAX peer, and the JAX client
  against the port's peer.
- The fan-in of both facades over the same two indexes (tie-aware), and an
  int8 shared index whose remote answers equal the JAX peer's bit for bit.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from intelligent_video_analysis_retrieval_system_tpu.index.container import (
    IndexContainer as JaxContainer,
)
from intelligent_video_analysis_retrieval_system_tpu.models.clip import (
    CLIPConfig as JaxCLIPConfig,
)
from intelligent_video_analysis_retrieval_system_tpu.serve import p2p as jax_p2p
from intelligent_video_analysis_retrieval_system_tpu.system.embedder import (
    CLIPEmbedder as JaxEmbedder,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    EnhancedRetrievalSystem as JaxSystem,
)
from intelligent_video_analysis_retrieval_system_tpu.system.facade import (
    SearchOptions as JaxOptions,
)
from intelligent_video_analysis_retrieval_system_tpu.utils.config import Config as JaxConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.models.clip import CLIPConfig
from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
    from_jax_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.serve import p2p
from intelligent_video_analysis_retrieval_system_tpu_torch.serve.p2p import (
    NetworkClient,
    NetworkDiscovery,
    NetworkServer,
    RemoteUnifiedIndex,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
    SearchOptions,
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
QUERIES = ["a scene", "a red car at night", "people walking on a beach",
           "xe máy trên phố"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, payload=None, method=None, raw: bytes | None = None):
    """(status, parsed JSON body) of one request (the JAX tests' helper)."""
    body = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=body, method=method or ("POST" if body else "GET"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _write_keyframes(root: Path, seed: int, folders: int = FOLDERS, per: int = PER_FOLDER,
                     prefix: str = "vid") -> Path:
    rng = np.random.default_rng(seed)
    keyframes = root / "keyframes"
    for f in range(folders):
        folder = keyframes / f"{prefix}{f}"
        folder.mkdir(parents=True)
        for n in range(per):
            Image.fromarray(rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)).save(
                folder / f"{n}.jpg", quality=95)
    return keyframes


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two JAX-built indexes (``local``: vid*, ``peer``: cam*, so the fan-in
    never dedups one row against another), the JAX embedder and the port's
    carrying the same weights."""
    root = tmp_path_factory.mktemp("p2p")
    jemb = JaxEmbedder(config=JaxCLIPConfig.tiny_test(), compute_dtype="float32")
    jemb.ensure_loaded()
    temb = CLIPEmbedder(config=CLIPConfig.tiny_test(), compute_dtype="float32", device="cpu")
    temb.load_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jemb.params),
                                     CLIPConfig.tiny_test()))
    temb.using_pretrained = False
    paths = {}
    for name, seed, prefix in (("local", 2, "vid"), ("peer", 3, "cam")):
        keyframes = _write_keyframes(root / name, seed, prefix=prefix)
        builder = JaxSystem(JaxConfig(config_file=None, base_dir=root / name / "built",
                                      create_dirs=True, overrides=OVERRIDES), embedder=jemb)
        paths[name] = Path(builder.build_system(keyframes)["index_path"])
        builder.cleanup()
    return {"root": root, "jemb": jemb, "temb": temb, **paths}


@pytest.fixture(scope="module")
def systems(corpus):
    """(JAX facade, port facade), each over the ``local`` index."""
    root = corpus["root"]
    jsys = JaxSystem(JaxConfig(config_file=None, base_dir=root / "jsys", create_dirs=True,
                               overrides=OVERRIDES), embedder=corpus["jemb"])
    tsys = EnhancedRetrievalSystem(Config(config_file=None, base_dir=root / "tsys",
                                          create_dirs=True, overrides=OVERRIDES),
                                   embedder=corpus["temb"], device="cpu")
    jsys.load_system(corpus["local"])
    tsys.load_system(corpus["local"])
    yield jsys, tsys
    jsys.cleanup()
    tsys.cleanup()


@pytest.fixture(scope="module")
def peers(corpus):
    """A JAX peer and a port peer, each sharing the ``peer`` index as
    ``shared`` and one folder as ``stuff``."""
    share = corpus["root"] / "share"
    (share / "sub").mkdir(parents=True)
    (share / "a.txt").write_text("hello")
    (share / "sub" / "b.bin").write_bytes(b"\x01\x02")
    jpeer = jax_p2p.NetworkServer("127.0.0.1", free_port(), node_name="jpeer",
                                  enable_discovery=False)
    tpeer = NetworkServer("127.0.0.1", free_port(), node_name="tpeer", enable_discovery=False,
                          device="cpu")
    for peer in (jpeer, tpeer):
        peer.register_index_file("shared", str(corpus["peer"]))
        peer.register_folder("stuff", str(share))
        peer.start_server()
    yield jpeer, tpeer
    jpeer.stop_server()
    tpeer.stop_server()


def same_hits(jhits: list[dict], phits: list[dict], atol: float = ATOL_TOPK) -> None:
    assert len(phits) == len(jhits)
    assert [set(h) for h in phits] == [set(h) for h in jhits]
    if not jhits:
        return
    key = {k: i for i, k in enumerate(sorted({(h["folder"], h["image"])
                                             for h in jhits + phits}))}
    tie_aware_equal([key[h["folder"], h["image"]] for h in phits],
                    [h["similarity_score"] for h in phits],
                    [key[h["folder"], h["image"]] for h in jhits],
                    [h["similarity_score"] for h in jhits], atol=atol)


# -- twins of the JAX package's TestP2P ---------------------------------------------


def test_same_host_discovery_via_well_known_port():
    """A listen-only consumer on one service port hears a peer announcing from
    another through the shared well-known port; node ids differ per port."""
    console = NetworkDiscovery(service_port=free_port(), listen_only=True, interval_s=0.2)
    console.start_discovery()
    peer = NetworkDiscovery(service_port=free_port(), interval_s=0.2, node_name="wkp-peer")
    assert console.node_id != peer.node_id
    peer.start_discovery()
    try:
        deadline = time.time() + 5
        while time.time() < deadline:
            if any(n["node_name"] == "wkp-peer" for n in console.get_nodes()):
                break
            time.sleep(0.1)
        nodes = console.get_nodes()
        assert any(n["node_name"] == "wkp-peer" and n["service_port"] == peer.service_port
                   for n in nodes), nodes
        # listen-only: the peer never hears the console
        assert not any(n["node_id"] == console.node_id for n in peer.get_nodes())
    finally:
        console.stop_discovery()
        peer.stop_discovery()


def test_two_node_mesh(corpus, systems):
    """A port peer shares an index opened on its device; the client lists,
    searches, fetches assets and metadata; plugged into the port's facade
    the fan-in merges local and remote hits; the peer stops cleanly."""
    _, tsys = systems
    port_a = free_port()
    server_a = NetworkServer("127.0.0.1", port_a, node_name="nodeA", enable_discovery=False,
                             device="cpu")
    server_a.register_index_file("shared", str(corpus["peer"]))
    assert isinstance(server_a.shared_indexes["shared"], UnifiedIndex)
    assert server_a.shared_indexes["shared"].device == torch.device("cpu")
    server_a.start_server()
    try:
        client = NetworkClient()
        record = client.connect_to_server("127.0.0.1", port_a)
        assert record["ping"]["status"] == "ok"
        assert record["info"]["node_name"] == "nodeA"
        listed = client.list_remote_indexes("127.0.0.1", port_a)
        assert listed[0]["index_id"] == "shared"
        assert listed[0]["ntotal"] == FOLDERS * PER_FOLDER

        remote = client.load_remote_index("127.0.0.1", port_a, "shared")
        assert (remote.ntotal, remote.dim) == (FOLDERS * PER_FOLDER, 32)
        qvec = tsys.embedder.encode_text(["a scene"])[0]
        hits = remote.search_vector(qvec, top_k=3)
        assert len(hits) == 3
        assert hits[0]["source"].startswith("remote:")
        assert remote.get_thumbnail(0)[:2] == b"\xff\xd8"
        assert remote.get_full_image(0)[:2] == b"\xff\xd8"
        assert remote.get_metadata(0)["folder"] == "cam0"

        tsys.remote_indexes.append(remote)
        try:
            merged = tsys.search("a scene", SearchOptions(limit=5, use_cache=False))
            assert len(merged) == 5
            assert {h["folder"][:3] for h in merged} <= {"vid", "cam"}
        finally:
            tsys.remote_indexes.clear()
    finally:
        server_a.stop_server()
    assert not client.health_check("127.0.0.1", port_a)  # clean shutdown
    assert not server_a.is_running and not server_a.shared_indexes


def test_remote_search_validates_dim(corpus):
    port = free_port()
    server = NetworkServer("127.0.0.1", port, enable_discovery=False, device="cpu")
    server.register_index_file("s", str(corpus["peer"]))
    server.start_server()
    try:
        status, _, body = http_json(f"http://127.0.0.1:{port}/api/indexes/s/search",
                                    {"query_vector": [1.0, 2.0], "top_k": 3})
        assert status == 400 and json.loads(body) == {"error": "query_vector must have dim 32"}
        status, _, _ = http_json(f"http://127.0.0.1:{port}/api/indexes/nope/search",
                                 {"query_vector": [0.0] * 32})
        assert status == 404
    finally:
        server.stop_server()


def test_discovery_loopback():
    port = free_port()
    disc_port = free_port()
    a = NetworkDiscovery(port, discovery_port=disc_port, interval_s=0.1, node_name="A")
    b = NetworkDiscovery(port + 1, discovery_port=disc_port, interval_s=0.1, node_name="B")
    assert a.node_id != b.node_id
    found = threading.Event()
    a.on_node_discovered = lambda node: found.set()
    a.start_discovery()
    try:
        time.sleep(0.2)
        b.broadcast_once()
        assert found.wait(timeout=3), "node B not discovered"
        assert any(n["node_name"] == "B" for n in a.get_nodes())
    finally:
        a.stop_discovery()
        assert not a.is_running


def test_folder_share_list_download(tmp_path):
    share_root = tmp_path / "share"
    (share_root / "sub").mkdir(parents=True)
    (share_root / "a.txt").write_text("hello")
    (share_root / "sub" / "b.bin").write_bytes(b"\x01\x02")
    port = free_port()
    server = NetworkServer("127.0.0.1", port, enable_discovery=False, device="cpu")
    server.register_folder("stuff", str(share_root))
    server.start_server()
    try:
        client = NetworkClient()
        folders = client.list_remote_folders("127.0.0.1", port)
        assert folders[0]["folder_id"] == "stuff"
        files = client.list_folder_files("127.0.0.1", port, "stuff")
        assert {f["path"] for f in files} == {"a.txt", "sub/b.bin"}
        dest = tmp_path / "dl" / "b.bin"
        client.download_file("127.0.0.1", port, "stuff", "sub/b.bin", str(dest))
        assert dest.read_bytes() == b"\x01\x02"
    finally:
        server.stop_server()


def test_path_traversal_blocked(tmp_path):
    share_root = tmp_path / "share2"
    share_root.mkdir()
    (tmp_path / "secret.txt").write_text("secret")
    port = free_port()
    server = NetworkServer("127.0.0.1", port, enable_discovery=False, device="cpu")
    server.register_folder("s", str(share_root))
    server.start_server()
    try:
        status, _, _ = http_json(f"http://127.0.0.1:{port}/api/folders/s/file"
                                 "?path=../secret.txt")
        assert status == 403
        status, _, _ = http_json(f"http://127.0.0.1:{port}/api/folders/s/file?path=nope.txt")
        assert status == 404
    finally:
        server.stop_server()


def test_upload_roundtrip(tmp_path):
    share_root = tmp_path / "up"
    share_root.mkdir()
    src = tmp_path / "local.bin"
    src.write_bytes(b"payload-123")
    port = free_port()
    server = NetworkServer("127.0.0.1", port, enable_discovery=False, device="cpu")
    server.register_folder("inbox", str(share_root))
    server.start_server()
    try:
        client = NetworkClient()
        out = client.upload_file("127.0.0.1", port, "inbox", "sub/dest.bin", str(src))
        assert out["bytes"] == 11 and out["uploaded"] == "sub/dest.bin"
        assert (share_root / "sub" / "dest.bin").read_bytes() == b"payload-123"
        with pytest.raises(urllib.error.HTTPError):   # traversal blocked on upload too
            client.upload_file("127.0.0.1", port, "inbox", "../escape.bin", str(src))
        assert not (tmp_path / "escape.bin").exists()
    finally:
        server.stop_server()


# -- every peer route against the JAX peer ----------------------------------------------

QVEC = np.random.default_rng(7).standard_normal(32).astype(np.float32).tolist()

# (id, method, path, JSON payload or raw bytes)
PEER_CASES = [
    ("indexes", "GET", "/api/indexes", None),
    ("index_info", "GET", "/api/indexes/shared/info", None),
    ("index_info_unknown", "GET", "/api/indexes/nope/info", None),
    ("search", "POST", "/api/indexes/shared/search", {"query_vector": QVEC, "top_k": 5}),
    ("search_default_k", "POST", "/api/indexes/shared/search", {"query_vector": QVEC}),
    ("search_k_past_the_rows", "POST", "/api/indexes/shared/search",
     {"query_vector": QVEC, "top_k": 5000}),
    ("search_wrong_dim", "POST", "/api/indexes/shared/search",
     {"query_vector": [1.0, 2.0], "top_k": 3}),
    ("search_matrix", "POST", "/api/indexes/shared/search",
     {"query_vector": [QVEC, QVEC], "top_k": 3}),
    ("search_no_vector", "POST", "/api/indexes/shared/search", {"top_k": 3}),
    ("search_bad_k", "POST", "/api/indexes/shared/search",
     {"query_vector": QVEC, "top_k": "many"}),
    ("search_invalid_json", "POST", "/api/indexes/shared/search", b"{not json"),
    ("search_not_an_object", "POST", "/api/indexes/shared/search", b"[1, 2]"),
    ("search_unknown_index", "POST", "/api/indexes/nope/search", {"query_vector": QVEC}),
    ("thumbnail", "GET", "/api/indexes/shared/thumbnail/3", None),
    ("image", "GET", "/api/indexes/shared/image/12", None),
    ("thumbnail_out_of_range", "GET", "/api/indexes/shared/thumbnail/16", None),
    ("thumbnail_negative", "GET", "/api/indexes/shared/thumbnail/-1", None),
    ("thumbnail_bad_row", "GET", "/api/indexes/shared/thumbnail/x", None),
    ("image_unknown_index", "GET", "/api/indexes/nope/image/0", None),
    ("metadata", "GET", "/api/indexes/shared/metadata/9", None),
    ("metadata_out_of_range", "GET", "/api/indexes/shared/metadata/99", None),
    ("metadata_bad_row", "GET", "/api/indexes/shared/metadata/x", None),
    ("folders", "GET", "/api/folders", None),
    ("files", "GET", "/api/folders/stuff/files", None),
    ("files_unknown", "GET", "/api/folders/nope/files", None),
    ("file", "GET", "/api/folders/stuff/file?path=sub/b.bin", None),
    ("file_text", "GET", "/api/folders/stuff/file?path=a.txt", None),
    ("file_missing", "GET", "/api/folders/stuff/file?path=nope.txt", None),
    ("file_traversal", "GET", "/api/folders/stuff/file?path=../secret.txt", None),
    ("file_is_the_root", "GET", "/api/folders/stuff/file", None),
    ("upload_without_path", "POST", "/api/folders/stuff/upload", b"x"),
    ("upload_traversal", "POST", "/api/folders/stuff/upload?path=../x.bin", b"x"),
    ("upload_unknown", "POST", "/api/folders/nope/upload?path=x.bin", b"x"),
]


@pytest.mark.parametrize("name,method,path,payload", PEER_CASES,
                         ids=[c[0] for c in PEER_CASES])
def test_peer_route_answers_as_the_jax_peer(peers, name, method, path, payload):
    raw = payload if isinstance(payload, bytes) else None
    body = None if raw is not None else payload
    answers = [http_json(f"http://127.0.0.1:{peer.port}{path}", body, method, raw)
               for peer in peers]
    (js, jct, jb), (ps, pct, pb) = answers
    assert ps == js, (pb, jb)
    if not jct.startswith("application/json"):
        assert pct.split(";")[0] == jct.split(";")[0]
        assert pb == jb and len(pb) > 0
        return
    assert pct.startswith("application/json")
    jb, pb = json.loads(jb), json.loads(pb)
    if "results" in jb:
        same_hits(jb["results"], pb["results"])
        for h in pb["results"]:
            assert h["row_id"] == int(h["image"].split(".")[0]) + \
                PER_FOLDER * int(h["folder"][3:])
    else:
        assert pb == jb


def test_ping_info_and_status_answer_as_the_jax_peer(peers):
    for path, keys in (("/api/ping", {"status", "node_id", "node_name", "ts"}),
                       ("/api/node/info", {"node_id", "node_name", "service_port",
                                           "shared_indexes"}),
                       ("/api/status", {"status", "uptime_s", "known_nodes",
                                        "shared_indexes"})):
        (js, _, jb), (ps, _, pb) = [http_json(f"http://127.0.0.1:{p.port}{path}")
                                    for p in peers]
        jb, pb = json.loads(jb), json.loads(pb)
        assert ps == js == 200 and set(pb) == set(jb) == keys
        for k in ("status", "shared_indexes", "known_nodes"):
            if k in jb:
                assert pb[k] == jb[k]
    assert json.loads(http_json(f"http://127.0.0.1:{peers[1].port}/api/node/info")[2]) \
        ["node_name"] == "tpeer"


def test_unknown_route_and_method_are_refused_like_the_jax_peer(peers):
    for method, path in (("GET", "/api/nope"), ("POST", "/api/ping"),
                         ("GET", "/api/indexes/shared/search")):
        statuses = [http_json(f"http://127.0.0.1:{p.port}{path}", None, method)[0]
                    for p in peers]
        assert statuses[1] == statuses[0] and statuses[0] in (404, 405)


# -- cross-wire: each client against the other's peer ------------------------------------


@pytest.mark.parametrize("client_cls,peer_at", [(NetworkClient, 0), (jax_p2p.NetworkClient, 1)],
                         ids=["port_client_jax_peer", "jax_client_port_peer"])
def test_client_and_peer_interoperate_across_the_two_packages(peers, tmp_path, client_cls,
                                                              peer_at):
    peer = peers[peer_at]
    client = client_cls()
    record = client.connect_to_server("127.0.0.1", peer.port)
    assert record["ping"]["status"] == "ok"
    assert record["info"]["shared_indexes"] == ["shared"]
    assert client.health_check("127.0.0.1", peer.port)
    listed = client.list_remote_indexes("127.0.0.1", peer.port)
    assert listed == [{"index_id": "shared", "ntotal": 16, "dim": 32}]
    remote = client.load_remote_index("127.0.0.1", peer.port, "shared")
    hits = remote.search_vector(np.asarray(QVEC), top_k=6)
    # the same answer as the other package's client against its own peer
    other = peers[1 - peer_at]
    own = (jax_p2p.NetworkClient if client_cls is NetworkClient else NetworkClient)()
    want = own.load_remote_index("127.0.0.1", other.port, "shared").search_vector(
        np.asarray(QVEC), top_k=6)
    same_hits(want, hits)
    assert all(h["source"] == f"remote:http://127.0.0.1:{peer.port}" for h in hits)
    assert remote.get_thumbnail(5) == own.load_remote_index(
        "127.0.0.1", other.port, "shared").get_thumbnail(5)
    assert remote.get_metadata(5)["image"] == "5.jpg"
    assert client.list_folder_files("127.0.0.1", peer.port, "stuff") == \
        own.list_folder_files("127.0.0.1", other.port, "stuff")
    dest = tmp_path / "b.bin"
    client.download_file("127.0.0.1", peer.port, "stuff", "sub/b.bin", str(dest))
    assert dest.read_bytes() == b"\x01\x02"
    src = tmp_path / "up.bin"
    src.write_bytes(b"cross-wire")
    out = client.upload_file("127.0.0.1", peer.port, "stuff", f"in/{peer_at}.bin", str(src))
    assert out == {"uploaded": f"in/{peer_at}.bin", "bytes": 10}
    merged = client.search_all([("127.0.0.1", p.port, "shared") for p in peers],
                               np.asarray(QVEC), 4)
    assert len(merged) == 4


# -- the facades' fan-in ---------------------------------------------------------------------


def test_fan_in_of_both_facades_over_the_same_two_indexes(systems, peers):
    """Each facade searches its local index and its own package's peer: the
    same merged answer (tie-aware), rows of both indexes in it, ranks 1..n;
    search_batch runs per query and equals search."""
    jsys, tsys = systems
    jpeer, tpeer = peers
    jsys.remote_indexes.append(jax_p2p.NetworkClient().load_remote_index(
        "127.0.0.1", jpeer.port, "shared"))
    tsys.remote_indexes.append(NetworkClient().load_remote_index(
        "127.0.0.1", tpeer.port, "shared"))
    try:
        for query in QUERIES:
            for limit in (3, 12, 40):
                want = jsys.search(query, JaxOptions(limit=limit, use_cache=False))
                got = tsys.search(query, SearchOptions(limit=limit, use_cache=False))
                same_hits(want, got)
                assert len(got) == min(limit, 2 * FOLDERS * PER_FOLDER)
                assert [h["rank"] for h in got] == list(range(1, len(got) + 1))
                if limit == 40:
                    assert {h["folder"][:3] for h in got} == {"vid", "cam"}
                    assert {h.get("source", "local") for h in got} == \
                        {"local", f"remote:http://127.0.0.1:{tpeer.port}"}
        assert tsys.get_system_stats()["remote_indexes"] == 1
        want = jsys.search_batch(QUERIES, JaxOptions(limit=9, use_cache=False))
        got = tsys.search_batch(QUERIES, SearchOptions(limit=9, use_cache=False))
        singles = [tsys.search(q, SearchOptions(limit=9, use_cache=False)) for q in QUERIES]
        for w, g, s in zip(want, got, singles):
            same_hits(w, g)
            assert [(h["folder"], h["image"]) for h in g] == \
                [(h["folder"], h["image"]) for h in s]
    finally:
        jsys.remote_indexes.clear()
        tsys.remote_indexes.clear()


def test_llm_enhanced_and_hybrid_fan_in_match_jax(systems, peers):
    jsys, tsys = systems
    jsys.remote_indexes.append(jax_p2p.NetworkClient().load_remote_index(
        "127.0.0.1", peers[0].port, "shared"))
    tsys.remote_indexes.append(NetworkClient().load_remote_index(
        "127.0.0.1", peers[1].port, "shared"))
    try:
        for mode in ("llm_enhanced", "hybrid"):
            for query in QUERIES[:2]:
                want = jsys.search(query, JaxOptions(mode=mode, limit=10, use_cache=False))
                got = tsys.search(query, SearchOptions(mode=mode, limit=10, use_cache=False))
                assert [(h["folder"], h["image"]) for h in got] == \
                    [(h["folder"], h["image"]) for h in want]
    finally:
        jsys.remote_indexes.clear()
        tsys.remote_indexes.clear()


def test_a_dead_peer_is_skipped_as_the_jax_facade_skips_it(systems):
    """A remote that fails (its peer is gone) is skipped with a warning: the
    answer is the local one, in both facades."""
    jsys, tsys = systems
    port = free_port()
    jsys.remote_indexes.append(jax_p2p.RemoteUnifiedIndex(
        jax_p2p.NetworkClient(timeout_s=2), f"http://127.0.0.1:{port}", "gone", {}))
    tsys.remote_indexes.append(RemoteUnifiedIndex(
        NetworkClient(timeout_s=2), f"http://127.0.0.1:{port}", "gone", {}))
    try:
        want = jsys.search("a scene", JaxOptions(limit=6, use_cache=False))
        got = tsys.search("a scene", SearchOptions(limit=6, use_cache=False))
        same_hits(want, got)
        assert {h["folder"][:3] for h in got} == {"vid"}
    finally:
        jsys.remote_indexes.clear()
        tsys.remote_indexes.clear()
    local = tsys.search("a scene", SearchOptions(limit=6, use_cache=False))
    assert [(h["folder"], h["image"]) for h in local] == [(h["folder"], h["image"]) for h in got]


def test_int8_peer_answers_equal_the_jax_peers_bit_for_bit(tmp_path):
    """One JAX-written int8 index (rows 3, 40 and 500 duplicate row 11: exact
    int8 ties) shared by both peers: the same rows and the same scores, bit
    for bit, for every query vector and k."""
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((600, 32)).astype(np.float32)
    rows[[3, 40, 500]] = rows[11]
    with JaxContainer(tmp_path / "i8.rvdb", "w", dim=32, dtype="int8") as c:
        c.append_embeddings(rows)
        c.append_metadata([{"folder": f"cam{i // 100}", "image": f"{i % 100}.jpg",
                            "frame_id": i % 100, "row_id": i} for i in range(600)])
        c.flush_checkpoint()
    jpeer = jax_p2p.NetworkServer("127.0.0.1", free_port(), enable_discovery=False)
    tpeer = NetworkServer("127.0.0.1", free_port(), enable_discovery=False, device="cpu")
    for peer in (jpeer, tpeer):
        peer.register_index_file("i8", str(tmp_path / "i8.rvdb"))
        peer.start_server()
    try:
        assert tpeer.shared_indexes["i8"]._dev_x.dtype == torch.int8
        queries = [rows[11], *rng.standard_normal((6, 32)).astype(np.float32)]
        for q in queries:
            for k in (1, 4, 20, 1000):
                answers = [NetworkClient().load_remote_index("127.0.0.1", p.port, "i8")
                           .search_vector(q, top_k=k) for p in (jpeer, tpeer)]
                (jh, th) = answers
                assert [(h["row_id"], h["similarity_score"]) for h in th] == \
                    [(h["row_id"], h["similarity_score"]) for h in jh]
        tied = NetworkClient().load_remote_index("127.0.0.1", tpeer.port, "i8") \
            .search_vector(rows[11], top_k=4)
        assert [h["row_id"] for h in tied] == [3, 11, 40, 500]
    finally:
        jpeer.stop_server()
        tpeer.stop_server()


# -- the device rule -------------------------------------------------------------------------


def test_the_peer_server_runs_on_the_card_unless_asked_for_the_cpu():
    import inspect

    assert inspect.signature(NetworkServer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        NetworkServer("127.0.0.1", free_port(), enable_discovery=False)
    server = NetworkServer("127.0.0.1", 0, enable_discovery=False, device="cpu")
    server.start_server()
    try:
        assert server.port != 0 and server.discovery.service_port == server.port
        assert NetworkClient().health_check("127.0.0.1", server.port)
    finally:
        server.stop_server()
    assert p2p.DEFAULT_DISCOVERY_PORT == jax_p2p.DEFAULT_DISCOVERY_PORT


# -- CLI share, doctor, validate ---------------------------------------------------------------


def test_cli_validate_passes_as_the_jax_clis_does(capsys):
    from intelligent_video_analysis_retrieval_system_tpu import cli as jcli
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    assert jcli.main(["validate"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["validate", "--device", "cpu", "--port", str(free_port())]) == 0
    got = capsys.readouterr().out
    assert "ALL CHECKS PASSED" in got and got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(["validate"])           # the default device is cuda


def test_cli_doctor_reports_the_card_network_and_a_probe(peers, capsys, monkeypatch):
    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    assert cli.main(["doctor", "--port", str(free_port())]) == 0
    out = capsys.readouterr().out
    for section in ("== device ==", "== model ==", "== network ==", "== checklist =="):
        assert section in out
    assert "cuda devices:" in out and "nvidia-smi" in out and "JAX" not in out
    assert "tokenizer:" in out and "weights: random init" in out
    assert cli.main(["doctor", "--probe", "127.0.0.1:1"]) == 1
    assert "FAILED" in capsys.readouterr().out
    assert cli.main(["doctor", "--probe", f"127.0.0.1:{peers[1].port}"]) == 0
    assert "OK (node tpeer)" in capsys.readouterr().out


def test_cli_share_serves_the_index_until_interrupted(corpus, capsys, monkeypatch):
    import types

    from intelligent_video_analysis_retrieval_system_tpu_torch import cli

    port = free_port()
    seen = {}

    def probe_then_interrupt(seconds):
        client = NetworkClient()
        seen["indexes"] = client.list_remote_indexes("127.0.0.1", port)
        remote = client.load_remote_index("127.0.0.1", port, "mine")
        seen["hits"] = remote.search_vector(np.asarray(QVEC), top_k=3)
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "time", types.SimpleNamespace(sleep=probe_then_interrupt))
    assert cli.main(["share", str(corpus["peer"]), "--host", "127.0.0.1", "--port", str(port),
                     "--index-id", "mine", "--name", "sharer", "--device", "cpu"]) == 0
    assert f"as 'mine' on 127.0.0.1:{port}" in capsys.readouterr().out
    assert seen["indexes"] == [{"index_id": "mine", "ntotal": 16, "dim": 32}]
    assert len(seen["hits"]) == 3
    assert not NetworkClient().health_check("127.0.0.1", port)    # stopped on the interrupt
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(["share", str(corpus["peer"]), "--port", str(free_port())])
