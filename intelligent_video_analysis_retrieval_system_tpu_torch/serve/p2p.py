"""LAN P2P layer: discovery, peer serving, remote index access.

Port of ``intelligent_video_analysis_retrieval_system_tpu/serve/p2p.py``.
:class:`NetworkDiscovery`, :class:`NetworkClient` and
:class:`RemoteUnifiedIndex` are the standard library there already and are
carried over line for line (keep them in step); :class:`NetworkServer`, an
aiohttp app there, stands here on the port's threaded HTTP server
(``serve/rest.py``), since the machine the port serves on has no aiohttp:

- :class:`NetworkDiscovery` — UDP broadcast ``node_announcement`` JSON on
  ``port+1`` and the well-known port, periodic (15 s), 5-minute peer
  expiry, manual discovery trigger, ``listen_only`` for consumers that
  serve no peer endpoints;
- :class:`NetworkServer` — HTTP peer endpoints with the JAX server's routes,
  statuses and bodies: ping/info/status, shared index listing/info,
  **remote vector search** (the client POSTs the query vector; the port's
  ``UnifiedIndex`` answers on its device: kernel B1 over bf16/f32 rows, B2
  over int8), per-row thumbnail/full-image/metadata fetch, and shared
  folders (listing, download, upload, with a path-traversal guard). Shared
  indexes are opened once and stay on the device;
- :class:`NetworkClient` / :class:`RemoteUnifiedIndex` — connect, list,
  and query remote indexes over ``urllib``; ``RemoteUnifiedIndex`` mimics
  the local index API over HTTP and plugs into ``system.remote_indexes``
  for the facade's fan-in merge.

Multi-device search on one host is ``parallel.sharded_search``; this layer
is the reference's ad-hoc desktop sharing.
"""

from __future__ import annotations

import hashlib
import json
import socket
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from .rest import HTTPApp, Request, Response, _Connection, _HTTPServer, json_response

if TYPE_CHECKING:
    from pathlib import Path

    from ..index.unified import UnifiedIndex

__all__ = [
    "NetworkDiscovery",
    "NetworkServer",
    "NetworkClient",
    "RemoteUnifiedIndex",
]


def _node_id(service_port: int = 0) -> str:
    """Stable node identity (reference api.py:338-361 hashes hostname_ip
    only — which collides for two nodes on one host, making each discard
    the other's announcements as its own; the service port disambiguates
    while staying stable across restarts)."""
    host = socket.gethostname()
    try:
        ip = socket.gethostbyname(host)
    except OSError:
        ip = "127.0.0.1"
    return hashlib.md5(f"{host}_{ip}_{service_port}".encode()).hexdigest()[:12]


DEFAULT_DISCOVERY_PORT = 5556  # reference legacy port (api.py:475-505)


class NetworkDiscovery:
    """UDP broadcast peer discovery (reference api.py:305-603)."""

    def __init__(
        self,
        service_port: int,
        discovery_port: int | None = None,
        interval_s: float = 15.0,
        node_timeout_s: float = 300.0,
        node_name: str | None = None,
        listen_only: bool = False,
    ) -> None:
        """``listen_only=True`` observes peer announcements without
        announcing this process — for consumers (e.g. the web console)
        that serve NO p2p endpoints: announcing their port would invite
        peers to connect to a server that cannot answer
        ``/api/node/info`` etc."""
        self.service_port = service_port
        self.discovery_port = discovery_port or service_port + 1
        # nodes on ARBITRARY service ports can only find each other through
        # a shared port — announce/listen on the well-known port too
        # (reference api.py:475-505 uses legacy 5556 alongside port+1)
        self.well_known_port = DEFAULT_DISCOVERY_PORT
        self.interval_s = interval_s
        self.node_timeout_s = node_timeout_s
        self.listen_only = listen_only
        self.node_id = _node_id(service_port)
        self.node_name = node_name or socket.gethostname()
        self.known_nodes: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.on_node_discovered: Callable[[dict], None] | None = None

    def _announcement(self) -> bytes:
        return json.dumps(
            {
                "type": "node_announcement",
                "node_id": self.node_id,
                "node_name": self.node_name,
                "service_port": self.service_port,
                "ts": time.time(),
            }
        ).encode("utf-8")

    def start_discovery(self) -> None:
        self._stop.clear()
        targets = [self._listen_loop, self._expiry_loop]
        if not self.listen_only:
            targets.insert(0, self._broadcast_loop)
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop_discovery(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()

    @property
    def is_running(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def _announce_ports(self) -> list[int]:
        ports = [self.discovery_port]
        if self.well_known_port not in ports:
            ports.append(self.well_known_port)
        return ports

    def _send_announcements(self, sock: socket.socket) -> None:
        for port in self._announce_ports():
            sock.sendto(self._announcement(), ("255.255.255.255", port))
            sock.sendto(self._announcement(), ("127.0.0.1", port))

    def _broadcast_loop(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        try:
            while not self._stop.is_set():
                try:
                    self._send_announcements(sock)
                except OSError:
                    pass
                self._stop.wait(self.interval_s)
        finally:
            sock.close()

    def broadcast_once(self) -> None:
        """Manual discovery trigger (reference api.py:507-533)."""
        if self.listen_only:
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        try:
            self._send_announcements(sock)
        except OSError:
            pass
        finally:
            sock.close()

    def _listen_loop(self) -> None:
        """Dual listeners (reference api.py:407-448): the node's own
        ``discovery_port`` plus the shared well-known port, so peers on
        arbitrary service ports are heard. The well-known bind is
        best-effort (SO_REUSEADDR lets co-hosted nodes share it; if the
        OS refuses, per-port discovery still works)."""
        socks: list[socket.socket] = []
        for port in self._announce_ports():
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # deliberately NO SO_REUSEPORT: a reuseport group delivers each
            # loopback *unicast* announcement to one hash-chosen member
            # (often the sender's own listener), making same-host discovery
            # nondeterministic. First binder of the well-known port wins;
            # everyone still has their per-port listener + LAN broadcast.
            sock.settimeout(0.5)
            try:
                sock.bind(("", port))
            except OSError:
                sock.close()
                continue
            socks.append(sock)
        if not socks:
            return
        try:
            while not self._stop.is_set():
                for sock in socks:
                    try:
                        data, addr = sock.recvfrom(4096)
                    except socket.timeout:
                        continue
                    except OSError:
                        return
                    self._handle_announcement(data, addr)
        finally:
            for sock in socks:
                sock.close()

    def _handle_announcement(self, data: bytes, addr: tuple[str, int]) -> None:
        try:
            msg = json.loads(data.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        if msg.get("type") != "node_announcement":
            return
        if msg.get("node_id") == self.node_id:
            return  # our own broadcast
        # sender-IP rewrite (reference api.py:450-473): trust the socket addr
        node = {
            "node_id": msg.get("node_id"),
            "node_name": msg.get("node_name", "unknown"),
            "host": addr[0],
            "service_port": msg.get("service_port"),
            "last_seen": time.time(),
        }
        with self._lock:
            is_new = node["node_id"] not in self.known_nodes
            self.known_nodes[node["node_id"]] = node
        if is_new and self.on_node_discovered is not None:
            try:
                self.on_node_discovered(node)
            except Exception:
                pass

    def _expiry_loop(self) -> None:
        while not self._stop.is_set():
            cutoff = time.time() - self.node_timeout_s
            with self._lock:
                dead = [
                    nid for nid, n in self.known_nodes.items()
                    if n["last_seen"] < cutoff
                ]
                for nid in dead:
                    del self.known_nodes[nid]
            self._stop.wait(5.0)

    def get_nodes(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self.known_nodes.values())


class NetworkServer(HTTPApp):
    """HTTP peer server sharing local indexes and folders (the JAX server's
    routes) on the port's threaded HTTP server. ``device`` (default
    ``"cuda"``, which raises where CUDA is missing) is where
    :meth:`register_index_file` opens an index."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 5001,
        node_name: str | None = None,
        enable_discovery: bool = True,
        device: torch.device | str = "cuda",
    ) -> None:
        from ..index.unified import resolve_device

        super().__init__()
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.node_name = node_name or socket.gethostname()
        self.discovery = NetworkDiscovery(port, node_name=self.node_name)
        self.enable_discovery = enable_discovery
        self.shared_indexes: dict[str, "UnifiedIndex"] = {}
        self.shared_folders: dict[str, "Path"] = {}
        self._lock = threading.RLock()
        self._httpd: _HTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.started_at: float | None = None
        add = self._add
        add("GET", "/api/ping", self._ping)
        add("GET", "/api/node/info", self._info)
        add("GET", "/api/status", self._status)
        add("GET", "/api/indexes", self._list_indexes)
        add("GET", "/api/indexes/{index_id}/info", self._index_info)
        add("POST", "/api/indexes/{index_id}/search", self._index_search)
        add("GET", "/api/indexes/{index_id}/thumbnail/{row_id}", self._index_thumbnail)
        add("GET", "/api/indexes/{index_id}/image/{row_id}", self._index_image)
        add("GET", "/api/indexes/{index_id}/metadata/{row_id}", self._index_metadata)
        add("GET", "/api/folders", self._list_folders)
        add("GET", "/api/folders/{folder_id}/files", self._folder_files)
        add("GET", "/api/folders/{folder_id}/file", self._folder_file)
        add("POST", "/api/folders/{folder_id}/upload", self._folder_upload)

    # -- index registry (open once, serve many) --------------------------------

    def register_index(self, index_id: str, index: "UnifiedIndex") -> None:
        with self._lock:
            self.shared_indexes[index_id] = index

    def register_index_file(self, index_id: str, path: str) -> None:
        """Open the ``.rvdb`` at ``path`` as the port's ``UnifiedIndex`` on
        this server's device (it needs h5py, as the container does)."""
        from ..index.unified import UnifiedIndex

        index = UnifiedIndex(device=self.device)
        index.load_unified_index(path, mode="r")
        self.register_index(index_id, index)

    def remove_index(self, index_id: str) -> None:
        with self._lock:
            index = self.shared_indexes.pop(index_id, None)
        if index is not None:
            index.close()

    # -- shared folders --------------------------------------------------------

    def register_folder(self, folder_id: str, path: str) -> None:
        from pathlib import Path

        p = Path(path).resolve()
        if not p.is_dir():
            raise NotADirectoryError(p)
        with self._lock:
            self.shared_folders[folder_id] = p

    def remove_folder(self, folder_id: str) -> None:
        with self._lock:
            self.shared_folders.pop(folder_id, None)

    # -- lifecycle ---------------------------------------------------------------

    def start_server(self) -> None:
        """Bind (``port=0`` takes a free port, written back to ``self.port``),
        serve in a thread of its own, then start discovery if enabled."""
        httpd = _HTTPServer((self.host, self.port), _Connection)
        httpd.app = self
        if self.port == 0:
            self.port = httpd.server_address[1]
            self.discovery = NetworkDiscovery(self.port, node_name=self.node_name)
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever, name="ivars-p2p",
                                        daemon=True)
        self._thread.start()
        if self.enable_discovery:
            self.discovery.start_discovery()
        self.started_at = time.time()

    def stop_server(self) -> None:
        """Stop discovery and serving, close every connection, and close and
        forget the shared indexes."""
        self.discovery.stop_discovery()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._shutdown_connections()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            for index in self.shared_indexes.values():
                index.close()
            self.shared_indexes.clear()

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- handlers ------------------------------------------------------------------

    def _ping(self, request: Request) -> Response:
        return json_response({"status": "ok", "node_id": self.discovery.node_id,
                              "node_name": self.node_name, "ts": time.time()})

    def _info(self, request: Request) -> Response:
        with self._lock:
            indexes = list(self.shared_indexes)
        return json_response({"node_id": self.discovery.node_id, "node_name": self.node_name,
                              "service_port": self.port, "shared_indexes": indexes})

    def _status(self, request: Request) -> Response:
        return json_response({
            "status": "running",
            "uptime_s": round(time.time() - (self.started_at or time.time()), 1),
            "known_nodes": len(self.discovery.get_nodes()),
            "shared_indexes": len(self.shared_indexes),
        })

    def _list_indexes(self, request: Request) -> Response:
        with self._lock:
            items = [{"index_id": iid, "ntotal": idx.ntotal, "dim": idx.dim}
                     for iid, idx in self.shared_indexes.items()]
        return json_response({"indexes": items})

    def _get_index(self, request: Request):
        index_id = request.match_info["index_id"]
        with self._lock:
            return index_id, self.shared_indexes.get(index_id)

    def _index_info(self, request: Request) -> Response:
        index_id, index = self._get_index(request)
        if index is None:
            return json_response({"error": "unknown index"}, 404)
        return json_response({"index_id": index_id, "ntotal": index.ntotal, "dim": index.dim})

    def _index_search(self, request: Request) -> Response:
        """Remote vector search: body {query_vector: [f32...], top_k}."""
        _, index = self._get_index(request)
        if index is None:
            return json_response({"error": "unknown index"}, 404)
        try:
            payload = json.loads(request.read().decode("utf-8"))
            qvec = np.asarray(payload["query_vector"], dtype=np.float32)
            top_k = int(payload.get("top_k", 20))
        except Exception:
            return json_response({"error": "bad request"}, 400)
        if qvec.ndim != 1 or qvec.shape[0] != index.dim:
            return json_response({"error": f"query_vector must have dim {index.dim}"}, 400)
        hits = index.search(qvec, top_k=min(top_k, 1000))
        return json_response({"results": [{**h.to_dict("rich"), "row_id": h.metadata.row_id}
                                          for h in hits]})

    def _index_thumbnail(self, request: Request) -> Response:
        return self._asset(request, full=False)

    def _index_image(self, request: Request) -> Response:
        return self._asset(request, full=True)

    def _asset(self, request: Request, full: bool) -> Response:
        _, index = self._get_index(request)
        if index is None:
            return json_response({"error": "unknown index"}, 404)
        try:
            row_id = int(request.match_info["row_id"])
        except ValueError:
            return json_response({"error": "bad row id"}, 400)
        if not 0 <= row_id < index.ntotal:
            return json_response({"error": "row out of range"}, 404)
        data = (index.get_full_image if full else index.get_thumbnail)(row_id)
        if not data:
            return json_response({"error": "asset unavailable"}, 404)
        return Response(200, data, "image/jpeg")

    def _index_metadata(self, request: Request) -> Response:
        _, index = self._get_index(request)
        if index is None:
            return json_response({"error": "unknown index"}, 404)
        try:
            row_id = int(request.match_info["row_id"])
            meta = index.get_metadata(row_id)
        except (ValueError, IndexError):
            return json_response({"error": "row out of range"}, 404)
        return json_response({"metadata": meta.to_dict()})

    # -- shared folder handlers ------------------------------------------------------

    def _list_folders(self, request: Request) -> Response:
        with self._lock:
            items = [{"folder_id": fid, "path": str(p)} for fid, p in self.shared_folders.items()]
        return json_response({"folders": items})

    def _resolve_shared(self, request: Request):
        folder_id = request.match_info["folder_id"]
        with self._lock:
            return folder_id, self.shared_folders.get(folder_id)

    def _folder_files(self, request: Request) -> Response:
        _, root = self._resolve_shared(request)
        if root is None:
            return json_response({"error": "unknown folder"}, 404)
        files = []
        for p in sorted(root.rglob("*")):
            if p.is_file():
                files.append({"path": str(p.relative_to(root)), "bytes": p.stat().st_size})
            if len(files) >= 10000:
                break
        return json_response({"files": files})

    def _folder_file(self, request: Request) -> Response:
        import mimetypes

        _, root = self._resolve_shared(request)
        if root is None:
            return json_response({"error": "unknown folder"}, 404)
        rel = request.query.get("path", "")
        target = (root / rel).resolve()
        # path traversal protection: target must stay inside the share
        if root.resolve() not in target.parents and target != root.resolve():
            return json_response({"error": "forbidden path"}, 403)
        if not target.is_file():
            return json_response({"error": "file not found"}, 404)
        ctype = mimetypes.guess_type(target.name)[0] or "application/octet-stream"
        return Response(200, target.read_bytes(), ctype)

    def _folder_upload(self, request: Request) -> Response:
        """Peer file upload: body = raw bytes (at most 64 MiB), ?path=
        the destination relative to the shared folder."""
        _, root = self._resolve_shared(request)
        if root is None:
            return json_response({"error": "unknown folder"}, 404)
        rel = request.query.get("path", "")
        if not rel:
            return json_response({"error": "path query required"}, 400)
        target = (root / rel).resolve()
        if root.resolve() not in target.parents:
            return json_response({"error": "forbidden path"}, 403)
        data = request.read()
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(target.name + ".part")
        tmp.write_bytes(data)
        tmp.replace(target)
        return json_response({"uploaded": str(target.relative_to(root)), "bytes": len(data)})


class NetworkClient:
    """Synchronous HTTP client for peer servers (reference api.py:1311-1810)."""

    def __init__(self, timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        self.connected: dict[str, dict[str, Any]] = {}

    def _get(self, base: str, path: str) -> dict[str, Any]:
        import urllib.request

        req = urllib.request.Request(f"{base}{path}", method="GET")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _get_bytes(self, base: str, path: str) -> bytes:
        import urllib.request

        req = urllib.request.Request(f"{base}{path}", method="GET")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def _post(self, base: str, path: str, payload: dict[str, Any]) -> dict[str, Any]:
        import urllib.request

        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{base}{path}",
            data=body,
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def connect_to_server(self, host: str, port: int) -> dict[str, Any]:
        base = f"http://{host}:{port}"
        pong = self._get(base, "/api/ping")
        info = self._get(base, "/api/node/info")
        record = {"base": base, "ping": pong, "info": info}
        self.connected[f"{host}:{port}"] = record
        return record

    def health_check(self, host: str, port: int) -> bool:
        try:
            self._get(f"http://{host}:{port}", "/api/ping")
            return True
        except Exception:
            return False

    def list_remote_indexes(self, host: str, port: int) -> list[dict[str, Any]]:
        return self._get(f"http://{host}:{port}", "/api/indexes")["indexes"]

    def load_remote_index(
        self, host: str, port: int, index_id: str
    ) -> "RemoteUnifiedIndex":
        base = f"http://{host}:{port}"
        info = self._get(base, f"/api/indexes/{index_id}/info")
        return RemoteUnifiedIndex(self, base, index_id, info)

    def list_remote_folders(self, host: str, port: int) -> list[dict[str, Any]]:
        return self._get(f"http://{host}:{port}", "/api/folders")["folders"]

    def list_folder_files(
        self, host: str, port: int, folder_id: str
    ) -> list[dict[str, Any]]:
        return self._get(
            f"http://{host}:{port}", f"/api/folders/{folder_id}/files"
        )["files"]

    def download_file(
        self, host: str, port: int, folder_id: str, rel_path: str, dest: str
    ) -> str:
        from pathlib import Path
        from urllib.parse import quote

        data = self._get_bytes(
            f"http://{host}:{port}",
            f"/api/folders/{folder_id}/file?path={quote(rel_path)}",
        )
        dest_path = Path(dest)
        dest_path.parent.mkdir(parents=True, exist_ok=True)
        dest_path.write_bytes(data)
        return str(dest_path)

    def upload_file(
        self, host: str, port: int, folder_id: str, rel_path: str,
        local_path: str,
    ) -> dict[str, Any]:
        import urllib.request
        from pathlib import Path
        from urllib.parse import quote

        data = Path(local_path).read_bytes()
        req = urllib.request.Request(
            f"http://{host}:{port}/api/folders/{folder_id}/upload"
            f"?path={quote(rel_path)}",
            data=data,
            method="POST",
            headers={"Content-Type": "application/octet-stream"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def search_all(
        self, servers: list[tuple[str, int, str]], qvec: np.ndarray, top_k: int
    ) -> list[dict[str, Any]]:
        """Fan-out search across servers, merged by similarity
        (reference api.py:1661-1695)."""
        merged: list[dict[str, Any]] = []
        for host, port, index_id in servers:
            try:
                remote = RemoteUnifiedIndex(
                    self, f"http://{host}:{port}", index_id, {}
                )
                merged.extend(remote.search_vector(qvec, top_k))
            except Exception:
                continue
        merged.sort(key=lambda r: r.get("similarity_score", 0.0), reverse=True)
        return merged[:top_k]


class RemoteUnifiedIndex:
    """Local-index-API facade over a remote peer (reference api.py:60-247).

    Plugs into ``EnhancedRetrievalSystem.remote_indexes``; the facade
    merges its results with local hits by similarity score.
    """

    def __init__(
        self,
        client: NetworkClient,
        base: str,
        index_id: str,
        info: dict[str, Any],
    ) -> None:
        self.client = client
        self.base = base
        self.index_id = index_id
        self.info = info

    @property
    def ntotal(self) -> int:
        return int(self.info.get("ntotal", 0))

    @property
    def dim(self) -> int:
        return int(self.info.get("dim", 0))

    def search_vector(self, qvec: np.ndarray, top_k: int = 20) -> list[dict[str, Any]]:
        out = self.client._post(
            self.base,
            f"/api/indexes/{self.index_id}/search",
            {"query_vector": np.asarray(qvec, np.float32).tolist(), "top_k": top_k},
        )
        results = out.get("results", [])
        for r in results:
            r["source"] = f"remote:{self.base}"
        return results

    def get_thumbnail(self, row_id: int) -> bytes:
        return self.client._get_bytes(
            self.base, f"/api/indexes/{self.index_id}/thumbnail/{row_id}"
        )

    def get_full_image(self, row_id: int) -> bytes:
        return self.client._get_bytes(
            self.base, f"/api/indexes/{self.index_id}/image/{row_id}"
        )

    def get_metadata(self, row_id: int) -> dict[str, Any]:
        return self.client._get(
            self.base, f"/api/indexes/{self.index_id}/metadata/{row_id}"
        )["metadata"]
