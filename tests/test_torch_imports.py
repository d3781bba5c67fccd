"""The port stands on its own: it imports neither JAX nor anything of the
JAX package, nor the server libraries the card's machine lacks.

- In a fresh interpreter with ``jax``, ``jaxlib``, ``flax``, ``optax``,
  ``orbax``, ``intelligent_video_analysis_retrieval_system_tpu``,
  ``aiohttp`` and ``websockets`` blocked (``None`` in ``sys.modules``, so any import of them
  raises), every module of the port and ``chip_smoke`` imports.
- No source line of the port or of ``chip_smoke.py`` is an import of them
  (comments and strings that name the originals of copies, or the TPU
  kernels a CUDA kernel replaces, are fine).
- The copies the port keeps of the JAX package's framework-free modules
  name their originals and have not drifted from them; the REST server's
  console page is the JAX server's, byte for byte.
- The P2P layer and the Socket.IO wire import with ``aiohttp``, ``socketio``
  and ``openai`` blocked; the agents import ``openai`` only inside
  ``LLMProcessor._build_provider``, where an API key is set.
- The trainer's collectives, the parity gate and the twin of
  ``__graft_entry__.py`` import with ``transformers`` blocked as well; the
  gate imports ``transformers`` only inside ``run_parity``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "intelligent_video_analysis_retrieval_system_tpu_torch"
JAX_PKG = ROOT / "intelligent_video_analysis_retrieval_system_tpu"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "intelligent_video_analysis_retrieval_system_tpu", "aiohttp", "websockets")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
blocked = sys.argv[1].split(",")
for name in blocked:
    sys.modules[name] = None
import intelligent_video_analysis_retrieval_system_tpu_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(port.__path__,
                                                                 port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m] is not None]
assert not loaded, loaded
print("IMPORTED", len(names))
"""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_the_jax_package_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, ",".join(BLOCKED)],
                          capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # every .py of the port is a module or a package that was walked
    assert int(proc.stdout.split("IMPORTED")[1]) == len(list(PORT.rglob("*.py")))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_them(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in BLOCKED, f"{path}:{node.lineno} imports {root}"

COPIES = ["utils/__init__.py", "utils/cache.py", "utils/config.py", "utils/dataproc.py",
          "utils/files.py", "utils/logging.py", "utils/paths.py", "utils/perf.py",
          "native/__init__.py", "native/ivars_native.cpp", "serve/batching.py",
          "serve/handlers.py", "index/metacols.py", "index/portable.py", "ingest/video.py",
          "agents/__init__.py", "agents/llm.py", "agents/manager.py", "agents/tools.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copies_name_their_originals_and_keep_in_step(rel):
    copy, original = (PORT / rel).read_text(), (JAX_PKG / rel).read_text()
    head = "\n".join(copy.splitlines()[:4])
    assert f"intelligent_video_analysis_retrieval_system_tpu/{rel}" in head
    assert "Keep the two" in head and "in step" in head
    # apart from the note and the few lines the port had to change, line for line
    theirs = set(original.splitlines())
    own = [line for line in copy.splitlines() if line not in theirs]
    assert len(own) <= 30, own
    assert len(copy.splitlines()) >= len(original.splitlines())


def test_the_bench_and_the_index_open_modules_are_walked():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"bench/__init__.py", "bench/__main__.py", "bench/timing.py", "bench/data.py",
            "bench/headline.py", "bench/probes.py", "index/metacols.py",
            "index/fastloader.py", "index/portable.py", "ops/ann.py",
            "retrieval/temporal.py", "ingest/__init__.py", "ingest/frames.py",
            "ingest/pipeline.py", "ingest/video.py", "ops/quality.py", "ops/phash.py",
            "ops/dedup.py", "models/dino.py", "serve/rest.py", "serve/websocket.py",
            "bench/served.py", "parallel/train.py", "serve/p2p.py", "serve/socketio.py",
            "agents/__init__.py", "agents/llm.py", "agents/manager.py",
            "agents/tools.py", "parallel/collectives.py", "models/parity.py",
            "graft_entry.py"} <= names


_IMPORT_SERVE = r"""
import sys
for name in ("aiohttp", "socketio", "openai", "jax",
             "intelligent_video_analysis_retrieval_system_tpu"):
    sys.modules[name] = None
from intelligent_video_analysis_retrieval_system_tpu_torch.serve import p2p, rest, socketio
from intelligent_video_analysis_retrieval_system_tpu_torch import agents
from intelligent_video_analysis_retrieval_system_tpu_torch.system.facade import (
    EnhancedRetrievalSystem,
)
system = EnhancedRetrievalSystem(device="cpu")
proc = system.enable_llm()               # no key, no provider: offline, openai untouched
assert not proc.available and system.chat("hello")["method"] == "greeting"
server = p2p.NetworkServer("127.0.0.1", 0, enable_discovery=False, device="cpu")
server.start_server()
assert p2p.NetworkClient().health_check("127.0.0.1", server.port)
server.stop_server()
print("SERVED", socketio.PING_INTERVAL_S, len(agents.__all__))
"""


def test_p2p_socketio_and_agents_run_with_aiohttp_socketio_and_openai_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "OPENAI_API_KEY"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SERVE], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED 25.0 8" in proc.stdout


def test_openai_is_imported_only_where_a_key_builds_the_provider():
    found = []
    for path in _sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Import) and any(
                            a.name.split(".")[0] == "openai" for a in inner.names):
                        found.append((path.relative_to(PORT).as_posix(), node.name))
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("openai"):
                found.append((str(path), "from-import"))
    assert found == [("agents/llm.py", "_build_provider")]
    source = (PORT / "agents" / "llm.py").read_text()
    provider = source[source.index("def _build_provider"):source.index("def available")]
    assert provider.index("if not api_key:") < provider.index("import openai")


def test_the_console_page_is_the_jax_servers():
    from intelligent_video_analysis_retrieval_system_tpu.serve import rest as jax_rest
    from intelligent_video_analysis_retrieval_system_tpu_torch.serve import rest

    assert rest._CONSOLE_HTML.encode() == jax_rest._CONSOLE_HTML.encode()


def test_native_copy_builds_into_its_own_cache_directory():
    from intelligent_video_analysis_retrieval_system_tpu import native as jnative
    from intelligent_video_analysis_retrieval_system_tpu_torch import native as tnative

    assert tnative._build_dir().name == "ivars_torch_native"
    assert tnative._build_dir() != jnative._build_dir()
    assert tnative._SRC.parent == PORT / "native"


_IMPORT_LAST = r"""
import sys
for name in sys.argv[1].split(",") + ["transformers"]:
    sys.modules[name] = None
from intelligent_video_analysis_retrieval_system_tpu_torch import graft_entry
from intelligent_video_analysis_retrieval_system_tpu_torch.models import parity
from intelligent_video_analysis_retrieval_system_tpu_torch.parallel import collectives, train
report = parity.run_parity(sys.argv[2], device="cpu")
assert not report.ok and report.errors[0].startswith("torch/transformers unavailable"), report
print("LAST", len(collectives.__all__), len(graft_entry.__all__), train.CLIPTrainer.__name__)
"""


def test_collectives_parity_and_graft_entry_import_with_transformers_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_LAST, ",".join(BLOCKED),
                           str(tmp_path)], capture_output=True, text=True, cwd=tmp_path,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LAST 10 2 CLIPTrainer" in proc.stdout


def test_transformers_is_imported_only_inside_run_parity():
    tree = ast.parse((PORT / "models" / "parity.py").read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Import) and any(
                        a.name.split(".")[0] == "transformers" for a in inner.names):
                    found.append(node.name)
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("transformers"):
            found.append("from-import")
    assert found == ["run_parity"]
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert all("transformers" not in ast.dump(n) for n in top)
