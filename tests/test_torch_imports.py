"""The port stands on its own: it imports neither JAX nor anything of the
JAX package.

- In a fresh interpreter with ``jax``, ``jaxlib``, ``flax`` and
  ``intelligent_video_analysis_retrieval_system_tpu`` blocked (``None`` in
  ``sys.modules``, so any import of them raises), every module of the port
  and ``chip_smoke`` imports.
- No source line of the port or of ``chip_smoke.py`` is an import of them
  (comments and strings that name the originals of copies, or the TPU
  kernels a CUDA kernel replaces, are fine).
- The copies the port keeps of the JAX package's framework-free modules
  name their originals and have not drifted from them.
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
BLOCKED = ("jax", "jaxlib", "flax", "intelligent_video_analysis_retrieval_system_tpu")

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
          "serve/handlers.py"]


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


def test_native_copy_builds_into_its_own_cache_directory():
    from intelligent_video_analysis_retrieval_system_tpu import native as jnative
    from intelligent_video_analysis_retrieval_system_tpu_torch import native as tnative

    assert tnative._build_dir().name == "ivars_torch_native"
    assert tnative._build_dir() != jnative._build_dir()
    assert tnative._SRC.parent == PORT / "native"
