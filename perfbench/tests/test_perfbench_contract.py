"""What the harness may import and read, and the shape of ``BENCHMARK.json``."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
HARNESS = REPO / "perfbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "intelligent_video_analysis_retrieval_system_tpu"}
PORT = "intelligent_video_analysis_retrieval_system_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _sources(root: Path) -> list[Path]:
    return sorted(root.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(HARNESS), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", _sources(HARNESS / "reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = _imports(path)
    assert PORT not in names and "perfbench" not in names
    for node in ast.walk(tree):   # relative imports stay inside the reference
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, node.module


def test_loadgen_uses_the_standard_library_only():
    import sys

    assert _imports(HARNESS / "loadgen.py") <= set(sys.stdlib_module_names)


def test_reads_none_of_the_tpu_era_benchmark():
    text = "\n".join(p.read_text() for p in _sources(HARNESS) if p.parent.name != "tests")
    for needle in ("benchmarks/", "bench.py", "BENCH_", "BASELINE", "MULTICHIP_"):
        assert needle not in text


def test_benchmark_json_shape():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        names.add(c["name"])
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (HARNESS / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == names
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert (HARNESS / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:   # each cell: setup_s, one more end-to-end metric, a per-layer one
        own = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])


def test_traffic_limits_are_set():
    for path in sorted((HARNESS / "traffic").glob("*.json")):
        limits = json.loads(path.read_text())["limits"]
        assert limits and all(isinstance(v, (int, float)) for v in limits.values()), path.name
