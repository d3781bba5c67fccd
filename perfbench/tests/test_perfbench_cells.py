"""Every cell's traffic end to end on the CPU at tiny widths, through the
program's plain versions: a sound run is correct and reports its metrics;
a run with the timed path broken underneath is not correct."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.index.unified import UnifiedIndex
from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder
from perfbench.run import run_cell

CPU = torch.device("cpu")
SECONDS = 2.0
E2E = {"toy-serve": "query_p95_ms", "b32-knn-96M-int8": "queries_per_s",
       "l14-encode-256": "images_per_s"}
PER_LAYER = {"toy-serve": set(), "b32-knn-96M-int8": {"mfu.knn"},
             "l14-encode-256": {"mfu.encode"}}


def _run(root, workload, trace=False, seed=2**31 + 11):
    result, notes, checks = run_cell(root, workload, seed, SECONDS, trace, CPU,
                                     time.perf_counter())
    return result, checks


@pytest.mark.parametrize("workload", sorted(E2E))
def test_cell_runs_correct(toy_root, workload):
    result, checks = _run(toy_root, workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {E2E[workload], "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert all(limit is not None and value <= limit for _, value, limit in checks)


@pytest.mark.parametrize("workload", sorted(E2E))
def test_cell_traced(toy_root, workload):
    result, _ = _run(toy_root, workload, trace=True)
    assert result["correct"]
    # the CPU has no device trace: the device readers find nothing and stay out
    assert set(result["metrics"]) == PER_LAYER[workload]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_answer(monkeypatch):
    search = UnifiedIndex.search_vectors

    def altered(self, *args, **kwargs):
        out = search(self, *args, **kwargs)
        for hits in out:   # every answer's best row named wrongly
            if hits:
                hits[0].metadata = self._metadata[(hits[0].metadata.row_id + 1) % self._n_valid]
        return out

    monkeypatch.setattr(UnifiedIndex, "search_vectors", altered)


def _half_rows(monkeypatch):
    search = UnifiedIndex.search_vectors

    def half(self, *args, **kwargs):
        n = self._n_valid
        self._n_valid = n // 2
        try:
            return search(self, *args, **kwargs)
        finally:
            self._n_valid = n

    monkeypatch.setattr(UnifiedIndex, "search_vectors", half)


def _altered_embedding(monkeypatch):
    encode = CLIPEmbedder.encode_images

    def altered(self, *args, **kwargs):
        out = encode(self, *args, **kwargs)
        return np.roll(out, 1, axis=1)   # every embedding's entries shifted

    monkeypatch.setattr(CLIPEmbedder, "encode_images", altered)


def _half_batch(monkeypatch):
    encode = CLIPEmbedder.encode_images

    def half(self, images, *args, **kwargs):
        if len(images) < 2:   # the load-time self-test
            return encode(self, images, *args, **kwargs)
        h = len(images) // 2
        out = encode(self, images[:h], *args, **kwargs)
        return np.concatenate([out, out])

    monkeypatch.setattr(CLIPEmbedder, "encode_images", half)


FAULTS = [("toy-serve", _altered_answer), ("toy-serve", _half_rows),
          ("b32-knn-96M-int8", _altered_answer), ("b32-knn-96M-int8", _half_rows),
          ("l14-encode-256", _altered_embedding), ("l14-encode-256", _half_batch)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_broken_path_is_not_correct(toy_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    result, _ = _run(toy_root, workload, seed=5)
    assert result["correct"] is False, result["checks"]
