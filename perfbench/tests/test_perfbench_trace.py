"""The trace reduction of a card's slice, the arithmetic of the window
before the slice, the float8 rounding of the encode control, and that
every traffic mix's driver has its own control."""

from __future__ import annotations

import importlib
import json
import math

import pytest
import torch

from perfbench.drivers.common import before_slice, slice_note
from perfbench.reference.clip import _fp8
from perfbench.tests.conftest import REPO
from perfbench.trace import MARKER_KERNEL, Tracer


def _kernel(name, ts_us, dur_us):
    return {"cat": "kernel", "name": name, "ts": ts_us, "dur": dur_us}


def test_card_slice_is_bounded_by_its_markers():
    events = [_kernel("before", 900.0, 200.0),            # in flight when the slice opened
              _kernel(f"at::cuda::{MARKER_KERNEL}(long)", 1000.0, 1.0),
              _kernel("b2", 1100.0, 300.0),
              _kernel("b2", 1500.0, 300.0),
              {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1900.0, "dur": 50.0},
              _kernel(f"at::cuda::{MARKER_KERNEL}(long)", 2000.0, 1.0),
              _kernel("after", 2100.0, 100.0)]
    tr = Tracer(True, torch.device("cpu"))
    with tr.span("search_vectors"):
        pass
    s = tr._reduce(events, 10.0, 10.001)
    assert s.tie == "markers"
    assert math.isclose(s.window_s, 1000e-6)
    # 100 us of "before" inside, two sweeps, the copy; no marker, nothing after
    assert math.isclose(s.busy_s, (100 + 300 + 300 + 50) * 1e-6)
    assert {n for n, _, _ in s.kernels} == {"before", "b2"}
    assert math.isclose(sum(g for _, g in s.idle_gaps), s.window_s - s.busy_s)


def test_card_slice_without_markers_takes_the_work_extent():
    s = Tracer(True, torch.device("cpu"))._reduce(
        [_kernel("b2", 100.0, 300.0), _kernel("b2", 500.0, 300.0)], 0.0, 0.001)
    assert s.tie == "extent" and math.isclose(s.window_s, 700e-6)
    assert math.isclose(s.busy_s, 600e-6)


def test_rate_before_the_slice():
    rec = {"t0": 100.0, "call_ends": [100.5, 101.0, 101.5, 102.0, 103.0, 104.5, 105.0]}
    assert before_slice(rec, None) == (7, 5.0)
    assert before_slice(rec, (102.2, 104.0)) == (4, 2.0)
    assert before_slice(rec, (100.1, 101.0)) is None
    assert slice_note(rec, (102.2, 104.2)) == \
        "profiler: 2.000 calls/s before the slice, 0.500 inside it"
    assert slice_note(rec, None) is None


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(3))
    y = _fp8(x)
    scale = x.abs().amax(-1, keepdim=True) / 448.0
    normal = x.abs() >= scale * 2.0 ** -6          # e4m3's smallest normal, scaled
    rel = ((y - x).abs() / x.abs())[normal]
    assert rel.max() <= 2.0 ** -4 + 1e-6 and rel.max() > 2.0 ** -5
    torch.testing.assert_close(y.abs().amax(-1), x.abs().amax(-1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", sorted((REPO / "perfbench" / "traffic").glob("*.json")),
                         ids=lambda p: p.name)
def test_every_driver_has_its_control(path):
    mod = importlib.import_module(f"perfbench.drivers.{json.loads(path.read_text())['driver']}")
    assert callable(mod.run) and callable(mod.control)
