"""The kernel lab's build flags are ones the kernel sources read.

``ops/kernel_lab.py`` builds ``csrc/`` once more per experiment with
``-DIVARS_LAB_...`` flags and measures the result on the card. Here, without
a card: every flag an experiment passes names a macro that ``csrc/`` tests,
every part a timing-only build leaves out has its constant in
``csrc/lab.cuh`` and its use in ``csrc/ln_mlp.cu``, and the library the port
loads is built with none of them.
"""

import re
from pathlib import Path

import pytest

from intelligent_video_analysis_retrieval_system_tpu_torch.ops import kernel_lab, kernels

CSRC = Path(kernel_lab.__file__).resolve().parent.parent / "csrc"
SOURCES = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu*"))}


@pytest.mark.parametrize("name", sorted(kernel_lab.EXPERIMENTS))
def test_every_flag_of_an_experiment_is_read_by_the_sources(name):
    _, variants = kernel_lab.EXPERIMENTS[name]
    assert variants
    for variant, flags, what in variants:
        assert variant and what
        for flag in flags:
            macro = re.fullmatch(r"-D(IVARS_LAB_[A-Z_]+)(=\d+)?", flag)
            assert macro, flag
            tested = re.compile(r"#\s*if(n?def)?\s+.*\b" + macro.group(1) + r"\b")
            assert any(tested.search(text) for text in SOURCES.values()), flag


@pytest.mark.parametrize("part", sorted(kernel_lab._SKIP))
def test_every_part_a_timing_only_build_leaves_out_is_wired(part):
    bit = kernel_lab._SKIP[part]
    found = re.search(r"constexpr bool (kLab\w+) = \(IVARS_LAB_SKIP & %d\) != 0;" % bit,
                      SOURCES["lab.cuh"])
    assert found, (part, bit)
    assert found.group(1) in SOURCES["ln_mlp.cu"]
    assert kernel_lab._skip(part) == (f"-DIVARS_LAB_SKIP={bit}",)


def test_parts_add_up_in_one_flag():
    assert kernel_lab._skip("products", "activation", "loads") == ("-DIVARS_LAB_SKIP=7",)


def test_the_port_builds_without_any_lab_flag():
    assert not any("IVARS_LAB" in flag for flag in kernels.NVCC_FLAGS)
    # a trace build exports the entry points that install the stamp buffer;
    # nothing binds them in the library the port loads
    for setter in ("ivars_ln_mlp_set_stamps", "ivars_mha_set_stamps"):
        assert any(f"LAB_EXPORT_STAMPS({setter})" in text for text in SOURCES.values())
        assert setter not in (CSRC.parent / "ops" / "kernels.py").read_text()


def test_unknown_experiment_is_refused():
    with pytest.raises(SystemExit):
        kernel_lab.main(["b5-trace"])


def test_b1_probes_leave_out_parts_that_chunk_max_reads():
    _, variants = kernel_lab.EXPERIMENTS["b1-probes"]
    parts = {"no_products": "kLabSkipProducts", "no_loads": "kLabSkipLoads"}
    for variant, flags, what in variants:
        assert what == "b1-time"
        if variant in parts:
            assert parts[variant] in SOURCES["chunk_max.cu"]
            assert re.search(r"constexpr bool %s = \(IVARS_LAB_SKIP & (\d+)\)" % parts[variant],
                             SOURCES["lab.cuh"]).group(1) == flags[0].split("=")[1]
        else:
            assert flags == ()
