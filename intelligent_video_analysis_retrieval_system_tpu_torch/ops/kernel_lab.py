"""Kernel lab: where the time of B4 (``csrc/ln_mlp.cu``), B3
(``csrc/mha.cu``) and B1 (``csrc/chunk_max.cu``) goes on the card.

Each experiment builds the kernels once more with a ``-DIVARS_LAB_...`` flag
(``csrc/lab.cuh`` says what each does; the library the port loads is built
without any) in a process of its own, through ``ops.kernels``, whose build
directory is keyed by the flags, and prints one JSON line per result.

    python -m intelligent_video_analysis_retrieval_system_tpu_torch.ops.kernel_lab [what ...]

``what`` (default: every experiment of ``EXPERIMENTS`` marked as such):

- ``b4-scale``: B4's time against the token count at ViT-L/14 widths: how
  many clusters the card runs at a time.
- ``b4-probes``: B4 as it is, without any product, without products and
  activation arithmetic, without the weights' loads as well, without the
  tiles' exchange between the blocks as well, and with no hidden chunk at
  all (LN, the accumulators' start and the store): timing only, the results
  are wrong on purpose. The differences say what each part costs.
- ``b4-handover``: B4 as it is against the same kernel with every hand-over
  of an activation tile at cluster scope (acquire and release), both checked
  against the plain version and timed, twice over in alternation.
- ``b4-trace``: ``clock64`` stamps of one block's fc1 and fc2 warpgroups,
  cycles per phase of a hidden chunk; ``b4-trace-no-products``: the same
  without any product, so that the products' phases show only their waits
  for the weights (not part of the default run).
- ``b3-trace``: the same for one warp of B3, cycles per phase of a 16-row
  query tile.
- ``b3-wgmma-trace``: the same for B3's ``wgmma`` variant at SigLIP so400m/14's
  shape (256 images, 729 tokens, 16 heads of 72): one warp of each consumer
  warpgroup of one block, cycles per phase of a 128-key ring stage in each
  pass of its first item.
- ``b1-probes``: B1 in bf16 over 1,001,472 x 768 rows at B = 8 and 64, as it
  is (checked against the plain version, beside P3's stream and matmul +
  amax over the same rows), without any product (the TMA ring, the masks
  and the max only: the rate a TMA stream reaches on this card) and without
  the rows' loads (the products and the ring's hand-overs alone): timing
  only, the results of the last two are wrong on purpose.
- ``ab FILE.cu VARIANT.cu [VARIANT.cu ...]``: the source as it is against
  variants of it (paths; copies of ``csrc/`` with the file swapped are built
  under ``build/kernel_lab/``), each checked against the plain version and
  timed, twice over in alternation; for comparing designs within one call.

Times are CUDA-graph replays of 20 launches (a kernel shorter than a launch
gap is timed, not the gap).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["EXPERIMENTS", "main"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_LAB = _PKG.parent / "build" / "kernel_lab"

_SKIP = {"products": 1, "activation": 2, "loads": 4, "exchange": 8, "all_chunks": 16}


def _skip(*parts: str) -> tuple[str, ...]:
    return (f"-DIVARS_LAB_SKIP={sum(_SKIP[p] for p in parts)}",)


# name -> (in the default run, [(variant's name, extra nvcc flags, measurement), ...])
EXPERIMENTS: dict[str, tuple[bool, list[tuple[str, tuple[str, ...], str]]]] = {
    "b4-scale": (True, [("as_is", (), "b4-scale")]),
    "b4-probes": (True, [
        ("as_is", (), "b4-time"),
        ("no_products", _skip("products"), "b4-time"),
        ("no_products_no_activation", _skip("products", "activation"), "b4-time"),
        ("no_products_no_activation_no_loads", _skip("products", "activation", "loads"),
         "b4-time"),
        ("skeleton_no_exchange", _skip("products", "activation", "loads", "exchange"), "b4-time"),
        ("head_and_tail_only", _skip("all_chunks"), "b4-time"),
    ]),
    "b4-handover": (True, 2 * [("as_is", (), "b4-check"),
                               ("cluster_scope", ("-DIVARS_LAB_STRICT_HANDOVER",), "b4-check")]),
    "b4-trace": (True, [("b4_trace", ("-DIVARS_LAB_TRACE",), "b4-trace")]),
    "b4-trace-no-products": (False, [("b4_trace_no_products",
                                      ("-DIVARS_LAB_TRACE",) + _skip("products"), "b4-trace")]),
    "b3-trace": (True, [("b3_trace", ("-DIVARS_LAB_TRACE",), "b3-trace")]),
    "b3-wgmma-trace": (True, [("b3_wgmma_trace", ("-DIVARS_LAB_TRACE",), "b3-wgmma-trace")]),
    "b1-probes": (True, [
        ("as_is", (), "b1-time"),
        ("no_products", _skip("products"), "b1-time"),
        ("no_loads", _skip("loads"), "b1-time"),
    ]),
}


def _spawn(name: str, flags: tuple[str, ...], what: str, csrc: Path = _CSRC) -> int:
    """Run one measurement in a process of its own (a process holds one
    build of the kernels): the sources in ``csrc`` built with ``flags``."""
    return subprocess.run([sys.executable, "-m", __spec__.name, "_run", name, str(csrc), what,
                           *flags]).returncode


def _variant_dir(name: str, replace: dict | None = None) -> Path:
    """A copy of ``csrc/`` under ``build/kernel_lab/<name>/`` with the files
    of ``replace`` (name -> path) swapped in."""
    dst = _LAB / name / "csrc"
    if dst.parent.exists():
        shutil.rmtree(dst.parent)
    shutil.copytree(_CSRC, dst)
    for file, path in (replace or {}).items():
        shutil.copy(path, dst / file)
    return dst


# ---------------------------------------------------------------------------
# inside the child process
# ---------------------------------------------------------------------------

def _graph_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _ln_mlp_args(tokens: int, d: int, h: int, gen):
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    return (randn(tokens, d).to(torch.bfloat16), 1.0 + 0.1 * randn(d), 0.1 * randn(d),
            (randn(h, d) / d ** 0.5).to(torch.bfloat16), 0.1 * randn(h),
            (randn(d, h) / h ** 0.5).to(torch.bfloat16), 0.1 * randn(d))


def _stamps(lib, setter: str, rows: int, launch):
    """``launch()`` once to warm up, once with a stamp buffer installed
    (builds with ``-DIVARS_LAB_TRACE`` only); the stamps as lists."""
    import ctypes

    import torch

    set_stamps = getattr(lib, setter)
    set_stamps.argtypes = [ctypes.c_void_p]
    launch()
    stamps = torch.zeros(rows, 256, dtype=torch.int64, device="cuda")
    set_stamps(ctypes.c_void_p(stamps.data_ptr()))
    launch()
    torch.cuda.synchronize()
    set_stamps(ctypes.c_void_p(0))
    return stamps.cpu().tolist()


def _run(name: str, csrc: str, what: str, flags: tuple[str, ...]) -> None:
    import torch

    from . import attention, block, kernels, topk

    # this process builds and loads its own variant of the library
    kernels._CSRC = Path(csrc)
    kernels.NVCC_FLAGS = kernels.NVCC_FLAGS + flags
    lib = kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(**row):
        print(json.dumps({"variant": name, "what": what, **row}), flush=True)

    if what in ("b4-time", "b4-check"):
        for tokens in (2056, 65_792):
            args = _ln_mlp_args(tokens, 1024, 4096, gen)
            row = {"tokens": tokens, "ms": _graph_ms(lambda: block.fused_ln_mlp(*args), 10)}
            if what == "b4-check":
                got, ref = block.fused_ln_mlp(*args), block.fused_ln_mlp_reference(*args)
                row["max_abs_err"] = float((got.float() - ref.float()).abs().max())
                row["ok"] = row["max_abs_err"] <= 0.01 * float(ref.float().abs().max())
            emit(**row)
    elif what == "b3-check":
        for b, t, d, h in ((8, 257, 1024, 16), (256, 257, 1024, 16), (256, 50, 768, 12),
                           (256, 729, 1152, 16), (256, 273, 1152, 16)):
            q, k, v = (torch.randn(b, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            got, ref = attention.fused_mha(q, k, v, h), attention._einsum_attention(q, k, v, h)
            emit(shape=[b, t, d, h], ms=_graph_ms(lambda: attention.fused_mha(q, k, v, h)),
                 ok=bool(torch.allclose(got.float(), ref.float(), atol=2e-2, rtol=2e-2)))
    elif what == "b4-scale":
        w = _ln_mlp_args(64, 1024, 4096, gen)[1:]
        for tokens in (64, 512, 1024, 2048, 2056, 2112, 4096, 4224, 65_792):
            x = torch.randn(tokens, 1024, generator=gen, device="cuda").to(torch.bfloat16)
            emit(tokens=tokens, blocks=block.ln_mlp_plan(tokens, 1024)["blocks"],
                 ms=_graph_ms(lambda: block.fused_ln_mlp(x, *w), 10))
    elif what == "b4-trace":
        args = _ln_mlp_args(65_792, 1024, 4096, gen)
        fc1, fc2 = _stamps(lib, "ivars_ln_mlp_set_stamps", 2, lambda: block.fused_ln_mlp(*args))
        for c in range(2, 30):   # steady state: past the first chunks, before the last
            a, b = fc1[4 * c: 4 * c + 5], fc2[5 * c: 5 * c + 6]
            emit(chunk=c,
                 fc1_warpgroup=dict(zip(("products", "wait_tile_free", "epilogue"),
                                        (a[i + 1] - a[i] for i in range(3))), chunk=a[4] - a[0]),
                 fc2_warpgroup=dict(zip(("wait_pre", "finish_act", "wait_tile", "products"),
                                        (b[i + 1] - b[i] for i in range(4))), chunk=b[5] - b[0]))
    elif what == "b3-trace":
        q, k, v = (torch.randn(256, 257, 1024, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        (s,) = _stamps(lib, "ivars_mha_set_stamps", 1, lambda: attention.fused_mha(q, k, v, 16))
        emit(stage_k=s[1] - s[0])
        for i in range(2, 249, 7):   # seven stamps a tile
            if not s[i + 6]:
                break
            emit(tile=dict(zip(("q_load", "qk", "softmax", "wait_v", "pv", "store"),
                               (s[i + j + 1] - s[i + j] for j in range(6)))))
    elif what == "b3-wgmma-trace":
        q, k, v = (torch.randn(256, 729, 1152, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        rows = _stamps(lib, "ivars_mha_set_stamps", 3, lambda: attention.fused_mha(q, k, v, 16))
        n = 6   # stages of 128 keys a pass at 729 keys
        for wg, s in enumerate(rows):
            # an item's stamps: its start, Q ready; pass 1, per stage: landed,
            # then per 64 keys scores and statistics done; pass 2, per stage:
            # landed, then per 64 keys scores, weights and P V done; then the
            # next item's start
            emit(warpgroup=wg, q_ready=s[1] - s[0], item=s[2 + 12 * n] - s[0],
                 pass1=s[2 + 5 * n] - s[1], pass2=s[1 + 12 * n] - s[1 + 5 * n],
                 store=s[2 + 12 * n] - s[1 + 12 * n])
            for j in range(n):
                a = s[2 + 5 * j: 8 + 5 * j]
                b = s[2 + 5 * n + 7 * j: 9 + 5 * n + 7 * j]
                emit(warpgroup=wg, stage=j,
                     pass1=dict(wait=a[0] - s[1 + 5 * j], qk=a[1] - a[0] + a[3] - a[2],
                                stats=a[2] - a[1] + a[4] - a[3]),
                     pass2=dict(wait=b[0] - s[1 + 5 * n + 7 * j], qk=b[1] - b[0] + b[4] - b[3],
                                weights=b[2] - b[1] + b[5] - b[4],
                                pv=b[3] - b[2] + b[6] - b[5]))
    elif what == "b1-time":
        from ..bench import probes

        n_pad, d, n_valid = 1_001_472, 768, 999_000
        x = torch.randn(n_pad, d, generator=gen, device="cuda")
        x = (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
        dead = (torch.rand(n_pad, generator=gen, device="cuda") < 1e-3).to(torch.int8)
        gb = n_pad * d * 2 / 1e9
        for b in (8, 64):
            q = torch.randn(b, d, generator=gen, device="cuda")
            q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
            ms = _graph_ms(lambda: topk.chunk_max_sweep(x, q, n_valid, dead))
            row = {"b": b, "ms": ms, "gbps": gb / ms * 1e3}
            if name == "as_is":
                got, ref = topk.chunk_max_sweep(x, q, n_valid, dead), \
                    topk.chunk_max_plain(x, q, n_valid, dead)
                fin = torch.isfinite(ref)
                row["max_abs_err"] = float((got[fin] - ref[fin]).abs().max())
                row["ok"] = bool(torch.equal(fin, torch.isfinite(got))) and \
                    row["max_abs_err"] <= 1e-3
                row["library_ms"] = _graph_ms(
                    lambda: (x @ q.T).view(n_pad // topk.CHUNK, topk.CHUNK, b).amax(dim=1))
                if b == 8:   # P3's plain stream over the same bytes, 2 blocks a multiprocessor
                    p3 = _graph_ms(lambda: probes.probe_stream(x, topk.TILE_N, 2))
                    row.update(p3_ms=p3, p3_gbps=gb / p3 * 1e3)
            emit(**row)
    else:
        raise SystemExit(f"kernel_lab: unknown measurement {what!r}")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["_run"]:
        _run(argv[1], argv[2], argv[3], tuple(argv[4:]))
        return 0
    rc = 0
    if argv[:1] == ["ab"]:
        file, variants = argv[1], [Path(v) for v in argv[2:]]
        what = "b3-check" if file == "mha.cu" else "b4-check"
        dirs = [("as_is", _CSRC)] + [(v.stem, _variant_dir(v.stem, {file: v})) for v in variants]
        for _ in range(2):
            for name, csrc in dirs:
                rc |= _spawn(name, (), what, csrc)
        return rc
    names = argv or [name for name, (default, _) in EXPERIMENTS.items() if default]
    unknown = [name for name in names if name not in EXPERIMENTS]
    if unknown:
        raise SystemExit(f"kernel_lab: unknown experiment {unknown[0]!r}")
    for name in names:
        for variant, flags, what in EXPERIMENTS[name][1]:
            rc |= _spawn(variant, flags, what)
    return rc


if __name__ == "__main__":
    sys.exit(main())
