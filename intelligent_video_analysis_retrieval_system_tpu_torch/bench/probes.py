"""The bench probes: how fast the card streams int8 rows, three ways.

Ports of the Pallas kernels of the JAX package's bench experiments
(``benchmarks/exp_int8.py`` and ``benchmarks/exp_stream_bw.py``), each a
hand-written CUDA kernel of ``csrc/probes.cu`` beside its plain version:

- **P1** :func:`probe_int8_mma_sweep` (``_mxu_kernel``): int8 rows x 8 int8
  queries -> int32 on the tensor cores, x the f32 row scale, rows at or past
  ``n_valid`` at -inf, max per 128 rows. No tombstones, and the query's own
  scale is left out (it commutes with the max). It is kernel B2 without the
  tombstone load: with an all-zero mask the two agree bit for bit.
- **P2** :func:`probe_int8_convert_sweep` (``conv_kernel``): the int8 rows
  widened to bf16 in registers, bf16 products accumulated in f32 against a
  bf16 query. Not exact (f32 sums in another order): tolerance ``1e-5 x
  max |score|`` against the plain version.
- **P3** :func:`probe_stream` (``exp_stream_bw.kernel``): reads every byte
  of ``x`` once and returns the first 8 x 128 elements of the last tile as
  f32. Its time is the memory stream alone.

``rows_per_block`` (128, 256 or 512) is to P1 and P2 what the tile height
was to the TPU kernels; ``blocks_per_sm`` is P3's knob. Dispatch is by the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from ..ops import kernels
from ..ops.quant import topk_search_int8
from ..ops.topk import _PLAIN_ROWS, CHUNK, TILE_N
from .data import gen_db_int8
from .timing import median_ms

__all__ = [
    "PROBE_QUERIES", "PROBE_ROWS", "STREAM_BYTES",
    "probe_int8_mma_sweep", "probe_int8_mma_sweep_plain",
    "probe_int8_convert_sweep", "probe_int8_convert_sweep_plain",
    "probe_stream", "probe_stream_plain", "probe_queries", "stream_cases",
    "run_probes", "ProbeCheck",
]

PROBE_QUERIES = 8
PROBE_ROWS = 2_097_152          # the sweeps' rows (x 768 int8 = 1.61 GB)
STREAM_BYTES = 1_610_612_736    # 1.5 GiB per stream case
ROWS_PER_BLOCK = (128, 256, 512)
BLOCKS_PER_SM = (1, 2, 4)
_STREAM_DTYPES = {torch.bfloat16: 0, torch.int8: 1, torch.int32: 2}
ProbeCheck = Callable[..., None]   # see run_probes


def _masked_chunk_max(scores: torch.Tensor, start: int, n_valid: int) -> torch.Tensor:
    """(rows, B) scores of rows ``start..`` -> (rows / CHUNK, B) maxima with
    rows at or past ``n_valid`` at -inf."""
    alive = torch.arange(start, start + scores.shape[0], device=scores.device) < n_valid
    scores = scores.masked_fill(~alive[:, None], float("-inf"))
    return scores.reshape(-1, CHUNK, scores.shape[1]).amax(1)


def _check_sweep(x_i8, xs, q, q_dtype, rows_per_block):
    n_pad, d = x_i8.shape
    if x_i8.dtype != torch.int8 or q.dtype != q_dtype or tuple(q.shape) != (PROBE_QUERIES, d):
        raise ValueError(f"want int8 rows and ({PROBE_QUERIES}, {d}) {q_dtype} queries, got "
                         f"x {tuple(x_i8.shape)} {x_i8.dtype}, q {tuple(q.shape)} {q.dtype}")
    if rows_per_block % CHUNK != 0 or rows_per_block <= 0 or n_pad % rows_per_block != 0:
        raise ValueError(f"{n_pad} rows are not whole blocks of {rows_per_block} rows, "
                         f"a multiple of {CHUNK}")
    xs = xs.reshape(-1)
    if xs.shape[0] != n_pad or xs.dtype != torch.float32:
        raise ValueError(f"scales {tuple(xs.shape)} {xs.dtype}: want {n_pad} float32")
    return xs


def _launch_sweep(name: str, x_i8, xs, q, n_valid: int, rows_per_block: int) -> torch.Tensor:
    n_pad, d = x_i8.shape
    if x_i8.device.type != "cuda" or {q.device, xs.device} != {x_i8.device}:
        raise ValueError(f"{name}: x on {x_i8.device}, q on {q.device}, scales on {xs.device}")
    if d % 16 != 0:
        raise ValueError(f"{name}: row of {d} int8 is not a multiple of 16 bytes")
    x_i8, xs, q = x_i8.contiguous(), xs.contiguous(), q.contiguous()
    if x_i8.data_ptr() % 16 != 0 or q.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: x or q is not 16-byte aligned")
    out = torch.empty((n_pad // CHUNK, PROBE_QUERIES), dtype=torch.float32,
                      device=x_i8.device)
    fn = getattr(kernels.load(), f"ivars_{name}")
    with torch.cuda.device(x_i8.device):
        rc = fn(ctypes.c_void_p(x_i8.data_ptr()), ctypes.c_void_p(xs.data_ptr()),
                ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                n_pad, d, rows_per_block, int(n_valid), kernels.stream_of(x_i8))
    kernels.check_launch(rc, name)
    return out


# ---------------------------------------------------------------------------
# P1: int8 x int8 on the tensor cores
# ---------------------------------------------------------------------------


def probe_int8_mma_sweep_plain(x_i8: torch.Tensor, xs: torch.Tensor, q_i8: torch.Tensor,
                               n_valid: int) -> torch.Tensor:
    """Plain P1: ``torch._int_mm`` (int8 x int8 -> int32), the f32 image of
    the exact integer dot times the row scale, masked chunk maxima."""
    xs = xs.reshape(-1)
    qt = q_i8.T.contiguous()
    out = torch.empty((x_i8.shape[0] // CHUNK, q_i8.shape[0]), dtype=torch.float32,
                      device=x_i8.device)
    for s in range(0, x_i8.shape[0], _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, x_i8.shape[0])
        scores = torch._int_mm(x_i8[s:e], qt).float() * xs[s:e, None]
        out[s // CHUNK:e // CHUNK] = _masked_chunk_max(scores, s, n_valid)
    return out


def probe_int8_mma_sweep(x_i8: torch.Tensor, xs: torch.Tensor, q_i8: torch.Tensor,
                         n_valid: int, rows_per_block: int = 128) -> torch.Tensor:
    """P1: (N_pad / 128, 8) f32 chunk maxima of ``(x_i8 . q_i8) * xs`` for
    (N_pad, D) int8 rows, (N_pad,) or (N_pad, 1) f32 scales and (8, D) int8
    queries. CPU tensors take the plain version; CUDA tensors launch the
    kernel (count in ``probe_int8_mma_sweep.launches``)."""
    xs = _check_sweep(x_i8, xs, q_i8, torch.int8, rows_per_block)
    if x_i8.device.type == "cpu":
        return probe_int8_mma_sweep_plain(x_i8, xs, q_i8, n_valid)
    out = _launch_sweep("probe_int8_mma", x_i8, xs, q_i8, n_valid, rows_per_block)
    probe_int8_mma_sweep.launches += 1
    return out


probe_int8_mma_sweep.launches = 0


# ---------------------------------------------------------------------------
# P2: int8 rows widened to bf16, bf16 products
# ---------------------------------------------------------------------------


def probe_int8_convert_sweep_plain(x_i8: torch.Tensor, xs: torch.Tensor,
                                   q_bf16: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain P2: the rows cast to bf16 (exact), an f32-accumulating matmul
    against the bf16 query, times the row scale, masked chunk maxima."""
    xs = xs.reshape(-1)
    qf = q_bf16.float()
    out = torch.empty((x_i8.shape[0] // CHUNK, q_bf16.shape[0]), dtype=torch.float32,
                      device=x_i8.device)
    for s in range(0, x_i8.shape[0], _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, x_i8.shape[0])
        scores = (x_i8[s:e].to(torch.bfloat16).float() @ qf.T) * xs[s:e, None]
        out[s // CHUNK:e // CHUNK] = _masked_chunk_max(scores, s, n_valid)
    return out


def probe_int8_convert_sweep(x_i8: torch.Tensor, xs: torch.Tensor, q_bf16: torch.Tensor,
                             n_valid: int, rows_per_block: int = 128) -> torch.Tensor:
    """P2: as :func:`probe_int8_mma_sweep` with (8, D) bf16 queries and the
    rows widened to bf16 in the kernel (count in
    ``probe_int8_convert_sweep.launches``)."""
    xs = _check_sweep(x_i8, xs, q_bf16, torch.bfloat16, rows_per_block)
    if x_i8.device.type == "cpu":
        return probe_int8_convert_sweep_plain(x_i8, xs, q_bf16, n_valid)
    out = _launch_sweep("probe_int8_convert", x_i8, xs, q_bf16, n_valid, rows_per_block)
    probe_int8_convert_sweep.launches += 1
    return out


probe_int8_convert_sweep.launches = 0


# ---------------------------------------------------------------------------
# P3: the memory stream
# ---------------------------------------------------------------------------


def probe_stream_plain(x: torch.Tensor, tile_n: int) -> torch.Tensor:
    """Plain P3: the first 8 x 128 elements of the last whole tile of
    ``tile_n`` rows, as f32."""
    last = (x.shape[0] // tile_n - 1) * tile_n
    return x[last:last + 8, :128].float()


def probe_stream(x: torch.Tensor, tile_n: int, blocks_per_sm: int = 2) -> torch.Tensor:
    """P3: read every whole tile of ``tile_n`` rows of ``x`` (bf16, int8 or
    int32; at least 128 columns) once and return (8, 128) f32, the head of
    the last tile. CPU tensors take the plain version; CUDA tensors launch
    the kernel on ``blocks_per_sm`` blocks per multiprocessor (count in
    ``probe_stream.launches``)."""
    if x.dim() != 2 or x.dtype not in _STREAM_DTYPES or x.shape[1] < 128:
        raise ValueError(f"probe_stream: want (n, d >= 128) bf16, int8 or int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n_tiles = x.shape[0] // tile_n
    if tile_n < 8 or n_tiles < 1:
        raise ValueError(f"probe_stream: {x.shape[0]} rows hold no tile of {tile_n} >= 8 rows")
    if x.device.type == "cpu":
        return probe_stream_plain(x, tile_n)
    if x.device.type != "cuda":
        raise ValueError(f"probe_stream: unsupported device {x.device}")
    x = x.contiguous()
    d = x.shape[1]
    row_bytes = d * x.element_size()
    n_bytes = n_tiles * tile_n * row_bytes
    if n_bytes % 16 != 0 or x.data_ptr() % 16 != 0:
        raise ValueError("probe_stream: the tiles are not whole, aligned 16-byte vectors")
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    scratch = torch.zeros((1,), dtype=torch.int32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = kernels.load()
    with torch.cuda.device(x.device):
        rc = lib.ivars_probe_stream(
            ctypes.c_void_p(x.data_ptr()), n_bytes,
            ctypes.c_void_p(x.data_ptr() + (n_tiles - 1) * tile_n * row_bytes), d,
            _STREAM_DTYPES[x.dtype], ctypes.c_void_p(out.data_ptr()), 0x9E3779B9,
            ctypes.c_void_p(scratch.data_ptr()), sms * int(blocks_per_sm),
            kernels.stream_of(x))
    kernels.check_launch(rc, "probe_stream")
    probe_stream.launches += 1
    return out


probe_stream.launches = 0


# ---------------------------------------------------------------------------
# the --probes report
# ---------------------------------------------------------------------------


def probe_queries(dim: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """The probes' 8 queries from ``numpy.random.default_rng(0)``: f32, their
    bf16 image (P2) and their per-row symmetric int8 image (P1)."""
    q = np.random.default_rng(0).standard_normal((PROBE_QUERIES, dim)).astype(np.float32)
    qs = np.maximum(np.abs(q).max(axis=-1), 1e-12) / 127.0
    q_i8 = np.clip(np.rint(q / qs[:, None]), -127, 127).astype(np.int8)
    qf = torch.from_numpy(q).to(device)
    return qf, qf.to(torch.bfloat16), torch.from_numpy(q_i8).to(device)


def stream_cases(total_bytes: int, device: torch.device, seed: int = 0):
    """(name, x) for P3's three dtypes at one byte count: (n, 768) bf16,
    (n, 768) int8 and (n, 192) int32, made on the device one at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, d, dtype in (("bf16", 768, torch.bfloat16), ("i8", 768, torch.int8),
                           ("i32", 192, torch.int32)):
        n = total_bytes // (d * torch.empty((), dtype=dtype).element_size())
        if dtype == torch.bfloat16:
            x = torch.empty((n, d), dtype=dtype, device=device)
            for s in range(0, n, 262_144):
                e = min(s + 262_144, n)
                x[s:e].copy_(torch.randn((e - s, d), generator=gen, device=device))
        else:
            x = torch.randint(-100, 100, (n, d), generator=gen, device=device, dtype=dtype)
        yield name, x


def run_probes(device: torch.device, rows: int = PROBE_ROWS, dim: int = 768,
               stream_bytes: int = STREAM_BYTES, check: ProbeCheck | None = None) -> dict:
    """Time every variant (``timing.median_ms``; CUDA events on a card):
    P1 and P2 at 128, 256 and 512 rows per block, the production int8 search
    (kernel B2 through ``topk_search_int8``) beside them, and P3 for three
    dtypes at 1, 2 and 4 blocks per multiprocessor. Rates are GB/s of the
    bytes of ``x``; ``stream_gbps`` is P3's best.

    ``check``, when given, is called once with ``"sweeps"`` after P1 and P2
    (keywords ``x_i8``, ``xs``, ``q_i8``, ``q_bf16``, ``n_valid`` and
    ``outs``: rows per block -> what P1 and P2 returned) and once per stream
    case with ``"stream"`` (``name``, ``x``, ``tile`` and ``outs``: blocks
    per multiprocessor -> what P3 returned), so that a caller can hold the
    timed kernels against their plain versions on the very inputs."""
    n_pad = -(-rows // TILE_N) * TILE_N      # whole blocks of 128, 256 and 512 rows
    # the JAX experiment's 2,000,000 live rows of 2,097,152; else inside a chunk
    n_valid = 2_000_000 if n_pad == PROBE_ROWS else n_pad - 3
    x_i8, xs = gen_db_int8(n_pad, dim, 0, device)
    qf, q_bf, q_i8 = probe_queries(dim, device)
    gb = n_pad * dim / 1e9
    out: dict = {"timer": "cuda_events" if device.type == "cuda" else "host_clock",
                 "rows": n_pad, "dim": dim, "n_valid": n_valid, "variants": {}}

    def record(name: str, fn, gigabytes: float):
        ms = median_ms(fn, device)
        out["variants"][name] = {"ms": ms, "gbps": gigabytes / ms * 1e3}
        return fn()

    record("A_b2_topk_search_int8",
           lambda: topk_search_int8(x_i8, xs, qf, 10, n_valid=n_valid, use_pallas=True), gb)
    outs = {}
    for rpb in ROWS_PER_BLOCK:
        outs[rpb] = (
            record(f"P1_int8_mma_rows{rpb}",
                   lambda: probe_int8_mma_sweep(x_i8, xs, q_i8, n_valid, rpb), gb),
            record(f"P2_int8_convert_rows{rpb}",
                   lambda: probe_int8_convert_sweep(x_i8, xs, q_bf, n_valid, rpb), gb))
    if check is not None:
        check("sweeps", x_i8=x_i8, xs=xs, q_i8=q_i8, q_bf16=q_bf, n_valid=n_valid, outs=outs)
    del x_i8, xs, outs
    for name, x in stream_cases(stream_bytes, device):
        tile = min(2048, x.shape[0])
        sgb = x.shape[0] // tile * tile * x.shape[1] * x.element_size() / 1e9
        outs = {bpsm: record(f"P3_stream_{name}_blocks{bpsm}",
                             lambda: probe_stream(x, tile, bpsm), sgb)
                for bpsm in BLOCKS_PER_SM}
        if check is not None:
            check("stream", name=name, x=x, tile=tile, outs=outs)
        del x, outs
    out["stream_gbps"] = max(v["gbps"] for k, v in out["variants"].items()
                             if k.startswith("P3_"))
    return out
