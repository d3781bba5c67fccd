"""The bench probes' plain versions against the TPU kernels they replace.

- P1 ``probe_int8_mma_sweep``: equals ``benchmarks/exp_int8.py:_mxu_kernel``
  run in interpret mode (the file is loaded with importlib and the kernel
  wrapped in this test's own ``pl.pallas_call``), atol 0, with ``n_valid``
  inside a chunk; and equals kernel B2's plain version under an all-zero
  tombstone mask.
- P2 and P3: ``conv_kernel`` and the stream kernel are closures inside
  functions that need the TPU, so their expressions are written out here in
  ``jnp`` / numpy. P2: within ``1e-5 x max |score|`` (bf16 products summed in
  f32, in another order); P3: equal.

On the CPU every wrapper takes its plain version (the CUDA kernels are held
against the same plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py), for every ``rows_per_block`` and ``blocks_per_sm``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.bench import probes
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 128


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(n_pad: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n_pad, d), dtype=np.int8)
    xs = ((rng.random(n_pad, dtype=np.float32) * 0.2 + 0.9) / 127.0).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    qs = np.maximum(np.abs(q).max(axis=-1), 1e-12) / 127.0
    q_i8 = np.clip(np.rint(q / qs[:, None]), -127, 127).astype(np.int8)
    return x, xs, q, q_i8


def _jax_mxu(exp_int8, x, xs, q_i8, n_valid: int, tile_n: int):
    """``_mxu_kernel`` in interpret mode, set up as ``build_mxu_sweep`` does."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n_pad, d = x.shape
    sweep = pl.pallas_call(
        exp_int8._mxu_kernel,
        grid=(n_pad // tile_n,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((tile_n, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile_n, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((8, d), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile_n // CHUNK, 8), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_pad // CHUNK, 8), jnp.float32),
        interpret=True,
    )
    return np.asarray(sweep(jnp.asarray([n_valid], jnp.int32), jnp.asarray(x),
                            jnp.asarray(xs).reshape(-1, 1), jnp.asarray(q_i8)))


@pytest.mark.parametrize("n_valid", [4096, 4000, 2048 + 77, 1])
def test_p1_plain_equals_the_mxu_kernel_in_interpret_mode(n_valid):
    exp_int8 = _load("exp_int8")
    assert exp_int8.CHUNK == CHUNK
    x, xs, _, q_i8 = _inputs(4096, 96)
    want = _jax_mxu(exp_int8, x, xs, q_i8, n_valid, tile_n=2048)
    tx, ts, tq8 = torch.from_numpy(x), torch.from_numpy(xs), torch.from_numpy(q_i8)
    got = probes.probe_int8_mma_sweep_plain(tx, ts, tq8, n_valid)
    assert got.shape == (4096 // CHUNK, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(want[-(-n_valid // CHUNK):]).all()      # chunks past n_valid
    assert np.isfinite(want[(n_valid - 1) // CHUNK]).all()     # the ragged chunk is live
    # the wrapper on CPU tensors, scales as the TPU kernel takes them: (n_pad, 1)
    for rpb in (128, 256, 512):
        again = probes.probe_int8_mma_sweep(tx, ts.reshape(-1, 1), tq8, n_valid, rpb)
        np.testing.assert_array_equal(again.numpy(), want)
    # P1 is B2 without tombstones
    b2 = tq.int8_chunk_max_plain(tx, ts, tq8, n_valid, torch.zeros(4096, dtype=torch.int8))
    assert torch.equal(got, b2)


def test_p2_plain_matches_the_convert_kernels_expression():
    x, xs, q, _ = _inputs(4096, 96, seed=1)
    n_valid = 4000
    qb = jnp.asarray(q, jnp.bfloat16)
    # benchmarks/exp_int8.py conv_kernel, over the whole array as one tile
    scores = jnp.dot(jnp.asarray(x).astype(jnp.bfloat16), qb.T,
                     preferred_element_type=jnp.float32) * jnp.asarray(xs)[:, None]
    scores = jnp.where(jnp.arange(4096)[:, None] < n_valid, scores, -jnp.inf)
    want = np.asarray(jnp.max(scores.reshape(-1, CHUNK, 8), axis=1))
    tqb = torch.from_numpy(q).to(torch.bfloat16)
    np.testing.assert_array_equal(tqb.float().numpy(), np.asarray(qb.astype(jnp.float32)))
    got = probes.probe_int8_convert_sweep(torch.from_numpy(x), torch.from_numpy(xs), tqb,
                                          n_valid, 256).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    tol = 1e-5 * float(np.abs(want[fin]).max())
    err = float(np.abs(got[fin] - want[fin]).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name,d,dtype", [("bf16", 768, torch.bfloat16),
                                          ("i8", 768, torch.int8),
                                          ("i32", 192, torch.int32)])
def test_p3_plain_equals_the_stream_kernels_last_write(name, d, dtype):
    tile_n = 64
    n = 5 * tile_n + 13            # a ragged tail the grid never visits
    rng = np.random.default_rng(2)
    if name == "bf16":
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    else:
        x = torch.from_numpy(rng.integers(-100, 100, (n, d)).astype(np.int32)).to(dtype)
    # benchmarks/exp_stream_bw.py: every grid step writes out block (0, 0) =
    # x_tile[:8, :128] as f32, so the last of n // tile_n steps decides
    host = x.float().numpy()
    want = None
    for step in range(n // tile_n):
        want = host[step * tile_n:(step + 1) * tile_n][:8, :128].astype(np.float32)
    for bpsm in (1, 2, 4):
        got = probes.probe_stream(x, tile_n, bpsm)
        assert got.shape == (8, 128) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probes.probe_stream_plain(x, tile_n).numpy(), want)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    x, xs, q, q_i8 = (torch.from_numpy(a) for a in _inputs(2048, 64))
    with pytest.raises(ValueError):
        probes.probe_int8_mma_sweep(x, xs, q_i8[:4], 2048)              # not 8 queries
    with pytest.raises(ValueError):
        probes.probe_int8_mma_sweep(x, xs, q_i8, 2048, rows_per_block=192)
    with pytest.raises(ValueError):
        probes.probe_int8_mma_sweep(x[:2000], xs[:2000], q_i8, 2000, 512)  # ragged rows
    with pytest.raises(ValueError):
        probes.probe_int8_convert_sweep(x, xs, q_i8, 2048)              # int8 query
    with pytest.raises(ValueError):
        probes.probe_int8_convert_sweep(x, xs[:5], q.to(torch.bfloat16), 2048)
    with pytest.raises(ValueError):
        probes.probe_stream(x.float(), 64)                              # dtype
    with pytest.raises(ValueError):
        probes.probe_stream(x[:, :64], 64)                              # under 128 columns
    with pytest.raises(ValueError):
        probes.probe_stream(x, 4096)                                    # no whole tile


def test_run_probes_reports_every_variant_on_the_cpu():
    out = probes.run_probes(torch.device("cpu"), rows=3000, dim=64, stream_bytes=600 * 768)
    assert out["timer"] == "host_clock" and out["rows"] == 4096 and out["n_valid"] == 4093
    names = set(out["variants"])
    assert names == {"A_b2_topk_search_int8"} | {
        f"{p}_rows{r}" for p in ("P1_int8_mma", "P2_int8_convert") for r in (128, 256, 512)} | {
        f"P3_stream_{t}_blocks{b}" for t in ("bf16", "i8", "i32") for b in (1, 2, 4)}
    assert all(v["ms"] > 0 and v["gbps"] > 0 for v in out["variants"].values())
    assert out["stream_gbps"] == max(v["gbps"] for k, v in out["variants"].items()
                                     if k.startswith("P3_"))
    # no launch counted: CPU tensors take the plain versions
    assert (probes.probe_int8_mma_sweep.launches, probes.probe_int8_convert_sweep.launches,
            probes.probe_stream.launches) == (0, 0, 0)


def test_run_probes_hands_its_check_the_inputs_and_outputs_it_timed():
    seen = []

    def check(kind, **given):
        if kind == "sweeps":
            x, xs, n_valid = given["x_i8"], given["xs"], given["n_valid"]
            assert sorted(given["outs"]) == [128, 256, 512]
            for got1, got2 in given["outs"].values():
                assert torch.equal(got1, probes.probe_int8_mma_sweep_plain(
                    x, xs, given["q_i8"], n_valid))
                assert torch.equal(got2, probes.probe_int8_convert_sweep_plain(
                    x, xs, given["q_bf16"], n_valid))
            seen.append(kind)
        else:
            assert kind == "stream" and sorted(given["outs"]) == [1, 2, 4]
            for got in given["outs"].values():
                assert torch.equal(got, probes.probe_stream_plain(given["x"], given["tile"]))
            seen.append(given["name"])

    probes.run_probes(torch.device("cpu"), rows=3000, dim=64, stream_bytes=600 * 768,
                      check=check)
    assert seen == ["sweeps", "bf16", "i8", "i32"]
