"""Parity of the PyTorch port's int8 search (kernel B2's module) with the JAX
package, bit for bit.

The int8 metric is integer math, exact in f32 (``ops/quant.py``), so ids
and scores must EQUAL the JAX package's: ``np.testing.assert_array_equal``
everywhere, including rows that tie exactly (duplicated rows quantize to
the same int8 row, and both packages return equal scores lowest index
first). The JAX side runs its Pallas kernel in interpret mode, its XLA
backend, and its full-matrix reference; the port's sweep runs its plain
torch version on CPU tensors. The CUDA kernel itself is compared with its
plain version on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from intelligent_video_analysis_retrieval_system_tpu.index import unified as junified
from intelligent_video_analysis_retrieval_system_tpu.ops import quant as jq
from intelligent_video_analysis_retrieval_system_tpu.ops import topk as jtopk
from intelligent_video_analysis_retrieval_system_tpu_torch.index import unified as tunified
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import quant as tq
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)


def _corpus(rng, n, d, dups=True):
    """Unit rows with groups of exact duplicates (exact int8 ties) spread
    over several chunks and tiles."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if dups:
        for src, dst in ((4000, (7, 100, 2500, 2600)), (5, (6, 3000, 4090))):
            for r in dst:
                if r < n and src < n:
                    x[r] = x[src]
    return x


def _jax_chunk_max(xi, xs, qi, n_valid, dead):
    """The JAX package's Pallas B2 in interpret mode, set up as its
    ``_build_int8_searcher`` sets it up."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n_pad, d = xi.shape
    b = qi.shape[0]
    tile = jtopk.TILE_N
    sweep = pl.pallas_call(
        jq._int8_sweep_kernel,
        grid=(n_pad // tile,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((tile, d), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((b, d), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile // jtopk.CHUNK, b), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_pad // jtopk.CHUNK, b), jnp.float32),
        interpret=True,
    )
    return np.asarray(sweep(jnp.asarray([n_valid], jnp.int32), jnp.asarray(xi),
                            jnp.asarray(xs).reshape(-1, 1), jnp.asarray(qi),
                            jnp.asarray(dead).reshape(-1, 1)))


def test_symmetric_int8_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 96)).astype(np.float32) * rng.uniform(
        1e-3, 30, (40, 1)).astype(np.float32)
    x[0] = 0.0                                   # zero row: the eps scale
    x[1, :4] = [127.0, 63.5, -0.5, 1.5]          # exact halves: round half to even
    for axis in (-1, 0):
        jqv, jsc = jq.symmetric_int8(jnp.asarray(x), axis=axis)
        tqv, tsc = tq.symmetric_int8(torch.from_numpy(x), dim=axis)
        assert tqv.dtype == torch.int8
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    jq8, jqs = jq._quantize_q(jnp.asarray(x))
    tq8, tqs = tq._quantize_q(torch.from_numpy(x))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))


def test_quantize_rows_and_fold_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 48)).astype(np.float32)
    x[3] = 0.0
    jrows, jsc = jq.quantize_rows_int8(x)
    trows, tsc = tq.quantize_rows_int8(x)
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(tsc, jsc)
    # the numpy twin and the torch quantizer agree
    t8, ts = tq.symmetric_int8(torch.from_numpy(x), dim=-1)
    np.testing.assert_array_equal(t8.numpy(), trows)
    np.testing.assert_array_equal(ts.numpy()[:, 0], tsc)
    np.testing.assert_array_equal(tq.dequantize_rows_int8(trows, tsc),
                                  jq.dequantize_rows_int8(jrows, jsc))
    np.testing.assert_array_equal(tunified._fold_norm_into_scales(trows, tsc),
                                  junified._fold_norm_into_scales(jrows, jsc))
    for n in (1, 2048, 2049, 5000):
        jp = jq.pad_rows_int8(*jq.quantize_rows_int8(x[:1].repeat(n, 0)))
        tp = tq.pad_rows_int8(*tq.quantize_rows_int8(x[:1].repeat(n, 0)))
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_valid", [6000, 4500])
def test_chunk_max_plain_matches_jax_pallas_interpret(n_valid):
    rng = np.random.default_rng(2)
    x = _corpus(rng, 6000, 64)
    xi, xs = tq.pad_rows_int8(*tq.quantize_rows_int8(x))
    qi, _ = tq.quantize_rows_int8(rng.standard_normal((8, 64)).astype(np.float32))
    dead = (rng.random(len(xi)) < 0.02).astype(np.int8)
    want = _jax_chunk_max(xi, xs, qi, n_valid, dead)
    got = tq.int8_chunk_max_sweep(torch.from_numpy(xi), torch.from_numpy(xs),
                                  torch.from_numpy(qi), n_valid, torch.from_numpy(dead))
    assert got.shape == want.shape == (len(xi) // ttopk.CHUNK, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(want[n_valid // ttopk.CHUNK + 1:]).all()


@pytest.mark.parametrize("backend", ["pallas", "xla"])   # the JAX package's phase 1
@pytest.mark.parametrize("k", [1, 7, 64, 300])
def test_topk_search_int8_matches_jax(backend, k):
    rng = np.random.default_rng(3)
    n, d, n_valid = 6000, 64, 5500
    x = _corpus(rng, n, d)
    xi, xs = tq.pad_rows_int8(*tq.quantize_rows_int8(x))
    q = rng.standard_normal((5, d)).astype(np.float32)      # B=5: not a bucket
    q[0] = x[4000]                                           # hits a tie group
    q[1] = x[5] + 0.01
    dead = (rng.random(n) < 0.02).astype(np.int8)
    dead[[7, 100, 2500, 2600, 4000, 5, 6, 3000, 4090]] = 0
    dead[2600] = 1                                           # one tie member dead
    jkw = dict(n_valid=n_valid, deleted=jnp.asarray(dead), use_pallas=True,
               backend=backend, interpret=backend == "pallas")
    want = jq.topk_search_int8(jnp.asarray(xi), jnp.asarray(xs), jnp.asarray(q), k, **jkw)
    got = tq.topk_search_int8(torch.from_numpy(xi), torch.from_numpy(xs),
                              torch.from_numpy(q), k, n_valid=n_valid,
                              deleted=torch.from_numpy(dead), use_pallas=True)
    assert got.indices.shape == (5, k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.indices[0, :3].tolist() == [7, 100, 2500][:k]  # the tie, lowest row first


@pytest.mark.parametrize("block", [None, 1024])
def test_int8_reference_matches_jax(monkeypatch, block):
    if block is not None:   # several blocks: the running top-k merges ties
        monkeypatch.setattr(tq, "_PLAIN_ROWS", block)
    rng = np.random.default_rng(4)
    x = _corpus(rng, 4500, 32)
    xi, xs = tq.quantize_rows_int8(x)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    q[2] = x[4000]
    dead = (rng.random(4500) < 0.05).astype(np.int8)
    dead[[7, 100, 2500, 2600, 4000]] = 0
    for k in (1, 4, 50):
        want = jq._int8_reference(jnp.asarray(xi), jnp.asarray(xs), jnp.asarray(q), k,
                                  deleted=jnp.asarray(dead))
        got = tq.int8_reference(torch.from_numpy(xi), torch.from_numpy(xs),
                                torch.from_numpy(q), k, deleted=torch.from_numpy(dead))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.indices[2, :5].tolist() == [7, 100, 2500, 2600, 4000]


def test_cpu_dispatch_takes_the_reference_like_jax():
    rng = np.random.default_rng(5)
    x = _corpus(rng, 3000, 32)
    xi, xs = tq.pad_rows_int8(*tq.quantize_rows_int8(x))
    q = rng.standard_normal((4, 32)).astype(np.float32)
    q[0] = x[5]
    dead = np.zeros((len(xi), 1), np.int8)
    dead[[10, 11, 6]] = 1
    # use_pallas=None: JAX serves the CPU by its reference, and so does the port
    want = jq.topk_search_int8(jnp.asarray(xi), jnp.asarray(xs), jnp.asarray(q), 12,
                               n_valid=2900, deleted=jnp.asarray(dead))
    got = tq.topk_search_int8(torch.from_numpy(xi), torch.from_numpy(xs),
                              torch.from_numpy(q), 12, n_valid=2900,
                              deleted=torch.from_numpy(dead))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_k_beyond_live_rows_and_empty():
    rng = np.random.default_rng(6)
    x = _corpus(rng, 300, 16, dups=False)
    xi, xs = tq.pad_rows_int8(*tq.quantize_rows_int8(x))
    q = rng.standard_normal((2, 16)).astype(np.float32)
    for use_pallas in (True, None):
        want = jq.topk_search_int8(jnp.asarray(xi), jnp.asarray(xs), jnp.asarray(q), 150,
                                   n_valid=100, use_pallas=use_pallas,
                                   interpret=bool(use_pallas))
        got = tq.topk_search_int8(torch.from_numpy(xi), torch.from_numpy(xs),
                                  torch.from_numpy(q), 150, n_valid=100,
                                  use_pallas=use_pallas)
        assert got.indices.shape == (2, 100)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    empty = tq.topk_search_int8(torch.from_numpy(xi), torch.from_numpy(xs),
                                torch.from_numpy(q), 5, n_valid=0)
    assert empty.scores.shape == (2, 0) and empty.indices.shape == (2, 0)


def test_tie_order_matches_lax_top_k():
    rng = np.random.default_rng(7)
    scores = rng.integers(0, 6, (4, 5000)).astype(np.float32)   # ties everywhere
    scores[0, [7, 10, 2500, 4000]] = 9.0
    for k in (1, 4, 37):
        wv, wi = lax.top_k(jnp.asarray(scores), k)
        tv, ti = ttopk.topk_lowest_index_first(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    assert ti[0, :4].tolist() == [7, 10, 2500, 4000]


def test_non_cpu_tensor_never_takes_the_plain_version():
    x = torch.zeros((ttopk.TILE_N, 16), dtype=torch.int8, device="meta")
    xs = torch.zeros((ttopk.TILE_N,), device="meta")
    q = torch.zeros((2, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tq.int8_chunk_max_sweep(x, xs, q, 10)
    with pytest.raises(ValueError):   # not even when asked for the reference
        tq.topk_search_int8(x, xs, torch.zeros((2, 16), device="meta"), 3,
                            use_pallas=False)


def test_bad_input_rejected():
    x = torch.zeros((100, 16), dtype=torch.int8)
    with pytest.raises(ValueError):   # not padded to TILE_N
        tq.int8_chunk_max_sweep(x, torch.ones(100), torch.zeros((2, 16), dtype=torch.int8), 10)
    x = torch.zeros((ttopk.TILE_N, 16), dtype=torch.int8)
    with pytest.raises(ValueError):   # float queries
        tq.int8_chunk_max_sweep(x, torch.ones(ttopk.TILE_N), torch.zeros((2, 16)), 10)
    with pytest.raises(ValueError):   # scales of the wrong length
        tq.int8_chunk_max_sweep(x, torch.ones(10), torch.zeros((2, 16), dtype=torch.int8), 10)
    with pytest.raises(ValueError):   # the two-phase search wants padded rows
        tq.topk_search_int8(x[:100], torch.ones(100), torch.zeros((2, 16)), 3,
                            use_pallas=True)
