"""Parity of the PyTorch port's top-k search (kernel B1's module) with the
JAX package.

The same numpy inputs go through the JAX functions (the Pallas chunk-max
sweep in interpreter mode, as tests/test_ops.py runs it) and through the
port, whose sweep runs its plain torch version on CPU tensors. Tolerances:
chunk maxima f32 1e-5; top-k ids exact in f32 where scores are distinct,
tie-aware (candidate set + sorted scores within 5e-4) in bf16.

The CUDA kernel itself is compared with its plain version on a card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import normalize as jnorm
from intelligent_video_analysis_retrieval_system_tpu.ops import topk as jtopk
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import normalize as tnorm
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import topk as ttopk
from intelligent_video_analysis_retrieval_system_tpu_torch.testing import tie_aware_equal

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both(a: np.ndarray, dtype: str):
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_max_matches_jax_interpret(dtype):
    rng = np.random.default_rng(1)
    n, d, b, n_valid = 4096, 64, 5, 3000
    xj, xt = _both(_normed(rng, n, d), dtype)
    qj, qt = _both(_normed(rng, b, d), dtype)
    want = np.asarray(jtopk.chunk_max_sweep(xj, qj, n_valid=n_valid, interpret=True))
    got = ttopk.chunk_max_sweep(xt, qt, n_valid).numpy()
    assert got.shape == want.shape == (n // ttopk.CHUNK, b)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 10, 100])
def test_topk_search_matches_jax(dtype, k):
    rng = np.random.default_rng(2)
    n, d, b, n_valid = 6000, 32, 5, 5500   # B=5 is not a bucket size
    x = _normed(rng, n, d)
    q = _normed(rng, b, d)
    dead = (rng.random(n) < 0.02).astype(np.int8)
    # tombstone each query's best live row, so masking decides the answer
    best = np.argmax(np.where(np.arange(n) < n_valid, q @ x.T, -np.inf), axis=1)
    dead[best] = 1
    xj, xt = _both(x, dtype)
    qj, qt = _both(q, dtype)
    want = jtopk.topk_search(xj, qj, k, n_valid=n_valid, use_pallas=True,
                             interpret=True, deleted=jnp.asarray(dead))
    got = ttopk.topk_search(xt, qt, k, n_valid=n_valid, deleted=torch.from_numpy(dead))
    w_ids, w_sc = np.asarray(want.indices), np.asarray(want.scores)
    g_ids, g_sc = got.indices.numpy(), got.scores.numpy()
    assert g_ids.shape == w_ids.shape == (b, k)
    assert not np.isin(g_ids, np.flatnonzero(dead)).any()
    assert (g_ids < n_valid).all()
    for i in range(b):
        if dtype == "float32":
            np.testing.assert_allclose(g_sc[i], w_sc[i], atol=1e-6)
            distinct = np.diff(w_sc[i]) < -1e-6
            np.testing.assert_array_equal(g_ids[i][:-1][distinct], w_ids[i][:-1][distinct])
        else:
            tie_aware_equal(g_ids[i], g_sc[i], w_ids[i], w_sc[i])


def test_buckets_and_padding_match_jax():
    for b in list(range(1, 140)) + [200, 257, 513]:
        assert ttopk.bucket_b(b) == jtopk.bucket_b(b)
    for k in list(range(1, 300)) + [1000]:
        assert ttopk.bucket_k(k) == jtopk.bucket_k(k)
    rng = np.random.default_rng(3)
    for n in (1, 2048, 2049, 5000):
        x = rng.standard_normal((n, 8)).astype(np.float32)
        np.testing.assert_array_equal(
            ttopk.pad_database(torch.from_numpy(x)).numpy(),
            np.asarray(jtopk.pad_database(jnp.asarray(x))))
    q = rng.standard_normal((11, 8)).astype(np.float32)
    np.testing.assert_array_equal(ttopk.pad_queries(torch.from_numpy(q)).numpy(),
                                  np.asarray(jtopk.pad_queries(jnp.asarray(q))))


def test_reference_oracles_match_jax():
    rng = np.random.default_rng(4)
    x, q = _normed(rng, 700, 24), _normed(rng, 3, 24)
    dead = (rng.random(700) < 0.1).astype(np.int8)
    want = jtopk.topk_exact_reference(jnp.asarray(x), jnp.asarray(q), 15)
    got = ttopk.topk_exact_reference(torch.from_numpy(x), torch.from_numpy(q), 15)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
    want = jtopk.topk_masked_reference(jnp.asarray(x), jnp.asarray(q), 15,
                                       jnp.int32(650), deleted=jnp.asarray(dead))
    got = ttopk.topk_masked_reference(torch.from_numpy(x), torch.from_numpy(q), 15,
                                      650, deleted=torch.from_numpy(dead))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)


def test_k_beyond_live_rows_and_empty():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_normed(rng, 40, 16))
    q = torch.from_numpy(_normed(rng, 2, 16))
    res = ttopk.topk_search(x, q, 100, n_valid=30)
    assert res.indices.shape == (2, 30)
    assert (res.indices < 30).all()
    empty = ttopk.topk_search(x, q, 5, n_valid=0)
    assert empty.scores.shape == (2, 0)


def test_cosine_topk_self_retrieval():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((300, 16)).astype(np.float32) * 3.0
    res = ttopk.cosine_topk(torch.from_numpy(x), torch.from_numpy(x[:4]), 1)
    np.testing.assert_array_equal(res.indices.numpy()[:, 0], np.arange(4))
    want = jtopk.cosine_topk(jnp.asarray(x), jnp.asarray(x[:4]), 3)
    got = ttopk.cosine_topk(torch.from_numpy(x), torch.from_numpy(x[:4]), 3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_normalize_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 33)).astype(np.float32) * 5
    x[0] = 0.0  # zero row stays finite
    xj, xt = _both(x, dtype)
    want = np.asarray(jnorm.l2_normalize(xj).astype(jnp.float32))
    got = tnorm.l2_normalize(xt).float().numpy()
    assert tnorm.l2_normalize(xt).dtype == xt.dtype
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 1e-2)


def test_non_cpu_tensor_never_takes_the_plain_version():
    # a tensor that is not on the CPU must launch the kernel or raise:
    # the meta device has no kernel, so the wrapper refuses it
    x = torch.zeros((ttopk.TILE_N, 16), device="meta")
    q = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError):
        ttopk.chunk_max_sweep(x, q, 10)


def test_unpadded_rows_rejected():
    with pytest.raises(ValueError):
        ttopk.chunk_max_sweep(torch.zeros((100, 16)), torch.zeros((2, 16)), 10)
