"""Parity of the PyTorch port's fused attention (kernel B3's module) with
the JAX package.

On CPU tensors ``fused_mha`` runs its plain einsum; it is held against the
JAX Pallas kernel in interpreter mode and against JAX's
``_einsum_attention``: f32 within 1e-5, bf16 within 2e-2. The gradient of
the port's ``autograd.Function`` matches ``jax.vjp`` through the JAX custom
VJP in f32 within 1e-4. The CUDA kernel is compared with its plain version
on a card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import attention as jatt
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b=2, t=17, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_interpret(dtype):
    jd, td = _DT[dtype]
    q, k, v = _qkv(0)
    want = jatt.fused_mha(*(jnp.asarray(a, jd) for a in (q, k, v)), 4, True)
    got = tatt.fused_mha(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 4)
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_einsum(dtype):
    jd, td = _DT[dtype]
    q, k, v = _qkv(1, b=3, t=9, d=48)
    want = jatt._einsum_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), 6)
    got = tatt._einsum_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_TOL[dtype], rtol=0)


def test_gradient_matches_jax_vjp():
    q, k, v = _qkv(2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jatt.fused_mha(a, b, c, 4, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tatt.fused_mha(*ts, 4)
    out.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_fused_mha_qkv_matches_jax():
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((2, 16, 96)).astype(np.float32)
    want = jatt.fused_mha_qkv(jnp.asarray(qkv), num_heads=4, interpret=True)
    got = tatt.fused_mha_qkv(torch.from_numpy(qkv), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    q = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        tatt.fused_mha(q, q, q, 2)
