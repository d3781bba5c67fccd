"""Parity of the PyTorch port's fused attention (kernel B3's module) with
the JAX package.

On CPU tensors ``fused_mha`` runs its plain einsum; it is held against the
JAX Pallas kernel in interpreter mode and against JAX's
``_einsum_attention``: f32 within 1e-5, bf16 within 2e-2. The gradient of
the port's ``autograd.Function`` matches ``jax.vjp`` through the JAX custom
VJP in f32 within 1e-4. The CUDA kernel is compared with its plain version
on a card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# the bf16 kernel's host-side choice (which variant for which T) and the
# ragged shapes it special-cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [17, 33])
def test_plain_matches_jax_interpret_at_ragged_tiles(dtype, t):
    # T % 16 == 1: the kernel's last query tile holds one real row; dh = 64
    jd, td = _DT[dtype]
    q, k, v = _qkv(10 + t, b=2, t=t, d=128)
    want = jatt.fused_mha(*(jnp.asarray(a, jd) for a in (q, k, v)), 2, True)
    got = tatt.fused_mha(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("head_dim", [1, 16, 32, 64, 80, 128])
def test_mha_plan_is_total_and_fits_the_card(head_dim):
    for t in list(range(1, 400)) + [577, 1024, 4097, 100_000]:
        plan = tatt.mha_plan(t, head_dim)
        t_pad = -(-t // 16) * 16
        assert plan["smem_bytes"] <= 232_448, (t, plan)
        # the kernel runs each head padded to a multiple of 8 columns
        assert plan["head_dim"] % 8 == 0 and 0 <= plan["head_dim"] - head_dim < 8
        if t_pad <= 272:
            # the whole row's scores fit the register tile, K/V staged once
            assert plan["variant"] == "registers" and plan["blocks_per_head"] == 1
            assert plan["frags"] * 8 >= t_pad and plan["frags"] in (8, 16, 34)
            assert plan["smem_bytes"] >= 2 * t_pad * plan["head_dim"] * 2
        else:
            # the wgmma variant, 192 query rows a block, for every head dim
            assert plan["variant"] == "wgmma" and plan["frags"] == 8
            assert plan["blocks_per_head"] * 192 >= t > (plan["blocks_per_head"] - 1) * 192


@pytest.mark.parametrize("case", [(1, "registers", 8), (50, "registers", 8), (64, "registers", 8),
                                  (65, "registers", 16), (128, "registers", 16),
                                  (129, "registers", 34), (197, "registers", 34),
                                  (257, "registers", 34), (272, "registers", 34),
                                  (273, "wgmma", 8), (320, "wgmma", 8), (577, "wgmma", 8)])
def test_mha_plan_variant_by_t_alone(case):
    # the same variant for every head dim, padded where it is no multiple of 8
    t, variant, frags = case
    for head_dim in (20, 32, 36, 64, 72, 128):
        plan = tatt.mha_plan(t, head_dim)
        assert (plan["variant"], plan["frags"]) == (variant, frags)
    # ViT-L/14: 78,336 bytes for K and V of one head
    assert tatt.mha_plan(257, 64)["smem_bytes"] == 2 * 272 * 72 * 2


@pytest.mark.parametrize("case", [
    # (t, head_dim) -> (192-row items a head, smem bytes): 1 KB of alignment,
    # two buffers of Q for 3 warpgroups in 8 KB boxes of 64 rows x 64 columns,
    # a ring of 2 stages of K and V of 128 keys in 16 KB boxes (two boxes a
    # row past 64 columns), and 8 barriers
    ((273, 64), (2, 1024 + 6 * 8192 + 4 * 16384 + 64)),
    ((320, 32), (2, 1024 + 6 * 8192 + 4 * 16384 + 64)),
    ((729, 72), (4, 1024 + 12 * 8192 + 8 * 16384 + 64)),     # SigLIP so400m/14 at 384 px
    ((729, 80), (4, 1024 + 12 * 8192 + 8 * 16384 + 64)),
    ((1100, 128), (6, 1024 + 12 * 8192 + 8 * 16384 + 64)),
    ((4097, 96), (22, 1024 + 12 * 8192 + 8 * 16384 + 64))])
def test_mha_plan_wgmma_variant(case):
    (t, head_dim), (blocks_per_head, smem) = case
    plan = tatt.mha_plan(t, head_dim, blocks=4096)
    assert plan == {"variant": "wgmma", "head_dim": head_dim, "frags": 8,
                    "blocks_per_head": blocks_per_head, "warps": 13, "smem_bytes": smem}
    assert smem <= 232_448
    # the same for any grid and card: one block of 416 threads a multiprocessor
    assert tatt.mha_plan(t, head_dim, blocks=1, sm_count=8) == plan


@pytest.mark.parametrize("case", [
    # (t, head_dim) -> (the head dim the kernel runs at, the variant)
    ((273, 64), (64, "wgmma")), ((729, 72), (72, "wgmma")), ((729, 36), (40, "wgmma")),
    ((729, 20), (24, "wgmma")), ((300, 1), (8, "wgmma")), ((300, 8), (8, "wgmma")),
    ((577, 100), (104, "wgmma")), ((272, 72), (72, "registers")),
    ((272, 36), (40, "registers"))])
def test_mha_plan_pads_the_head_dim_to_a_multiple_of_8(case):
    (t, head_dim), (width, variant) = case
    plan = tatt.mha_plan(t, head_dim)
    assert (plan["head_dim"], plan["variant"]) == (width, variant)
    # the plan of the padded width is the same plan
    assert tatt.mha_plan(t, width) == plan


@pytest.mark.parametrize("case", [
    # (t, blocks = heads x images, multiprocessors) -> warps per block
    ((1, 16, 132), 1), ((50, 3072, 132), 4), ((64, 3072, 132), 4), ((128, 3072, 132), 8),
    ((129, 128, 132), 8), ((257, 128, 132), 8), ((257, 264, 132), 8), ((257, 265, 132), 4),
    ((257, 4096, 132), 4), ((257, 4096, 4096), 8), ((272, 4096, 132), 4),
    ((273, 4096, 132), 13), ((577, 16, 132), 13)])
def test_mha_plan_warps_by_tiles_and_grid_depth(case):
    # past 272 keys 13: three warpgroups and the producer's warp
    (t, blocks, sms), warps = case
    plan = tatt.mha_plan(t, 64, blocks=blocks, sm_count=sms)
    assert plan["warps"] == warps
    if plan["variant"] == "registers":
        # one warp per 16-row query tile at most
        assert 1 <= plan["warps"] <= min(8, -(-t // 16))
    # the defaults are one block on an H100
    assert tatt.mha_plan(t, 64)["warps"] == tatt.mha_plan(t, 64, blocks=1, sm_count=132)["warps"]


@pytest.mark.parametrize("args", [(0, 64), (-3, 64), (17, 0), (17, 129), (17, 64, 0),
                                  (17, 64, 1, 0)])
def test_mha_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        tatt.mha_plan(*args)


@pytest.mark.parametrize("t", [17, 300])
@pytest.mark.parametrize("head_dim", [1, 20, 36, 100])
def test_padded_heads_give_the_plain_result(head_dim, t):
    # what the wrapper does for the bf16 kernels: heads padded with zero
    # columns to a multiple of 8, the true head dim's scale, the output cut
    # back; the zero columns add exact zeros to every score
    rng = np.random.default_rng(head_dim * t)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, 3 * head_dim)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    width = tatt.mha_plan(t, head_dim)["head_dim"]
    padded = [tatt._pad_heads(x, 3, width) for x in (q, k, v)]
    assert padded[0].shape == (2, t, 3 * width)
    assert torch.equal(tatt._pad_heads(padded[0], 3, head_dim), q)
    got = tatt._einsum_attention(*padded, 3, scale=head_dim ** -0.5)
    assert torch.equal(tatt._pad_heads(got, 3, head_dim), tatt._einsum_attention(q, k, v, 3))


def test_variant_codes_are_the_librarys():
    # the span names ivars_mha_variant's answer through these codes: they are
    # the values of csrc/mha.cu's enum, in order
    src = (Path(tatt.__file__).resolve().parent.parent / "csrc" / "mha.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\};", src).group(1)
    codes = dict((name.strip(), int(value)) for name, value in
                 (item.split("=") for item in enum.split(",")))
    assert codes == {"k" + v.capitalize(): i for i, v in enumerate(tatt._VARIANTS)}
