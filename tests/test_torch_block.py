"""The port's fused LN+MLP half-block (kernel B4's wrapper and plain
version) against the JAX package's ``ops.block.fused_ln_mlp``.

The JAX function reaches its Pallas kernel in interpret mode, as the JAX
package's own tests run it off the TPU. On the CPU the port's wrapper takes
its plain version, which has the kernel's rounding points. Weights are made
with numpy in the Flax layout (``w1``: (D, H), ``w2``: (H, D)); the port
takes ``nn.Linear``'s layout, their transposes.

Tolerances: f32 ``atol=2e-5`` (the JAX test's own bound: the order of the
hidden-chunk sum differs); bf16 max abs difference at most 0.01 of the
output's max abs (both round at the same points, sums differ in order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu.ops import block as jblock
from intelligent_video_analysis_retrieval_system_tpu_torch.ops import block as tblock

torch.set_num_threads(2)

D, H = 256, 512
ACTS = ["quick_gelu", "gelu", "gelu_tanh"]


def _params(seed=0, d=D, h=H):
    rng = np.random.default_rng(seed)
    return {
        "g": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "bt": (0.1 * rng.standard_normal(d)).astype(np.float32),
        "w1": (rng.standard_normal((d, h)) / np.sqrt(d)).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(h)).astype(np.float32),
        "w2": (rng.standard_normal((h, d)) / np.sqrt(h)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(d)).astype(np.float32),
    }


def _jax(x, p, act, dtype=jnp.float32):
    return np.asarray(jblock.fused_ln_mlp(
        jnp.asarray(x, dtype), p["g"], p["bt"], p["w1"], p["b1"], p["w2"], p["b2"],
        act=act, interpret=True), np.float32)


def _port(x, p, act, dtype=torch.float32, fn=tblock.fused_ln_mlp):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    out = fn(torch.from_numpy(x).to(dtype), t["g"], t["bt"],
             t["w1"].T.contiguous(), t["b1"], t["w2"].T.contiguous(), t["b2"], act=act)
    assert out.dtype == dtype and out.shape == x.shape
    return out.float().numpy()


@pytest.mark.parametrize("act", ACTS)
def test_f32_matches_jax_interpret(act):
    x = np.random.default_rng(1).standard_normal((2, 9, D)).astype(np.float32)
    p = _params()
    np.testing.assert_allclose(_port(x, p, act), _jax(x, p, act), atol=2e-5, rtol=0)


@pytest.mark.parametrize("act", ACTS)
def test_bf16_matches_jax_interpret(act):
    x = np.random.default_rng(2).standard_normal((2, 7, D)).astype(np.float32)
    p = _params(seed=2)
    want = _jax(x, p, act, jnp.bfloat16)
    got = _port(x, p, act, torch.bfloat16)
    assert np.abs(got - want).max() <= 0.01 * np.abs(want).max()


def test_ragged_token_count_and_flat_input():
    # 37 tokens: not a multiple of any tile; (tokens, D) input without a batch axis
    x = np.random.default_rng(3).standard_normal((37, D)).astype(np.float32)
    p = _params(seed=3)
    want = _jax(x[None], p, "quick_gelu")[0]
    np.testing.assert_allclose(_port(x, p, "quick_gelu"), want, atol=2e-5, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    x = np.random.default_rng(4).standard_normal((1, 5, D)).astype(np.float32)
    p = _params(seed=4)
    before = tblock.fused_ln_mlp.launches
    a = _port(x, p, "gelu", torch.bfloat16)
    b = _port(x, p, "gelu", torch.bfloat16, fn=tblock.fused_ln_mlp_reference)
    np.testing.assert_array_equal(a, b)
    assert tblock.fused_ln_mlp.launches == before  # no kernel ran on the CPU


def test_quick_gelu_rounds_every_step_in_bf16():
    # the plain activation is the TPU kernel's logistic with bf16 constants
    x = torch.from_numpy(np.linspace(-6, 6, 4001, dtype=np.float32)).to(torch.bfloat16)
    got = tblock.activation("quick_gelu")(x)
    want = np.asarray(jblock._act_fn("quick_gelu")(jnp.asarray(x.float().numpy(),
                                                               jnp.bfloat16)), np.float32)
    # exp differs by an f32 ulp between the frameworks, which can move a
    # rounding boundary: at most one bf16 step, on few elements
    diff = np.abs(got.float().numpy() - want)
    assert (diff > 0).mean() < 0.02
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("args", [(1024, 4096, "quick_gelu"), (48, 192, "quick_gelu"),
                                  (1024, 4096, "relu"), (768, 3072, "gelu"),
                                  (512, 2048, "gelu_tanh"), (128, 256, "gelu")])
def test_supports_gate_equals_jax(args):
    assert tblock.supports_fused_ln_mlp(*args) == jblock.supports_fused_ln_mlp(*args)


def test_gate_and_shape_errors():
    # wider than the kernel's register tile: the port's gate says no
    assert not tblock.supports_fused_ln_mlp(1280, 5120, "quick_gelu")
    p = _params(seed=5)
    x = np.zeros((2, 3, D + 128), np.float32)
    with pytest.raises(ValueError):
        _port(x, p, "quick_gelu")
    with pytest.raises(ValueError):
        tblock.activation("relu")


# ---------------------------------------------------------------------------
# the bf16 kernel's launch plan and the ragged token counts around its tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [63, 65])
def test_token_counts_around_the_tile_match_jax(tokens, dtype):
    # the kernel's tile is 64 tokens: one short of it and one past it
    d, h = 128, 256
    x = np.random.default_rng(tokens).standard_normal((1, tokens, d)).astype(np.float32)
    p = _params(seed=tokens, d=d, h=h)
    if dtype == "float32":
        np.testing.assert_allclose(_port(x, p, "quick_gelu"), _jax(x, p, "quick_gelu"),
                                   atol=2e-5, rtol=0)
    else:
        want = _jax(x, p, "quick_gelu", jnp.bfloat16)
        got = _port(x, p, "quick_gelu", torch.bfloat16)
        assert np.abs(got - want).max() <= 0.01 * np.abs(want).max()


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_ln_mlp_plan_is_total_over_the_gate(d):
    assert tblock.supports_fused_ln_mlp(d, 4 * d if d > 128 else 256, "quick_gelu")
    for n_tok in (1, 63, 64, 65, 129, 2056, 4223, 4224, 4225, 65_792, 10_000_000):
        plan = tblock.ln_mlp_plan(n_tok, d)
        assert plan["tile_tokens"] == 64 and plan["tiles"] == -(-n_tok // 64)
        # D is split four ways whatever the token count
        assert plan["cluster"] == 4 and plan["blocks"] == 4 * plan["tiles"]
        assert 2 <= plan["w2_stages"] <= 8 and 4 <= plan["w1_stages"] <= 8
        assert plan["smem_bytes"] <= tblock.MAX_SMEM == 232_448
        # LN(x) of the tile, two activation tiles and both rings all fit
        assert plan["smem_bytes"] >= (64 * d * 2 + 2 * 16_384 + plan["w1_stages"] * 8_192
                                      + plan["w2_stages"] * 16_384)


@pytest.mark.parametrize("case", [(2056, 1024, 132, 4, 2, 230_912), (65_792, 1024, 4112, 4, 2, 230_912),
                                  (3850, 768, 244, 6, 3, 230_912), (19_712, 768, 1232, 6, 3, 230_912),
                                  (1, 128, 4, 8, 5, 198_144)])
def test_ln_mlp_plan_at_the_towers_shapes(case):
    n_tok, d, blocks, w1_stages, w2_stages, smem = case
    plan = tblock.ln_mlp_plan(n_tok, d)
    assert (plan["blocks"], plan["w1_stages"], plan["w2_stages"], plan["smem_bytes"]) == (
        blocks, w1_stages, w2_stages, smem)


@pytest.mark.parametrize("args", [(0, 1024), (64, 1280), (64, 100), (64, 0)])
def test_ln_mlp_plan_refuses_what_the_gate_refuses(args):
    with pytest.raises(ValueError):
        tblock.ln_mlp_plan(*args)
