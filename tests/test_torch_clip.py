"""Parity of the PyTorch CLIP towers with the Flax towers.

A JAX ``CLIPModel(tiny_test)`` is initialized, its params go to numpy and
through ``models.convert.from_jax_params`` into the port. Towers in f32
agree within 1e-4; in bf16 their embeddings keep cosine >= 0.999 (the gate
of the JAX package's ``models/convert.py``). The weight mapping is checked
by a round trip through the JAX ``convert_hf_clip_params``. Seeded init, HF
checkpoints, the tokenizer and preprocessing are in test_torch_convert.py.

``fused_mlp=True`` (the fused LN+MLP half-block, kernel B4; on the CPU its
plain version): a fused block equals the same block unfused and the JAX
``TransformerBlock(fused_mlp=True)`` (interpret mode) at f32 ``atol=2e-5``
(the JAX test's own bound), for each of the three activations; a model of
widths that pass the kernel's gate equals the Flax model at f32 1e-4 / bf16
cosine >= 0.999; a Flax tree initialised through the fused block carries
across unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from intelligent_video_analysis_retrieval_system_tpu.models import clip as jclip
from intelligent_video_analysis_retrieval_system_tpu.models.convert import (
    convert_hf_clip_params,
)
from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv

torch.set_num_threads(2)

CFG_J = jclip.CLIPConfig.tiny_test()
CFG_T = tclip.CLIPConfig.tiny_test()


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(0)
    px = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 500, (1, 16)).astype(np.int32)
    params = jclip.CLIPModel(CFG_J).init(jax.random.PRNGKey(0), px, toks)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 500, (3, 16)).astype(np.int32)
    toks[:, 0] = 500
    eot = np.array([5, 9, 15])
    toks[np.arange(3), eot] = 511          # EOT = largest id
    return px, toks, eot


def _jax_model(dtype, precision):
    return jclip.CLIPModel(CFG_J, dtype=dtype, precision=precision)


def _port_model(sd, dtype, precision):
    m = tconv.empty_model(CFG_T, "cpu", dtype=dtype, precision=precision)
    m.load_state_dict(sd)
    return m.eval()


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_text_tower_f32(jax_params, inputs, precision):
    _, toks, eot = inputs
    jp = lax.Precision.HIGHEST if precision == "highest" else lax.Precision.DEFAULT
    want = _jax_model(jnp.float32, jp).apply(
        {"params": jax_params}, jnp.asarray(toks), jnp.asarray(eot),
        method=jclip.CLIPModel.encode_text)
    m = _port_model(tconv.from_jax_params(jax_params, CFG_T), torch.float32, precision)
    with torch.no_grad():
        got = m.encode_text(torch.from_numpy(toks), torch.from_numpy(eot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_vision_tower_f32(jax_params, inputs, precision):
    px, _, _ = inputs
    jp = lax.Precision.HIGHEST if precision == "highest" else lax.Precision.DEFAULT
    want = _jax_model(jnp.float32, jp).apply(
        {"params": jax_params}, jnp.asarray(px), method=jclip.CLIPModel.encode_image)
    m = _port_model(tconv.from_jax_params(jax_params, CFG_T), torch.float32, precision)
    with torch.no_grad():
        got = m.encode_image(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_towers_bf16_cosine_gate(jax_params, inputs, tower):
    px, toks, eot = inputs
    jm = _jax_model(jnp.bfloat16, lax.Precision.DEFAULT)
    m = _port_model(tconv.from_jax_params(jax_params, CFG_T), torch.bfloat16, "default")
    with torch.no_grad():
        if tower == "text":
            want = jm.apply({"params": jax_params}, jnp.asarray(toks), jnp.asarray(eot),
                            method=jclip.CLIPModel.encode_text)
            got = m.encode_text(torch.from_numpy(toks), torch.from_numpy(eot))
        else:
            want = jm.apply({"params": jax_params}, jnp.asarray(px),
                            method=jclip.CLIPModel.encode_image)
            got = m.encode_image(torch.from_numpy(px))
    assert got.dtype == torch.bfloat16
    cos = _cos(got.float().numpy(), np.asarray(want, np.float32))
    assert cos.min() >= 0.999, cos


def test_roundtrip_through_convert_hf_clip_params(jax_params):
    sd = tconv.from_jax_params(jax_params, CFG_T)
    back = convert_hf_clip_params(sd, CFG_J)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    # and the state dict has exactly the port model's parameter names
    assert set(sd) == set(tconv.empty_model(CFG_T, "meta").state_dict())


def test_contrastive_logits_match(jax_params, inputs):
    px, toks, _ = inputs
    want = _jax_model(jnp.float32, lax.Precision.HIGHEST).apply(
        {"params": jax_params}, jnp.asarray(px), jnp.asarray(toks))
    m = _port_model(tconv.from_jax_params(jax_params, CFG_T), torch.float32, "highest")
    with torch.no_grad():
        got = m(torch.from_numpy(px), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-5)


def test_unported_options_raise(jax_params, inputs):
    # nothing is refused any more: remat (activation checkpointing) is ported;
    # its gradients equal the plain loop's, and without autograd it is that loop
    px, toks, _ = inputs
    sd = tconv.from_jax_params(jax_params, CFG_T)
    grads, outs = [], []
    for remat in (False, True):
        m = tconv.empty_model(CFG_T, "cpu", remat=remat)
        m.load_state_dict(sd)
        assert m.vision_model.encoder.remat is remat and m.text_model.encoder.remat is remat
        m(torch.from_numpy(px), torch.from_numpy(toks)).logsumexp(-1).sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        with torch.no_grad():
            outs.append(m(torch.from_numpy(px), torch.from_numpy(toks)))
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    assert torch.equal(outs[0], outs[1])
    # ported (tests/test_torch_w8a8.py): the W8A8 layers and int8 attention
    m = tclip.CLIPModel(CFG_T, w8a8=True, w8a8_static=True, int8_attn=True)
    assert m.vision_model.encoder.layers[0].mlp.fc1.w8a8_static
    assert m.text_model.encoder.layers[0].self_attn.int8_attn
    # a W8A8 block never takes the fused LN+MLP half-block
    assert not tclip.TransformerBlock(256, 4, 512, fused_mlp=True, w8a8=True).fused_mlp
    # fused_mlp is ported: taken where the gate passes, the unfused chain else
    assert tclip.TransformerBlock(256, 4, 512, fused_mlp=True).fused_mlp
    assert not tclip.TransformerBlock(64, 4, 256, fused_mlp=True).fused_mlp
    assert not tclip.TransformerBlock(256, 4, 512, precision="highest", fused_mlp=True).fused_mlp
    assert not tclip.TransformerBlock(256, 4, 512).fused_mlp


# ---------------------------------------------------------------------------
# fused_mlp: widths that pass the kernel's gate (D % 128 == 0, H % 256 == 0)
# ---------------------------------------------------------------------------

WIDE_J = jclip.CLIPConfig(
    vision=jclip.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=128, num_layers=2,
                                  num_heads=4, projection_dim=32),
    text=jclip.CLIPTextConfig(vocab_size=512, max_length=16, hidden_size=128, num_layers=2,
                              num_heads=4, projection_dim=32))
WIDE_T = tclip.CLIPConfig(
    vision=tclip.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=128, num_layers=2,
                                  num_heads=4, projection_dim=32),
    text=tclip.CLIPTextConfig(vocab_size=512, max_length=16, hidden_size=128, num_layers=2,
                              num_heads=4, projection_dim=32))


def _jax_block(fused, act="quick_gelu"):
    return jclip.TransformerBlock(num_heads=4, mlp_ratio=2, act=act, fused_mlp=fused)


def _port_block(tree, fused, act="quick_gelu"):
    blk = tclip.TransformerBlock(256, 4, 512, act=act, fused_mlp=fused)
    blk.load_state_dict({k[2:]: v for k, v in tconv._block(tree, "b").items()})
    return blk.eval()


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_tanh"])
def test_fused_block_matches_unfused_and_jax(act):
    x = np.random.default_rng(3).standard_normal((2, 8, 256)).astype(np.float32)
    tree = _jax_block(False, act).init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    want = np.asarray(_jax_block(True, act).apply({"params": tree}, jnp.asarray(x)))
    fused, unfused = _port_block(tree, True, act), _port_block(tree, False, act)
    assert fused.fused_mlp and not unfused.fused_mlp
    with torch.no_grad():
        got_f = fused(torch.from_numpy(x)).numpy()
        got_u = unfused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_f, got_u, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_f, want, atol=2e-5, rtol=0)
    # with autograd recording the block takes its unfused modules: gradients flow
    y = fused(torch.from_numpy(x))
    y.sum().backward()
    assert fused.mlp.fc1.weight.grad is not None
    np.testing.assert_allclose(y.detach().numpy(), got_u, atol=1e-6, rtol=0)


def test_flax_tree_of_the_fused_block_carries_across_unchanged():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 8, 256)).astype(np.float32))
    tree_f = _jax_block(True).init(jax.random.PRNGKey(0), x)["params"]
    tree_u = _jax_block(False).init(jax.random.PRNGKey(0), x)["params"]
    sd_f, sd_u = tconv._block(tree_f, "b"), tconv._block(tree_u, "b")
    assert set(sd_f) == set(sd_u) == {
        f"b.{k}" for k in tclip.TransformerBlock(256, 4, 512, fused_mlp=True).state_dict()}
    for key in sd_f:
        assert torch.equal(sd_f[key], sd_u[key]), key
    np.testing.assert_array_equal(sd_f["b.mlp.fc1.weight"].numpy(),
                                  np.asarray(tree_f["mlp_fc"]["kernel"]).T)
    np.testing.assert_array_equal(sd_f["b.layer_norm2.weight"].numpy(),
                                  np.asarray(tree_f["ln_2"]["scale"]))


@pytest.fixture(scope="module")
def wide_params():
    rng = np.random.default_rng(0)
    px = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 500, (1, 16)).astype(np.int32)
    params = jclip.CLIPModel(WIDE_J).init(jax.random.PRNGKey(0), px, toks)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_model_matches_flax(wide_params, inputs, dtype):
    px, toks, eot = inputs
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jm = jclip.CLIPModel(WIDE_J, dtype=jdt, precision=lax.Precision.DEFAULT)
    m = tconv.empty_model(WIDE_T, "cpu", dtype=tdt, precision="default", fused_mlp=True)
    m.load_state_dict(tconv.from_jax_params(wide_params, WIDE_T))
    m.eval()
    layers = list(m.vision_model.encoder.layers) + list(m.text_model.encoder.layers)
    assert all(blk.fused_mlp for blk in layers)
    want_i = jm.apply({"params": wide_params}, jnp.asarray(px),
                      method=jclip.CLIPModel.encode_image)
    want_t = jm.apply({"params": wide_params}, jnp.asarray(toks), jnp.asarray(eot),
                      method=jclip.CLIPModel.encode_text)
    with torch.no_grad():
        got_i = m.encode_image(torch.from_numpy(px))
        got_t = m.encode_text(torch.from_numpy(toks), torch.from_numpy(eot))
    for got, want in ((got_i, want_i), (got_t, want_t)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        else:
            assert got.dtype == torch.bfloat16
            cos = _cos(got.float().numpy(), np.asarray(want, np.float32))
            assert cos.min() >= 0.999, cos
