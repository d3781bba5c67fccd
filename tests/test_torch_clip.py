"""Parity of the PyTorch CLIP towers with the Flax towers.

A JAX ``CLIPModel(tiny_test)`` is initialized, its params go to numpy and
through ``models.convert.from_jax_params`` into the port. Towers in f32
agree within 1e-4; in bf16 their embeddings keep cosine >= 0.999 (the gate
of the JAX package's ``models/convert.py``). The weight mapping is checked
by a round trip through the JAX ``convert_hf_clip_params``. Seeded init, HF
checkpoints, the tokenizer and preprocessing are in test_torch_convert.py.
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


def test_unported_options_raise():
    for flag in ("w8a8", "int8_attn", "remat"):
        with pytest.raises(NotImplementedError):
            tclip.CLIPModel(CFG_T, **{flag: True})
    with pytest.raises(NotImplementedError):
        tclip.TransformerBlock(64, 4, 4, fused_mlp=True)
