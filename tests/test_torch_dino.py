"""Parity of the port's DINO tower and ``dino_embedder`` with the JAX package's.

A JAX ``DINOTower(DINOConfig.tiny_test())`` is initialized, its params go to
numpy and through ``models.convert.from_jax_dino_params`` into the port. The
towers in f32 agree within 1e-4; in bf16 their embeddings keep cosine >=
0.999 (the towers' parity rule). The JAX ``convert_hf_vit_params`` is the
exact inverse of the port's converter, and the port's state dict carries HF
``ViTModel`` names: an HF checkpoint loads as it is and gives HF's own
output within 1e-4.

``dino_embedder`` (resize, normalize, tower) of both packages loads one
local HF checkpoint (``DINOConfig.vit_s_16`` patched to the tiny config in
both, as the bench tests narrow the CLIP towers): f32 within 1e-4, bf16
cosine >= 0.999. Without a checkpoint the port seeds the tower from a
``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from intelligent_video_analysis_retrieval_system_tpu.ingest import frames as jframes
from intelligent_video_analysis_retrieval_system_tpu.models import dino as jdino
from intelligent_video_analysis_retrieval_system_tpu_torch.ingest import frames as tframes
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv
from intelligent_video_analysis_retrieval_system_tpu_torch.models import dino as tdino

torch.set_num_threads(2)

CFG_J = jdino.DINOConfig.tiny_test()
CFG_T = tdino.DINOConfig.tiny_test()


@pytest.fixture(scope="module")
def jax_params():
    px = np.zeros((1, 32, 32, 3), np.float32)
    params = jdino.DINOTower(CFG_J).init(jax.random.PRNGKey(0), px)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)


def _port_tower(sd, dtype=torch.float32, precision="default"):
    tower = tdino.DINOTower(CFG_T, dtype=dtype, precision=precision)
    tower.load_state_dict(sd)
    return tower.eval()


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_tower_f32_matches_jax(jax_params, pixels, precision):
    jp = lax.Precision.HIGHEST if precision == "highest" else lax.Precision.DEFAULT
    want = np.asarray(jdino.DINOTower(CFG_J, precision=jp).apply(
        {"params": jax_params}, jnp.asarray(pixels)))
    tower = _port_tower(tconv.from_jax_dino_params(jax_params, CFG_T), precision=precision)
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tower_bf16_matches_jax(jax_params, pixels):
    want = np.asarray(jdino.DINOTower(CFG_J, dtype=jnp.bfloat16).apply(
        {"params": jax_params}, jnp.asarray(pixels)).astype(jnp.float32))
    tower = _port_tower(tconv.from_jax_dino_params(jax_params, CFG_T), dtype=torch.bfloat16)
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels))
    assert got.dtype == torch.bfloat16
    assert _cos(got.float().numpy(), want).min() >= 0.999


def test_converter_round_trips_through_the_jax_inverse(jax_params):
    tower = _port_tower(tconv.from_jax_dino_params(jax_params, CFG_T))
    back = jdino.convert_hf_vit_params(
        {k: v.numpy() for k, v in tower.state_dict().items()}, CFG_J)
    flat_want = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


def _hf_config():
    transformers = pytest.importorskip("transformers")
    return transformers, transformers.ViTConfig(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=192,
        image_size=32, patch_size=8, layer_norm_eps=1e-6, hidden_act="gelu")


def _hf_model(seed: int = 3):
    """An HF ViTModel of the tiny widths with numpy-seeded weights."""
    transformers, config = _hf_config()
    model = transformers.ViTModel(config, add_pooling_layer=False).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if "layernorm" in name and name.endswith("weight") else 0.0
            p.copy_(torch.from_numpy(
                (base + 0.1 * rng.standard_normal(tuple(p.shape))).astype(np.float32)))
    return model


def test_state_dict_carries_hf_vit_names_and_hf_weights_give_hf_output(pixels):
    hf = _hf_model()
    tower = _port_tower(hf.state_dict())
    assert sorted(tower.state_dict()) == sorted(hf.state_dict())
    for key, value in hf.state_dict().items():
        assert torch.equal(tower.state_dict()[key], value), key
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2)
                  ).last_hidden_state[:, 0]
        got = tower(torch.from_numpy(pixels))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    # the blocks inside keep the CLIP modules' names
    names = [n for n, _ in tower.named_parameters()]
    assert "encoder.layers.1.self_attn.q_proj.weight" in names
    assert tdino.own_name("encoder.layer.1.attention.output.dense.bias") == \
        "encoder.layers.1.self_attn.out_proj.bias"
    assert tdino.hf_name("embeddings.cls_token") == "embeddings.cls_token"


def test_seeded_init_is_deterministic_and_lecun_scaled():
    cfg, sd = tconv.load_dino(config=CFG_T, seed=0)
    _, again = tconv.load_dino(config=CFG_T, seed=0)
    _, other = tconv.load_dino(config=CFG_T, seed=1)
    assert cfg == CFG_T and list(sd) == list(again)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["encoder.layer.0.intermediate.dense.weight"],
                           other["encoder.layer.0.intermediate.dense.weight"])
    w = sd["encoder.layer.0.intermediate.dense.weight"]        # (192, 48): fan_in 48
    assert abs(float(w.std()) * 48 ** 0.5 - 1.0) < 0.1
    assert torch.all(sd["layernorm.weight"] == 1) and torch.all(
        sd["embeddings.patch_embeddings.projection.bias"] == 0)
    assert abs(float(sd["embeddings.position_embeddings"].std()) - 0.02) < 0.005
    _port_tower(sd)      # loads strictly


@pytest.fixture
def tiny_vit_s_16(monkeypatch):
    """``DINOConfig.vit_s_16`` -> the tiny config, in both packages."""
    monkeypatch.setattr(jdino.DINOConfig, "vit_s_16",
                        classmethod(lambda cls: cls.tiny_test()))
    monkeypatch.setattr(tdino.DINOConfig, "vit_s_16",
                        classmethod(lambda cls: cls.tiny_test()))


@pytest.fixture
def checkpoint(tmp_path):
    path = tmp_path / "dino-tiny"
    _hf_model().save_pretrained(path)
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dino_embedder_matches_jax_with_the_same_weights(tiny_vit_s_16, checkpoint, dtype):
    frames = np.random.default_rng(2).integers(0, 256, (5, 40, 24, 3)).astype(np.uint8)
    want = jframes.dino_embedder(str(checkpoint), dtype=dtype)(frames)
    embed = tframes.dino_embedder(str(checkpoint), dtype=dtype, device="cpu")
    got = embed(frames)
    assert got.shape == (5, 48) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert _cos(got, want).min() >= 0.999
    # padded to batch_pad rows and sliced: the rows of the unpadded device path
    on_device = embed.device_fn(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, on_device, atol=1e-5 if dtype == "float32" else 1e-2)


def test_dino_embedder_without_a_checkpoint_is_seeded_and_dedups(tiny_vit_s_16):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)
    near = np.clip(base.astype(int) + rng.integers(-2, 3, base.shape), 0, 255).astype(np.uint8)
    far = rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)
    embed = tframes.dino_embedder(dtype="float32", device="cpu")
    emb = embed(np.stack([base, near, far]))
    assert emb.shape == (3, 48)
    again = tframes.dino_embedder(dtype="float32", device="cpu")(np.stack([base, near, far]))
    np.testing.assert_array_equal(emb, again)
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    assert emb[0] @ emb[1] > 0.99 > emb[0] @ emb[2]
