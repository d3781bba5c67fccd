"""The harness's inputs and its reference against the program, on the CPU:
the queries reach the tower as written, two seeds ask for the same work,
the seeded leaves are the program's state dict, and the reference's
tokenizer and towers compute what the program computes in float32."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import empty_model
from intelligent_video_analysis_retrieval_system_tpu_torch.models.tokenizer import SimpleTokenizer
from intelligent_video_analysis_retrieval_system_tpu_torch.retrieval.translator import (
    UniversalQueryTranslator)
from perfbench import data, weights
from perfbench.drivers.common import clip_config
from perfbench.reference import clip as ref_clip
from perfbench.reference import tokenizer as ref_tok
from perfbench.tests.conftest import REPO, _toy_config

SEEDS = [0, 17, 2**31 + 5, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_queries_reach_the_tower_as_written(seed):
    texts = data.text_queries(300, seed)
    assert len(set(texts)) == len(texts)
    assert all(5 <= len(t.split()) <= 40 for t in texts)
    tr = UniversalQueryTranslator()
    for t in texts[:60]:
        out = tr.translate_query(t)
        assert out.clip_prompt == t and out.confidence >= tr.min_confidence


def test_a_flood_of_queries_stays_distinct():
    texts = data.text_queries(12_000, 2**31 + 9)
    assert len(set(texts)) == len(texts) == 12_000


def test_two_seeds_ask_for_the_same_work():
    a, b = data.poisson_offsets(80.0, 30.0, 1), data.poisson_offsets(80.0, 30.0, 2)
    assert len(a) == len(b) == 2400 and not np.array_equal(a, b)
    assert 0 <= a.min() and a.max() < 30.0
    assert sorted(len(t.split()) for t in data.text_queries(200, 1)) == \
        sorted(len(t.split()) for t in data.text_queries(200, 2))


@pytest.mark.parametrize("name", ["clip-vit-l-14.json", "clip-vit-b-32.json"])
def test_leaves_are_the_programs_state_dict(name):
    cfg = json.loads((REPO / "perfbench" / "configs" / name).read_text())
    want = {k: tuple(v.shape) for k, v in empty_model(clip_config(cfg), "meta").state_dict().items()}
    assert {n: tuple(s) for n, s, _ in weights.spec(cfg)} == want


def test_frozen_tokenizer_agrees():
    texts = data.text_queries(200, 3) + ["a photo of &amp; café 2 dogs, at 5pm!"]
    tok = SimpleTokenizer(vocab_size=49408)
    ids, eot = ref_tok.tokenize(texts, 49408, 77)
    want = tok(texts, 77)
    assert np.array_equal(ids, want) and np.array_equal(eot, tok.eot_positions(want))


def test_reference_towers_match_the_program_in_f32():
    cfg = _toy_config("clip-vit-l-14.json", "bfloat16")
    sd = weights.make(cfg, 5, torch.device("cpu"))
    model = empty_model(clip_config(cfg), "cpu", dtype=torch.float32, precision="highest")
    model.load_state_dict({k: v.clone() for k, v in sd.items()})
    ids, eot = ref_tok.tokenize(data.text_queries(6, 1), 512, 16)
    px = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), np.uint8))
    from intelligent_video_analysis_retrieval_system_tpu_torch.ops.preprocess import (
        normalize_images_reference)
    with torch.no_grad():
        txt = model.encode_text(torch.from_numpy(ids), torch.from_numpy(eot))
        img = model.encode_image(normalize_images_reference(px, dtype=torch.float32))
    ref_txt = ref_clip.text_embed(sd, cfg, torch.from_numpy(ids), torch.from_numpy(eot))
    ref_img = ref_clip.image_embed(sd, cfg, px)
    torch.testing.assert_close(ref_txt, txt, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref_img, img, rtol=1e-4, atol=1e-5)
