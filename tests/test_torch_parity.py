"""The port's real-weight parity gate (``models/parity.py``, CLI ``parity``)
against the JAX package's, on the CPU.

Twins of JAX's ``TestParityCommand`` (``tests/test_models.py``) on the same
kind of checkpoint: a seeded ``transformers.CLIPConfig`` saved to
``tmp_path`` with the synthetic CLIP vocab of that file (523 ids, EOT 522),
which is what a user's ``openai/clip-vit-*`` directory looks like
structurally. Nothing is downloaded. The port's towers run on the CPU
(``device="cpu"``); its default, ``"cuda"``, raises where there is no card.

Beside the twins, the port's report is held to JAX's on the same directory:
the same tokenizer verdict, both towers' cosines at or above the gate and
within 1e-5 of JAX's (both are f32 against HF's f32), the same summary
lines but for those numbers, and the same error strings for a missing
directory, a missing vocab, a vocab whose EOT id is not the checkpoint's,
and ``transformers`` missing.
"""

from __future__ import annotations

import json
import re
import sys

import pytest
import torch
from test_models import _build_synthetic_clip_vocab

from intelligent_video_analysis_retrieval_system_tpu.models import parity as jparity
from intelligent_video_analysis_retrieval_system_tpu_torch import cli
from intelligent_video_analysis_retrieval_system_tpu_torch.models import parity

transformers = pytest.importorskip("transformers")


def _save_checkpoint(d, eos_token_id=522):
    """The JAX fixture's checkpoint: text sized for the synthetic vocab (523
    ids, EOT 522), so HF pools at the EOT the tokenizer emits."""
    torch.manual_seed(1)
    hf_cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config={
            "vocab_size": 523,
            "hidden_size": 48,
            "intermediate_size": 192,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "max_position_embeddings": 16,
            "hidden_act": "quick_gelu",
            "eos_token_id": eos_token_id,
        },
        vision_config={
            "image_size": 32,
            "patch_size": 8,
            "hidden_size": 64,
            "intermediate_size": 256,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "hidden_act": "quick_gelu",
        },
    )
    transformers.CLIPModel(hf_cfg).eval().save_pretrained(str(d))
    return d


@pytest.fixture()
def checkpoint_dir(tmp_path):
    d = _save_checkpoint(tmp_path / "ckpt")
    _build_synthetic_clip_vocab(d)
    return d


def _numbers_out(summary: str) -> str:
    return re.sub(r"\d+\.\d{6}", "<n>", summary)


# ---------------------------------------------------------------------------
# twins of TestParityCommand
# ---------------------------------------------------------------------------


def test_run_parity_passes(checkpoint_dir):
    report = parity.run_parity(checkpoint_dir, n_images=2, device="cpu")
    assert report.errors == []
    assert report.text_cosine_min is not None
    assert report.text_cosine_min >= 0.999, report.summary()
    assert report.image_cosine_min >= 0.999, report.summary()
    assert report.ok, report.summary()
    assert "PASS" in report.summary()


def test_run_parity_missing_artifacts(tmp_path):
    report = parity.run_parity(tmp_path / "nope", device="cpu")
    assert not report.ok and report.errors
    assert report.errors == jparity.run_parity(tmp_path / "nope").errors


def test_cli_parity_exit_codes(checkpoint_dir, tmp_path, capsys):
    assert cli.main(["parity", "--weights", str(checkpoint_dir), "--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["parity", "--weights", str(empty), "--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port's report against JAX's
# ---------------------------------------------------------------------------


def test_report_equals_the_jax_report(checkpoint_dir):
    ours = parity.run_parity(checkpoint_dir, n_images=2, device="cpu")
    theirs = jparity.run_parity(checkpoint_dir, n_images=2)
    assert theirs.ok and ours.ok
    assert ours.errors == theirs.errors == []
    assert ours.tokenizer_exact is theirs.tokenizer_exact is True
    assert ours.threshold == theirs.threshold == 0.999
    assert abs(ours.text_cosine_min - theirs.text_cosine_min) <= 1e-5
    assert abs(ours.image_cosine_min - theirs.image_cosine_min) <= 1e-5
    assert _numbers_out(ours.summary()) == _numbers_out(theirs.summary())


def test_a_high_threshold_fails_both_alike(checkpoint_dir, capsys):
    # a gate no f32 pair of towers reaches: the report keeps its numbers and
    # says FAIL; the CLI exits 1 on both
    ours = parity.run_parity(checkpoint_dir, threshold=1.5, n_images=2, device="cpu")
    theirs = jparity.run_parity(checkpoint_dir, threshold=1.5, n_images=2)
    assert not ours.ok and not theirs.ok and ours.errors == theirs.errors == []
    assert _numbers_out(ours.summary()) == _numbers_out(theirs.summary())
    assert "FAIL" in ours.summary()
    assert cli.main(["parity", "--weights", str(checkpoint_dir), "--threshold", "1.5",
                     "--device", "cpu"]) == 1
    capsys.readouterr()


def test_missing_vocab_is_reported_as_jax_reports_it(tmp_path):
    d = _save_checkpoint(tmp_path / "no_vocab")
    ours = parity.run_parity(d, device="cpu")
    theirs = jparity.run_parity(d)
    assert not ours.ok and ours.errors and ours.errors == theirs.errors
    assert ours.text_cosine_min is None and ours.image_cosine_min is None


def test_eot_mismatch_is_reported_as_jax_reports_it(tmp_path):
    d = _save_checkpoint(tmp_path / "eos", eos_token_id=7)
    _build_synthetic_clip_vocab(d)
    ours = parity.run_parity(d, device="cpu")
    theirs = jparity.run_parity(d)
    assert not ours.ok and len(ours.errors) == 1 and ours.errors == theirs.errors
    assert "from different models" in ours.errors[0]


def test_transformers_missing_is_reported_and_the_cli_exits_1(checkpoint_dir, monkeypatch,
                                                              capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    report = parity.run_parity(checkpoint_dir, device="cpu")
    assert not report.ok and len(report.errors) == 1
    assert report.errors[0].startswith("torch/transformers unavailable")
    assert cli.main(["parity", "--weights", str(checkpoint_dir), "--device", "cpu"]) == 1
    assert "unavailable" in capsys.readouterr().out


def test_towers_default_to_the_card(checkpoint_dir):
    assert cli._build_parser().parse_args(["parity", "--weights", "w"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parity.run_parity(checkpoint_dir)


def test_the_checkpoint_is_the_jax_fixtures(checkpoint_dir):
    cfg = json.loads((checkpoint_dir / "config.json").read_text())
    assert cfg["text_config"]["eos_token_id"] == 522
    assert cfg["projection_dim"] == 32
    assert sorted(p.name for p in checkpoint_dir.iterdir() if p.suffix in (".txt", ".json")) \
        == ["config.json", "merges.txt", "vocab.json"]
