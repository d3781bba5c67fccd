"""The port's twin of the repository's ``__graft_entry__.py``
(``graft_entry.py``), on the CPU.

- ``entry(device="cpu")`` at a small config (``CLIPConfig.vit_l_14``
  patched to ``tiny_test`` in both packages), held to the JAX ``entry``'s
  function with the JAX params carried across by
  ``models.convert.from_jax_params``: the same (4, 32, 32, 3) zero pixels,
  and seeded random ones, through both; every embedding of unit norm
  (within 1e-5 in f32) and each row's cosine to JAX's at or above 0.999
  (both towers run in bf16, the gate of ``tests/test_torch_clip.py``).
- ``dryrun_multichip(4, device="cpu")`` passes: the training step, the
  bf16 and int8 self-retrieval, and every lifecycle and IVF stage that the
  JAX dry run certifies, in its order (its containers need h5py).
- Both default to ``"cuda"`` and raise where there is no card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from intelligent_video_analysis_retrieval_system_tpu.models import clip as jclip
from intelligent_video_analysis_retrieval_system_tpu_torch import graft_entry
from intelligent_video_analysis_retrieval_system_tpu_torch.models import clip as tclip
from intelligent_video_analysis_retrieval_system_tpu_torch.models import convert as tconv

torch.set_num_threads(2)

# the stages of __graft_entry__._lifecycle_dryrun and _ann_dryrun, in order
STAGES = (
    [f"{dt}:{s}" for dt in ("bfloat16", "int8")
     for s in ("build+search", "append_in_place", "delete_tombstone", "compact",
               "append_overflow_reshard", "tombstone_survives_reshard")]
    + [f"ann:{dt}:{s}" for dt in ("float32", "int8")
       for s in ("build_sharded", "equals_single_device", "full_probe_exact",
                 "batched_equals_b1", "tail_append", "tombstone")])


@pytest.fixture()
def tiny(monkeypatch):
    """``vit_l_14`` is the tiny config in both packages."""
    monkeypatch.setattr(jclip.CLIPConfig, "vit_l_14",
                        classmethod(lambda cls: jclip.CLIPConfig.tiny_test()))
    monkeypatch.setattr(tclip.CLIPConfig, "vit_l_14",
                        classmethod(lambda cls: tclip.CLIPConfig.tiny_test()))
    return tclip.CLIPConfig.tiny_test()


def test_entry_is_the_jax_entrys_function(tiny):
    jfn, (jparams, jpixels) = jentry.entry()
    fn, (model, pixels) = graft_entry.entry(device="cpu")
    assert pixels.shape == tuple(jpixels.shape) == (4, 32, 32, 3)
    assert pixels.dtype == torch.bfloat16 and not pixels.any()
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.load_state_dict(tconv.from_jax_params(jparams, tiny))
    rand = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    for px in (np.zeros((4, 32, 32, 3), np.float32), rand):
        got = fn(model, torch.from_numpy(px).to(torch.bfloat16)).numpy()
        want = np.asarray(jfn(jparams, jnp.asarray(px, jnp.bfloat16)), np.float32)
        assert got.shape == want.shape == (4, tiny.vision.projection_dim)
        assert got.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos


def test_entry_seeds_its_own_tower(tiny):
    fn, (model, pixels) = graft_entry.entry(device="cpu")
    _, (again, _) = graft_entry.entry(device="cpu")
    for (name, p), (_, q) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(p, q), name
    out = fn(model, pixels)
    assert out.shape == (4, tiny.vision.projection_dim) and bool(torch.isfinite(out).all())


def test_dryrun_multichip_passes_every_stage(capsys):
    pytest.importorskip("h5py")
    graft_entry.dryrun_multichip(4, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip ok")]
    assert len(line) == 1 and line[0].startswith("dryrun_multichip ok: 4 shards of cpu")
    stages = line[0].split("single-device oracle: ")[1].split(";")[0].split()
    assert stages == STAGES


def test_both_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
