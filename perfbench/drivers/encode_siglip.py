"""The build's image step on the SigLIP tower: ``CLIPEmbedder.encode_images``
with a ``SiglipConfig`` over batches of uint8 keyframes handed over as host
arrays, closed loop.

As :mod:`.encode`: set-up makes the towers from the seed
(``perfbench/weights_siglip.py``), a pool of distinct keyframe batches from
the seed, and warms the batch shape; the window embeds batches back to back
until ``--seconds`` have passed, and the rate is the images embedded over
the time from the first call's start to the last call's end. After the
window the program is freed and a sample of the embedded keyframes, drawn
from the seed, is compared with the float32 SigLIP vision tower
(``reference/siglip.py``).

With ``--trace 1`` the program's own spans and counters (its ``trace``
module) are recorded over the traced slice alone and handed to the readers
as ``records["program_spans"]``: dicts of ``name``, ``start``, ``end``
(``time.perf_counter()`` seconds), ``attrs`` and ``counts``. A program
without that module gives none.

The control (:func:`control`) puts the float32 tower in the program's place
with the inputs and weights of every dense product rounded to float8 (e4m3),
the step below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import data, weights_siglip
from ..reference import compare
from ..reference import siglip as ref_siglip
from . import common


def siglip_config(cfg):
    """The port's ``SiglipConfig`` of a configuration file (its groups hold
    HF ``SiglipConfig``'s keys)."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.models.convert import (
        hf_siglip_config_to_ours)

    return hf_siglip_config_to_ours(SimpleNamespace(
        vision_config=SimpleNamespace(**cfg["vision_config"]),
        text_config=SimpleNamespace(**cfg["text_config"])))


def embedder(ctx: common.Context):
    """The program's ``CLIPEmbedder`` over the SigLIP towers, loaded through
    its public path and then handed the seeded weights."""
    from intelligent_video_analysis_retrieval_system_tpu_torch.system.embedder import CLIPEmbedder

    emb = CLIPEmbedder(config=siglip_config(ctx.config), device=ctx.device,
                       compute_dtype=ctx.config["dtype"],
                       image_batch_size=int(ctx.traffic.get("batch", 256)))
    emb.ensure_loaded()
    ctx.log("embedder loaded (its own seeded init)")
    emb.load_params(weights_siglip.make(ctx.config, ctx.seed, ctx.device))
    return emb


def _program_trace():
    """The program's span recorder, or None where the program has none."""
    try:
        from intelligent_video_analysis_retrieval_system_tpu_torch import trace
    except ImportError:
        return None
    return trace


@contextlib.contextmanager
def _recording(trace):
    """The program's spans recorded inside the body alone."""
    if trace is None:
        yield
        return
    trace.take()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


def _spans(trace) -> list[dict]:
    if trace is None:
        return []
    return [{"name": s.name, "start": s.start, "end": s.end, "attrs": dict(s.attrs),
             "counts": dict(s.counts)} for s in trace.take()]


def run(ctx: common.Context) -> common.Outcome:
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    batch, pool = int(tr["batch"]), int(tr["pool_batches"])
    size = cfg["vision_config"]["image_size"]
    emb = embedder(ctx)
    ctx.log("towers loaded")
    frames = data.images(batch * pool, size, ctx.seed + 2, dev).reshape(pool, batch, size, size, 3)
    unwrap = ctx.tracer.wrap(emb, "encode_images", "encode_images")
    for i in range(int(tr["warm_calls"])):
        emb.encode_images(frames[-1 - i % pool])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.log("keyframes made, shapes warmed")
    program = _program_trace() if ctx.trace else None
    ctx.setup_done()
    outs: list[np.ndarray] = []
    ends: list[float] = []
    start, length = ctx.slice_bounds()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and not ctx.tracer.taken and time.perf_counter() - t0 >= start:
            with ctx.tracer.slice(), _recording(program):
                s0 = time.perf_counter()
                while time.perf_counter() - s0 < length:
                    outs.append(emb.encode_images(frames[len(outs) % pool]))
                    ends.append(time.perf_counter())
            continue
        outs.append(emb.encode_images(frames[len(outs) % pool]))
        ends.append(time.perf_counter())
    window_s = time.perf_counter() - t0
    unwrap()
    memory = common.peak_bytes(dev)
    del emb
    common.free_device()

    calls = len(outs)
    pick = common.sample(calls * batch, int(tr["check_sample"]), ctx.seed)
    call_of, img_of = pick // batch, pick % batch
    got = np.stack([outs[c][i] for c, i in zip(call_of, img_of)])
    px = torch.from_numpy(np.ascontiguousarray(frames[call_of % pool, img_of])).to(dev)
    sd = weights_siglip.make(cfg, ctx.seed, dev)
    ref = ref_siglip.image_embed(sd, cfg, px)
    del sd
    numbers = {"embed_gap": compare.embed_gap(got, ref)}
    done = calls * batch
    bad = sum(int(not np.isfinite(o).all()) for o in outs)
    return common.Outcome(
        attempted=calls, failed=bad,
        end_to_end={"images_per_s": done / window_s},
        numbers=numbers,
        records={"calls": calls, "batch": batch, "window_s": window_s, "t0": t0,
                 "call_ends": ends, "program_spans": _spans(program)},
        notes=[f"window {window_s:.3f} s, {calls} batches of {batch} keyframes, "
               f"{len(pick)} compared"],
        memory_peak_bytes=memory)


def control(ctx: common.Context) -> dict:
    """The program's ``embed_gap`` and the control's over ``check_sample``
    keyframes: the float32 tower with float8 (e4m3) products in the
    program's place, each dense layer's input scaled per token and its
    weight per output channel, as a float8 product path would have them."""
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    size = cfg["vision_config"]["image_size"]
    px = data.images(int(tr["check_sample"]), size, ctx.seed + 2, dev)
    sd = weights_siglip.make(cfg, ctx.seed, dev)
    pixels = torch.from_numpy(px).to(dev)
    ref = ref_siglip.image_embed(sd, cfg, pixels)
    low = ref_siglip.image_embed(sd, cfg, pixels, dense=ref_siglip.fp8_dense)
    del sd
    emb = embedder(ctx)
    got = emb.encode_images(px)
    del emb
    common.free_device()
    return {"program": {"embed_gap": compare.embed_gap(got, ref)},
            "control": {"embed_gap": compare.embed_gap(low.cpu().numpy(), ref)}}
