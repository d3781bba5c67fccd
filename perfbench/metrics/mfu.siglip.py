"""The SigLIP vision tower's share of the chip's peak: each call's
operations from the program's ``embed.tokens`` counter (tokens through the
blocks in an ``embed.images`` call) and the configuration's shapes (the
blocks over 729 tokens, the patch product over all of them, the MAP head),
or its weights' and pixels' bytes, at the larger bound, summed over the
calls that ended before the traced slice and divided by their seconds (the
profiler slows the host, so the slice and what follows are left out).
Nothing where the program counts no tokens."""

from perfbench import roofline, roofline_siglip
from perfbench.drivers.common import before_slice


def read(ctx, out, summary):
    part = before_slice(out.records, ctx.tracer.host_bounds)
    rows = [s["counts"]["embed.tokens"] for s in out.records.get("program_spans", ())
            if s["name"] == "embed.images" and "embed.tokens" in s["counts"]]
    if part is None or not rows:
        return None
    calls, seconds = part
    v = ctx.config["vision_config"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2
    per_call = sum(roofline.bound_s(*roofline_siglip.vision_tower(ctx.config, r / tokens))
                   for r in rows) / len(rows)
    return 100.0 * calls * per_call / seconds
