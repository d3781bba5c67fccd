"""The vision tower's share of the chip's peak: every batch's operations at
the model's own widths (B images, 1 + patches tokens), or its weights' and
pixels' bytes, at the larger bound, summed over the batches that ended
before the traced slice and divided by their seconds (the profiler slows
the host, so the slice and what follows are left out)."""

from perfbench import roofline
from perfbench.drivers.common import before_slice


def read(ctx, out, summary):
    part = before_slice(out.records, ctx.tracer.host_bounds)
    if part is None:
        return None
    calls, seconds = part
    per_call = roofline.bound_s(*roofline.vision_tower(ctx.config, out.records["batch"]))
    return 100.0 * calls * per_call / seconds
