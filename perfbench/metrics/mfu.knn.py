"""The whole call's share of the chip's peak: every call scores its queries
against every int8 row once, at the larger of its int8 operations at the
int8 peak and its rows' bytes at the memory's peak, summed over the calls
that ended before the traced slice and divided by their seconds (the
profiler slows the host, so the slice and what follows are left out)."""

from perfbench import roofline
from perfbench.drivers.common import before_slice


def read(ctx, out, summary):
    part = before_slice(out.records, ctx.tracer.host_bounds)
    if part is None:
        return None
    calls, seconds = part
    idx = ctx.config["index"]
    ops, nbytes = roofline.sweep(idx["rows"], idx["dim"], out.records["queries_per_call"], 1)
    return 100.0 * calls * roofline.bound_s(ops, nbytes, roofline.INT8_OPS) / seconds
