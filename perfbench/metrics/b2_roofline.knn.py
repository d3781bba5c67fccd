"""Kernel B2 (``csrc/int8_sweep.cu``): the bytes of the int8 rows and their
scales that each launch must read, at the memory's peak rate, over the
launches' time in the trace."""

from perfbench import roofline

PATTERN = "int8_chunk_max_kernel"


def read(ctx, out, summary):
    if summary is None:
        return None
    launches, seconds = summary.seconds_of(PATTERN)
    if not launches or seconds <= 0:
        return None
    idx = ctx.config["index"]
    _, nbytes = roofline.sweep(idx["rows"], idx["dim"], 1, 1)
    return 100.0 * launches * nbytes / roofline.HBM_BYTES / seconds
