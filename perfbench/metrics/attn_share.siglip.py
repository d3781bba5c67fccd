"""Kernel B3's share of the device's busy time in the traced slice: its
launches' seconds (``mha_fwd_bf16``, both variants) over the union of every
kernel, copy and set."""

PATTERN = "mha_fwd_bf16"


def read(ctx, out, summary):
    if summary is None or summary.busy_s <= 0:
        return None
    launches, seconds = summary.seconds_of(PATTERN)
    if not launches:
        return None
    return 100.0 * seconds / summary.busy_s
