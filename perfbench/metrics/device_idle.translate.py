"""Share of the traced slice in which no kernel, copy or set ran on the
device (``torch.profiler``)."""


def read(ctx, out, summary):
    if summary is None or summary.window_s <= 0 or not summary.kernels:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
