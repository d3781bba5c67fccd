"""Kernel B3 (``csrc/mha.cu``): per launch, the larger of attention's
operations at the bf16 peak and the bytes of q, k, v and the output at the
memory's peak (one launch a layer over the batch), over the launches' time
in the trace."""

from perfbench import roofline

PATTERN = "mha_fwd_bf16"


def read(ctx, out, summary):
    if summary is None:
        return None
    launches, seconds = summary.seconds_of(PATTERN)
    if not launches or seconds <= 0:
        return None
    v = ctx.config["vision_config"]
    b, d = out.records["batch"], v["hidden_size"]
    t = (v["image_size"] // v["patch_size"]) ** 2 + 1
    one = roofline.bound_s(roofline.mha_flops(b, t, d), roofline.mha_bytes(b, t, d))
    return 100.0 * launches * one / seconds
