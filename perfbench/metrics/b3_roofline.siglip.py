"""Kernel B3 (``csrc/mha.cu``) in the SigLIP cell: per launch, the larger of
attention's operations at the bf16 peak and the bytes of q, k, v and the
output at the memory's peak, at the shape the program's ``attn.b3`` spans
give over the traced slice (their mean), times the launches, over the
launches' time in the device trace. Nothing where the program records no
such span."""

from perfbench import roofline_siglip

PATTERN = "mha_fwd_bf16"


def read(ctx, out, summary):
    if summary is None:
        return None
    launches, seconds = summary.seconds_of(PATTERN)
    shapes = [s["attrs"] for s in out.records.get("program_spans", ()) if s["name"] == "attn.b3"]
    if not launches or seconds <= 0 or not shapes:
        return None
    one = sum(roofline_siglip.b3_bound_s(a["batch"], a["tokens"], a["dim"])
              for a in shapes) / len(shapes)
    return 100.0 * launches * one / seconds
