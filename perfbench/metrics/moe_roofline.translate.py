"""The routed experts' grouped products in the translate cell: their least
time (``perfbench/roofline_deepseek_v2.py`` ``expert_work``: each touched
expert's weights once, from the program's ``moe.experts_hit``, and every
token-expert pair through gate, up and down, at the larger of the bf16 and
memory bounds), summed over the slice's ``llm.generate`` calls, over the
device seconds of the grouped-product kernels in the slice (``torch._grouped_mm``'s
CUTLASS grouped GEMM and the launch that prepares its groups). Nothing
where the program records no such span or the trace no such kernel."""

from perfbench import roofline_deepseek_v2

PATTERNS = ("GroupProblemShape", "prepare_grouped_gemm")


def read(ctx, out, summary):
    if summary is None:
        return None
    calls = [s["counts"] for s in out.records.get("program_spans", ())
             if s["name"] == "llm.generate" and "moe.experts_hit" in s["counts"]]
    seconds = sum(d for n, _, d in summary.kernels if any(p in n for p in PATTERNS))
    if not calls or seconds <= 0:
        return None
    return 100.0 * sum(roofline_deepseek_v2.expert_bound_s(ctx.config, c) for c in calls) / seconds
