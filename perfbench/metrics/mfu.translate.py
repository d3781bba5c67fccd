"""DeepSeek-V2-Lite's generation calls' share of the chip's peak: per call,
the larger of its operations at the bf16 peak and its bytes at the memory's
peak (``perfbench/roofline_deepseek_v2.py``: every weight outside the
routed experts once a pass, each touched expert once, the cached latents
read), from the program's counters on ``llm.generate`` (tokens computed,
steps, ``moe.experts_hit``) and the configuration's shapes; the mean over
the slice's calls, times the calls that ended before the traced slice,
over their seconds (the profiler slows the host, so the slice and what
follows are left out). Nothing where the program records no such span."""

from perfbench import roofline_deepseek_v2
from perfbench.drivers.common import before_slice


def read(ctx, out, summary):
    part = before_slice(out.records, ctx.tracer.host_bounds)
    calls = [s for s in out.records.get("program_spans", ())
             if s["name"] == "llm.generate" and "moe.experts_hit" in s["counts"]]
    if part is None or not calls:
        return None
    n, seconds = part
    prefix = out.records["prefix_tokens"]
    per_call = sum(roofline_deepseek_v2.call_bound_s(ctx.config, s["counts"], s["attrs"]["rows"],
                                                     s["attrs"]["prompt_tokens"], prefix)
                   for s in calls) / len(calls)
    return 100.0 * n * per_call / seconds
