"""Device milliseconds per call of everything but kernel B2 in the traced
slice: chunk top-k, gather, rescore and the final top-k of
``search_vectors``. A call launches B2 once per 64 queries of its padded
batch."""

PATTERN = "int8_chunk_max_kernel"
B2_QUERIES = 64


def _padded(b: int) -> int:
    if b <= 8:
        return 8
    if b > 128:
        return -(-b // 32) * 32
    return 1 << (b - 1).bit_length()


def read(ctx, out, summary):
    if summary is None or not summary.kernels:
        return None
    launches, b2 = summary.seconds_of(PATTERN)
    per_call = -(-_padded(out.records["queries_per_call"]) // B2_QUERIES)
    calls = launches / per_call
    if calls <= 0:
        return None
    rest = sum(d for _, _, d in summary.kernels) - b2
    return 1e3 * rest / calls
