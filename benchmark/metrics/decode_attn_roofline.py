"""The paged decode attention kernel (K3) against its roofline in the
profiled serving steps: the bytes of each pure-decode step's calls (every
decoding slot's K and V up to its length, in the cache's float32, its
query and output) over the HBM rate, over K3's device time. Prefill steps
run no K3 and count on neither side."""

from harness import counts, patterns, peaks


def read(ctx):
    t = ctx.get("step_trace")
    if t is None:
        return None
    secs, n = t.matching(patterns("paged_decode"))
    if not n:
        return None
    m = ctx["cell"].config["model"]
    c = counts("paged_decode")
    by = sum(c.call_bytes(ctx_sum, slots, m["hidden_size"])
             for ctx_sum, slots in ctx["decode_steps"]) * m["num_layers"]
    return 100.0 * by / peaks()["hbm_bytes_per_s"] / secs
