"""The step's flash attention kernels (K5-K8) against their roofline: the
least time the step's causal attention needs (operations over the bf16
peak or bytes over the HBM rate, whichever is longer) over the device
time of their launches in the profiled steps."""

from harness import counts, patterns, peaks


def read(ctx):
    t = ctx.get("step_trace")
    if t is None:
        return None
    secs, n = t.matching(patterns("flash_attention"))
    if not n:
        return None
    m, tr = ctx["cell"].config["model"], ctx["cell"].traffic
    h = m["num_heads"]
    ops, by = counts("flash_attention").train_step(
        tr["batch"], h, tr["sequence"], m["hidden_size"] // h,
        m["num_layers"])
    p = peaks()
    least = max(ops / p["bf16_flops_per_s"], by / p["hbm_bytes_per_s"])
    return 100.0 * least * ctx["steps"] / secs
