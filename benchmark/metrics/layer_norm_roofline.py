"""The step's LayerNorm kernels (K1, K4) against their roofline: the bytes
of the step's 2 L + 1 LayerNorms, forward and backward, over the HBM rate,
over the device time of their launches in the profiled steps."""

from harness import counts, patterns, peaks


def read(ctx):
    t = ctx.get("step_trace")
    if t is None:
        return None
    secs, n = t.matching(patterns("layer_norm"))
    if not n:
        return None
    m, tr = ctx["cell"].config["model"], ctx["cell"].traffic
    by = counts("layer_norm").train_step(
        tr["batch"] * tr["sequence"], m["hidden_size"],
        2 * m["num_layers"] + 1)
    least = by / peaks()["hbm_bytes_per_s"]
    return 100.0 * least * ctx["steps"] / secs
