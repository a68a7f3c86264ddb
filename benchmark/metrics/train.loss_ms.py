"""Device milliseconds a step of the loss layer in the profiled steps of
the captured `fit` step: every kernel that runs between the head's
logits product and its gradient products, the forward and backward of
the sparse cross-entropy with the metric counter's sum, found as the
runs of kernels between matrix products (`kernel_names/gemm.json`) that
hold a kernel only the loss runs (`kernel_names/loss.json`)."""

from harness import patterns


def read(ctx):
    t = ctx.get("step_trace")
    if t is None:
        return None
    secs, runs = t.runs_holding(patterns("loss"), patterns("gemm"))
    return 1e3 * secs / ctx["steps"] if runs else None
