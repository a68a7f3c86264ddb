"""Device milliseconds a step of the AdamOptimizer's `_foreach_` kernels,
by name in the profiled steps."""

from harness import patterns


def read(ctx):
    t = ctx.get("step_trace")
    if t is None:
        return None
    secs, n = t.matching(patterns("adam"))
    return 1e3 * secs / ctx["steps"] if n else None
