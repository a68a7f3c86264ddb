"""Share of the profiled serving steps' wall time in which no device operation ran
(1 minus the union of kernel, copy and set intervals over the region)."""


def read(ctx):
    t = ctx.get("step_trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
