"""Median wait from a client's send to the engine's admission of its
request (`Request.admit_t`), over the requests admitted in the window."""

import statistics


def read(ctx):
    waits = ctx["window"]["queue_waits"]
    return 1e3 * statistics.median(waits) if waits else None
