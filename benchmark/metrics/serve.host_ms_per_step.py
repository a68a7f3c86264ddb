"""Host milliseconds a step: the window's wall time less the time the
engine spent inside its device calls (`stats()['device_s']`, host-timed
around each synchronised call), over the window's steps."""


def read(ctx):
    w = ctx["window"]
    if w["steps"] <= 0:
        return None
    return 1e3 * (w["window_s"] - w["engine_delta"]["device_s"]) / w["steps"]
