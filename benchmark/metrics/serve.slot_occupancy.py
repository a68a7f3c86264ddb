"""Decoding slots a decode iteration, over the slots: the engine's own
counts (`stats()`: decode tokens less the first tokens that prefills
sampled, over decode iterations) across the window."""


def read(ctx):
    w = ctx["window"]
    d = w["engine_delta"]
    if d["decode_iterations"] <= 0:
        return None
    decoded = d["decode_tokens"] - w["first_tokens"]
    return 100.0 * decoded / d["decode_iterations"] / w["slots"]
