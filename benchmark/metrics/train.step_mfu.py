"""The whole training step's share of the card's bf16 peak: the frozen
6N + causal attention count a token, times the window's tokens a second
(host clock, the whole window), over the peak."""

from harness import counts, peaks


def read(ctx):
    m = ctx["cell"].config["model"]
    flops = counts("gpt").train_flops_per_token(m) * ctx["window"][
        "tokens_per_s"]
    return 100.0 * flops / peaks()["bf16_flops_per_s"]
