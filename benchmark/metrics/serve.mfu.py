"""The served tokens' share of the card's bf16 peak over the window:
2 a matrix parameter for every token the model processed (each prompt
token, each fed-back output token) plus attention's 4 d a context
position a layer, counted on the client, over the window's wall time."""

from harness import counts, peaks


def read(ctx):
    w = ctx["window"]
    m = ctx["cell"].config["model"]
    flops = counts("gpt").serve_flops(m, w["processed_tokens"],
                                      w["context_sum"])
    return 100.0 * flops / w["window_s"] / peaks()["bf16_flops_per_s"]
