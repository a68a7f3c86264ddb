"""Operation counts of the GPT model from its sizes.

`train_flops_per_token` is a frozen copy of the program's
`transformer_lm_flops_per_token`: 6 N over the matrix parameters (the
head among them, the embedding gathers not) plus causal attention's
scores and values, forward and backward, with no recompute counted.
"""


def matmul_params(m: dict) -> int:
    d, L, v = m["hidden_size"], m["num_layers"], m["vocab_size"]
    return L * (4 * d * d + 2 * m["mlp_ratio"] * d * d) + v * d


def train_flops_per_token(m: dict) -> float:
    d, L, s = m["hidden_size"], m["num_layers"], m["sequence_length"]
    return 6.0 * matmul_params(m) + L * 12.0 * d * s / 2


def serve_flops(m: dict, tokens: int, context_sum: int) -> float:
    """Forward operations of serving `tokens` tokens whose attention
    contexts (the positions each one attends to) sum to `context_sum`:
    2 a matrix parameter a token, and 4 d a context position a layer."""
    return (2.0 * matmul_params(m) * tokens
            + 4.0 * m["hidden_size"] * m["num_layers"] * context_sum)
