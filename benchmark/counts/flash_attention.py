"""Operations and bytes of causal flash attention in a training step.

Per layer, at batch b, h heads of width hd and sequence s: the forward's
Q K^T and P V over the lower triangle, 2 b h s^2 hd operations; the
backward's four products (dV, dP, dQ, dK) twice that; no recompute. Bytes
read once and written once: q, k, v in, o and the row statistics out
forward; q, k, v, o, dO and the statistics in, dq, dk, dv out backward.
"""


def train_step(b: int, h: int, s: int, hd: int, layers: int,
               elem_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one step's attention, forward and
    backward."""
    ops = layers * 3 * 2.0 * b * h * s * s * hd
    act = b * s * h * hd * elem_bytes
    stats = b * h * s * 4
    by = layers * ((4 * act + stats) + (5 * act + stats + 3 * act))
    return ops, by
