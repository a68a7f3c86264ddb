"""Bytes of the LayerNorms of a training step, read once and written once.

Each of the step's LayerNorms normalises `rows` rows of width d in the
activations' type: the forward reads x and the f32 scale and bias and
writes y; the backward reads x, dy and the scale and writes dx and the
f32 scale and bias gradients. The row statistics are not counted: they
can be made again from x.
"""


def train_step(rows: int, d: int, count: int,
               elem_bytes: int = 2) -> float:
    fwd = 2 * rows * d * elem_bytes + 2 * d * 4
    bwd = 3 * rows * d * elem_bytes + 3 * d * 4
    return float(count * (fwd + bwd))
