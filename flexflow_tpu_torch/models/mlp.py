"""MLP models.

- `build_mnist_mlp`: examples/python/native/mnist_mlp.py:14-26 — dense 512
  relu ×2, dense 10, softmax; the reference's E2E accuracy-gate model.
- `build_mlp_unify`: examples/cpp/MLP_Unify/mlp.cc — two input towers of
  bias-free dense layers whose outputs are summed, then softmax.
"""

from __future__ import annotations

from typing import Sequence

from ..fftype import ActiMode


def build_mnist_mlp(ff, batch_size: int | None = None, in_dim: int = 784,
                    num_classes: int = 10):
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, in_dim), name="input")
    t = ff.dense(input, 512, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 512, ActiMode.AC_MODE_RELU, name="fc2")
    t = ff.dense(t, num_classes, name="fc3")
    t = ff.softmax(t, name="softmax")
    return input, t


def build_mlp_unify(ff, batch_size: int | None = None, in_dim: int = 1024,
                    hidden_dims: Sequence[int] = (8192, 8192, 8192, 8192)):
    bs = batch_size or ff.config.batch_size
    x1 = ff.create_tensor((bs, in_dim), name="input1")
    x2 = ff.create_tensor((bs, in_dim), name="input2")
    t1, t2 = x1, x2
    for i, h in enumerate(hidden_dims):
        t1 = ff.dense(t1, h, ActiMode.AC_MODE_RELU, use_bias=False,
                      name=f"t1_fc{i}")
        t2 = ff.dense(t2, h, ActiMode.AC_MODE_RELU, use_bias=False,
                      name=f"t2_fc{i}")
    t = ff.add(t1, t2, name="unify")
    t = ff.softmax(t, name="softmax")
    return (x1, x2), t
