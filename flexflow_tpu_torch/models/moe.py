"""Mixture-of-Experts classifier: examples/cpp/mixture_of_experts/moe.cc —
the MNIST MoE model (moe.cc:137-160: one ff.moe block over flattened input,
then the reference encoder variant create_moe_encoder with attention +
residual layer_norm, moe.cc:100-124).
(Twin of `flexflow_tpu/models/moe.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MoeConfig:
    # moe.h defaults
    num_exp: int = 5
    num_select: int = 2
    alpha: float = 2.0
    lambda_bal: float = 0.04
    hidden_size: int = 64
    num_attention_heads: int = 16
    num_encoder_layers: int = 6
    in_dim: int = 784
    num_classes: int = 10


def build_moe(ff, config: MoeConfig | None = None,
              batch_size: int | None = None, fused: bool = False):
    """The flat MNIST MoE (moe.cc:151-160): input → moe → softmax."""
    c = config or MoeConfig()
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, c.in_dim), name="input")
    t = ff.moe(input, c.num_exp, c.num_select, c.num_classes, c.alpha,
               c.lambda_bal, fused=fused)
    t = ff.softmax(t, name="softmax")
    return input, t


def build_moe_encoder(ff, config: MoeConfig | None = None,
                      batch_size: int | None = None, seq_length: int = 64,
                      fused: bool = True):
    """create_moe_encoder (moe.cc:100-124): per layer, attention + residual
    layer_norm, then MoE + residual layer_norm. Requires 3D (b, s, d) input;
    the MoE runs per flattened token (reference partitions the sample dim)."""
    c = config or MoeConfig()
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, seq_length, c.hidden_size), name="input")
    x = input
    for i in range(c.num_encoder_layers):
        a = ff.multihead_attention(
            x, x, x, c.hidden_size, c.num_attention_heads,
            name=f"enc{i}_attn",
        )
        x = ff.layer_norm(ff.add(a, x, name=f"enc{i}_res1"), [2],
                          name=f"enc{i}_ln1")
        flat = ff.reshape(x, (bs * seq_length, c.hidden_size),
                          name=f"enc{i}_flat")
        m = ff.moe(flat, c.num_exp, c.num_select, c.hidden_size, c.alpha,
                   c.lambda_bal, fused=fused)
        m = ff.reshape(m, (bs, seq_length, c.hidden_size),
                       name=f"enc{i}_unflat")
        x = ff.layer_norm(ff.add(m, x, name=f"enc{i}_res2"), [2],
                          name=f"enc{i}_ln2")
    t = ff.mean(x, [1], name="pool")
    t = ff.dense(t, c.num_classes, name="head")
    t = ff.softmax(t, name="softmax")
    return input, t
