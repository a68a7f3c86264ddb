"""The flagship decoder-only Transformer LM (twin of
`flexflow_tpu/models/transformer.py`).

Token + position embedding, pre-LN causal blocks with residuals, an exact
GELU MLP, a final LayerNorm and a vocab head. The layer names are the JAX
package's, so weights copied by name (`convert.load_params`) make both
packages compute the same function, and the serving engine's decode graph
adopts the trained weights by name.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fftype import DataType


@dataclass
class TransformerLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    mlp_ratio: int = 4
    sequence_length: int = 512
    dtype: DataType = DataType.DT_FLOAT
    attention_impl: str = "flash"  # xla | flash


def _lm_trunk(ff, c: TransformerLMConfig, h, attention):
    """The pre-LN block stack + final norm + vocab head, shared between
    the training builder and the decode builder: `attention(x, name)`
    supplies either training MHA or incremental KV-cache attention."""
    for i in range(c.num_layers):
        p = f"l{i}_"
        a = ff.layer_norm(h, [2], name=f"{p}ln1")
        a = attention(a, f"{p}attn")
        h = ff.add(h, a, name=f"{p}res1")
        m = ff.layer_norm(h, [2], name=f"{p}ln2")
        m = ff.dense(m, c.mlp_ratio * c.hidden_size, name=f"{p}ffn1")
        m = ff.gelu(m, name=f"{p}gelu")
        m = ff.dense(m, c.hidden_size, name=f"{p}ffn2")
        h = ff.add(h, m, name=f"{p}res2")
    h = ff.layer_norm(h, [2], name="ln_f")
    return ff.dense(h, c.vocab_size, use_bias=False, name="lm_head")


def build_transformer_lm(ff, config: TransformerLMConfig | None = None,
                         batch_size: int | None = None):
    """Returns (tokens_input, logits). The model also takes a `positions`
    input (0..seq-1 per row) for the position embedding."""
    c = config or TransformerLMConfig()
    bs = batch_size or ff.config.batch_size
    tokens = ff.create_tensor((bs, c.sequence_length), DataType.DT_INT32,
                              name="tokens")
    h = ff.embedding(tokens, c.vocab_size, c.hidden_size, name="wte")
    pos = ff.create_tensor((bs, c.sequence_length), DataType.DT_INT32,
                           name="positions")
    hp = ff.embedding(pos, c.sequence_length, c.hidden_size, name="wpe")
    h = ff.add(h, hp, name="embed_add")

    def attention(a, name):
        return ff.multihead_attention(
            a, a, a, c.hidden_size, c.num_heads, causal=True,
            impl=c.attention_impl, name=name,
        )

    logits = _lm_trunk(ff, c, h, attention)
    return tokens, logits


def build_transformer_lm_decode(ff, config: TransformerLMConfig | None = None,
                                slots: int | None = None,
                                max_seq_len: int | None = None,
                                kv_layout: str | None = None,
                                kv_block_size: int | None = None,
                                kv_num_blocks: int = 0):
    """The LM's decode graph, built directly: one query token per slot,
    per-layer KV caches written at the rows `positions` names. "paged"
    adds the shared `page_table` input and block pools, "contiguous" the
    per-slot region. Returns (tokens, positions, logits)."""
    c = config or TransformerLMConfig()
    n = slots or ff.config.serve_slots
    max_seq = max_seq_len or c.sequence_length
    layout = kv_layout or ff.config.serve_kv_layout
    tokens = ff.create_tensor((n, 1), DataType.DT_INT32, create_grad=False,
                              name="tokens")
    pos = ff.create_tensor((n, 1), DataType.DT_INT32, create_grad=False,
                           name="positions")
    if layout == "paged":
        bs = kv_block_size or ff.config.serve_kv_block_size
        table_width = -(-max_seq // bs)
        num_blocks = kv_num_blocks or n * table_width + 1
        page_table = ff.create_tensor(
            (n, table_width), DataType.DT_INT32, create_grad=False,
            name="page_table")

        def attention(a, name):
            return ff.paged_inc_multihead_attention(
                a, pos, page_table, c.hidden_size, c.num_heads, max_seq,
                bs, num_blocks, name=name,
            )
    else:
        def attention(a, name):
            return ff.inc_multihead_attention(
                a, pos, c.hidden_size, c.num_heads, max_seq, name=name,
            )

    h = ff.embedding(tokens, c.vocab_size, c.hidden_size, name="wte")
    hp = ff.embedding(pos, c.sequence_length, c.hidden_size, name="wpe")
    h = ff.add(h, hp, name="embed_add")
    logits = _lm_trunk(ff, c, h, attention)
    return tokens, pos, logits


def transformer_lm_param_count(c: TransformerLMConfig) -> int:
    """Trainable parameter count (embeddings + blocks + final norm +
    head)."""
    d, L, v = c.hidden_size, c.num_layers, c.vocab_size
    per_layer = (4 * d * d + 4 * d          # attention qkv+o (+ biases)
                 + 2 * c.mlp_ratio * d * d  # mlp up + down
                 + c.mlp_ratio * d + d      # mlp biases
                 + 4 * d)                   # 2x layernorm scale+bias
    return (v * d + c.sequence_length * d   # wte + wpe
            + L * per_layer
            + 2 * d                         # final norm
            + v * d)                        # lm_head


def transformer_lm_flops_per_token(c: TransformerLMConfig) -> float:
    """Analytic forward + backward FLOPs per token for MFU accounting (6N
    over the matmul parameters, plus causal attention), the JAX package's
    formula: the wte/wpe lookups are gathers, only the lm_head counts of
    the embedding-sized parameters."""
    d, L, s, v = c.hidden_size, c.num_layers, c.sequence_length, c.vocab_size
    params_per_layer = 4 * d * d + 2 * c.mlp_ratio * d * d
    n_matmul_params = L * params_per_layer + v * d  # lm_head only
    flops = 6.0 * n_matmul_params
    flops += L * 12.0 * d * s / 2  # causal attention scores+values fwd+bwd
    return flops


# Tiers of the JAX package's zoo that the port runs, same configurations.
TRANSFORMER_LM_ZOO: dict = {
    "lm-smoke": TransformerLMConfig(
        vocab_size=512, hidden_size=128, num_heads=4, num_layers=2,
        sequence_length=128, attention_impl="xla"),
    "lm-base": TransformerLMConfig(
        vocab_size=32000, hidden_size=1024, num_heads=16, num_layers=12,
        sequence_length=512),
    # the zoo's one tier with head_dim 128 (32 heads of 128)
    "lm-xxl-fsdp": TransformerLMConfig(
        vocab_size=32000, hidden_size=4096, num_heads=32, num_layers=32,
        sequence_length=2048),
}
