"""Transformer models (twin of `flexflow_tpu/models/transformer.py`):
the reference benchmark model (`build_transformer`, transformer.cc) and
the flagship decoder-only LM.

The LM: token + position embedding, pre-LN causal blocks with residuals, an exact
GELU MLP, a final LayerNorm and a vocab head. The layer names are the JAX
package's, so weights copied by name (`convert.load_params`) make both
packages compute the same function, and the serving engine's decode graph
adopts the trained weights by name. `build_transformer_lm_pipelined`
puts the block stack into one PipelineBlocks op (its own block function)
whose layers shard over the `pipe` mesh axis.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fftype import ActiMode, DataType


@dataclass
class TransformerConfig:
    """The reference benchmark model's settings (transformer.cc:79-85)."""

    hidden_size: int = 1024
    embedding_size: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    sequence_length: int = 512


def create_attention_encoder(ff, input, hidden_dim, num_heads, kdim, vdim,
                             prefix=""):
    """transformer.cc:33-45: MHA, then dense(hidden, relu, no bias) and
    dense(hidden, no bias); no residuals or LayerNorm, as the reference."""
    t = ff.multihead_attention(input, input, input, hidden_dim, num_heads,
                               kdim, vdim, name=f"{prefix}attn")
    t = ff.dense(t, hidden_dim, ActiMode.AC_MODE_RELU, use_bias=False,
                 name=f"{prefix}ffn1")
    return ff.dense(t, hidden_dim, use_bias=False, name=f"{prefix}ffn2")


def build_transformer(ff, config: TransformerConfig | None = None,
                      batch_size: int | None = None):
    """The reference benchmark model (transformer.cc:112-160): a stack of
    `create_attention_encoder` blocks on a (batch, seq, hidden) float
    input and a dense(1) head. Returns (input_tensor, output_tensor);
    the loss is LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE (transformer.cc:163)."""
    c = config or TransformerConfig()
    bs = batch_size or ff.config.batch_size
    input = ff.create_tensor((bs, c.sequence_length, c.hidden_size),
                             name="input")
    t = input
    for i in range(c.num_layers):
        t = create_attention_encoder(
            ff, t, c.hidden_size, c.num_heads,
            c.hidden_size // c.num_heads, c.hidden_size // c.num_heads,
            prefix=f"l{i}_")
    t = ff.dense(t, 1, use_bias=False, name="head")
    return input, t


@dataclass
class TransformerLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    mlp_ratio: int = 4
    sequence_length: int = 512
    dtype: DataType = DataType.DT_FLOAT
    attention_impl: str = "flash"  # xla | flash | ring


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


def build_transformer_lm_pipelined(ff, config: TransformerLMConfig | None = None,
                                   batch_size: int | None = None,
                                   num_microbatches: int = 0):
    """The LM with its block stack as one PipelineBlocks op, whose layer
    dim shards over the `pipe` mesh axis (parallel/pipeline.py). The
    block is the op's own (fused qkv, tanh GELU, plain LayerNorm), so
    this is a different function from `build_transformer_lm`'s trunk;
    on a mesh with no pipe axis the same op runs its blocks in order.
    Returns (tokens_input, logits)."""
    c = config or TransformerLMConfig()
    bs = batch_size or ff.config.batch_size
    tokens = ff.create_tensor((bs, c.sequence_length), DataType.DT_INT32,
                              name="tokens")
    h = ff.embedding(tokens, c.vocab_size, c.hidden_size, name="wte")
    pos = ff.create_tensor((bs, c.sequence_length), DataType.DT_INT32,
                           name="positions")
    hp = ff.embedding(pos, c.sequence_length, c.hidden_size, name="wpe")
    h = ff.add(h, hp, name="embed_add")
    h = ff.pipeline_blocks(h, c.num_layers, c.num_heads, c.mlp_ratio,
                           num_microbatches=num_microbatches, causal=True,
                           attention_impl=c.attention_impl, name="blocks")
    h = ff.layer_norm(h, [2], name="ln_f")
    logits = ff.dense(h, c.vocab_size, use_bias=False, name="lm_head")
    return tokens, logits


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


def transformer_lm_state_bytes_per_chip(c: TransformerLMConfig,
                                        opt_slots: int = 2,
                                        update_stage: int = 0,
                                        shards: int = 1) -> float:
    """Resident fp32 training-state bytes per chip (master, gradient and
    `opt_slots` optimizer entries per parameter) under a weight-update
    stage: stage 2 shards masters, gradients and slots 1/shards but keeps
    one gathered compute copy of each weight; stage 3 shards the weights
    at rest too."""
    n = float(transformer_lm_param_count(c)) * 4.0
    state = n * (2 + opt_slots)
    if update_stage >= 3 and shards > 1:
        return state / shards
    if update_stage >= 2 and shards > 1:
        return n + state / shards
    return state


# Tiers of the JAX package's zoo that the port runs, same configurations.
# The -fsdp tiers' replicated training state (about 16 bytes a parameter
# with Adam) exceeds one chip of the HBM class they name; stage 3 over
# enough data shards fits them.
TRANSFORMER_LM_ZOO: dict = {
    "lm-smoke": TransformerLMConfig(
        vocab_size=512, hidden_size=128, num_heads=4, num_layers=2,
        sequence_length=128, attention_impl="xla"),
    # speculative-decoding drafter for lm-smoke: the same vocab and
    # positional extent (a drafter shares the target's tokenizer and
    # reaches every position it decodes at), a quarter the width, half
    # the depth
    "lm-smoke-draft": TransformerLMConfig(
        vocab_size=512, hidden_size=32, num_heads=2, num_layers=1,
        sequence_length=128, attention_impl="xla"),
    "lm-base": TransformerLMConfig(
        vocab_size=32000, hidden_size=1024, num_heads=16, num_layers=12,
        sequence_length=512),
    # drafter for lm-base: about 20x smaller, sharing the 32k vocab and
    # the 512-token extent
    "lm-base-draft": TransformerLMConfig(
        vocab_size=32000, hidden_size=256, num_heads=4, num_layers=4,
        sequence_length=512),
    # ~1.3B params: replicated Adam state ~21 GB
    "lm-xl-fsdp": TransformerLMConfig(
        vocab_size=32000, hidden_size=2048, num_heads=32, num_layers=24,
        sequence_length=1024),
    # head_dim 128 (32 heads of 128); ~6.7B params: replicated Adam state
    # ~107 GB
    "lm-xxl-fsdp": TransformerLMConfig(
        vocab_size=32000, hidden_size=4096, num_heads=32, num_layers=32,
        sequence_length=2048),
}
