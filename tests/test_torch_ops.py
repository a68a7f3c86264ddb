"""Each op of the port's serving slice against the JAX package's op.

Same numpy inputs and weights, made from a seed, go through the JAX op's
forward and the port's, in float32 with the tensor-op policy off on both
sides. Tolerance: rtol = atol = 2e-5 (float32 sums in another order).
The incremental-attention ops are checked on their output AND on the KV
state they leave behind, including dead (scratch-bound) positions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import ops as jops
from flexflow_tpu.fftype import ActiMode as JActi, OperatorType as JOT
from flexflow_tpu.ops.base import OpContext as JCtx, get_op_def as jdef
from flexflow_tpu_torch import ops as tops
from flexflow_tpu_torch.fftype import ActiMode as TActi, OperatorType as TOT
from flexflow_tpu_torch.ops.base import OpContext as TCtx, get_op_def as tdef

TOL = dict(rtol=2e-5, atol=2e-5)


def _run(op_name, jparams, tparams, inputs, weights, state=None):
    """Forward one op in both packages; returns (jax outs, jax state,
    torch outs, torch state) as numpy."""
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tw = {k: torch.tensor(v) for k, v in weights.items()}
    if state:
        jw.update({k: jnp.asarray(v) for k, v in state.items()})
        tw.update({k: torch.tensor(v) for k, v in state.items()})
    jouts, jst = jdef(getattr(JOT, op_name)).forward(
        jparams, [jnp.asarray(x) for x in inputs], jw, None,
        JCtx(training=False))
    touts, tst = tdef(getattr(TOT, op_name)).forward(
        tparams, [torch.tensor(x) for x in inputs], tw, None,
        TCtx(training=False))
    return ([np.asarray(o, np.float32) for o in jouts],
            {k: np.asarray(v) for k, v in (jst or {}).items()},
            [o.float().numpy() for o in touts],
            {k: v.numpy() for k, v in (tst or {}).items()})


def test_op_enums_agree():
    for name in ("OP_LINEAR", "OP_EMBEDDING", "OP_EW_ADD", "OP_GELU",
                 "OP_LAYERNORM", "OP_MULTIHEAD_ATTENTION",
                 "OP_INC_MULTIHEAD_ATTENTION",
                 "OP_PAGED_INC_MULTIHEAD_ATTENTION"):
        assert int(getattr(TOT, name)) == int(getattr(JOT, name)), name


@pytest.mark.parametrize("act", ["AC_MODE_NONE", "AC_MODE_RELU",
                                 "AC_MODE_GELU"])
def test_linear(act):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 24).astype(np.float32)
    w = {"kernel": rs.randn(24, 40).astype(np.float32),
         "bias": rs.randn(40).astype(np.float32)}
    jo, _, to, _ = _run("OP_LINEAR",
                        jops.LinearParams(40, True, getattr(JActi, act)),
                        tops.LinearParams(40, True, getattr(TActi, act)),
                        [x], w)
    np.testing.assert_allclose(to[0], jo[0], **TOL)


@pytest.mark.parametrize("axes", [(2,), (1, 2)])
def test_layer_norm(axes):
    """Last-axis (the kernel's case, its plain version on the CPU) and a
    two-axis norm (plain torch, CPU only)."""
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 6, 128) * 2 + 0.5).astype(np.float32)
    shape = tuple(x.shape[a] for a in axes)
    w = {"scale": rs.randn(*shape).astype(np.float32),
         "bias": rs.randn(*shape).astype(np.float32)}
    jo, _, to, _ = _run("OP_LAYERNORM", jops.LayerNormParams(axes),
                        tops.LayerNormParams(axes), [x], w)
    np.testing.assert_allclose(to[0], jo[0], **TOL)


def test_embedding_out_of_range_ids_fill_nan():
    """The engine pads idle elements with position max_seq_len, one past
    the position table: the JAX gather fills NaN there, and so must the
    port (a plain F.embedding would raise)."""
    rs = np.random.RandomState(2)
    table = rs.randn(10, 8).astype(np.float32)
    ids = np.asarray([[0, 9, 10], [-1, 3, 25]], np.int32)
    jo, _, to, _ = _run("OP_EMBEDDING", jops.EmbeddingParams(10, 8),
                        tops.EmbeddingParams(10, 8), [ids],
                        {"kernel": table})
    np.testing.assert_array_equal(np.isnan(to[0]), np.isnan(jo[0]))
    assert np.isnan(to[0][0, 2]).all() and np.isnan(to[0][1, 2]).all()
    np.testing.assert_allclose(to[0], jo[0], **TOL)


def test_gelu_is_exact_erf_form_and_add():
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 33) * 3).astype(np.float32)
    y = rs.randn(4, 33).astype(np.float32)
    jo, _, to, _ = _run("OP_GELU", jops.ElementUnaryParams(JOT.OP_GELU),
                        tops.ElementUnaryParams(TOT.OP_GELU), [x], {})
    np.testing.assert_allclose(to[0], jo[0], **TOL)
    jo, _, to, _ = _run("OP_EW_ADD",
                        jops.ElementBinaryParams(JOT.OP_EW_ADD),
                        tops.ElementBinaryParams(TOT.OP_EW_ADD), [x, y], {})
    np.testing.assert_allclose(to[0], jo[0], **TOL)


def _attn_weights(rs, d, e):
    w = {n: (rs.randn(d, e) / np.sqrt(d)).astype(np.float32)
         for n in ("wq", "wk", "wv")}
    w["wo"] = (rs.randn(e, e) / np.sqrt(e)).astype(np.float32)
    for n in ("bq", "bk", "bv", "bo"):
        w[n] = (rs.randn(e) * 0.1).astype(np.float32)
    return w


SLOTS, MAX_SEQ, E_, H_ = 3, 24, 32, 4


@pytest.mark.parametrize("q_len", [1, 3])
def test_inc_attention_contiguous(q_len):
    """Cache write + read. Slot 2 is idle: its elements sit at the scratch
    position max_seq_len and must leave every real row untouched."""
    rs = np.random.RandomState(4)
    x = rs.randn(SLOTS, q_len, E_).astype(np.float32)
    pos = np.full((SLOTS, q_len), MAX_SEQ, np.int32)
    pos[0] = np.arange(5, 5 + q_len)
    pos[1] = np.arange(MAX_SEQ - q_len, MAX_SEQ)
    state = {n: rs.randn(SLOTS, MAX_SEQ + 1, E_).astype(np.float32)
             for n in ("cache_k", "cache_v")}
    p_j = jops.IncMultiHeadAttentionParams(E_, H_, MAX_SEQ)
    p_t = tops.IncMultiHeadAttentionParams(E_, H_, MAX_SEQ)
    jo, js, to, ts = _run("OP_INC_MULTIHEAD_ATTENTION", p_j, p_t,
                          [x, pos], _attn_weights(rs, E_, E_), state)
    live = [0, 1]  # an idle slot's output row is never read
    np.testing.assert_allclose(to[0][live], jo[0][live], **TOL)
    for n in ("cache_k", "cache_v"):
        np.testing.assert_allclose(ts[n], js[n], **TOL)
        np.testing.assert_array_equal(ts[n][2, :MAX_SEQ],
                                      state[n][2, :MAX_SEQ])
        assert (ts[n][2, MAX_SEQ] == 0).all()  # scratch row: zeros


@pytest.mark.parametrize("q_len", [1, 3])
def test_inc_attention_paged(q_len):
    """Pool write + read through a page table; slot 1 shares slot 0's
    first block read-only, slot 2 is idle and writes zeros into the
    scratch block 0 only."""
    rs = np.random.RandomState(5)
    bs, nb = 8, 10
    W = MAX_SEQ // bs
    x = rs.randn(SLOTS, q_len, E_).astype(np.float32)
    pos = np.full((SLOTS, q_len), MAX_SEQ, np.int32)
    pos[0] = np.arange(9, 9 + q_len)     # inside logical block 1
    pos[1] = np.arange(16, 16 + q_len)   # block 2
    table = np.asarray([[3, 7, 0], [3, 5, 9], [0, 0, 0]], np.int32)
    state = {n: rs.randn(nb, bs, E_).astype(np.float32)
             for n in ("pool_k", "pool_v")}
    p_j = jops.PagedIncMultiHeadAttentionParams(E_, H_, MAX_SEQ, bs, nb)
    p_t = tops.PagedIncMultiHeadAttentionParams(E_, H_, MAX_SEQ, bs, nb)
    assert p_t.blocks_per_slot == W
    jo, js, to, ts = _run("OP_PAGED_INC_MULTIHEAD_ATTENTION", p_j, p_t,
                          [x, pos, table], _attn_weights(rs, E_, E_), state)
    live = [0, 1]
    np.testing.assert_allclose(to[0][live], jo[0][live], **TOL)
    for n in ("pool_k", "pool_v"):
        np.testing.assert_allclose(ts[n], js[n], **TOL)
        # the idle slot's write: clipped to max_seq - 1, routed to block 0
        assert (ts[n][0, (MAX_SEQ - 1) % bs] == 0).all()
        np.testing.assert_array_equal(ts[n][[1, 2, 4, 6, 8]],
                                      state[n][[1, 2, 4, 6, 8]])


def test_training_attention_forward_raises():
    """The MHA op's weights match the JAX op's by name (the decode replay
    adopts them); its training forward runs "flash" and "xla"
    (tests/test_torch_train.py) and "ring", which with no mesh is
    `sdpa_xla` in both packages (the ring schedule itself:
    tests/test_torch_ring.py). What raises, in both packages alike, is
    ring attention inside the pipelined blocks, whose schedule does not
    thread the seq axis."""
    p = tops.MultiHeadAttentionParams(E_, H_, causal=True, impl="ring")
    jp = jops.MultiHeadAttentionParams(E_, H_, causal=True, impl="ring")
    x = torch.zeros(2, 4, E_)
    specs = tdef(TOT.OP_MULTIHEAD_ATTENTION).weights(p, [x.shape] * 3)
    assert [w.name for w in specs] == [w.name for w in jdef(
        JOT.OP_MULTIHEAD_ATTENTION).weights(jp, [tuple(x.shape)] * 3)]
    rs = np.random.RandomState(3)
    weights = {w.name: rs.randn(*w.shape).astype(np.float32) * 0.3
               for w in specs}
    xs = rs.randn(2, 4, E_).astype(np.float32)
    jo, _, to, _ = _run("OP_MULTIHEAD_ATTENTION", jp, p, [xs] * 3, weights)
    np.testing.assert_allclose(to[0], jo[0], **TOL)
    xla = dataclasses.replace(p, impl="xla")
    _, _, to_xla, _ = _run("OP_MULTIHEAD_ATTENTION", jp, xla, [xs] * 3,
                           weights)
    np.testing.assert_array_equal(to[0], to_xla[0])
    pb = tops.PipelineBlocksParams(2, H_, attention_impl="ring")
    stacked = {w.name: torch.zeros(w.shape) for w in tdef(
        TOT.OP_PIPE_BLOCKS).weights(pb, [x.shape])}
    with pytest.raises(ValueError, match="ring attention needs the seq"):
        tdef(TOT.OP_PIPE_BLOCKS).forward(pb, [x], stacked, None, TCtx())
    with pytest.raises(ValueError, match="ring attention needs the seq"):
        jdef(JOT.OP_PIPE_BLOCKS).forward(
            jops.PipelineBlocksParams(2, H_, attention_impl="ring"),
            [jnp.zeros((2, 4, E_))], {k: jnp.zeros(v.shape)
                                      for k, v in stacked.items()},
            None, JCtx())
