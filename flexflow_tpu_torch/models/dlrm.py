"""DLRM: examples/cpp/DLRM/dlrm.cc — sparse embedding towers (AGGR_MODE_SUM,
fp16 tables cast to fp32: create_emb, dlrm.cc:67-82), bottom MLP over dense
features, concat interaction (interact_features, dlrm.cc:84-101), top MLP
with sigmoid head. Defaults follow DLRMConfig (dlrm.cc:26-42).
(Twin of `flexflow_tpu/models/dlrm.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..fftype import ActiMode, AggrMode, DataType
from ..initializer import UniformInitializer


@dataclass
class DLRMConfig:
    sparse_feature_size: int = 64
    embedding_size: Sequence[int] = (1000000,) * 4
    embedding_bag_size: int = 1
    mlp_bot: Sequence[int] = (4, 64, 64)
    mlp_top: Sequence[int] = (64, 64, 2)
    sigmoid_bot: int = -1
    sigmoid_top: int = -1
    arch_interaction_op: str = "cat"


def _create_mlp(ff, input, dims, sigmoid_layer, prefix):
    """dlrm.cc:44-65 (xdl.cc:38-59 identical): dims[0] is the input width;
    emit len-1 bias-free dense layers, relu except sigmoid at
    `sigmoid_layer`."""
    t = input
    for i in range(len(dims) - 1):
        act = (ActiMode.AC_MODE_SIGMOID if i == sigmoid_layer
               else ActiMode.AC_MODE_RELU)
        t = ff.dense(t, dims[i + 1], act, use_bias=False,
                     name=f"{prefix}fc{i}")
    return t


def _create_emb(ff, input, vocab, out_dim, idx):
    rng = (1.0 / vocab) ** 0.5
    t = ff.embedding(input, vocab, out_dim, AggrMode.AGGR_MODE_SUM,
                     dtype=DataType.DT_HALF,
                     kernel_initializer=UniformInitializer(0, -rng, rng),
                     name=f"emb{idx}")
    return ff.cast(t, DataType.DT_FLOAT, name=f"emb{idx}_cast")


def build_dlrm(ff, config: DLRMConfig | None = None,
               batch_size: int | None = None):
    """Returns ((sparse_inputs..., dense_input), output). Loss:
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE (dlrm.cc compile)."""
    c = config or DLRMConfig()
    bs = batch_size or ff.config.batch_size
    sparse_inputs = [
        ff.create_tensor((bs, c.embedding_bag_size), DataType.DT_INT64,
                         name=f"sparse{i}")
        for i in range(len(c.embedding_size))
    ]
    dense_input = ff.create_tensor((bs, c.mlp_bot[0]), name="dense_input")
    ly = [
        _create_emb(ff, s, c.embedding_size[i], c.sparse_feature_size, i)
        for i, s in enumerate(sparse_inputs)
    ]
    x = _create_mlp(ff, dense_input, c.mlp_bot, c.sigmoid_bot, "bot_")
    if c.arch_interaction_op != "cat":
        raise NotImplementedError(
            f"interaction {c.arch_interaction_op!r} (reference supports cat "
            "only, dlrm.cc:84-101)"
        )
    z = ff.concat([x] + ly, -1, name="interact")
    # the reference hardcodes mlp_top.size()-2 at the call site and leaves
    # sigmoid_top dead (dlrm.cc:165); honor the field when explicitly set
    sig_top = c.sigmoid_top if c.sigmoid_top >= 0 else len(c.mlp_top) - 2
    out = _create_mlp(ff, z, c.mlp_top, sig_top, "top_")
    return tuple(sparse_inputs) + (dense_input,), out
