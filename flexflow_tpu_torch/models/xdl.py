"""XDL: examples/cpp/XDL/xdl.cc — DLRM-style sparse embeddings concatenated
straight into a top MLP (no dense bottom tower); mlp_top (256,256,256,2),
where mlp_top[0] is the concat width and len-1 layers are emitted
(xdl.cc:43, same create_mlp as DLRM).
(Twin of `flexflow_tpu/models/xdl.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..fftype import AggrMode, DataType
from ..initializer import UniformInitializer
from .dlrm import _create_mlp


@dataclass
class XDLConfig:
    sparse_feature_size: int = 64
    embedding_size: Sequence[int] = (1000000,) * 4
    embedding_bag_size: int = 1
    mlp_top: Sequence[int] = (256, 256, 256, 2)


def build_xdl(ff, config: XDLConfig | None = None,
              batch_size: int | None = None):
    c = config or XDLConfig()
    bs = batch_size or ff.config.batch_size
    sparse_inputs = [
        ff.create_tensor((bs, c.embedding_bag_size), DataType.DT_INT64,
                         name=f"sparse{i}")
        for i in range(len(c.embedding_size))
    ]
    ly = []
    for i, s in enumerate(sparse_inputs):
        rng = (1.0 / c.embedding_size[i]) ** 0.5
        t = ff.embedding(s, c.embedding_size[i], c.sparse_feature_size,
                         AggrMode.AGGR_MODE_SUM, dtype=DataType.DT_HALF,
                         kernel_initializer=UniformInitializer(0, -rng, rng),
                         name=f"emb{i}")
        ly.append(ff.cast(t, DataType.DT_FLOAT, name=f"emb{i}_cast"))
    z = ff.concat(ly, -1, name="interact")
    t = _create_mlp(ff, z, c.mlp_top, len(c.mlp_top) - 2, "top_")
    return tuple(sparse_inputs), t
