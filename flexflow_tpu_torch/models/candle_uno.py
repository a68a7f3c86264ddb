"""CANDLE Uno: examples/cpp/candle_uno/candle_uno.cc — seven input feature
streams; cell/drug streams pass through a shared-architecture feature tower
(bias-free dense 4192 ×3: build_feature_model, candle_uno.cc:49-57), then
concat + final dense tower and a scalar head; MSE loss.
(Twin of `flexflow_tpu/models/candle_uno.py`.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

from ..fftype import ActiMode


@dataclass
class CandleUnoConfig:
    dense_layers: Sequence[int] = (4192, 4192, 4192)
    dense_feature_layers: Sequence[int] = (4192, 4192, 4192)
    # input name → feature type (candle_uno.cc:40-47)
    input_features: Dict[str, str] = field(default_factory=lambda: {
        "dose1": "dose",
        "dose2": "dose",
        "cell.rnaseq": "cell.rnaseq",
        "drug1.descriptors": "drug.descriptors",
        "drug1.fingerprints": "drug.fingerprints",
        "drug2.descriptors": "drug.descriptors",
        "drug2.fingerprints": "drug.fingerprints",
    })
    feature_shapes: Dict[str, int] = field(default_factory=lambda: {
        "dose": 1,
        "cell.rnaseq": 942,
        "drug.descriptors": 5270,
        "drug.fingerprints": 2048,
    })


def _feature_tower(ff, input, layers, prefix):
    t = input
    for i, h in enumerate(layers):
        t = ff.dense(t, h, ActiMode.AC_MODE_RELU, use_bias=False,
                     name=f"{prefix}fc{i}")
    return t


def build_candle_uno(ff, config: CandleUnoConfig | None = None,
                     batch_size: int | None = None):
    c = config or CandleUnoConfig()
    bs = batch_size or ff.config.batch_size
    # cell/drug feature types get an encoder tower (candle_uno.cc:90-103)
    towered = {ft for ft in c.feature_shapes
               if ft.split(".")[0] in ("cell", "drug")}
    all_inputs, encoded = [], []
    for name, ftype in c.input_features.items():
        shape = c.feature_shapes[ftype]
        inp = ff.create_tensor((bs, shape), name=name.replace(".", "_"))
        all_inputs.append(inp)
        if ftype in towered:
            encoded.append(
                _feature_tower(ff, inp, c.dense_feature_layers,
                               f"{name.replace('.', '_')}_")
            )
        else:
            encoded.append(inp)
    out = ff.concat(encoded, -1, name="concat")
    for i, h in enumerate(c.dense_layers):
        out = ff.dense(out, h, ActiMode.AC_MODE_RELU, use_bias=False,
                       name=f"top_fc{i}")
    out = ff.dense(out, 1, use_bias=False, name="head")
    return tuple(all_inputs), out
