"""Layer: the lazy frontend IR record (twin of `flexflow_tpu/layer.py`).

Builder calls create Layers before compile(); compile turns them into
graph nodes.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

from .fftype import DataType, OperatorType

_layer_guid = itertools.count(1000000)  # LAYER_GUID_FIRST_VALID


class Layer:
    def __init__(
        self,
        op_type: OperatorType,
        params: Any,
        inputs: list,
        name: str = "",
        data_type: DataType = DataType.DT_FLOAT,
        initializers: Optional[dict] = None,
    ):
        self.layer_guid = next(_layer_guid)
        self.op_type = op_type
        self.params = params
        self.inputs = list(inputs)
        self.outputs = []
        self.data_type = data_type
        self.name = name or f"{op_type.name.lower()}_{self.layer_guid}"
        # per-weight Initializer overrides, name -> Initializer
        self.initializers = initializers or {}
        # tied weights: the layer_guid whose parameters this layer reads
        # (FFModel's shared_op), else -1
        self.shared_layer_guid = -1

    def __repr__(self):
        return f"Layer({self.name}, {self.op_type.name})"
