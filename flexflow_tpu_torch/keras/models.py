"""Keras Sequential + functional Model (reference keras/models/*.py).

compile() lowers the symbolic layer DAG onto a fresh FFModel (the reference's
BaseModel.compile → _create_flexflow_layers, base_model.py:128-197); fit/
evaluate delegate to FFModel.fit/eval (same trace loop semantics,
base_model.py:198-376).
(Twin of `flexflow_tpu/keras/models.py`.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..fftype import DataType, LossType, MetricsType
from ..model import FFModel
from .layers import InputLayer, KTensor, Layer
from . import optimizers as _optim

_LOSSES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
}

_METRICS = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


class BaseModel:
    def __init__(self, name=None):
        self.name = name
        self.ffmodel: Optional[FFModel] = None
        self.ffconfig = FFConfig()
        self._output_tensor = None
        self.optimizer = None  # the core optimizer, set by compile()

    # ---- provided by subclasses: producing KTensors in topological order
    def _topo_calls(self):
        raise NotImplementedError

    def _input_ktensors(self):
        raise NotImplementedError

    def compile(self, optimizer, loss=None, metrics=None, **kwargs):
        ff = FFModel(self.ffconfig)
        mapping = {}
        for kt in self._input_ktensors():
            shape = list(kt.shape)
            if shape[0] is None:
                shape[0] = self.ffconfig.batch_size
            dtype = (DataType.DT_INT32 if "int" in str(kt.dtype)
                     else DataType.DT_FLOAT)
            mapping[kt.name] = ff.create_tensor(shape, dtype, name=kt.name)
        import inspect

        call_counts: dict = {}
        for kt in self._topo_calls():
            layer = kt.layer
            # stale anchors from a previous compile must not leak into this
            # FFModel
            if call_counts.get(id(layer), 0) == 0:
                layer._ff_dense_out = None
            ins = [mapping[t.name] for t in kt.call_inputs]
            n = call_counts.get(id(layer), 0)
            call_counts[id(layer)] = n + 1
            if n > 0:
                # shared layer called again: materialize under a unique name
                # tied to the first call's parameters (Keras layer-sharing
                # semantics; reference dense/embedding shared_op). Layer
                # types whose materialize has no shared_op parameter fall
                # back to per-call weights — a real limitation for weighted
                # layers other than Dense, kept visible here rather than
                # swallowed by a broad except.
                saved = layer.name
                layer.name = f"{saved}_call{n}"
                sig = inspect.signature(layer.materialize)
                if "shared_op" in sig.parameters:
                    out = layer.materialize(ff, ins, shared_op=True)
                else:
                    out = layer.materialize(ff, ins)
                layer.name = saved
            else:
                out = layer.materialize(ff, ins)
            mapping[kt.name] = out
        loss_type = _LOSSES[loss] if isinstance(loss, str) else (
            loss or LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        mtypes = [_METRICS[m] if isinstance(m, str) else m
                  for m in (metrics or [])]
        ff.compile(optimizer=_optim.get(optimizer), loss_type=loss_type,
                   metrics=mtypes)
        self.ffmodel = ff
        self.optimizer = ff.optimizer  # scheduler-settable (callbacks.py)
        return ff

    def fit(self, x, y, epochs=1, batch_size=-1, callbacks=None,
            shuffle=True, verbose=True):
        """Reference base_model.py:198-376 semantics: train/epoch callback
        hooks fire around the per-epoch FFModel.fit loop; an on_epoch_end
        returning truthy stops training early (EpochVerifyMetrics)."""
        assert self.ffmodel is not None, "call compile() first"
        if isinstance(x, (list, tuple)):
            names = [t.name for t in self._input_ktensors()]
            x = dict(zip(names, x))
        y = np.asarray(y)
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_model(self)
            cb.set_params({"epochs": epochs, "batch_size": batch_size})
            cb.on_train_begin()
        for epoch in range(epochs):
            # per-epoch metrics, like the reference's reset at epoch start
            # (base_model.py:397): gates read THIS epoch's accuracy, not a
            # running average over all epochs
            self.ffmodel.reset_metrics()
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            self.ffmodel.fit(x, y, epochs=1, batch_size=batch_size,
                             shuffle=shuffle, verbose=verbose)
            # evaluate EVERY callback's hook before deciding to stop — a
            # short-circuiting any() would starve callbacks after the
            # first truthy one of their final-epoch hook
            stops = [cb.on_epoch_end(epoch) for cb in callbacks]
            if any(stops):
                break
        for cb in callbacks:
            cb.on_train_end()

    def evaluate(self, x, y, batch_size=-1):
        assert self.ffmodel is not None
        if isinstance(x, (list, tuple)):
            names = [t.name for t in self._input_ktensors()]
            x = dict(zip(names, x))
        return self.ffmodel.eval(x, np.asarray(y), batch_size=batch_size)

    def summary(self):
        for kt in self._topo_calls():
            print(f"{kt.layer.name}: "
                  f"{[t.shape for t in kt.call_inputs]} -> [{kt.shape}]")


class Sequential(BaseModel):
    """reference keras/models/sequential.py."""

    def __init__(self, layers=None, name=None):
        super().__init__(name)
        self._layers: list[Layer] = []
        self._input_kt = None
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer):
        if isinstance(layer, InputLayer):
            self._input_kt = layer.output_tensors[0]
            return
        if self._input_kt is None:
            shape = getattr(layer, "input_shape_arg", None)
            assert shape is not None, (
                "first layer needs input_shape= or add an InputLayer"
            )
            self._input_kt = KTensor((None,) + tuple(shape))
        prev = (self._layers[-1].output_tensors[0] if self._layers
                else self._input_kt)
        layer(prev)
        self._layers.append(layer)

    def _topo_calls(self):
        return [l.output_tensors[0] for l in self._layers]

    def _input_ktensors(self):
        return [self._input_kt]


class Model(BaseModel):
    """Functional model (reference keras/models/model.py): walk back from
    outputs to inputs to topologically order the recorded layer DAG."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name)
        self.inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self.outputs = outputs if isinstance(outputs, (list, tuple)) \
            else [outputs]
        self._order = self._toposort()

    def _toposort(self):
        """DFS over KTensors (per-call edges, so shared layers keep every
        invocation)."""
        order, visited = [], set()

        def visit(kt: KTensor):
            if kt.layer is None or isinstance(kt.layer, InputLayer):
                return
            if kt.name in visited:
                return
            visited.add(kt.name)
            for t in kt.call_inputs:
                visit(t)
            order.append(kt)

        for out in self.outputs:
            visit(out)
        return order

    def _topo_calls(self):
        return list(self._order)

    def _input_ktensors(self):
        return list(self.inputs)
