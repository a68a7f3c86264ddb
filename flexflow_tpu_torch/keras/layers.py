"""Keras layer classes (reference python/flexflow/keras/layers/*).

Each layer is a symbolic node: `__call__` records connectivity on KTensor
handles and computes output shapes; `materialize(ff, inputs)` emits the
FFModel builder call at compile time.
(Twin of `flexflow_tpu/keras/layers.py`.)
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

from ..fftype import ActiMode, DataType, PoolType

_uid = itertools.count()


class KTensor:
    """Symbolic keras tensor: batch-inclusive shape + the producing layer
    call. `call_inputs` records this specific call's inputs so a layer
    invoked multiple times (shared layer) keeps every edge."""

    def __init__(self, shape, dtype="float32", layer=None, idx=0,
                 name=None, call_inputs=()):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layer = layer
        self.idx = idx
        self.name = name or f"ktensor_{next(_uid)}"
        self.call_inputs: tuple = tuple(call_inputs)

    @property
    def batch_shape(self):
        return self.shape


class Layer:
    def __init__(self, name=None, **kwargs):
        self.name = name or f"{type(self).__name__.lower()}_{next(_uid)}"
        self.input_tensors: list[KTensor] = []
        self.output_tensors: list[KTensor] = []
        self._num_calls = 0

    def __call__(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        # last-call views, kept for Sequential and summary()
        self.input_tensors = list(ins)
        out_shape = self.compute_output_shape([t.shape for t in ins])
        self._num_calls += 1
        out = KTensor(out_shape, ins[0].dtype, layer=self,
                      name=f"{self.name}_out{self._num_calls}",
                      call_inputs=ins)
        self.output_tensors = [out]
        return out

    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0])

    def materialize(self, ff, inputs):  # -> output Tensor
        raise NotImplementedError


class InputLayer(Layer):
    def __init__(self, shape=None, batch_size=None, dtype="float32",
                 name=None):
        super().__init__(name)
        self.batch_size = batch_size
        self.shape = tuple(shape or ())
        t = KTensor((batch_size,) + self.shape, dtype, layer=self,
                    name=self.name)
        self.output_tensors = [t]


def Input(shape=None, batch_size=None, dtype="float32", name=None):
    """Reference input_layer.py:43."""
    return InputLayer(shape, batch_size, dtype, name).output_tensors[0]


_ACTIVATIONS = {
    None: ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH,
    "gelu": ActiMode.AC_MODE_GELU,
    "softmax": "softmax",
}


class Dense(Layer):
    def __init__(self, units, input_shape=None, activation=None,
                 use_bias=True, name=None, **kwargs):
        super().__init__(name)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.input_shape_arg = input_shape

    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0][:-1]) + (self.units,)

    def materialize(self, ff, inputs, shared_op=None):
        """`shared_op` is a sharing FLAG from BaseModel.compile (truthy on
        re-calls of the same layer object): the tie anchors to the first
        call's dense op recorded on the layer, since the externally visible
        output may be a trailing softmax tensor."""
        act = _ACTIVATIONS.get(self.activation, ActiMode.AC_MODE_NONE)
        softmax_after = act == "softmax"
        tie = (getattr(self, "_ff_dense_out", None) if shared_op else None)
        t = ff.dense(inputs[0], self.units,
                     ActiMode.AC_MODE_NONE if softmax_after else act,
                     use_bias=self.use_bias, name=self.name,
                     shared_op=tie)
        if getattr(self, "_ff_dense_out", None) is None:
            self._ff_dense_out = t
        if softmax_after:
            t = ff.softmax(t, name=f"{self.name}_softmax")
        return t


class Conv2D(Layer):
    def __init__(self, filters, kernel_size, strides=(1, 1), padding="valid",
                 activation=None, use_bias=True, input_shape=None,
                 groups=1, name=None, **kwargs):
        super().__init__(name)
        self.filters = filters
        self.kernel = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.strides = (strides,) * 2 if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups
        self.input_shape_arg = input_shape

    def _pads(self, in_shape):
        if self.padding == "same":
            return self.kernel[0] // 2, self.kernel[1] // 2
        if self.padding == "valid":
            return 0, 0
        p = self.padding
        return (p, p) if isinstance(p, int) else tuple(p)

    def compute_output_shape(self, in_shapes):
        n, c, h, w = in_shapes[0]
        ph, pw = self._pads(in_shapes[0])
        oh = (h + 2 * ph - self.kernel[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.kernel[1]) // self.strides[1] + 1
        return (n, self.filters, oh, ow)

    def materialize(self, ff, inputs):
        ph, pw = self._pads(None)
        act = _ACTIVATIONS.get(self.activation, ActiMode.AC_MODE_NONE)
        softmax_after = act == "softmax"
        t = ff.conv2d(inputs[0], self.filters, *self.kernel, *self.strides,
                      ph, pw,
                      ActiMode.AC_MODE_NONE if softmax_after else act,
                      groups=self.groups, use_bias=self.use_bias,
                      name=self.name)
        if softmax_after:
            t = ff.softmax(t, name=f"{self.name}_softmax")
        return t


class Pooling2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None, **kwargs):
        super().__init__(name)
        self.pool = (pool_size,) * 2 if isinstance(pool_size, int) \
            else tuple(pool_size)
        strides = strides if strides is not None else self.pool
        self.strides = (strides,) * 2 if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding

    def _pads(self):
        if self.padding == "same":
            return self.pool[0] // 2, self.pool[1] // 2
        return 0, 0

    def compute_output_shape(self, in_shapes):
        n, c, h, w = in_shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.pool[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.pool[1]) // self.strides[1] + 1
        return (n, c, oh, ow)

    def materialize(self, ff, inputs):
        ph, pw = self._pads()
        return ff.pool2d(inputs[0], *self.pool, *self.strides, ph, pw,
                         self.pool_type, name=self.name)


class MaxPooling2D(Pooling2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(Pooling2D):
    pool_type = PoolType.POOL_AVG


class Flatten(Layer):
    def compute_output_shape(self, in_shapes):
        s = in_shapes[0]
        n = 1
        for d in s[1:]:
            n *= d
        return (s[0], n)

    def materialize(self, ff, inputs):
        return ff.flat(inputs[0], name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim, output_dim, input_length=None, name=None,
                 **kwargs):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0]) + (self.output_dim,)

    def materialize(self, ff, inputs):
        return ff.embedding(inputs[0], self.input_dim, self.output_dim,
                            name=self.name)


class Activation(Layer):
    def __init__(self, activation, name=None, **kwargs):
        super().__init__(name)
        self.activation = activation

    def materialize(self, ff, inputs):
        x = inputs[0]
        if self.activation == "softmax":
            return ff.softmax(x, name=self.name)
        fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
              "gelu": ff.gelu, "elu": ff.elu}[self.activation]
        return fn(x, name=self.name)


class Dropout(Layer):
    def __init__(self, rate, seed=0, name=None, **kwargs):
        super().__init__(name)
        self.rate = rate
        self.seed = seed

    def materialize(self, ff, inputs):
        return ff.dropout(inputs[0], self.rate, self.seed, name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, name=None, **kwargs):
        super().__init__(name)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, in_shapes):
        return (in_shapes[0][0],) + self.target_shape

    def materialize(self, ff, inputs):
        return ff.reshape(
            inputs[0], (inputs[0].dims[0],) + self.target_shape,
            name=self.name)


class Permute(Layer):
    def __init__(self, dims, name=None, **kwargs):
        super().__init__(name)
        self.dims = tuple(dims)  # keras: 1-indexed, excludes batch

    def compute_output_shape(self, in_shapes):
        s = in_shapes[0]
        return (s[0],) + tuple(s[d] for d in self.dims)

    def materialize(self, ff, inputs):
        perm = (0,) + self.dims
        return ff.transpose(inputs[0], perm, name=self.name)


class BatchNormalization(Layer):
    def __init__(self, relu=False, name=None, **kwargs):
        super().__init__(name)
        self.relu = relu

    def materialize(self, ff, inputs):
        return ff.batch_norm(inputs[0], relu=self.relu, name=self.name)


class _Merge(Layer):
    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0])


class Add(_Merge):
    def materialize(self, ff, inputs):
        return ff.add(inputs[0], inputs[1], name=self.name)


class Subtract(_Merge):
    def materialize(self, ff, inputs):
        return ff.subtract(inputs[0], inputs[1], name=self.name)


class Multiply(_Merge):
    def materialize(self, ff, inputs):
        return ff.multiply(inputs[0], inputs[1], name=self.name)


class Maximum(_Merge):
    def materialize(self, ff, inputs):
        return ff.max(inputs[0], inputs[1], name=self.name)


class Minimum(_Merge):
    def materialize(self, ff, inputs):
        return ff.min(inputs[0], inputs[1], name=self.name)


class Concatenate(_Merge):
    def __init__(self, axis=1, name=None, **kwargs):
        super().__init__(name)
        self.axis = axis

    def compute_output_shape(self, in_shapes):
        s = list(in_shapes[0])
        ax = self.axis % len(s)
        s[ax] = sum(x[ax] for x in in_shapes)
        return tuple(s)

    def materialize(self, ff, inputs):
        return ff.concat(list(inputs), self.axis, name=self.name)


def concatenate(input_tensors, _axis=1):
    return Concatenate(axis=_axis)(input_tensors)


def add(input_tensors):
    return Add()(input_tensors)


def subtract(input_tensors):
    return Subtract()(input_tensors)
