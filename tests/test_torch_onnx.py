"""The port's ONNX frontend (`flexflow_tpu_torch/onnx_frontend/`) against
the JAX package's, on the CPU, with no `onnx` installed.

A test-only stand-in `onnx` module (with `onnx.helper` and
`onnx.numpy_helper` as submodules) is put into `sys.modules`: `load`
hands back a duck-typed model (graph.node, graph.initializer,
graph.output), `helper.get_attribute_value` an attribute's value and
`numpy_helper.to_array` an initializer's array, the three points where
both frontends reach `onnx`. Two graphs go through both packages'
`ONNXModel.apply` and cover all 18 handlers: a LeNet-like CNN (conv,
relu, maxpool, averagepool, flatten, gemm with and without `transB`,
softmax) and an MLP (matmul with an initializer and between two
tensors, add, sub, mul, concat, dropout, identity, tanh, sigmoid,
reshape with -1 and without, transpose). The built graphs must be the
same (op types, names, output shapes, weight shapes), and the port's
float32 forward, after `load_params` of the JAX model's weights, must
give the JAX model's outputs within 1e-5 (rtol and atol); both compile
for inference, where dropout passes its input through.
"""

import re
import sys
import types

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4


class _Attr:
    def __init__(self, name, value):
        self.name, self.value = name, value


class _Node:
    def __init__(self, op_type, inputs, outputs, name="", **attrs):
        self.op_type = op_type
        self.input = list(inputs)
        self.output = list(outputs)
        self.name = name
        self.attribute = [_Attr(k, v) for k, v in attrs.items()]


class _Init:
    """An initializer: its name, its dims, and (the stand-in's own field)
    its array for `numpy_helper.to_array`."""

    def __init__(self, name, array):
        self.name = name
        self.array = np.asarray(array)
        self.dims = list(self.array.shape)


class _Value:
    def __init__(self, name):
        self.name = name


def _model(nodes, inits, outputs):
    graph = types.SimpleNamespace(node=nodes, initializer=inits,
                                  output=[_Value(o) for o in outputs])
    return types.SimpleNamespace(graph=graph)


def _lenet():
    rs = np.random.RandomState(0)
    inits = [_Init("w1", rs.randn(4, 1, 5, 5)), _Init("b1", rs.randn(4)),
             _Init("w2", rs.randn(8, 4, 5, 5)),
             _Init("w3", rs.randn(32, 8 * 5 * 5)), _Init("b3", rs.randn(32)),
             _Init("w4", rs.randn(32, 10)), _Init("b4", rs.randn(10))]
    nodes = [
        _Node("Conv", ["x", "w1", "b1"], ["c1"], "conv1",
              kernel_shape=[5, 5], strides=[1, 1], pads=[2, 2, 2, 2]),
        _Node("Relu", ["c1"], ["r1"], "relu1"),
        _Node("MaxPool", ["r1"], ["p1"], "pool1", kernel_shape=[2, 2],
              strides=[2, 2]),
        _Node("Conv", ["p1", "w2"], ["c2"], "conv2", kernel_shape=[5, 5]),
        _Node("Relu", ["c2"], ["r2"], "relu2"),
        _Node("AveragePool", ["r2"], ["p2"], "pool2", kernel_shape=[2, 2],
              strides=[2, 2]),
        _Node("Flatten", ["p2"], ["f"], "flat"),
        _Node("Gemm", ["f", "w3", "b3"], ["g1"], "fc1", transB=1),
        _Node("Relu", ["g1"], ["r3"], "relu3"),
        _Node("Gemm", ["r3", "w4", "b4"], ["g2"], "fc2"),
        _Node("Softmax", ["g2"], ["out"], "prob", axis=-1),
    ]
    return _model(nodes, inits, ["out"]), {"x": (BATCH, 1, 28, 28)}


def _mlp():
    rs = np.random.RandomState(1)
    inits = [_Init("w1", rs.randn(16, 32)),
             _Init("shape1", np.asarray([-1, 8, 8], np.int64)),
             _Init("shape2", np.asarray([BATCH, 64], np.int64)),
             _Init("w2", rs.randn(10, 64)), _Init("b2", rs.randn(10))]
    nodes = [
        _Node("MatMul", ["x", "w1"], ["h"], "proj"),
        _Node("Tanh", ["h"], ["t"], "tanh"),
        _Node("Sigmoid", ["h"], ["s"], "sig"),
        _Node("Add", ["t", "s"], ["u"], "add"),
        _Node("Sub", ["u", "s"], ["v"], "sub"),
        _Node("Mul", ["v", "t"], ["m"], "mul"),
        _Node("Concat", ["m", "h"], ["c"], "cat", axis=1),
        _Node("Dropout", ["c"], ["d"], "drop", ratio=0.25),
        _Node("Identity", ["d"], ["e"], "ident"),
        _Node("Reshape", ["e", "shape1"], ["r"], "to3d"),
        _Node("Transpose", ["r"], ["rt"], "swap", perm=[0, 2, 1]),
        _Node("MatMul", ["r", "rt"], ["bm"], ""),
        _Node("Reshape", ["bm", "shape2"], ["f"], "to2d"),
        _Node("Gemm", ["f", "w2", "b2"], ["g"], "head", transB=1),
        _Node("Softmax", ["g"], ["out"], "prob", axis=-1),
    ]
    return _model(nodes, inits, ["out"]), {"x": (BATCH, 16)}


GRAPHS = {"lenet": _lenet, "mlp": _mlp}


@pytest.fixture
def fake_onnx(monkeypatch):
    """The stand-in `onnx`: `load(filename)` returns the model registered
    under that name in `models`."""
    models = {}
    onnx = types.ModuleType("onnx")
    helper = types.ModuleType("onnx.helper")
    numpy_helper = types.ModuleType("onnx.numpy_helper")
    onnx.load = lambda filename: models[filename]
    helper.get_attribute_value = lambda a: a.value
    numpy_helper.to_array = lambda init: init.array
    onnx.helper, onnx.numpy_helper = helper, numpy_helper
    monkeypatch.setitem(sys.modules, "onnx", onnx)
    monkeypatch.setitem(sys.modules, "onnx.helper", helper)
    monkeypatch.setitem(sys.modules, "onnx.numpy_helper", numpy_helper)
    return models


def _build(pkg, model_path, inputs):
    sys.argv = ["test"]
    mod = __import__(pkg)
    onnx_frontend = __import__(f"{pkg}.onnx_frontend", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.batch_size = BATCH
    ff = mod.FFModel(cfg)
    xs = {k: ff.create_tensor(shape, name=k) for k, shape in inputs.items()}
    (out,) = onnx_frontend.ONNXModel(model_path).apply(ff, xs)
    # for inference: dropout passes its input through in both packages
    # (in training their masks come from generators of different bits)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.0),
               loss_type=mod.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
               comp_mode=mod.CompMode.COMP_MODE_INFERENCE)
    return ff, out


def _graph(ff) -> list:
    """Each layer's op type, name (a generated name's counter dropped),
    output shapes and weight shapes."""
    return [(l.op_type.name, re.sub(r"_\d+$", "_#", l.name),
             [tuple(t.dims) for t in l.outputs],
             {k: tuple(np.shape(v))
              for k, v in sorted(ff._params.get(l.name, {}).items())})
            for l in ff.layers]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_onnx_graph_builds_the_jax_graph_and_its_outputs(fake_onnx, name):
    model, inputs = GRAPHS[name]()
    path = f"{name}.onnx"
    fake_onnx[path] = model
    jff, jout = _build("flexflow_tpu", path, inputs)
    tff, tout = _build("flexflow_tpu_torch", path, inputs)
    assert _graph(tff) == _graph(jff)
    assert tuple(tout.dims) == tuple(jout.dims)
    assert tff.layers[-1].op_type.name == "OP_SOFTMAX"

    from flexflow_tpu_torch import load_params

    weights = {n: {k: np.asarray(v) for k, v in ws.items()}
               for n, ws in jff._params.items()}
    assert load_params(tff, weights) == sum(len(ws) for ws in
                                            weights.values())
    rs = np.random.RandomState(7)
    feed = {k: rs.randn(*shape).astype(np.float32)
            for k, shape in inputs.items()}
    labels = np.zeros(tuple(jout.dims), np.float32)
    jff.start_batch(feed, labels)
    tff.start_batch(feed, labels)
    want = np.asarray(jff.forward(), np.float32)
    got = np.asarray(tff.forward(), np.float32)
    assert got.shape == want.shape == tuple(jout.dims)
    np.testing.assert_allclose(got, want, **TOL)


def test_all_eighteen_handlers_are_mirrored_and_exercised():
    from flexflow_tpu.onnx_frontend import ONNXModel as JModel
    from flexflow_tpu_torch.onnx_frontend import ONNXModel as TModel

    def handlers(cls):
        return {n[len("_handle_"):] for n in dir(cls)
                if n.startswith("_handle_")}

    assert handlers(TModel) == handlers(JModel)
    assert len(handlers(TModel)) == 18
    used = {n.op_type.lower() for build in GRAPHS.values()
            for n in build()[0].graph.node}
    assert used == handlers(TModel)
    # both matmul branches: an initializer and a tensor as the right side
    mlp = _mlp()[0].graph
    inits = {i.name for i in mlp.initializer}
    sides = {n.input[1] in inits for n in mlp.node if n.op_type == "MatMul"}
    assert sides == {True, False}


def test_unknown_op_raises_not_implemented(fake_onnx):
    model, inputs = _mlp()
    model.graph.node.insert(1, _Node("Erf", ["h"], ["z"], "erf"))
    fake_onnx["bad.onnx"] = model
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        with pytest.raises(NotImplementedError, match="ONNX op Erf"):
            _build(pkg, "bad.onnx", inputs)


def test_missing_onnx_raises_the_same_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "onnx", None)  # `import onnx` fails
    msgs = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        onnx_frontend = __import__(f"{pkg}.onnx_frontend", fromlist=["x"])
        m = onnx_frontend.ONNXModel("model.onnx")  # constructs anywhere
        with pytest.raises(ImportError) as e:
            m.apply(None, {})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "the onnx package is required for ONNXModel" in msgs[1]
