"""ONNX graph → FFModel builders.

Reference: python/flexflow/onnx/model.py (`ONNXModel.apply` walking
graph.node with one handle_* per op type). The `onnx` package is not a
dependency of the port, so the import is lazy, at the JAX package's three
points (`onnx.load`, `onnx.helper.get_attribute_value`,
`onnx.numpy_helper.to_array`): construction works anywhere, `apply`
raises a clear error if onnx is missing. The graph's initializers are
read for their shapes only; a model's weights reach the compiled FFModel
through `load_params` under the node names.
(Twin of `flexflow_tpu/onnx_frontend/model.py`.)
"""

from __future__ import annotations

import math

from ..fftype import PoolType


def _attrs(node):
    import onnx

    out = {}
    for a in node.attribute:
        out[a.name] = onnx.helper.get_attribute_value(a)
    return out


class ONNXModel:
    def __init__(self, filename: str):
        self.filename = filename
        self._model = None

    def _load(self):
        if self._model is None:
            try:
                import onnx
            except ImportError as e:
                raise ImportError(
                    "the onnx package is required for ONNXModel; install "
                    "onnx or use the torch/keras frontends"
                ) from e
            self._model = onnx.load(self.filename)
        return self._model

    def apply(self, ffmodel, input_tensors: dict):
        """input_tensors: graph input name → FF Tensor. Returns the graph
        outputs as FF Tensors."""
        graph = self._load().graph
        env = dict(input_tensors)
        # initializers (weights) that feed ops like Gemm are consumed by
        # the corresponding FFModel builders, which read their shapes
        inits = {i.name: i for i in graph.initializer}
        for node in graph.node:
            handler = getattr(self, f"_handle_{node.op_type.lower()}", None)
            if handler is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            outs = handler(ffmodel, node, env, inits)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            for name, t in zip(node.output, outs):
                env[name] = t
        return [env[o.name] for o in graph.output]

    # ---------------------------------------------------------- handlers

    def _handle_gemm(self, ff, node, env, inits):
        x = env[node.input[0]]
        w = inits[node.input[1]]
        a = _attrs(node)
        # B is (N, K) when transB=1 (torch export), (K, N) otherwise
        out_dim = list(w.dims)[0] if a.get("transB", 0) else list(w.dims)[1]
        use_bias = len(node.input) > 2
        return ff.dense(x, out_dim, use_bias=use_bias, name=node.name or "")

    def _handle_matmul(self, ff, node, env, inits):
        if node.input[1] in inits:
            out_dim = list(inits[node.input[1]].dims)[-1]
            return ff.dense(env[node.input[0]], out_dim, use_bias=False,
                            name=node.name or "")
        return ff.batch_matmul(env[node.input[0]], env[node.input[1]])

    def _handle_conv(self, ff, node, env, inits):
        a = _attrs(node)
        w = inits[node.input[1]]
        oc = list(w.dims)[0]
        kh, kw = a.get("kernel_shape", [1, 1])
        sh, sw = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        groups = a.get("group", 1)
        return ff.conv2d(env[node.input[0]], oc, kh, kw, sh, sw,
                         pads[0], pads[1], groups=groups,
                         use_bias=len(node.input) > 2, name=node.name or "")

    def _pool(self, ff, node, env, pool_type):
        a = _attrs(node)
        kh, kw = a.get("kernel_shape", [1, 1])
        sh, sw = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], kh, kw, sh, sw, pads[0],
                         pads[1], pool_type, name=node.name or "")

    def _handle_maxpool(self, ff, node, env, inits):
        return self._pool(ff, node, env, PoolType.POOL_MAX)

    def _handle_averagepool(self, ff, node, env, inits):
        return self._pool(ff, node, env, PoolType.POOL_AVG)

    def _handle_relu(self, ff, node, env, inits):
        return ff.relu(env[node.input[0]], name=node.name or "")

    def _handle_sigmoid(self, ff, node, env, inits):
        return ff.sigmoid(env[node.input[0]], name=node.name or "")

    def _handle_tanh(self, ff, node, env, inits):
        return ff.tanh(env[node.input[0]], name=node.name or "")

    def _handle_softmax(self, ff, node, env, inits):
        a = _attrs(node)
        return ff.softmax(env[node.input[0]], a.get("axis", -1),
                          name=node.name or "")

    def _handle_flatten(self, ff, node, env, inits):
        return ff.flat(env[node.input[0]], name=node.name or "")

    def _handle_add(self, ff, node, env, inits):
        return ff.add(env[node.input[0]], env[node.input[1]],
                      name=node.name or "")

    def _handle_sub(self, ff, node, env, inits):
        return ff.subtract(env[node.input[0]], env[node.input[1]],
                           name=node.name or "")

    def _handle_mul(self, ff, node, env, inits):
        return ff.multiply(env[node.input[0]], env[node.input[1]],
                           name=node.name or "")

    def _handle_concat(self, ff, node, env, inits):
        a = _attrs(node)
        return ff.concat([env[i] for i in node.input], a.get("axis", 0),
                         name=node.name or "")

    def _handle_dropout(self, ff, node, env, inits):
        a = _attrs(node)
        return ff.dropout(env[node.input[0]], a.get("ratio", 0.5),
                          name=node.name or "")

    def _handle_identity(self, ff, node, env, inits):
        return env[node.input[0]]

    def _handle_reshape(self, ff, node, env, inits):
        import onnx.numpy_helper as nh

        shape = nh.to_array(inits[node.input[1]]).tolist()
        x = env[node.input[0]]
        if -1 in shape:
            total = math.prod(x.dims)
            known = -math.prod(shape)
            shape = [total // known if s == -1 else s for s in shape]
        return ff.reshape(x, shape, name=node.name or "")

    def _handle_transpose(self, ff, node, env, inits):
        a = _attrs(node)
        return ff.transpose(env[node.input[0]], a["perm"],
                            name=node.name or "")
