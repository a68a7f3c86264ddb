"""torch.fx → FFModel conversion.

Reference behavior (python/flexflow/torch/model.py): symbolic-trace the
module, emit one IR record per fx node (`IR_DELIMITER`-joined fields), and
rebuild FFModel layers from records (`PyTorchModel.torch_to_ff`, the ~60
Node subclasses). Here the per-node translation table is `_module_handlers`
/ `_function_handlers` / `_method_handlers`; shape propagation runs with
torch.fx.passes.shape_prop so view/reshape/flatten get concrete shapes.

Weight transfer: torch Linear stores (out, in) — transposed into our (in,
out) kernels; `install_weights(ff)` copies trained torch parameters into
the compiled FFModel for numerics-preserving migration (beyond the
reference, which only rebuilds architecture).
(Twin of `flexflow_tpu/torch_frontend/model.py`.)
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np

from ..fftype import ActiMode, DataType

IR_DELIMITER = "; "


class PyTorchModel:
    def __init__(self, source, batch_size: Optional[int] = None):
        """source: an nn.Module, or a path to a .ff file produced by
        torch_to_flexflow."""
        self.source = source
        self.batch_size = batch_size
        self._weight_transfers = []  # (layer_name, weight_name, np array)

    # ------------------------------------------------------------ public

    def torch_to_ff(self, ffmodel, input_tensors, verbose=False):
        """Build the model on `ffmodel` from `input_tensors` (FF Tensors);
        returns the list of output Tensors."""
        if isinstance(self.source, str):
            return self._replay_file(ffmodel, input_tensors)
        return self._trace_module(ffmodel, input_tensors, verbose)

    apply = torch_to_ff

    def install_weights(self, ffmodel):
        """Copy the torch module's trained parameters into the compiled
        FFModel (call after ffmodel.compile())."""
        for lname, wname, arr in self._weight_transfers:
            if lname in ffmodel._params and wname in ffmodel._params[lname]:
                ffmodel.set_weight(lname, wname, arr)

    # ------------------------------------------------------------ fx path

    def _trace_module(self, ffmodel, input_tensors, verbose):
        import torch
        import torch.fx
        from torch.fx.passes.shape_prop import ShapeProp

        module = self.source.eval()
        traced = torch.fx.symbolic_trace(module)
        example = [
            torch.zeros(
                tuple(t.dims),
                dtype=torch.int64 if "INT" in t.dtype.name else torch.float32,
            )
            for t in input_tensors
        ]
        ShapeProp(traced).propagate(*example)

        env = {}
        inputs_iter = iter(input_tensors)
        outputs = []
        for node in traced.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = next(inputs_iter)
            elif node.op == "call_module":
                sub = traced.get_submodule(node.target)
                env[node.name] = self._handle_module(
                    ffmodel, node, sub, env)
            elif node.op == "call_function":
                env[node.name] = self._handle_function(ffmodel, node, env)
            elif node.op == "call_method":
                env[node.name] = self._handle_method(ffmodel, node, env)
            elif node.op == "get_attr":
                env[node.name] = _fetch_attr(module, node.target)
            elif node.op == "output":
                args = node.args[0]
                outs = args if isinstance(args, (tuple, list)) else [args]
                outputs = [env[a.name] for a in outs]
            if verbose and node.op != "output":
                print(f"{node.op} {node.name} -> {env.get(node.name)}")
        return outputs

    # ---------------------------------------------------------- handlers

    def _handle_module(self, ff, node, sub, env):
        import torch.nn as nn

        x = lambda i=0: env[node.args[i].name]
        name = node.target.replace(".", "_")
        if isinstance(sub, nn.Linear):
            out = ff.dense(x(), sub.out_features,
                           use_bias=sub.bias is not None, name=name)
            self._weight_transfers.append(
                (name, "kernel", sub.weight.detach().numpy().T))
            if sub.bias is not None:
                self._weight_transfers.append(
                    (name, "bias", sub.bias.detach().numpy()))
            return out
        if isinstance(sub, nn.Conv2d):
            out = ff.conv2d(
                x(), sub.out_channels, *sub.kernel_size, *sub.stride,
                *(sub.padding if isinstance(sub.padding, tuple)
                  else (sub.padding,) * 2),
                groups=sub.groups, use_bias=sub.bias is not None, name=name)
            self._weight_transfers.append(
                (name, "kernel", sub.weight.detach().numpy()))
            if sub.bias is not None:
                self._weight_transfers.append(
                    (name, "bias", sub.bias.detach().numpy()))
            return out
        if isinstance(sub, nn.MaxPool2d):
            k = _pair(sub.kernel_size)
            s = _pair(sub.stride or sub.kernel_size)
            p = _pair(sub.padding)
            return ff.pool2d(x(), *k, *s, *p, name=name)
        if isinstance(sub, nn.AvgPool2d):
            from ..fftype import PoolType

            k, s, p = _pair(sub.kernel_size), _pair(sub.stride or
                                                    sub.kernel_size), \
                _pair(sub.padding)
            return ff.pool2d(x(), *k, *s, *p, PoolType.POOL_AVG, name=name)
        if isinstance(sub, nn.BatchNorm2d):
            return ff.batch_norm(x(), relu=False, name=name)
        if isinstance(sub, nn.LayerNorm):
            nd = len(env[node.args[0].name].dims)
            axes = list(range(nd - len(sub.normalized_shape), nd))
            out = ff.layer_norm(x(), axes, sub.elementwise_affine,
                                sub.eps, name=name)
            if sub.elementwise_affine:
                # the op's weights are "scale" and "bias" (ROADMAP C10)
                self._weight_transfers.append(
                    (name, "scale", sub.weight.detach().numpy()))
                self._weight_transfers.append(
                    (name, "bias", sub.bias.detach().numpy()))
            return out
        if isinstance(sub, nn.Embedding):
            out = ff.embedding(x(), sub.num_embeddings, sub.embedding_dim,
                               name=name)
            self._weight_transfers.append(
                (name, "kernel", sub.weight.detach().numpy()))
            return out
        if isinstance(sub, nn.Dropout):
            return ff.dropout(x(), sub.p, name=name)
        if isinstance(sub, nn.MultiheadAttention):
            q, k, v = (env[a.name] for a in node.args[:3])
            return ff.multihead_attention(
                q, k, v, sub.embed_dim, sub.num_heads,
                dropout=sub.dropout, bias=sub.in_proj_bias is not None,
                name=name)
        if isinstance(sub, nn.ReLU):
            return ff.relu(x(), name=name)
        if isinstance(sub, nn.GELU):
            return ff.gelu(x(), name=name)
        if isinstance(sub, nn.Sigmoid):
            return ff.sigmoid(x(), name=name)
        if isinstance(sub, nn.Tanh):
            return ff.tanh(x(), name=name)
        if isinstance(sub, nn.Softmax):
            return ff.softmax(x(), sub.dim if sub.dim is not None else -1,
                              name=name)
        if isinstance(sub, nn.Flatten):
            return ff.flat(x(), name=name)
        if isinstance(sub, nn.Identity):
            return x()
        raise NotImplementedError(f"torch module {type(sub).__name__}")

    def _handle_function(self, ff, node, env):
        import torch
        import torch.nn.functional as F

        fn = node.target

        def val(a):
            return env[a.name] if hasattr(a, "name") and a.name in env else a

        args = [val(a) for a in node.args]
        if fn in (operator.add, torch.add):
            return _binary(ff, ff.add, ff.scalar_add, args)
        if fn in (operator.sub, torch.sub):
            return _binary(ff, ff.subtract, ff.scalar_sub, args)
        if fn in (operator.mul, torch.mul):
            return _binary(ff, ff.multiply, ff.scalar_multiply, args)
        if fn in (operator.truediv, torch.div):
            return _binary(ff, ff.divide, ff.scalar_true_divide, args)
        if fn in (torch.relu, F.relu):
            return ff.relu(args[0])
        if fn is F.gelu:
            return ff.gelu(args[0])
        if fn in (torch.sigmoid, F.sigmoid):
            return ff.sigmoid(args[0])
        if fn in (torch.tanh, F.tanh):
            return ff.tanh(args[0])
        if fn is F.softmax or fn is torch.softmax:
            dim = node.kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return ff.softmax(args[0], dim)
        if fn is torch.flatten:
            return ff.flat(args[0])
        if fn is torch.cat:
            tensors = [val(t) for t in node.args[0]]
            dim = node.kwargs.get("dim", args[1] if len(args) > 1 else 0)
            return ff.concat(tensors, dim)
        if fn in (torch.matmul, torch.bmm):
            return ff.batch_matmul(args[0], args[1])
        if fn is torch.mean:
            dims = node.kwargs.get("dim", args[1] if len(args) > 1 else None)
            keep = node.kwargs.get("keepdim", False)
            if dims is None:  # global mean over every dim
                dims = list(range(len(args[0].dims)))
            dims = [dims] if isinstance(dims, int) else list(dims)
            return ff.mean(args[0], dims, keep)
        if fn is operator.getitem:
            seq, idx = args
            return seq[idx]
        if fn is torch.transpose:
            return _swap(ff, args[0], args[1], args[2])
        raise NotImplementedError(f"torch function {fn}")

    def _handle_method(self, ff, node, env):
        def val(a):
            return env[a.name] if hasattr(a, "name") and a.name in env else a

        args = [val(a) for a in node.args]
        x = args[0]
        m = node.target
        if m in ("view", "reshape"):
            shape = [a for a in args[1:]]
            if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                shape = list(shape[0])
            # resolve -1 against the fx-propagated meta shape
            meta = node.meta.get("tensor_meta")
            if meta is not None:
                shape = list(meta.shape)
            return ff.reshape(x, shape)
        if m == "flatten":
            return ff.flat(x)
        if m == "permute":
            perm = args[1:]
            if len(perm) == 1 and isinstance(perm[0], (tuple, list)):
                perm = list(perm[0])
            return ff.transpose(x, perm)
        if m == "transpose":
            return _swap(ff, x, args[1], args[2])
        if m == "mean":
            dims = [args[1]] if isinstance(args[1], int) else list(args[1])
            return ff.mean(x, dims)
        if m in ("contiguous", "detach", "clone", "to", "float"):
            return x
        if m == "split":
            size, dim = args[1], node.kwargs.get(
                "dim", args[2] if len(args) > 2 else 0)
            total = x.dims[dim % len(x.dims)]
            return ff.split(x, total // size, dim)
        raise NotImplementedError(f"torch method {m}")

    # ------------------------------------------------------------ file path

    def _replay_file(self, ffmodel, input_tensors):
        outputs = {}
        env = {}
        it = iter(input_tensors)
        lines = [l.strip() for l in open(self.source) if l.strip()]
        final = []
        for line in lines:
            fields = line.split(IR_DELIMITER)
            name, in_names, op = fields[0], fields[1], fields[2]
            ins = [env[n] for n in in_names.split(",") if n]
            if op == "input":
                env[name] = next(it)
            elif op == "output":
                final = ins
            else:
                env[name] = _REPLAY[op](ffmodel, ins, fields[3:], name)
        return final


def _binary(ff, tensor_op, scalar_op, args):
    a, b = args[0], args[1]
    if isinstance(b, (int, float)):
        return scalar_op(a, float(b))
    if isinstance(a, (int, float)):
        return scalar_op(b, float(a))
    return tensor_op(a, b)


def _swap(ff, x, d0, d1):
    nd = len(x.dims)
    perm = list(range(nd))
    perm[d0 % nd], perm[d1 % nd] = perm[d1 % nd], perm[d0 % nd]
    return ff.transpose(x, perm)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _fetch_attr(module, target):
    obj = module
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


# ---------------------------------------------------------------- export

def torch_to_flexflow(module, filename: str, input_shapes=None):
    """Serialize an fx-traced module to a .ff IR file (reference
    torch_to_flexflow, model.py). Records: name; inputs; op; params..."""
    import torch
    import torch.fx

    traced = torch.fx.symbolic_trace(module.eval())
    if input_shapes:
        from torch.fx.passes.shape_prop import ShapeProp

        ShapeProp(traced).propagate(
            *[torch.zeros(s) for s in input_shapes])
    lines = []
    for node in traced.graph.nodes:
        if node.op == "placeholder":
            lines.append(IR_DELIMITER.join([node.name, "", "input"]))
        elif node.op == "output":
            args = node.args[0]
            outs = args if isinstance(args, (tuple, list)) else [args]
            names = ",".join(a.name for a in outs)
            lines.append(IR_DELIMITER.join(["_out", names, "output"]))
        elif node.op == "call_module":
            sub = traced.get_submodule(node.target)
            rec = _serialize_module(node, sub)
            lines.append(rec)
        else:
            raise NotImplementedError(
                f".ff export supports module calls only; got {node.op} "
                f"{node.target} (use PyTorchModel(module) for the direct "
                "path)")
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")


def _serialize_module(node, sub):
    import torch.nn as nn

    ins = ",".join(a.name for a in node.args if hasattr(a, "name"))
    name = node.name
    if isinstance(sub, nn.Linear):
        return IR_DELIMITER.join(
            [name, ins, "linear", str(sub.out_features),
             str(sub.bias is not None)])
    if isinstance(sub, nn.ReLU):
        return IR_DELIMITER.join([name, ins, "relu"])
    if isinstance(sub, nn.Sigmoid):
        return IR_DELIMITER.join([name, ins, "sigmoid"])
    if isinstance(sub, nn.Tanh):
        return IR_DELIMITER.join([name, ins, "tanh"])
    if isinstance(sub, nn.GELU):
        return IR_DELIMITER.join([name, ins, "gelu"])
    if isinstance(sub, nn.Softmax):
        dim = -1 if sub.dim is None else sub.dim
        return IR_DELIMITER.join([name, ins, "softmax", str(dim)])
    if isinstance(sub, nn.Flatten):
        return IR_DELIMITER.join([name, ins, "flat"])
    if isinstance(sub, nn.Dropout):
        return IR_DELIMITER.join([name, ins, "dropout", str(sub.p)])
    if isinstance(sub, nn.Conv2d):
        p = sub.padding if isinstance(sub.padding, tuple) \
            else (sub.padding,) * 2
        return IR_DELIMITER.join(
            [name, ins, "conv2d", str(sub.out_channels),
             str(sub.kernel_size[0]), str(sub.kernel_size[1]),
             str(sub.stride[0]), str(sub.stride[1]), str(p[0]), str(p[1]),
             str(sub.groups), str(sub.bias is not None)])
    if isinstance(sub, nn.MaxPool2d):
        k, s, p = _pair(sub.kernel_size), _pair(sub.stride or
                                                sub.kernel_size), \
            _pair(sub.padding)
        return IR_DELIMITER.join([name, ins, "pool2d", *map(str, k + s + p)])
    if isinstance(sub, nn.Embedding):
        return IR_DELIMITER.join(
            [name, ins, "embedding", str(sub.num_embeddings),
             str(sub.embedding_dim)])
    raise NotImplementedError(f".ff export for {type(sub).__name__}")


_REPLAY = {
    "linear": lambda ff, ins, p, n: ff.dense(
        ins[0], int(p[0]), use_bias=p[1] == "True", name=n),
    "relu": lambda ff, ins, p, n: ff.relu(ins[0], name=n),
    "sigmoid": lambda ff, ins, p, n: ff.sigmoid(ins[0], name=n),
    "tanh": lambda ff, ins, p, n: ff.tanh(ins[0], name=n),
    "gelu": lambda ff, ins, p, n: ff.gelu(ins[0], name=n),
    "softmax": lambda ff, ins, p, n: ff.softmax(ins[0], int(p[0]), name=n),
    "flat": lambda ff, ins, p, n: ff.flat(ins[0], name=n),
    "dropout": lambda ff, ins, p, n: ff.dropout(ins[0], float(p[0]), name=n),
    "conv2d": lambda ff, ins, p, n: ff.conv2d(
        ins[0], int(p[0]), int(p[1]), int(p[2]), int(p[3]), int(p[4]),
        int(p[5]), int(p[6]), groups=int(p[7]), use_bias=p[8] == "True",
        name=n),
    "pool2d": lambda ff, ins, p, n: ff.pool2d(
        ins[0], *(int(v) for v in p[:6]), name=n),
    "embedding": lambda ff, ins, p, n: ff.embedding(
        ins[0], int(p[0]), int(p[1]), name=n),
}
