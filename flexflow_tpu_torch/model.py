"""FFModel: the layer-builder API, single-device compile, weights I/O and
`serve()` (twin of `flexflow_tpu/model.py`, serving slice).

The builder methods mirror the JAX package's one for one (155-490), so a
model script carries over with only the import changed. `compile` lowers
the layer list to a graph and adopts the single-device plan: on one device
every plan is the replicated one, so no Unity search runs (the search and
its plan cache are a later slice of the port). Training (`fit`, the
optimizers, the loss) is the port's training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import FFConfig, resolve_device
from .executor import Executor
from .fftype import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    OperatorType as OT,
)
from .initializer import Initializer
from .layer import Layer
from .ops import (
    ElementBinaryParams,
    ElementUnaryParams,
    EmbeddingParams,
    IncMultiHeadAttentionParams,
    LayerNormParams,
    LinearParams,
    MultiHeadAttentionParams,
    PagedIncMultiHeadAttentionParams,
)
from .ops.base import get_op_def
from .pcg.graph import Graph, OpNode
from .tensor import Tensor


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        # raises when CUDA is asked for (the default) and absent
        self.device = resolve_device(self.config)
        self.layers: list[Layer] = []
        self._input_tensors: list[Tensor] = []
        self.graph: Optional[Graph] = None
        self.executor: Optional[Executor] = None
        self.loss_type: Optional[LossType] = None
        self._params = None
        self._state = None
        self._compiled = False

    # ================================================== tensor creation

    def create_tensor(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.DT_FLOAT,
        create_grad: bool = True,
        name: str = "",
    ) -> Tensor:
        t = Tensor(tuple(dims), dtype,
                   name=name or f"input_{len(self._input_tensors)}",
                   create_gradients=create_grad)
        self._input_tensors.append(t)
        return t

    # ================================================== internal builder

    def _add_layer(
        self,
        op_type: OT,
        params,
        inputs: list[Tensor],
        name: str = "",
        initializers: Optional[dict] = None,
        data_type: DataType = DataType.DT_FLOAT,
    ) -> Layer:
        layer = Layer(op_type, params, inputs, name=name, data_type=data_type,
                      initializers=initializers)
        out_shapes = get_op_def(op_type).infer_shapes(
            params, [t.dims for t in inputs])
        for i, s in enumerate(out_shapes):
            layer.outputs.append(
                Tensor(s, data_type, owner_layer=layer, owner_idx=i,
                       name=f"{layer.name}_out{i}"))
        self.layers.append(layer)
        return layer

    def _unary(self, op_type: OT, x: Tensor, name: str = "") -> Tensor:
        p = ElementUnaryParams(op_type)
        return self._add_layer(op_type, p, [x], name,
                               data_type=x.dtype).outputs[0]

    def _binary(self, op_type: OT, x: Tensor, y: Tensor, name: str = "",
                inplace_a: bool = False) -> Tensor:
        p = ElementBinaryParams(op_type, inplace_a)
        return self._add_layer(op_type, p, [x, y], name,
                               data_type=x.dtype).outputs[0]

    # ================================================== ops

    def add(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_ADD, x, y, name, inplace_a)

    def gelu(self, x, name=""):
        return self._unary(OT.OP_GELU, x, name)

    def dense(
        self,
        input: Tensor,
        out_dim: int,
        activation: ActiMode = ActiMode.AC_MODE_NONE,
        use_bias: bool = True,
        data_type: DataType = DataType.DT_FLOAT,
        kernel_initializer: Optional[Initializer] = None,
        bias_initializer: Optional[Initializer] = None,
        name: str = "",
    ) -> Tensor:
        p = LinearParams(out_dim, use_bias, ActiMode(activation), data_type)
        inits = {}
        if kernel_initializer is not None:
            inits["kernel"] = kernel_initializer
        if bias_initializer is not None:
            inits["bias"] = bias_initializer
        return self._add_layer(OT.OP_LINEAR, p, [input], name, inits,
                               data_type).outputs[0]

    def layer_norm(
        self,
        input: Tensor,
        axes: Sequence[int],
        elementwise_affine: bool = True,
        eps: float = 1e-5,
        name: str = "",
    ) -> Tensor:
        p = LayerNormParams(tuple(axes), elementwise_affine, eps)
        return self._add_layer(OT.OP_LAYERNORM, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def embedding(
        self,
        input: Tensor,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
        dtype: DataType = DataType.DT_FLOAT,
        kernel_initializer: Optional[Initializer] = None,
        name: str = "",
    ) -> Tensor:
        p = EmbeddingParams(num_entries, out_dim, AggrMode(aggr), dtype)
        inits = {"kernel": kernel_initializer} if kernel_initializer else {}
        return self._add_layer(OT.OP_EMBEDDING, p, [input], name, inits,
                               dtype).outputs[0]

    def multihead_attention(
        self,
        query: Tensor,
        key: Tensor,
        value: Tensor,
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = True,
        add_bias_kv: bool = False,
        add_zero_attn: bool = False,
        kernel_initializer: Optional[Initializer] = None,
        causal: bool = False,
        impl: str = "xla",
        name: str = "",
    ) -> Tensor:
        if impl not in ("xla", "flash", "ring"):
            raise ValueError(
                f"multihead_attention impl must be xla|flash|ring, got "
                f"{impl!r}")
        p = MultiHeadAttentionParams(embed_dim, num_heads, kdim, vdim,
                                     dropout, bias, add_bias_kv,
                                     add_zero_attn, causal, impl)
        inits = {}
        if kernel_initializer is not None:
            for w in ("wq", "wk", "wv", "wo"):
                inits[w] = kernel_initializer
        return self._add_layer(OT.OP_MULTIHEAD_ATTENTION, p,
                               [query, key, value], name, inits,
                               query.dtype).outputs[0]

    def inc_multihead_attention(
        self,
        input: Tensor,
        positions: Tensor,
        embed_dim: int,
        num_heads: int,
        max_seq_len: int,
        use_bias: bool = True,
        name: str = "",
    ) -> Tensor:
        """Decode-phase self-attention over a per-layer contiguous KV
        cache (ops/inc_attention.py). Weight names match
        multihead_attention's, so trained parameters transfer by name."""
        p = IncMultiHeadAttentionParams(embed_dim, num_heads, max_seq_len,
                                        use_bias)
        return self._add_layer(OT.OP_INC_MULTIHEAD_ATTENTION, p,
                               [input, positions], name,
                               data_type=input.dtype).outputs[0]

    def paged_inc_multihead_attention(
        self,
        input: Tensor,
        positions: Tensor,
        page_table: Tensor,
        embed_dim: int,
        num_heads: int,
        max_seq_len: int,
        block_size: int,
        num_blocks: int,
        use_bias: bool = True,
        name: str = "",
    ) -> Tensor:
        """Decode-phase self-attention over a paged KV block pool, read
        through the shared `page_table` input (ops/inc_attention.py)."""
        p = PagedIncMultiHeadAttentionParams(
            embed_dim, num_heads, max_seq_len, block_size, num_blocks,
            use_bias)
        return self._add_layer(OT.OP_PAGED_INC_MULTIHEAD_ATTENTION, p,
                               [input, positions, page_table], name,
                               data_type=input.dtype).outputs[0]

    # ================================================== compile

    def compile(
        self,
        optimizer=None,
        loss_type: LossType = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
    ):
        """Lower layers to a graph, adopt the single-device plan, build the
        executor and initialise the weights on the model's device."""
        if optimizer is not None:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP queue A3): compile "
                "without an optimizer and serve the model")
        self.loss_type = LossType(loss_type)
        self.config.computation_mode = comp_mode
        g = Graph()
        tensor_to_out: dict[int, tuple[OpNode, int]] = {}
        for t in self._input_tensors:
            node = OpNode(OT.OP_INPUT, None, name=t.name)
            node.output_shapes = [t.dims]
            g.add_node(node)
            tensor_to_out[t.tensor_guid] = (node, 0)
        for layer in self.layers:
            node = OpNode(layer.op_type, layer.params, name=layer.name,
                          layer_guid=layer.layer_guid,
                          initializers=layer.initializers)
            g.add_node(node)
            for dst_idx, t_in in enumerate(layer.inputs):
                src_node, src_idx = tensor_to_out[t_in.tensor_guid]
                g.add_edge(src_node, node, src_idx, dst_idx)
            node.input_shapes = [t.dims for t in layer.inputs]
            node.output_shapes = [t.dims for t in layer.outputs]
            node.weight_specs = node.op_def.weights(layer.params,
                                                    node.input_shapes)
            for i, t_out in enumerate(layer.outputs):
                tensor_to_out[t_out.tensor_guid] = (node, i)
        self.graph = g
        logits_node = tensor_to_out[self.layers[-1].outputs[0].tensor_guid][0]
        self.executor = Executor(g, self.config, self.device, logits_node)
        self._params, self._state = self.executor.init_variables(
            self.config.seed)
        self._compiled = True

    # ================================================== weights I/O

    def get_weight(self, layer_name: str, weight_name: str) -> np.ndarray:
        return self._params[layer_name][weight_name].detach().cpu().numpy()

    def set_weight(self, layer_name: str, weight_name: str,
                   value: np.ndarray):
        old = self._params[layer_name][weight_name]
        value = np.asarray(value)
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(
                f"{layer_name}.{weight_name}: shape {value.shape} != "
                f"{tuple(old.shape)}")
        self._params[layer_name][weight_name] = torch.tensor(
            value, dtype=old.dtype, device=old.device)

    # ================================================== serving

    def serve(self, **kwargs):
        """Build a ServingEngine on this model: the decode graph of the
        same layer list (causal attention becomes incremental attention
        over a paged or contiguous KV cache), this model's weights adopted
        by name, and continuous batching over a fixed slot set. kwargs
        override ServingSpec fields: slots, max_seq_len, prefill_chunk,
        max_new_tokens, kv_layout, kv_block_size, kv_num_blocks,
        prefix_sharing, prefix_cache."""
        if not self._compiled:
            raise RuntimeError("call compile() before serve()")
        for flag in ("disaggregate", "speculate"):
            if kwargs.pop(flag, False):
                raise NotImplementedError(
                    f"serve({flag}=True) is not ported yet (ROADMAP queue "
                    f"A11)")
        from .serving import ServingEngine

        return ServingEngine(self, **kwargs)
