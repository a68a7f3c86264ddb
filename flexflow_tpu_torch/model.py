"""FFModel: the layer-builder API, single-device compile, training
(`fit`, `eval`, the granular forward/backward/update), weights I/O and
`serve()` (twin of `flexflow_tpu/model.py`).

The builder methods mirror the JAX package's one for one (155-690), so a
model script carries over with only the import changed. `compile` lowers
the layer list to a graph and adopts the single-device plan: on one device
every plan is the replicated one, so no Unity search runs (the search and
its plan cache are a later slice of the port). `fit` is the JAX package's
loop (1660) over the executor's train step (a CUDA graph replayed per
batch on the card, as JAX replays one jitted executable) without its
telemetry, checkpoint, diagnostics, elastic, sanitizer and scope hooks:
the flags that ask for those raise (config.py), as does `pipeline_steps >
1` (the pipelined lax.scan engine, ROADMAP A10). The training state
(masters, optimizer slots, step, metric counters) is updated in place,
the twin of the JAX step's donation.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import FFConfig, not_ported, resolve_device
from .executor import Executor
from .fftype import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
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
    SoftmaxParams,
)
from .metrics import Metrics, PerfMetrics
from .ops.base import get_op_def
from .optimizer import Optimizer, SGDOptimizer
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
        self.optimizer: Optional[Optimizer] = None
        self.metrics: Optional[Metrics] = None
        self._params = None
        self._state = None
        self._opt_slots = None
        self._step = None
        self._counters = None
        self._compiled = False
        # absolute epochs run by earlier fit() calls (shuffle keys)
        self._epoch_base = 0
        self._current_batch = None
        self._grads = None
        self._eval_counters = None

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

    def softmax(self, input: Tensor, dim: int = -1, name: str = "") -> Tensor:
        return self._add_layer(OT.OP_SOFTMAX, SoftmaxParams(dim), [input],
                               name, data_type=input.dtype).outputs[0]

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
        optimizer: Optional[Optimizer] = None,
        loss_type: LossType = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics: Sequence[MetricsType] = (),
        comp_mode: CompMode = CompMode.COMP_MODE_TRAINING,
    ):
        """Lower layers to a graph, adopt the single-device plan, build the
        executor, initialise the weights on the model's device and the
        training state (optimizer slots, step, metric counters). Without
        an optimizer, SGD at `config.learning_rate`, as in JAX."""
        self.optimizer = optimizer or SGDOptimizer(
            lr=self.config.learning_rate)
        self.loss_type = LossType(loss_type)
        self.metrics = Metrics.from_list(self.loss_type, list(metrics))
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
        self.executor = Executor(g, self.config, self.device, logits_node,
                                 self.loss_type, self.metrics, self.optimizer)
        self._params, self._state = self.executor.init_variables(
            self.config.seed)
        self._opt_slots = self.optimizer.init(self._params)
        self._step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._counters = self.metrics.zero_counters(self.device)
        self._compiled = True

    # ================================================== training

    def _make_batch(self, x_arrays: dict, labels):
        """Host arrays -> (inputs, labels) on the model's device."""
        return (self.executor.stage_inputs(x_arrays),
                torch.as_tensor(np.asarray(labels)).to(self.device))

    def _as_input_dict(self, x) -> dict:
        input_names = [t.name for t in self._input_tensors]
        if isinstance(x, dict):
            return x
        if isinstance(x, np.ndarray) or hasattr(x, "shape"):
            x = [x]
        if len(x) != len(input_names):
            raise ValueError(
                f"model has {len(input_names)} inputs {input_names}, got "
                f"{len(x)} arrays")
        return dict(zip(input_names, x))

    def _epoch_order(self, num_samples: int, epoch: int,
                     shuffle: bool) -> np.ndarray:
        """Sample order for one epoch, keyed on (config.seed, absolute
        epoch) exactly as the JAX package keys it, so both packages shuffle
        alike."""
        if not shuffle:
            return np.arange(num_samples)
        rs = np.random.RandomState(
            (self.config.seed * 1_000_003
             + self._epoch_base + epoch) % (2 ** 32))
        return rs.permutation(num_samples)

    def fit(self, x, y: np.ndarray, epochs: int = -1, batch_size: int = -1,
            shuffle: bool = True, verbose: bool = True,
            pipeline_steps: Optional[int] = None):
        """The training loop: per epoch an order from `_epoch_order`, then
        one train step per full batch (a tail shorter than a batch is
        dropped, as in JAX). Prints one line per epoch when verbose."""
        if not self._compiled:
            raise RuntimeError("call compile() before fit()")
        if pipeline_steps is not None and int(pipeline_steps) > 1:
            raise not_ported("fit(pipeline_steps > 1), the pipelined "
                             "lax.scan engine,", "A10 (engine/)")
        if epochs < 0:
            epochs = self.config.epochs
        if batch_size < 0:
            batch_size = self.config.batch_size
        x_dict = self._as_input_dict(x)
        num_samples = y.shape[0]
        num_batches = num_samples // batch_size
        step_fn = self.executor._train_step or self.executor.build_train_step()
        for epoch in range(epochs):
            order = self._epoch_order(num_samples, epoch, shuffle)
            t0 = time.time()
            for b in range(num_batches):
                idx = order[b * batch_size:(b + 1) * batch_size]
                batch = self._make_batch({k: v[idx] for k, v in x_dict.items()},
                                         y[idx])
                (self._params, self._state, self._opt_slots, self._step,
                 self._counters, _) = step_fn(
                    self._params, self._state, self._opt_slots, self._step,
                    self._counters, batch)
            if verbose:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.time() - t0
                print(f"epoch {epoch}: {self.get_perf_metrics()} ELAPSED "
                      f"TIME = {dt:.4f}s, THROUGHPUT = "
                      f"{num_batches * batch_size / dt:.2f} samples/s")
        self._epoch_base += epochs

    def eval(self, x, y, batch_size: int = -1) -> PerfMetrics:
        if not self._compiled:
            raise RuntimeError("call compile() before eval()")
        if batch_size < 0:
            batch_size = self.config.batch_size
        x_dict = self._as_input_dict(x)
        eval_fn = self.executor._eval_step or self.executor.build_eval_step()
        # one set of counters, zeroed in place: the eval step adds into the
        # tensors it was captured on
        if self._eval_counters is None:
            self._eval_counters = self.metrics.zero_counters(self.device)
        counters = self._eval_counters
        for c in counters.values():
            c.zero_()
        for b in range(y.shape[0] // batch_size):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            batch = self._make_batch({k: v[sl] for k, v in x_dict.items()},
                                     y[sl])
            counters = eval_fn(self._params, self._state, counters, batch)
        return PerfMetrics(counters, self.metrics)

    # granular API (the reference's C++ train loops)

    def start_batch(self, x, y):
        self._current_batch = self._make_batch(self._as_input_dict(x), y)

    def forward(self, seq_length: int = -1):
        if self._current_batch is None:
            raise RuntimeError("call start_batch first")
        fwd = self.executor._forward_fn or self.executor.build_forward()
        xs, _ = self._current_batch
        logits, self._state = fwd(
            self._params, self._state, xs,
            self.config.computation_mode == CompMode.COMP_MODE_TRAINING)
        return logits

    def zero_gradients(self):
        self._grads = None

    def backward(self, seq_length: int = -1):
        if self._current_batch is None:
            raise RuntimeError("call start_batch first")
        xs, labels = self._current_batch
        loss_fn = self.executor.make_loss_fn(self._state, xs, labels)
        lval, (logits, _, ce_sum), self._grads = (
            self.executor.value_and_grad(loss_fn, self._params))
        self._counters = self.metrics.compute(
            self._counters, logits.detach(), labels,
            from_logits=not self.executor.last_op_is_softmax,
            scce_sum=ce_sum)
        return lval

    def update(self):
        if self._grads is None:
            raise RuntimeError("call backward first")
        self._params, self._opt_slots = self.optimizer.update(
            self._grads, self._params, self._opt_slots, self._step)
        self._step.add_(1)
        self._grads = None

    def reset_metrics(self):
        for c in self._counters.values():
            c.zero_()

    def set_learning_rate(self, lr: float):
        """Change the optimizer's learning rate. The rate is a constant of
        the captured train step, so the step is dropped and the next batch
        captures anew (JAX retraces, `model.py:2208`)."""
        if not self._compiled:
            raise RuntimeError("call compile() before set_learning_rate()")
        if float(lr) == float(self.optimizer.lr):
            return
        self.optimizer.set_learning_rate(lr)
        self.executor._train_step = None

    def get_perf_metrics(self) -> PerfMetrics:
        return PerfMetrics(self._counters, self.metrics)

    def create_data_loader(self, batch_tensor: Tensor,
                           full_array: np.ndarray):
        from .dataloader import SingleDataLoader

        return SingleDataLoader(self, batch_tensor, full_array)

    # ================================================== weights I/O

    def get_weight(self, layer_name: str, weight_name: str) -> np.ndarray:
        return self._params[layer_name][weight_name].detach().cpu().numpy()

    def set_weight(self, layer_name: str, weight_name: str,
                   value: np.ndarray):
        """Replace one master with a new tensor of `value`, as the JAX
        package replaces the array: a serving engine that adopted the old
        one keeps it, and a captured train step that held it captures
        anew at the next batch."""
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
