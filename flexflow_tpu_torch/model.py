"""FFModel: the layer-builder API, compile onto a mesh, training (`fit`,
`eval`, the granular forward/backward/update), weights I/O and `serve()`
(twin of `flexflow_tpu/model.py`).

The builder methods mirror the JAX package's one for one (155-560), tied
weights (`shared_op`), constant inputs and the parallel ops
(`repartition`, `combine`, `replicate`, `reduction`) included, so a model
script carries over with only the import changed. `compile` lowers the
layer list to a graph, builds the mesh (`--mesh`, over the
torch.distributed world) and places every tensor: data parallel by
default (batch over `data`, weights replicated), under a strategy where
one is given (`set_strategy`, `--import-strategy`); the weight update
runs replicated or sharded (ZeRO stage 2/3), as the Unity search prices
it or the flags force it. Where the JAX package searches (a budget or a
parallelism flag on a mesh of more than one device), rank 0 runs the
Unity search (search/) and every rank applies its plan. Every rank is
given the same global arrays, as JAX's single-controller `fit` is, and
keeps its own rows. `fit` is the JAX package's
loop (1660) over the executor's train step (a CUDA graph replayed per
batch on the card, as JAX replays one jitted executable) with its
telemetry hooks (`--telemetry-dir`, `enable_telemetry`: spans, step
records, the MFU anchor) and without its checkpoint, diagnostics,
elastic, sanitizer and scope hooks: the flags that ask for those raise
(config.py), as does `pipeline_steps > 1` (the pipelined lax.scan engine,
ROADMAP A10). The training state
(masters, optimizer slots, step, metric counters) is updated in place,
the twin of the JAX step's donation.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .config import FFConfig, FFIterationConfig, not_ported, resolve_device
from .executor import Executor
from .fftype import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType as OT,
    PoolType,
    RegularizerMode,
)
from .initializer import Initializer
from .layer import Layer
from .ops import (
    BatchMatmulParams,
    BatchNormParams,
    CastParams,
    ConcatParams,
    Conv2DParams,
    DropoutParams,
    ElementBinaryParams,
    ElementUnaryParams,
    EmbeddingParams,
    GatherParams,
    IncMultiHeadAttentionParams,
    LayerNormParams,
    LinearParams,
    MultiHeadAttentionParams,
    PagedIncMultiHeadAttentionParams,
    Pool2DParams,
    ReduceParams,
    ReshapeParams,
    ReverseParams,
    SoftmaxParams,
    SplitParams,
    TopKParams,
    TransposeParams,
)
from .metrics import Metrics, PerfMetrics
from .ops.base import get_op_def
from .optimizer import Optimizer, SGDOptimizer
from .pcg.graph import Graph, OpNode
from .tensor import Tensor


# FFModel methods of the JAX package that the port has not got yet, by
# ROADMAP item: calling one raises, naming its item
_NOT_PORTED_METHODS = {
    "pipeline_blocks": "A8 (pipeline)",
    **dict.fromkeys(("enable_checkpointing", "save_checkpoint",
                     "load_checkpoint", "set_fault_hook"),
                    "A10 (resilience/)"),
    **dict.fromkeys(("enable_diagnostics", "get_diagnostics"),
                    "A10 (diagnostics/)"),
    "enable_elastic": "A10 (elastic/)",
    "profile_step": "A10 (scope/)",
    **dict.fromkeys(("moe", "experts", "group_by", "aggregate",
                     "aggregate_spec", "cache"), "A12 (ops/moe.py)"),
}


class FFModel:
    def __getattr__(self, name):
        item = _NOT_PORTED_METHODS.get(name)
        if item is None:
            raise AttributeError(
                f"{type(self).__name__!r} object has no attribute {name!r}")

        def not_yet(*args, **kwargs):
            raise not_ported(f"FFModel.{name}", item)

        return not_yet

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
        # the generator dropout draws from, on the model's device (the
        # JAX model's PRNG key), made at compile from config.seed
        self._rng = None
        self._telemetry = None  # TelemetrySession (telemetry/session.py)
        # tied node name -> the node that owns its parameters
        self._weight_alias: dict[str, str] = {}
        # MFU anchor: FLOPs of a train step (the ops' forward FLOPs x 3)
        # and the card's peak, set at compile (`_goodput`)
        self._goodput_anchor = None
        # the mesh (machine.Mesh), the strategy's overrides (set_strategy
        # or --import-strategy), where the plan came from and the update
        # sharding decision, set at compile
        self.mesh = None
        self._strategy = None
        self._plan_source = "none"
        self._update_sharding = None
        # (UnitySearch, choice) of the search this rank ran, else None
        self._search_result = None
        self.iter_config = FFIterationConfig()

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

    def create_constant(self, dims, value: float, data_type: DataType) -> Tensor:
        """An input that holds `value` everywhere: fit and eval take no
        array for it (the executor makes it on the device)."""
        t = self.create_tensor(dims, data_type, create_grad=False,
                               name=f"const_{len(self._input_tensors)}")
        t.constant_value = value
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
        shared_op=None,
    ) -> Layer:
        layer = Layer(op_type, params, inputs, name=name, data_type=data_type,
                      initializers=initializers)
        if shared_op is not None:
            # tied weights (reference dense/embedding shared_op): this
            # layer reads the shared layer's parameters; autograd sums the
            # gradients of every use into the one parameter set
            src = getattr(shared_op, "owner_layer", shared_op)
            if not isinstance(src, Layer):
                raise TypeError(
                    f"shared_op must be a Layer or one of its output "
                    f"tensors, got {type(shared_op).__name__}")
            if src.op_type != op_type:
                raise ValueError(
                    f"shared_op ties a {op_type.name} layer to a "
                    f"{src.op_type.name} layer")
            layer.shared_layer_guid = src.layer_guid
        out_shapes = get_op_def(op_type).infer_shapes(
            params, [t.dims for t in inputs])
        for i, s in enumerate(out_shapes):
            layer.outputs.append(
                Tensor(s, data_type, owner_layer=layer, owner_idx=i,
                       name=f"{layer.name}_out{i}"))
        self.layers.append(layer)
        return layer

    def _unary(self, op_type: OT, x: Tensor, name: str = "", inplace: bool = True,
               scalar: float = 0.0) -> Tensor:
        p = ElementUnaryParams(op_type, inplace, scalar)
        return self._add_layer(op_type, p, [x], name,
                               data_type=x.dtype).outputs[0]

    def _binary(self, op_type: OT, x: Tensor, y: Tensor, name: str = "",
                inplace_a: bool = False) -> Tensor:
        p = ElementBinaryParams(op_type, inplace_a)
        return self._add_layer(op_type, p, [x, y], name,
                               data_type=x.dtype).outputs[0]

    # ================================================== ops

    def exp(self, x, name=""):
        return self._unary(OT.OP_EXP, x, name)

    def sin(self, x, name=""):
        return self._unary(OT.OP_SIN, x, name)

    def cos(self, x, name=""):
        return self._unary(OT.OP_COS, x, name)

    def add(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_ADD, x, y, name, inplace_a)

    def subtract(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_SUB, x, y, name, inplace_a)

    def multiply(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_MUL, x, y, name, inplace_a)

    def divide(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_DIV, x, y, name, inplace_a)

    def max(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_MAX, x, y, name, inplace_a)

    def min(self, x, y, inplace_a=False, name=""):
        return self._binary(OT.OP_EW_MIN, x, y, name, inplace_a)

    def rsqrt(self, x, inplace=True, name=""):
        return self._unary(OT.OP_RSQRT, x, name, inplace)

    def pow(self, x, exponent: float, inplace=True, name=""):
        return self._unary(OT.OP_POW, x, name, inplace, scalar=exponent)

    def scalar_multiply(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OT.OP_SCALAR_MULTIPLY, x, name, inplace, scalar)

    def scalar_add(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OT.OP_SCALAR_ADD, x, name, inplace, scalar)

    def scalar_sub(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OT.OP_SCALAR_SUB, x, name, inplace, scalar)

    def scalar_true_divide(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OT.OP_SCALAR_TRUE_DIV, x, name, inplace, scalar)

    def relu(self, x, inplace=True, name=""):
        return self._unary(OT.OP_RELU, x, name, inplace)

    def identity(self, x, name=""):
        return self._unary(OT.OP_IDENTITY, x, name)

    def gelu(self, x, name=""):
        return self._unary(OT.OP_GELU, x, name)

    def sigmoid(self, x, name=""):
        return self._unary(OT.OP_SIGMOID, x, name)

    def tanh(self, x, name=""):
        return self._unary(OT.OP_TANH, x, name)

    def elu(self, x, inplace=True, name=""):
        return self._unary(OT.OP_ELU, x, name, inplace)

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
        shared_op=None,
        kernel_initializer: Optional[Initializer] = None,
        bias_initializer: Optional[Initializer] = None,
        kernel_regularizer: RegularizerMode = RegularizerMode.REG_MODE_NONE,
        name: str = "",
    ) -> Tensor:
        p = LinearParams(out_dim, use_bias, ActiMode(activation), data_type)
        inits = {}
        if kernel_initializer is not None:
            inits["kernel"] = kernel_initializer
        if bias_initializer is not None:
            inits["bias"] = bias_initializer
        return self._add_layer(OT.OP_LINEAR, p, [input], name, inits,
                               data_type, shared_op=shared_op).outputs[0]

    def conv2d(
        self,
        input: Tensor,
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        activation: ActiMode = ActiMode.AC_MODE_NONE,
        groups: int = 1,
        use_bias: bool = True,
        shared_op=None,
        kernel_initializer: Optional[Initializer] = None,
        bias_initializer: Optional[Initializer] = None,
        name: str = "",
    ) -> Tensor:
        p = Conv2DParams(out_channels, kernel_h, kernel_w, stride_h, stride_w,
                         padding_h, padding_w, groups, use_bias,
                         ActiMode(activation))
        inits = {}
        if kernel_initializer is not None:
            inits["kernel"] = kernel_initializer
        if bias_initializer is not None:
            inits["bias"] = bias_initializer
        return self._add_layer(OT.OP_CONV2D, p, [input], name,
                               inits).outputs[0]

    def pool2d(
        self,
        input: Tensor,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        pool_type: PoolType = PoolType.POOL_MAX,
        activation: ActiMode = ActiMode.AC_MODE_NONE,
        name: str = "",
    ) -> Tensor:
        p = Pool2DParams(kernel_h, kernel_w, stride_h, stride_w, padding_h,
                         padding_w, PoolType(pool_type), ActiMode(activation))
        return self._add_layer(OT.OP_POOL2D, p, [input], name).outputs[0]

    def batch_norm(self, input: Tensor, relu: bool = True, name: str = "") -> Tensor:
        p = BatchNormParams(relu)
        return self._add_layer(OT.OP_BATCHNORM, p, [input], name).outputs[0]

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

    def batch_matmul(
        self,
        A: Tensor,
        B: Tensor,
        a_seq_length_dim: int = -1,
        b_seq_length_dim: int = -1,
        name: str = "",
    ) -> Tensor:
        p = BatchMatmulParams(a_seq_length_dim, b_seq_length_dim)
        return self._add_layer(OT.OP_BATCHMATMUL, p, [A, B], name,
                               data_type=A.dtype).outputs[0]

    def dropout(self, input: Tensor, rate: float, seed: int = 0, name: str = "") -> Tensor:
        p = DropoutParams(rate, seed)
        return self._add_layer(OT.OP_DROPOUT, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def embedding(
        self,
        input: Tensor,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
        dtype: DataType = DataType.DT_FLOAT,
        shared_op=None,
        kernel_initializer: Optional[Initializer] = None,
        name: str = "",
    ) -> Tensor:
        p = EmbeddingParams(num_entries, out_dim, AggrMode(aggr), dtype)
        inits = {"kernel": kernel_initializer} if kernel_initializer else {}
        return self._add_layer(OT.OP_EMBEDDING, p, [input], name, inits,
                               dtype, shared_op=shared_op).outputs[0]

    def gather(self, input: Tensor, index: Tensor, dim: int = 0, name: str = "") -> Tensor:
        p = GatherParams(dim)
        return self._add_layer(OT.OP_GATHER, p, [input, index], name,
                               data_type=input.dtype).outputs[0]

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

    def concat(self, tensors: Sequence[Tensor], axis: int, name: str = "") -> Tensor:
        p = ConcatParams(axis, len(tensors))
        return self._add_layer(OT.OP_CONCAT, p, list(tensors), name,
                               data_type=tensors[0].dtype).outputs[0]

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]], axis: int,
              name: str = "") -> list[Tensor]:
        if isinstance(sizes, int):
            # torch.split-style: n equal chunks
            total = input.dims[axis % len(input.dims)]
            if total % sizes != 0:
                raise ValueError(f"cannot split dim {total} into {sizes} equal parts")
            sizes = [total // sizes] * sizes
        p = SplitParams(tuple(sizes), axis)
        return self._add_layer(OT.OP_SPLIT, p, [input], name,
                               data_type=input.dtype).outputs

    def flat(self, input: Tensor, name: str = "") -> Tensor:
        return self._add_layer(OT.OP_FLAT, None, [input], name).outputs[0]

    def transpose(self, input: Tensor, perm: Sequence[int], name: str = "") -> Tensor:
        p = TransposeParams(tuple(perm))
        return self._add_layer(OT.OP_TRANSPOSE, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def reduce_sum(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                   name: str = "") -> Tensor:
        p = ReduceParams(OT.OP_REDUCE_SUM, tuple(axes), keepdims)
        return self._add_layer(OT.OP_REDUCE_SUM, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name: str = "") -> Tensor:
        p = ReduceParams(OT.OP_MEAN, tuple(dims), keepdims)
        return self._add_layer(OT.OP_MEAN, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def reshape(self, input: Tensor, shape: Sequence[int], name: str = "") -> Tensor:
        p = ReshapeParams(tuple(shape))
        return self._add_layer(OT.OP_RESHAPE, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def reverse(self, input: Tensor, axis: int, name: str = "") -> Tensor:
        p = ReverseParams(axis)
        return self._add_layer(OT.OP_REVERSE, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name: str = "") -> tuple[Tensor, Tensor]:
        p = TopKParams(k, sorted)
        outs = self._add_layer(OT.OP_TOPK, p, [input], name,
                               data_type=input.dtype).outputs
        return outs[0], outs[1]

    def cast(self, input: Tensor, dtype: DataType, name: str = "") -> Tensor:
        p = CastParams(DataType(dtype))
        return self._add_layer(OT.OP_CAST, p, [input], name,
                               data_type=DataType(dtype)).outputs[0]

    # ================================================== parallel ops
    # (reference src/parallel_ops/*; inserted explicitly or by a strategy)

    def repartition(self, input: Tensor, dim: int, degree: int,
                    name: str = "") -> Tensor:
        from .parallel import RepartitionParams

        p = RepartitionParams(dim, degree)
        return self._add_layer(OT.OP_REPARTITION, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def combine(self, input: Tensor, dim: int, degree: int,
                name: str = "") -> Tensor:
        from .parallel import CombineParams

        p = CombineParams(dim, degree)
        return self._add_layer(OT.OP_COMBINE, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def replicate(self, input: Tensor, degree: int, name: str = "") -> Tensor:
        from .parallel import ReplicateParams

        p = ReplicateParams(degree)
        return self._add_layer(OT.OP_REPLICATE, p, [input], name,
                               data_type=input.dtype).outputs[0]

    def reduction(self, input: Tensor, degree: int, name: str = "") -> Tensor:
        from .parallel import ReductionParams

        p = ReductionParams(degree)
        return self._add_layer(OT.OP_REDUCTION, p, [input], name,
                               data_type=input.dtype).outputs[0]

    # ================================================== strategy

    def set_strategy(self, strategy):
        """Install a parallelization strategy (a parallel.Strategy or raw
        override dict), applied on top of the data-parallel default at
        compile: the `--import-strategy` analog."""
        self._strategy = getattr(strategy, "overrides", strategy)

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
        an optimizer, SGD at `config.learning_rate`, as in JAX. Under
        telemetry the manifest comes first, then a `compile` span and
        record (JAX `model.py:714-760`)."""
        from . import telemetry

        if self._telemetry is None and self.config.telemetry_dir:
            self.enable_telemetry(self.config.telemetry_dir)
        tel = self._telemetry
        try:
            if tel is not None:
                # the global sink is active only while ITS model is inside
                # an instrumented operation
                telemetry.activate(tel)
                tel.write_manifest(self)
            t_compile0 = time.perf_counter()
            if tel is not None:
                tel.note_compile_start(t_compile0)
            with telemetry.span("compile"):
                self._compile_impl(optimizer, loss_type, metrics, comp_mode)
            if tel is not None:
                tel.recorder.record(
                    "compile",
                    duration_s=time.perf_counter() - t_compile0,
                    num_nodes=len(self.graph.topo_order()),
                    mesh_axes={k: int(v)
                               for k, v in self.mesh.shape.items()},
                    strategy_nodes=sorted(self._strategy)
                    if self._strategy else [],
                    plan_source=self._plan_source,
                    plan_fingerprint=None,
                    sanitize_numerics=False,
                    spmd_barrier="off",
                )
        finally:
            if tel is not None:
                tel.flush()
                telemetry.deactivate(tel)

    def _compile_impl(self, optimizer, loss_type, metrics, comp_mode):
        from .parallel.strategies import Strategy
        from .search.unity import choose_update_sharding
        from .tensor import ParallelTensor, ParallelTensorShape

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
            node.outputs = [ParallelTensor(
                ParallelTensorShape.from_shape(t.dims, t.dtype), name=t.name)]
            if hasattr(t, "constant_value"):
                node.constant = (t.dims, t.dtype, t.constant_value)
            g.add_node(node)
            tensor_to_out[t.tensor_guid] = (node, 0)
        guid_to_node: dict[int, OpNode] = {}
        self._weight_alias = {}
        for layer in self.layers:
            node = OpNode(layer.op_type, layer.params, name=layer.name,
                          layer_guid=layer.layer_guid,
                          initializers=layer.initializers)
            g.add_node(node)
            guid_to_node[layer.layer_guid] = node
            for dst_idx, t_in in enumerate(layer.inputs):
                src_node, src_idx = tensor_to_out[t_in.tensor_guid]
                g.add_edge(src_node, node, src_idx, dst_idx)
                node.inputs.append(src_node.outputs[src_idx])
            node.input_shapes = [t.dims for t in layer.inputs]
            node.output_shapes = [t.dims for t in layer.outputs]
            node.weight_specs = node.op_def.weights(layer.params,
                                                    node.input_shapes)
            if layer.shared_layer_guid >= 0:
                # tied weights: this node reads the source node's
                # parameter set; the executor makes no variables for it
                src = guid_to_node.get(layer.shared_layer_guid)
                if src is None:
                    raise ValueError(
                        f"{layer.name}: shared_op layer must be built "
                        f"before the layer sharing it")
                src_shapes = {ws.name: ws.shape for ws in src.weight_specs}
                for ws in node.weight_specs:
                    if src_shapes.get(ws.name) != ws.shape:
                        raise ValueError(
                            f"{layer.name}: shared weight {ws.name!r} shape "
                            f"{ws.shape} != source {src.name}'s "
                            f"{src_shapes.get(ws.name)}")
                node.weight_source = src.name
                self._weight_alias[node.name] = src.name
            for i, t_out in enumerate(layer.outputs):
                pt = ParallelTensor(
                    ParallelTensorShape.from_shape(t_out.dims, t_out.dtype),
                    name=t_out.name)
                pt.owner_op, pt.owner_idx = node, i
                node.outputs.append(pt)
                tensor_to_out[t_out.tensor_guid] = (node, i)
        self.graph = g

        # --- mesh + strategy (JAX model.py 825-1230)
        cfg = self.config
        self.mesh = self._build_mesh(cfg.mesh_shape())
        if self._strategy is not None:
            self._plan_source = "manual"
        elif cfg.import_strategy_file:
            imported = Strategy.load(cfg.import_strategy_file)
            try:
                imported.validate(g, self.mesh)
            except ValueError as e:
                raise ValueError(
                    f"--import-strategy "
                    f"{cfg.import_strategy_file}: {e}") from e
            self._strategy = imported.overrides
            self._plan_source = "import"
        do_search = (
            self._strategy is None
            and not cfg.only_data_parallel
            and self.mesh.size > 1
            and (cfg.search_budget > 0
                 or cfg.enable_parameter_parallel
                 or cfg.enable_attribute_parallel
                 or cfg.enable_substitutions
                 or bool(cfg.substitution_json_path)))
        logits_node = tensor_to_out[self.layers[-1].outputs[0].tensor_guid][0]
        search_cost_model = None
        if do_search:
            logits_node._is_logits = True  # rewrites carry the marker
            search_cost_model = self._search(g)
        elif self._plan_source == "none":
            self._plan_source = "default"
        self._assign_strategy()
        if cfg.export_strategy_file:
            from .distributed import is_coordinator

            if is_coordinator():
                Strategy(self._strategy or {}).save(cfg.export_strategy_file)
        if cfg.export_strategy_computation_graph_file:
            from .distributed import is_coordinator
            from .pcg.graph import export_dot

            if is_coordinator():
                export_dot(g, cfg.export_strategy_computation_graph_file)

        # --- weight-update sharding: the update-dimension half of the
        # search, decided on the placed graph with the search's cost model
        # (calibrated on rank 0) and adopted from rank 0 on every rank of
        # the mesh, so every rank places the same update layout
        self._update_sharding = choose_update_sharding(
            g, self.mesh, cfg, cost_model=search_cost_model,
            opt_slots=self.optimizer.num_slots)
        if self.mesh.size > 1:
            from .distributed import broadcast_json, is_coordinator

            self._update_sharding = broadcast_json(
                self._update_sharding if is_coordinator() else None)
        self.executor = Executor(g, self.config, self.device, logits_node,
                                 self.loss_type, self.metrics, self.optimizer,
                                 mesh=self.mesh,
                                 update_sharding=self._update_sharding)
        self._update_sharding = self.executor.update_sharding
        self._params, self._state = self.executor.init_variables(
            self.config.seed)
        self._rng = torch.Generator(self.device).manual_seed(
            self.config.seed)
        self._opt_slots = self.optimizer.init(self._params)
        self._step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._counters = self.metrics.zero_counters(self.device)
        self._goodput_anchor = self._goodput()
        self._compiled = True

    def _search(self, g: Graph):
        """The Unity search where the JAX package's `do_search` holds (JAX
        model.py:872-1100): a budget or a parallelism/substitution flag on
        a mesh of more than one device. The port's devices are ranks, so it
        takes the JAX package's multi-process branch: rank 0 calibrates (on
        its card: `--calibrate K`) and searches, jointly over rewrites and
        placements (`joint_graph_optimize`), or also over the mesh's
        factorizations (`--search-mesh-shapes`); the plan is broadcast and
        every rank applies it to the graph as built, in its logical-rank
        form (`UnitySearch.to_strategy`). The warm-start plan cache the
        JAX package consults first (`restore_plan`/`store_plan`) is ROADMAP
        A10 and left out. Returns the cost model (rank 0's calibrated),
        which the update-sharding decision prices with."""
        from . import telemetry
        from .distributed import (
            broadcast_json,
            is_coordinator,
            run_search_on_host0,
        )
        from .machine import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, MeshShape
        from .search.cost_model import CostModel, OpHarness
        from .search.joint import joint_graph_optimize
        from .search.machine_model import (
            machine_model_for_mesh,
            machine_model_from_file,
        )
        from .search.mesh_search import search_mesh_shapes

        cfg = self.config
        machine = (machine_model_from_file(cfg.machine_model_file, self.mesh)
                   if cfg.machine_model_file
                   else machine_model_for_mesh(self.mesh,
                                               num_hosts=cfg.num_nodes))
        cost_model = CostModel(machine, opt_slots=self.optimizer.num_slots)
        cost_model.harness = OpHarness.of(cfg, self.device)
        if (cfg.weight_update_sharding
                and cfg.computation_mode == CompMode.COMP_MODE_TRAINING):
            # a forced sharded update is priced by the placement search
            # itself (the auto decision comes after it); overlapped, as
            # the JAX package prices it by default (the port's sync is
            # not overlapped yet: ROADMAP G1)
            cost_model.update_sharding = True
            cost_model.param_gather = cfg.weight_update_stage == 3
            cost_model.overlap_update = True
        ms = cfg.mesh_shape()
        search_axes = (AXIS_DATA, AXIS_MODEL)
        if cfg.search_mesh_shapes:
            # (the JAX package also searches `pipe` for a PIPE_BLOCKS
            # stack: ROADMAP A8)
            fixed = {a: n for a, n in zip(ms.axis_names, ms.axis_sizes)
                     if n > 1 and a not in search_axes}
            if fixed:
                raise ValueError(
                    f"--search-mesh-shapes factorizes the device count "
                    f"over {search_axes} on a single slice; drop the flag "
                    f"or the extra mesh axes {sorted(fixed)}")
        if cfg.search_calibrate > 0:
            ring_axes = [ax for ax in (AXIS_SEQ,)
                         if dict(self.mesh.shape).get(ax, 1) > 1]
            if ring_axes:
                # collective: every rank takes part in timing the hop
                hops = cost_model.calibrate_collectives(self.mesh, ring_axes)
                telemetry.event("calibrate_collectives", axes=ring_axes,
                                measured=hops)
        found: dict = {}

        def search():
            if cfg.search_calibrate > 0:
                # the dominant ops measured on this rank's device, so the
                # search prices from measurements, not the mfu guess
                with telemetry.span("compile.calibrate"):
                    cost_model.calibrate_graph(g, top_k=cfg.search_calibrate)
                    telemetry.event("calibrate", top_k=cfg.search_calibrate,
                                    **cost_model.calib_stats)
            if cfg.search_mesh_shapes:
                factory = None
                if cfg.machine_model_file:
                    def factory(mesh):
                        return machine_model_from_file(
                            cfg.machine_model_file, mesh)
                shape, _, choice, us, _ = search_mesh_shapes(
                    g, self.mesh.size, cfg, axes=search_axes,
                    chip=machine.chip, num_hosts=cfg.num_nodes,
                    calibrated=cost_model, machine_factory=factory)
                found["mesh"] = shape
            else:
                _, choice, us = joint_graph_optimize(g, self.mesh, cfg,
                                                     cost_model)
            self._search_result = (us, choice)
            return us.to_strategy(choice)

        mode = "mesh_shapes" if cfg.search_mesh_shapes else "joint"
        with telemetry.span("compile.search", mode=mode):
            self._strategy = run_search_on_host0(search)
        if cfg.search_mesh_shapes:
            shape = broadcast_json(found if is_coordinator() else None)["mesh"]
            sizes = {a: 1 for a in ms.axis_names}
            sizes.update(shape)
            self.mesh = self._build_mesh(MeshShape(
                tuple(sizes[a] for a in ms.axis_names), ms.axis_names))
        self._plan_source = "search" if is_coordinator() else "broadcast"
        return cost_model

    def _build_mesh(self, shape):
        """The mesh of `shape` over the torch.distributed world (JAX
        `_build_mesh`, model.py:2251)."""
        from .machine import build_mesh

        return build_mesh(shape, self.device)

    def _assign_strategy(self):
        """Mesh axes of every op output and weight (JAX model.py:1319):
        by default the batch dim of every activation over the batch axes
        (where they divide it), weights replicated; a parallel op's
        output derived from its input's; the strategy's overrides on
        top."""
        import warnings

        from .machine import batch_axes_for
        from .parallel.ops import derive_parallel_assignment

        batch_axes = batch_axes_for(dict(self.mesh.shape))
        batch_deg = self.mesh.axes_size(batch_axes)
        if self._strategy:
            present = {n.name for n in self.graph.topo_order()}
            dropped = sorted(set(self._strategy) - present)
            if dropped:
                warnings.warn(
                    "strategy contains placements for nodes not in this "
                    f"graph (dropped, falling back to data parallel): "
                    f"{dropped}", stacklevel=2)
        for node in self.graph.topo_order():
            ov = (self._strategy or {}).get(node.name, {})
            if node.is_parallel_op and node.inputs:
                if 0 not in ov.get("outputs", {}):
                    node.outputs[0].assign_axes(derive_parallel_assignment(
                        node.op_type, node.params,
                        node.inputs[0].axis_assignment, self.mesh))
            else:
                for pt in node.outputs:
                    dims = pt.shape.dims
                    assignment = [()] * len(dims)
                    if (batch_deg > 1 and len(dims) > 0
                            and dims[0].size % batch_deg == 0):
                        assignment[0] = batch_axes
                    pt.assign_axes(tuple(assignment))
            for i, spec_axes in ov.get("outputs", {}).items():
                node.outputs[i].assign_axes(spec_axes)
            node.weight_axes.update(ov.get("weights", {}))

    def _goodput(self) -> Optional[dict]:
        """The MFU anchor (JAX `model.py:1286-1314`): the ops' forward
        FLOPs over the graph, x3 for forward and backward, against the
        peak of the card `search/machine_model.detect_chip` names (the
        host entry on the CPU) times the mesh's chips. None when no op
        counts FLOPs or no spec names the device."""
        from . import telemetry
        from .search.machine_model import detect_chip

        fwd = 0.0
        for node in self.graph.topo_order():
            if node.op_type == OT.OP_INPUT or not node.input_shapes:
                continue
            fwd += node.op_def.flops(node.params, node.input_shapes,
                                     node.output_shapes)
        if fwd <= 0:
            return None
        try:
            peak = detect_chip(self.device).peak_flops
        except ValueError:  # a card the spec table does not hold
            return None
        num_chips = self.mesh.size
        anchor = {"flops_per_step": 3.0 * fwd,
                  "peak_flops": peak * num_chips, "num_chips": num_chips}
        telemetry.event("goodput_anchor", **anchor)
        return anchor

    # ================================================== training

    def _make_batch(self, x_arrays: dict, labels):
        """Host arrays of the global batch -> (inputs, labels) on the
        model's device, each rank keeping its block: an input by its
        node's placement, the labels by the logits' batch axes."""
        return (self.executor.stage_inputs(x_arrays),
                self.executor.stage_labels(labels))

    def _as_input_dict(self, x) -> dict:
        input_names = [t.name for t in self._input_tensors
                       if not hasattr(t, "constant_value")]
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
        dropped, as in JAX). Logs one line per epoch (`telemetry.log`:
        info when verbose, else debug).

        With telemetry on (--telemetry-dir / enable_telemetry) every step
        emits a `step` span around a `data_wait` span and a JSONL record
        splitting its wall time into data wait and device time (JAX
        `model.py:1927-2003`). A captured step's replay is one
        asynchronous launch, so on the card the step's window ends with
        a stream synchronisation, only when telemetry is on: its time is
        then the device's step, and the next batch's staging is its own
        data wait (the staging copies from pageable memory wait for the
        stream anyway, so the synchronisation removes no overlap)."""
        if not self._compiled:
            raise RuntimeError("call compile() before fit()")
        if pipeline_steps is not None and int(pipeline_steps) > 1:
            raise not_ported("fit(pipeline_steps > 1), the pipelined "
                             "lax.scan engine,", "A10 (engine/)")
        from . import telemetry
        from .telemetry import log as fflog

        if self._telemetry is None and self.config.telemetry_dir:
            self.enable_telemetry(self.config.telemetry_dir)
        tel = self._telemetry
        if tel is not None:
            # active only for the duration of THIS model's fit
            telemetry.activate(tel)
            tel.write_manifest(self)
            anchor = self._goodput_anchor
            if anchor is not None:
                tel.set_goodput(anchor["flops_per_step"],
                                anchor["peak_flops"])
            if self.config.metrics_interval or self.config.metrics_port:
                tel.start_exporter(interval_s=self.config.metrics_interval,
                                   port=self.config.metrics_port)
        epoch_log = fflog.info if verbose else fflog.debug
        if epochs < 0:
            epochs = self.config.epochs
        if batch_size < 0:
            batch_size = self.config.batch_size
        x_dict = self._as_input_dict(x)
        num_samples = y.shape[0]
        num_batches = num_samples // batch_size
        step_fn = self.executor._train_step or self.executor.build_train_step()
        sync = (torch.cuda.current_stream(self.device).synchronize
                if tel is not None and self.device.type == "cuda" else None)
        # labels shaped (N, seq, ...) carry seq tokens per example
        tokens_per_example = int(np.prod(y.shape[1:])) if y.ndim > 1 else 1
        py_step = int(self._step)
        try:
            for epoch in range(epochs):
                abs_e = self._epoch_base + epoch
                order = self._epoch_order(num_samples, epoch, shuffle)
                t0 = time.time()
                for b in range(num_batches):
                    t_it0 = time.perf_counter() if tel is not None else 0.0
                    with telemetry.span("step", step=py_step + 1):
                        with telemetry.span("data_wait"):
                            idx = order[b * batch_size:(b + 1) * batch_size]
                            batch = self._make_batch(
                                {k: v[idx] for k, v in x_dict.items()},
                                y[idx])
                        data_wait = (time.perf_counter() - t_it0
                                     if tel is not None else 0.0)
                        (self._params, self._state, self._opt_slots,
                         self._step, self._counters, _) = step_fn(
                            self._params, self._state, self._opt_slots,
                            self._step, self._counters, batch, self._rng)
                        py_step += 1
                        if sync is not None:
                            sync()
                    if tel is not None:
                        tel.record_step(
                            py_step, abs_e, time.perf_counter() - t_it0,
                            data_wait, 0.0, batch_size, tokens_per_example)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.time() - t0
                thru = num_batches * batch_size / dt
                epoch_log(f"epoch {epoch}: {self.get_perf_metrics()} "
                          f"ELAPSED TIME = {dt:.4f}s, THROUGHPUT = "
                          f"{thru:.2f} samples/s")
                telemetry.event("epoch", epoch=abs_e, duration_s=dt,
                                examples_per_sec=thru)
            self._epoch_base += epochs
        finally:
            if tel is not None:
                # artifacts exist however fit ends: summary, then trace
                tel.write_summary()
                tel.write_metrics_snapshot(reason="fit_end")
                tel.flush()
                telemetry.deactivate(tel)

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
        """The forward of the staged batch. `seq_length` >= 0 truncates
        the sequence dims batch_matmul names (FFIterationConfig's
        seq_length); the JAX model takes the argument and drops it."""
        if self._current_batch is None:
            raise RuntimeError("call start_batch first")
        fwd = self.executor._forward_fn or self.executor.build_forward()
        xs, _ = self._current_batch
        logits, self._state = fwd(
            self._params, self._state, xs,
            self.config.computation_mode == CompMode.COMP_MODE_TRAINING,
            seq_length)
        return self.executor.full_logits(logits)

    def zero_gradients(self):
        self._grads = None

    def backward(self, seq_length: int = -1):
        """Loss and gradients of the staged batch (dropout draws from the
        model's generator); `seq_length` as in `forward`."""
        if self._current_batch is None:
            raise RuntimeError("call start_batch first")
        xs, labels = self._current_batch
        loss_fn = self.executor.make_loss_fn(self._state, xs, labels,
                                             self._rng, seq_length)
        lval, (logits, _, ce_sum), grads = (
            self.executor.value_and_grad(loss_fn, self._params))
        self._grads = self.executor.sync_grads(grads)
        self._counters = self.executor.add_metrics(
            self._counters, logits.detach(), labels, ce_sum)
        return self.executor.global_loss(lval)

    def update(self):
        if self._grads is None:
            raise RuntimeError("call backward first")
        self._params, self._opt_slots = self.optimizer.update(
            self._grads, self._params, self._opt_slots, self._step)
        self._step.add_(1)
        self._grads = None

    def init_operators(self):
        """A no-op, as in the JAX package: per-device operator set-up (the
        reference's INIT tasks) has no analog; the first step does it."""

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

    def _resolve_weight_owner(self, layer_name: str) -> str:
        """Tied-weight nodes (shared_op) hold no parameters of their own:
        reads and writes go to the source layer's set."""
        return self._weight_alias.get(layer_name, layer_name)

    def get_weight(self, layer_name: str, weight_name: str) -> np.ndarray:
        """The whole weight, gathered from its shards (collective on a
        mesh: every rank calls it)."""
        layer_name = self._resolve_weight_owner(layer_name)
        w = self.executor.full_weight(
            layer_name, weight_name, self._params[layer_name][weight_name])
        return w.detach().cpu().numpy()

    def set_weight(self, layer_name: str, weight_name: str,
                   value: np.ndarray):
        """Replace one master with a new tensor of `value`, as the JAX
        package replaces the array: a serving engine that adopted the old
        one keeps it, and a captured train step that held it captures
        anew at the next batch."""
        layer_name = self._resolve_weight_owner(layer_name)
        old = self._params[layer_name][weight_name]
        value = np.asarray(value)
        shape = self.executor.weight_shape(layer_name, weight_name)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(
                f"{layer_name}.{weight_name}: shape {value.shape} != "
                f"{tuple(shape)}")
        self._params[layer_name][weight_name] = self.executor.local_weight(
            layer_name, weight_name,
            torch.tensor(value, dtype=old.dtype, device=old.device))

    # ================================================== observability

    def enable_telemetry(self, directory: str):
        """Attach the observability subsystem (telemetry/): Chrome-trace
        spans + JSONL run metrics under `directory`. The session becomes
        the process-wide sink only while this model is inside compile or
        fit. The programmatic twin of --telemetry-dir."""
        import os

        from . import telemetry
        from .telemetry import log as fflog

        if self._telemetry is None:
            self._telemetry = telemetry.TelemetrySession(directory)
        elif os.path.abspath(directory) != self._telemetry.directory:
            fflog.warning(
                "enable_telemetry(%r) ignored: this model's telemetry "
                "session already writes to %s",
                directory, self._telemetry.directory)
        return self._telemetry

    def get_telemetry(self):
        """The model's TelemetrySession, or None when telemetry is off."""
        return self._telemetry

    def export_dot(self, path: str = "") -> str:
        """Graph DOT export (reference --compgraph flag / print_dot)."""
        from .pcg.graph import export_dot

        if self.graph is None:
            raise RuntimeError("call compile() first")
        return export_dot(self.graph, path or None)

    def print_layers(self, id: int = -1):
        for i, l in enumerate(self.layers):
            if id < 0 or i == id:
                print(f"[{i}] {l.name} {l.op_type.name} "
                      f"in={[t.dims for t in l.inputs]} "
                      f"out={[t.dims for t in l.outputs]}")

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
        if self.mesh.size > 1:
            raise not_ported(
                f"serve() on a mesh of {self.mesh.size} devices (a sharded "
                f"KV cache)", "A11 (serving extras: serving on a mesh)")
        for flag in ("disaggregate", "speculate"):
            if kwargs.pop(flag, False):
                raise NotImplementedError(
                    f"serve({flag}=True) is not ported yet (ROADMAP queue "
                    f"A11)")
        from .serving import ServingEngine

        return ServingEngine(self, **kwargs)
