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
keeps its own rows; the search consults the warm-start plan cache
(`--warmstart-dir`) and the newest checkpoint's plan (`--auto-resume`)
first (warmstart/). `fit` is the JAX package's loop (1660) over the
executor's train step (a CUDA graph replayed per batch on the card, as
JAX replays one jitted executable), or with `pipeline_steps > 1` over
chunks of steps, each one replay (engine/), with its telemetry hooks
(`--telemetry-dir`, `enable_telemetry`: spans, step records, the MFU
anchor) and its resilience half (resilience/: `--checkpoint-dir`,
async atomic checkpoints, `--auto-resume` from the absolute (epoch,
batch) cursor, the SIGTERM drain with a final snapshot, the fault hook)
and its observability half (JAX 1476-1640, 1700-2098): diagnostics
(`--diagnostics`, `enable_diagnostics`: the strategy report, the drift
monitor, the health rules with `--health-abort-on` agreed over the
ranks), the sanitizer (`--sanitize-numerics`), sampled op-grain profiles
(`--profile-every`, `profile_step`), the hang watchdog, the flight
recorder, `--profiling` and `--xprof-dir`, and the elastic re-planner
(`--elastic`, `enable_elastic`: elastic/, JAX 1583-1608, 1842, 2048) at
fit entry and each step or chunk edge, its decisions agreed over the
ranks, a capacity shrink moving training onto a sub-mesh of the world
with the other ranks parked until a regrow. The training state
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

# ElasticController.maybe_replan's "check on your own cadence"
from .elastic.controller import POLL


# FFModel methods of the JAX package that the port has not got yet, by
# ROADMAP item: calling one raises, naming its item
_NOT_PORTED_METHODS = {
    **dict.fromkeys(("moe", "experts", "group_by", "aggregate",
                     "aggregate_spec", "cache"), "A12 (ops/moe.py)"),
}


def peer_abort(diag, step: int):
    """The HealthAbort of a rank whose own rules did not fire at `step`
    while another rank's abort-listed rule did (agreed at the step edge:
    `PreemptionHandler.poll`), its alert sunk like any other."""
    from .diagnostics.health import Alert, HealthAbort

    alert = Alert(rule="peer_abort", level="error", step=int(step),
                  message=(f"a rule of --health-abort-on fired on another "
                           f"rank at step {step}: every rank stops here"),
                  action="abort")
    if diag is not None:
        diag.health.alerts.append(alert)
        diag._sink_alert(alert)
    return HealthAbort(alert)


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
        # static analysis (analysis/): the compile gate's AnalysisResult,
        # the --spmd-barrier verdict, and the verified TransitionPlan of
        # the last restore (its JSON: the report's `transition` section)
        self._analysis = None
        self._spmd_barrier = None
        self._transition = None
        # (UnitySearch, choice) of the search this rank ran, else None
        self._search_result = None
        # warm start (warmstart/): the manager of --warmstart-dir, the
        # plan's structural fingerprint (set where a search could run) and
        # the plan record every checkpoint embeds
        self._warmstart = None
        self._plan_fingerprint = None
        self._plan_record = None
        # resilience (resilience/): the checkpoint manager, the per-step
        # fault hook, whether --auto-resume already restored this model,
        # and the (absolute epoch, batch) a resume starts from
        self._resilience = None
        self._fault_hook = None
        self._auto_resumed = False
        self._resume_cursor = None
        # diagnostics (diagnostics/): the manager, the plan's predicted
        # step makespan (the drift monitor's reference) and, where no
        # search ran here, the (UnitySearch, choice) the strategy report
        # reconstructed for the adopted plan (a recalibration's handle)
        self._diagnostics = None
        self._predicted_step_s = None
        self._replay_search = None
        # ffscope (scope/): the sampled step profiler; --profiling's table
        # printed for this compile
        self._scope_prof = None
        self._profiled = False
        self._diag_warned = False
        # elastic re-planning (elastic/): the controller (--elastic /
        # enable_elastic) and its decision records; the world ranks of a
        # sub-mesh (None: the whole world), the raw metrics argument a
        # re-plan compiles with again, the plan's origin behind a
        # "replan" source, and the steps a parked rank still skips
        self._elastic = None
        self._elastic_decisions = []
        self._mesh_ranks = None
        self._metrics_arg = ()
        self._plan_origin = None
        self._elastic_skip = 0
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

    def pipeline_blocks(
        self,
        input: Tensor,
        num_layers: int,
        num_heads: int,
        mlp_ratio: int = 4,
        num_microbatches: int = 0,
        causal: bool = True,
        attention_impl: str = "xla",
        name: str = "",
    ) -> Tensor:
        """L stacked pre-LN transformer blocks as one op whose layer dim
        shards over the `pipe` mesh axis: the fill/drain pipeline of
        parallel/pipeline.py on a mesh with a pipe axis, the sequential
        stack otherwise."""
        from .ops import PipelineBlocksParams

        p = PipelineBlocksParams(num_layers, num_heads, mlp_ratio,
                                 num_microbatches, causal, attention_impl)
        return self._add_layer(OT.OP_PIPE_BLOCKS, p, [input], name,
                               data_type=input.dtype).outputs[0]

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
                    plan_fingerprint=self._plan_fingerprint,
                    sanitize_numerics=bool(self.config.sanitize_numerics),
                    spmd_barrier=(self._spmd_barrier or {}).get(
                        "status", "off"),
                )
                diag = self._maybe_enable_diagnostics()
                if diag is not None and self.mesh.member:
                    # the strategy report and the drift monitor's
                    # reference, inside the session's window
                    diag.on_compile()
        finally:
            if tel is not None:
                tel.flush()
                telemetry.deactivate(tel)

    def _compile_impl(self, optimizer, loss_type, metrics, comp_mode):
        from . import telemetry
        from .parallel.strategies import Strategy
        from .search.unity import choose_update_sharding
        from .tensor import ParallelTensor, ParallelTensorShape

        self.optimizer = optimizer or SGDOptimizer(
            lr=self.config.learning_rate)
        self.loss_type = LossType(loss_type)
        self.metrics = Metrics.from_list(self.loss_type, list(metrics))
        # the raw metrics argument, kept so an elastic replan can drive
        # this same compile pipeline again with identical arguments
        self._metrics_arg = tuple(metrics)
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
        if not self.mesh.member:
            self._park()
            return
        if cfg.warmstart_dir and self._warmstart is None:
            from .warmstart import WarmStartManager

            self._warmstart = WarmStartManager(self, cfg.warmstart_dir)
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
        hint = getattr(self, "_plan_source_hint", None)
        if hint is not None:
            # elastic replan: the recompile's outcome is relabeled so
            # every consumer (plan record, compile event, report, ffcheck
            # context) sees plan_source "replan"; the underlying origin
            # (search/cache/broadcast/...) is kept for the decision record
            self._plan_origin = self._plan_source
            self._plan_source = hint
            self._plan_source_hint = None
        if self._plan_fingerprint is not None:
            # the plan record every checkpoint of this model carries:
            # --auto-resume restores the plan from the manifest
            # (warmstart._checkpoint_plan) instead of searching again
            self._plan_record = {
                "structural_fingerprint": self._plan_fingerprint,
                "plan_source": self._plan_source,
                "strategy": Strategy(self._strategy or {}).to_json(),
                "mesh_axes": {k: int(v)
                              for k, v in self.mesh.shape.items()},
            }
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
            if search_cost_model is not None:
                # the local cost model prices the ADOPTED mode (the
                # compile gate's memory cross-check and the report read it)
                search_cost_model.update_sharding = bool(
                    self._update_sharding["enabled"])
                search_cost_model.param_gather = (
                    self._update_sharding.get("stage", 0) == 3)
                search_cost_model.overlap_update = bool(
                    self._update_sharding["enabled"])
        self.executor = Executor(g, self.config, self.device, logits_node,
                                 self.loss_type, self.metrics, self.optimizer,
                                 mesh=self.mesh,
                                 update_sharding=self._update_sharding)
        # the realized record (the executor resolves the decision into
        # per-weight specs): manifests, the report and the event describe
        # what runs
        self._update_sharding = self.executor.update_sharding
        telemetry.event(
            "weight_update_decision",
            enabled=self._update_sharding["enabled"],
            stage=self._update_sharding.get("stage", 0),
            shards=self._update_sharding.get("shards", 1),
            reason=self._update_sharding.get("reason", ""))
        # --- ffcheck compile gate (analysis/): the materialized plan
        # verified on every plan source BEFORE init_variables allocates a
        # weight (the executor built above holds none), so a predicted OOM
        # or an invalid placement fails here with a structured report, not
        # on the card. Errors raise unless --no-verify-plan.
        from .analysis import verify_plan

        verify_plan(self, cost_model=search_cost_model)
        # --- the SPMD fingerprint barrier (--spmd-barrier): every rank's
        # step ingredients against rank 0's before the first step; a
        # diverged rank raises SPMDDivergenceError on every rank
        self._spmd_barrier = None
        if self.config.spmd_barrier:
            from .analysis import spmd

            with telemetry.span("compile.spmd_barrier"):
                self._spmd_barrier = spmd.fingerprint_barrier(self)
            telemetry.event("spmd_barrier", **self._spmd_barrier)
        self._params, self._state = self.executor.init_variables(
            self.config.seed)
        self._rng = torch.Generator(self.device).manual_seed(
            self.config.seed)
        self._opt_slots = self.optimizer.init(self._params)
        self._step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._counters = self.metrics.zero_counters(self.device)
        self._goodput_anchor = self._goodput()
        self._profiled = False
        self._compiled = True

    def _search(self, g: Graph):
        """The Unity search where the JAX package's `do_search` holds (JAX
        model.py:872-1100): a budget or a parallelism/substitution flag on
        a mesh of more than one device. The port's devices are ranks, so it
        takes the JAX package's multi-process branch: rank 0 consults the
        warm start first (`restore_plan`: the newest checkpoint's plan
        under `--auto-resume`, then the `--warmstart-dir` plan cache, whose
        fingerprint needs the calibration), else calibrates (on its card:
        `--calibrate K`) and searches, jointly over rewrites and
        placements (`joint_graph_optimize`), or also over the mesh's
        factorizations (`--search-mesh-shapes`), and stores the plan
        (`store_plan`); the plan is broadcast and every rank applies it to
        the graph as built, in its logical-rank form
        (`UnitySearch.to_strategy`). Returns the cost model (rank 0's
        calibrated), which the update-sharding decision prices with."""
        from . import telemetry
        from .distributed import (
            broadcast_json,
            is_coordinator,
            run_search_on_host0,
        )
        from .machine import (
            AXIS_DATA,
            AXIS_MODEL,
            AXIS_PIPE,
            AXIS_SEQ,
            MeshShape,
        )
        from .parallel.strategies import Strategy
        from .search.cost_model import CostModel, OpHarness
        from .search.joint import joint_graph_optimize
        from .search.machine_model import (
            machine_model_for_mesh,
            machine_model_from_file,
        )
        from .search.mesh_search import search_mesh_shapes
        from .telemetry import log as fflog
        from .warmstart import restore_plan, store_plan

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
            # a PIPE_BLOCKS stack makes the pipe axis searchable too: the
            # dp-vs-pp decision is taken across factorizations
            if any(n.op_type == OT.OP_PIPE_BLOCKS for n in g.topo_order()):
                search_axes = search_axes + (AXIS_PIPE,)
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
        calibrated = [False]

        def calibrate():
            # the dominant ops measured on this rank's device, so the
            # search prices from measurements, not the mfu guess; once
            # (the warm start's fingerprint runs it before the search)
            if calibrated[0] or cfg.search_calibrate <= 0:
                return
            calibrated[0] = True
            with telemetry.span("compile.calibrate"):
                cost_model.calibrate_graph(g, top_k=cfg.search_calibrate)
                telemetry.event("calibrate", top_k=cfg.search_calibrate,
                                **cost_model.calib_stats)

        def search():
            cur = {k: int(v) for k, v in self.mesh.shape.items()}
            warm = restore_plan(self, g, cost_model, calibrate)
            if (warm is not None and warm[1] and warm[1] != cur
                    and not cfg.search_mesh_shapes):
                # a plan for another factorization applies only where the
                # mesh is searched (and rebuilt from the broadcast)
                fflog.warning("warmstart: cached plan's mesh %s != this "
                              "mesh %s — re-searching", warm[1], cur)
                warm = None
            if warm is not None:
                self._plan_source = warm[2]
                found["mesh"] = warm[1] or cur
                return Strategy(warm[0])
            calibrate()
            orig_names = {n.name for n in g.topo_order()}
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
            strategy = us.to_strategy(choice)
            self._strategy = strategy.overrides
            self._plan_source = "search"
            # the mesh the plan was found for is recorded with it (the
            # mesh itself is rebuilt on every rank after the broadcast)
            store_plan(self, meta={"mode": mode, "evals": us.evals},
                       replay_names=orig_names,
                       mesh_axes=found.get("mesh"))
            return strategy

        mode = "mesh_shapes" if cfg.search_mesh_shapes else "joint"
        with telemetry.span("compile.search", mode=mode):
            self._strategy = run_search_on_host0(search)
        if cfg.search_mesh_shapes:
            shape = broadcast_json(found if is_coordinator() else None)["mesh"]
            sizes = {a: 1 for a in ms.axis_names}
            sizes.update(shape)
            self.mesh = self._build_mesh(MeshShape(
                tuple(sizes[a] for a in ms.axis_names), ms.axis_names))
        if not is_coordinator():
            self._plan_source = "broadcast"
        return cost_model

    def _build_mesh(self, shape):
        """The mesh of `shape` over the torch.distributed world (JAX
        `_build_mesh`, model.py:2251), or over `_mesh_ranks` of it (an
        elastic re-plan's sub-mesh); the distributed helpers' scope
        follows it (`distributed.set_scope`)."""
        from .distributed import set_scope
        from .machine import build_mesh

        ranks = self._mesh_ranks
        off = int(self.config.mesh_device_offset or 0)
        if ranks is None and off:
            # a window of the world from `mesh_device_offset` (the
            # sides of a split serve; JAX: jax.devices()[offset:])
            ranks = list(range(off, off + shape.num_devices))
        mesh = build_mesh(shape, self.device, ranks=ranks)
        set_scope(mesh)
        return mesh

    def _park(self):
        """This rank holds no device of the new mesh (an elastic shrink
        parked it): no executor and no state of its own; the step count
        it stopped at stays for the controller (elastic/controller.py
        keeps the rank in the world's agreement until a regrow)."""
        step = None if self._step is None else int(self._step)
        self.executor = None
        self._params = self._state = self._opt_slots = None
        self._counters = None
        self._step = None if step is None else torch.tensor(
            step, dtype=torch.int32)
        self._strategy = None
        self._plan_source = "parked"
        self._plan_source_hint = None
        self._predicted_step_s = None
        self._goodput_anchor = None
        self._compiled = True

    def _assign_strategy(self):
        """Mesh axes of every op output and weight (JAX model.py:1319):
        by default the batch dim of every activation over the batch axes
        (where they divide it), weights replicated; a parallel op's
        output derived from its input's; the strategy's overrides on
        top."""
        import warnings

        from .machine import AXIS_PIPE, batch_axes_for
        from .parallel.ops import derive_parallel_assignment
        from .tensor import PartitionSpec

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
            if (node.op_type == OT.OP_PIPE_BLOCKS
                    and self.mesh.shape.get(AXIS_PIPE, 1) > 1):
                # the stacked block weights shard their layer dim over
                # `pipe`: each stage stores only its layers (and their
                # masters and slots), the layout the schedule runs on
                for ws in node.weight_specs:
                    node.weight_axes.setdefault(ws.name, PartitionSpec(
                        AXIS_PIPE, *([None] * (len(ws.shape) - 1))))
            for i, spec_axes in ov.get("outputs", {}).items():
                node.outputs[i].assign_axes(spec_axes)
            node.weight_axes.update(ov.get("weights", {}))
            if node.op_type in (OT.OP_INC_MULTIHEAD_ATTENTION,
                                OT.OP_PAGED_INC_MULTIHEAD_ATTENTION):
                self._kv_state_follows_heads(node)

    @staticmethod
    def _kv_state_follows_heads(node):
        """A decode graph's KV state the plan leaves unplaced rests with
        its feature dim over the axes its projections split the heads by
        (the placement `Executor._kv_rule` runs on), the slot and block
        dims whole."""
        from .tensor import PartitionSpec

        wq = node.weight_axes.get("wq")
        heads = wq[1] if wq is not None and len(wq) > 1 else None
        names = (("pool_k", "pool_v")
                 if node.op_type == OT.OP_PAGED_INC_MULTIHEAD_ATTENTION
                 else ("cache_k", "cache_v"))
        for w in names:
            if w not in node.weight_axes and heads is not None:
                node.weight_axes[w] = PartitionSpec(None, None, heads)

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

    def enable_checkpointing(self, directory: str, every_n_steps: int = 0,
                             every_t_seconds: float = 0.0, keep: int = 3):
        """Attach the resilience subsystem (resilience/): async snapshots
        every N steps / T seconds during fit, a SIGTERM drain to a final
        snapshot, and `auto_resume`-able committed checkpoints. The
        programmatic twin of --checkpoint-dir/--checkpoint-every."""
        from .resilience import CheckpointPolicy, ResilienceManager

        self._resilience = ResilienceManager(
            self, directory,
            CheckpointPolicy(every_n_steps=every_n_steps,
                             every_t_seconds=every_t_seconds),
            keep=keep)
        return self._resilience

    def set_fault_hook(self, hook):
        """Install a per-step failure-injection hook (resilience/fault.py):
        called with the global step after each optimizer step (each chunk's
        steps at its boundary) and checkpoint decision; raising simulates
        mid-fit death. Test-only."""
        self._fault_hook = hook

    def _py_step(self) -> int:
        """The optimizer steps taken (a host read of the step counter)."""
        return int(self._step)

    def fit(self, x, y: np.ndarray, epochs: int = -1, batch_size: int = -1,
            shuffle: bool = True, verbose: bool = True,
            pipeline_steps: Optional[int] = None):
        """The training loop (JAX `model.py:1660-2110`): per epoch an order
        from `_epoch_order`, then one train step per full batch (a tail
        shorter than a batch is dropped, as in JAX). Logs one line per
        epoch (`telemetry.log`: info when verbose, else debug).

        Preemption-safe, as JAX's: policy-gated async checkpoints between
        steps (--checkpoint-dir, --checkpoint-every), a SIGTERM drain with
        a final snapshot (the flag agreed over the ranks), and
        --auto-resume from the newest committed checkpoint's absolute
        (epoch, batch) cursor, at most once a model. With `pipeline_steps
        > 1` (or --pipeline-steps) the epochs run through the pipelined
        engine (engine/): chunks of N steps, each one CUDA-graph replay
        over batches a background thread staged, with checkpoints and
        preemption at chunk boundaries; bit-identical to the per-step loop.

        With telemetry on (--telemetry-dir / enable_telemetry) every step
        emits a `step` span around a `data_wait` span and a JSONL record
        splitting its wall time into data wait, device time and the
        blocking slice of any save (JAX `model.py:1927-2003`; per step
        from the chunk window in pipelined mode). A captured step's replay
        is one asynchronous launch, so on the card the step's window ends
        with a stream synchronisation, only when telemetry is on: its time
        is then the device's step, and the next batch's staging is its own
        data wait.

        The observability hooks (JAX `model.py:1700-2098`): with
        diagnostics (--diagnostics, `enable_diagnostics`) the health rules
        and the drift monitor see a record every `--health-sample-every`
        K steps (the loss fetched only then; the window's averages); a
        rule in --health-abort-on stops fit with HealthAbort, agreed over
        the ranks in the all-reduce that agrees SIGTERM, so every rank
        stops at the same step. The health record's window ends before
        the step's save (the save's blocking slice is in metrics.jsonl).
        --sanitize-numerics names the first non-finite (op, phase, step)
        in the nan_loss alert; --profile-every K / `profile_step()` runs
        a sampled step eagerly under torch.profiler and attributes its
        device time to the ops; --watchdog-timeout starts the hang
        watchdog; --xprof-dir runs the whole fit under torch.profiler; the
        flight recorder (--flight-events) is dumped on SIGTERM, a health
        abort, an injected death or any other exception."""
        if not self._compiled:
            raise RuntimeError("call compile() before fit()")
        import contextlib

        from . import telemetry
        from .diagnostics.health import HealthAbort
        from .resilience.fault import SimulatedPreemption
        from .resilience.policy import PreemptionHandler
        from .scope import flightrec
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
        if self.config.sanitize_numerics:
            # a fresh fit gets a fresh provenance window: an earlier
            # (diverged) fit's reports must not win this run's
            from . import sanitize

            sanitize.get_monitor().reset()
        diag = self._maybe_enable_diagnostics()
        if diag is not None and diag.report is None and self.mesh.member:
            # diagnostics attached after compile: the report and the
            # drift monitor now
            diag.on_compile()
        elastic = self._maybe_enable_elastic(diag)
        # ffscope: the flight recorder's ring, sampled op-grain profiles,
        # the hang watchdog
        flightrec.configure(capacity=self.config.flight_events or None,
                            enabled=self.config.flight_events > 0)
        scope_prof = self._scope_prof
        if scope_prof is None and self.config.profile_every > 0:
            scope_prof = self._ensure_step_profiler()
        watchdog = self._start_watchdog(tel, diag)
        epoch_log = fflog.info if verbose else fflog.debug
        if self.config.profiling and not self._profiled:
            # --profiling: the per-op table, once per compile; its rows
            # also land in the report's `profile` section
            from .profiling import (print_operator_profile,
                                    profile_section_from_rows)
            from .search.cost_model import OpHarness

            rows = print_operator_profile(
                self.graph, harness=OpHarness.of(self.config, self.device))
            self._profiled = True
            if diag is not None and rows:
                diag.on_profile(profile_section_from_rows(rows))
        if epochs < 0:
            epochs = self.config.epochs
        if batch_size < 0:
            batch_size = self.config.batch_size
        x_dict = self._as_input_dict(x)
        num_samples = y.shape[0]
        num_batches = num_samples // batch_size
        if pipeline_steps is None:
            pipeline_steps = self.config.pipeline_steps
        pipeline_steps = max(1, int(pipeline_steps))
        engine = None
        if pipeline_steps > 1:
            from .engine import PipelinedEngine

            engine = PipelinedEngine(self, pipeline_steps)
        sync = (torch.cuda.current_stream(self.device).synchronize
                if tel is not None and self.device.type == "cuda" else None)
        health_every = max(1, int(self.config.health_sample_every))
        health_win = [0.0, 0.0, 0]  # step-time / data-wait sums, count

        resil = self._resilience
        if resil is None and self.config.checkpoint_dir:
            from .resilience import ResilienceManager

            resil = self._resilience = ResilienceManager.from_config(self)
        start_epoch = 0
        if (resil is not None and self.config.auto_resume
                and not self._auto_resumed):
            # at most once per model object: a second fit() (one fit a
            # keras epoch) must NOT rewind live state to the checkpoint
            self._auto_resumed = True
            # peek before restoring: a checkpoint older than this model's
            # live progress is rejected without rewinding anything
            peek = resil.peek_latest()
            if peek is not None:
                path, extras = peek
                cur = extras.get("cursor") or {}
                abs_epoch = int(cur.get("epoch", 0))
                if abs_epoch < self._epoch_base:
                    import warnings

                    warnings.warn(
                        f"auto-resume: checkpoint {path} is older than "
                        f"this model's live progress (epoch {abs_epoch} < "
                        f"{self._epoch_base}) — ignored", stacklevel=2)
                else:
                    with telemetry.span("resume.restore", path=path):
                        resil.restore_path(path)
                    start_epoch = abs_epoch - self._epoch_base
                    # the batch offset sticks to its ABSOLUTE epoch, which
                    # a later fit call may be the one to reach
                    self._resume_cursor = (
                        abs_epoch, int(cur.get("batch", 0)))
                    telemetry.instant("resume", path=path, epoch=abs_epoch)
                    telemetry.event("resume", path=path, epoch=abs_epoch,
                                    batch=int(cur.get("batch", 0)))
        py_step = self._py_step()
        if elastic is not None:
            # fit-entry check: a withdrawn or restored fleet re-plans
            # BEFORE the first step; a parked rank waits for a regrow
            elastic.enter_fit(py_step)
            if self.mesh.member:
                py_step = self._py_step()
        # labels shaped (N, seq, ...) carry seq tokens per example
        tokens_per_example = int(np.prod(y.shape[1:])) if y.ndim > 1 else 1
        # ffscope attribution joins trace ranges back to these names: the
        # report's op set (when diagnostics wrote one) is the contract
        prof_names = None
        if scope_prof is not None:
            if diag is not None and diag.report is not None:
                prof_names = [o["name"] for o in diag.report["ops"]]
            else:
                prof_names = [n.name for n in self.graph.topo_order()]
        if diag is not None and resil is not None:
            # staleness clock starts at fit start; every commit re-feeds it
            diag.note_checkpoint_commit(time.time())
        from .distributed import process_count, world_size

        # the flags agreed over the ranks at each step (or chunk) edge:
        # SIGTERM (with checkpointing), a health abort (with diagnostics
        # on a mesh) and the elastic controller's drift flag and capacity
        # checks (on a world of more than one rank), in one all-reduce
        preempt = None
        if resil is not None:
            preempt = PreemptionHandler()
        elif ((diag is not None and process_count() > 1)
              or (elastic is not None and world_size() > 1)):
            preempt = PreemptionHandler(signals=())
        preempted = False
        with contextlib.ExitStack() as stack:
            if preempt is not None:
                stack.enter_context(preempt)
            if self.config.xprof_dir:
                # the whole fit under torch.profiler, its Chrome trace
                # exported to --xprof-dir
                from .scope.profile import xprof_trace

                stack.enter_context(xprof_trace(self.config.xprof_dir))
            try:
                for epoch in range(start_epoch, epochs):
                    abs_e = self._epoch_base + epoch
                    order = self._epoch_order(num_samples, epoch, shuffle)
                    t0 = time.time()
                    b0 = 0
                    if (self._resume_cursor is not None
                            and abs_e >= self._resume_cursor[0]):
                        if abs_e == self._resume_cursor[0]:
                            b0 = self._resume_cursor[1]
                            if b0 >= num_batches and b0 > 0:
                                import warnings

                                warnings.warn(
                                    f"resume cursor batch {b0} does not "
                                    f"fit {num_batches} batches (batch "
                                    f"size changed?) — restarting the "
                                    f"epoch", stacklevel=2)
                                b0 = 0
                        self._resume_cursor = None
                    if engine is not None:
                        py_step, preempted = engine.run_epoch(
                            x_dict=x_dict, y=y, order=order, b0=b0,
                            num_batches=num_batches,
                            batch_size=batch_size, abs_e=abs_e,
                            py_step=py_step, tel=tel, diag=diag,
                            resil=resil, preempt=preempt,
                            fault_hook=self._fault_hook,
                            tokens_per_example=tokens_per_example,
                            watchdog=watchdog, elastic=elastic)
                        if preempted:
                            fflog.warning(
                                "preempted at step %d (chunk boundary): "
                                "final checkpoint committed, stopping "
                                "fit", py_step)
                            flightrec.dump("sigterm")
                            return
                        b_first = num_batches  # the epoch ran in chunks
                    else:
                        b_first = b0
                    for b in range(b_first, num_batches):
                        if self._elastic_skip > 0:
                            # parked by an elastic shrink: the steps the
                            # active ranks ran without this rank
                            self._elastic_skip -= 1
                            continue
                        # built anew after a recompile (RecompileState,
                        # a drift recalibration, an elastic re-plan)
                        # dropped the step
                        step_fn = (self.executor._train_step
                                   or self.executor.build_train_step())
                        t_it0 = time.perf_counter() if tel is not None else 0.0
                        with telemetry.span("step", step=py_step + 1):
                            with telemetry.span("data_wait"):
                                idx = order[b * batch_size:(b + 1) * batch_size]
                                batch = self._make_batch(
                                    {k: v[idx] for k, v in x_dict.items()},
                                    y[idx])
                            data_wait = (time.perf_counter() - t_it0
                                         if tel is not None else 0.0)
                            capturing = (
                                scope_prof is not None
                                and scope_prof.should_capture(py_step + 1)
                                and scope_prof.begin(py_step + 1))
                            with (self.executor.scoped() if capturing
                                  else contextlib.nullcontext()):
                                (self._params, self._state, self._opt_slots,
                                 self._step, self._counters, lval) = step_fn(
                                    self._params, self._state,
                                    self._opt_slots, self._step,
                                    self._counters, batch, self._rng)
                            py_step += 1
                            if capturing:
                                # the step's device work inside the capture
                                # (a sampled profile's step: the drain is
                                # the point)
                                if self.device.type == "cuda":
                                    torch.cuda.synchronize(self.device)  # fflint: ok host_sync_in_loop
                                section = scope_prof.end(py_step,
                                                         prof_names)
                                if section is not None and diag is not None:
                                    diag.on_profile(section)
                            elif sync is not None:
                                sync()
                            flightrec.note_step(py_step)
                            if watchdog is not None:
                                watchdog.beat(py_step)
                            # the cursor names the NEXT batch to run on
                            # resume; epochs are ABSOLUTE (since compile)
                            if b + 1 >= num_batches:
                                cursor = {"epoch": abs_e + 1, "batch": 0}
                            else:
                                cursor = {"epoch": abs_e, "batch": b + 1}
                            abort = None
                            if diag is not None:
                                # a step that warmed up or captured its
                                # graph, or ran under the profiler, is no
                                # sample of the step's time
                                timed = not capturing and getattr(
                                    step_fn, "last_call", "replay") in (
                                        "replay", "eager")
                                abort = self._health_step(
                                    diag, resil, py_step, abs_e, health_every,
                                    health_win, lval, t_it0, data_wait,
                                    timed)
                            t_save0 = (time.perf_counter()
                                       if tel is not None else 0.0)
                            view, drift = POLL, None
                            if preempt is not None:
                                preempt.poll(
                                    abort=abort is not None,
                                    drift=(elastic is not None
                                           and elastic.has_advisory),
                                    capacity=(elastic.capacity_view()
                                              if elastic is not None
                                              else None))
                                if elastic is not None:
                                    view, drift = (preempt.capacity,
                                                   preempt.drift)
                                if preempt.aborted:
                                    if tel is not None:
                                        tel.record_step(
                                            py_step, abs_e,
                                            t_save0 - t_it0, data_wait,
                                            0.0, batch_size,
                                            tokens_per_example)
                                    raise abort or peer_abort(diag, py_step)
                            elif abort is not None:
                                if tel is not None:
                                    tel.record_step(
                                        py_step, abs_e, t_save0 - t_it0,
                                        data_wait, 0.0, batch_size,
                                        tokens_per_example)
                                raise abort
                            if resil is not None:
                                if preempt.preempted:
                                    # the notice: drain the in-flight save,
                                    # then one final synchronous snapshot
                                    telemetry.instant("preempted",
                                                      step=py_step)
                                    resil.finalize(py_step, cursor,
                                                   final_save=True)
                                    preempted = True
                                else:
                                    resil.maybe_save(py_step, cursor)
                        if tel is not None:
                            now = time.perf_counter()
                            # the blocking slice of the step's save (none
                            # without checkpointing)
                            save_lat = (now - t_save0 if resil is not None
                                        else 0.0)
                            tel.record_step(
                                py_step, abs_e, now - t_it0, data_wait,
                                save_lat, batch_size, tokens_per_example)
                        if self._fault_hook is not None:
                            self._fault_hook(py_step)
                        if (elastic is not None and not preempted
                                and elastic.maybe_replan(
                                    py_step, capacity=view, drift=drift)):
                            # the re-plan moved executor + state at this
                            # step boundary: the loop's step is rebuilt
                            # from the new executor, the flags agreed
                            # over the new mesh's ranks
                            if preempt is not None:
                                preempt.rebind()
                            if self.mesh.member:
                                py_step = self._py_step()
                        if preempted:
                            telemetry.event("preempted", step=py_step)
                            fflog.warning(
                                "preempted at step %d: final checkpoint "
                                "committed, stopping fit", py_step)
                            flightrec.dump("sigterm")
                            return
                    if not self.mesh.member:
                        continue  # parked: no step of this epoch ran here
                    # once an epoch: its wall time needs its device work
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)  # fflint: ok host_sync_in_loop
                    dt = time.time() - t0
                    thru = (num_batches - b0) * batch_size / dt
                    epoch_log(f"epoch {epoch}: {self.get_perf_metrics()} "
                              f"ELAPSED TIME = {dt:.4f}s, THROUGHPUT = "
                              f"{thru:.2f} samples/s")
                    telemetry.event("epoch", epoch=abs_e, duration_s=dt,
                                    examples_per_sec=thru)
            except SimulatedPreemption:
                # injected death: die exactly as a real kill would: no
                # drain, no final save, and the in-flight async write must
                # not commit after the "kill"
                flightrec.dump("SimulatedPreemption")
                if resil is not None:
                    resil.checkpointer.abort()
                raise
            except HealthAbort:
                # a rule of --health-abort-on fired (here or on another
                # rank): stop with the artifacts; drain the in-flight save
                # but take no final snapshot of a NaN'd model
                flightrec.dump("HealthAbort")
                if resil is not None:
                    resil.finalize()
                fflog.error(
                    "fit aborted by diagnostics at step %d (see %s)",
                    self._py_step(),
                    diag.alerts_path if diag else "alerts.jsonl")
                raise
            except BaseException as e:
                # anything else that kills the fit (an executor error, the
                # watchdog's interrupt) leaves the flight record behind
                flightrec.dump(type(e).__name__)
                raise
            else:
                # the next fit() continues the absolute epoch count
                self._epoch_base += epochs
                if resil is not None:
                    resil.finalize()
            finally:
                if elastic is not None:
                    # the parked ranks leave their wait with this rank
                    elastic.release()
                if watchdog is not None:
                    watchdog.stop()
                if scope_prof is not None:
                    scope_prof.abandon()  # a capture left open by a raise
                if tel is not None:
                    # artifacts exist however fit ends: summary, then trace
                    if diag is not None:
                        diag.on_fit_end()
                    tel.write_summary()
                    tel.write_metrics_snapshot(reason="fit_end")
                    tel.flush()
                    telemetry.deactivate(tel)

    def _health_step(self, diag, resil, py_step: int, abs_e: int,
                     health_every: int, win: list, lval, t_it0: float,
                     data_wait: float, timed: bool = True):
        """The diagnostics of one eager step (JAX `model.py:1985-2041`):
        the step joins the health window; on a sampled step (every
        `--health-sample-every` K) the loss is fetched, the only sync
        diagnostics add, and the rules and the drift monitor see ONE
        record with the window's averages (K = 1: the step's own). A step
        that is no sample of the step time (`timed` False: its graph
        warmed up or captured, or it ran under the profiler) adds its
        loss but not its times, as the JAX engine's chunk that compiled;
        a window of no timed step carries no times. Returns the
        HealthAbort an abort-listed rule raised (the caller agrees it
        over the ranks before raising), else None."""
        from .diagnostics.health import HealthAbort

        sampled = py_step % health_every == 0
        loss_val = float(lval) if sampled else None
        if timed:
            win[0] += time.perf_counter() - t_it0
            win[1] += data_wait
            win[2] += 1
        if not sampled:
            return None
        k = win[2]
        times = {"step_time_s": None, "data_wait_s": None,
                 "save_latency_s": None, "device_time_s": None}
        if k:
            w_t, w_dw = win[0] / k, win[1] / k
            times = {"step_time_s": w_t, "data_wait_s": w_dw,
                     "save_latency_s": 0.0,
                     "device_time_s": max(0.0, w_t - w_dw)}
        win[:] = [0.0, 0.0, 0]
        # a wall-clock stamp, not the stop of a timer pair (the window's
        # times go to the diagnostics record below)
        rec = {"step": py_step, "epoch": abs_e, "t": time.time(),  # fflint: ok raw_timer_in_hot_path
               **times, "loss": loss_val}
        rec.update(self._nonfinite_localization(loss_val))
        if resil is not None:
            diag.note_checkpoint_commit(resil.last_commit_walltime())
        try:
            diag.on_step(rec)
        except HealthAbort as e:
            return e
        return None

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
        self.executor.flush_probes()
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
        the captured train and chunk steps, so they are dropped and the
        next batch captures anew (JAX retraces, `model.py:2208`)."""
        if not self._compiled:
            raise RuntimeError("call compile() before set_learning_rate()")
        if float(lr) == float(self.optimizer.lr):
            return
        self.optimizer.set_learning_rate(lr)
        self.executor._train_step = None
        # the chunked steps hold the same rate constant
        self.executor._chunk_steps.clear()

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

    def enable_diagnostics(self, directory: str = "",
                           drift_threshold: Optional[float] = None,
                           abort_on: Optional[Sequence[str]] = None,
                           recalibrate: bool = False, rules=None):
        """Attach the diagnostics subsystem (diagnostics/): the strategy
        explain report at compile, online cost-model drift monitoring and
        run-health anomaly rules during fit, artifacts next to the
        telemetry session's (strategy_report.json/md, alerts.jsonl). The
        programmatic twin of --diagnostics (JAX `model.py:1476`);
        `directory` enables telemetry there first when no session exists
        yet. A second call applies what can change live (the abort set,
        the drift threshold, recalibration)."""
        from .diagnostics import DiagnosticsManager
        from .telemetry import log as fflog

        if directory:
            self.enable_telemetry(directory)
        elif self._telemetry is None and self.config.telemetry_dir:
            self.enable_telemetry(self.config.telemetry_dir)
        if self._telemetry is None:
            raise ValueError(
                "diagnostics requires telemetry: pass a directory, set "
                "--telemetry-dir, or call enable_telemetry() first")
        if self._diagnostics is None:
            self._diagnostics = DiagnosticsManager(
                self, self._telemetry,
                drift_threshold=(self.config.drift_threshold
                                 if drift_threshold is None
                                 else drift_threshold),
                abort_on=tuple(self.config.health_abort_on
                               if abort_on is None else abort_on),
                recalibrate=recalibrate, rules=rules)
        elif (drift_threshold is not None or abort_on is not None
                or recalibrate or rules is not None):
            diag = self._diagnostics
            if abort_on is not None:
                diag.health.set_abort_on(tuple(abort_on))
            if drift_threshold is not None:
                diag.drift_threshold = float(drift_threshold)
                if diag.drift is not None:
                    diag.drift.threshold = float(drift_threshold)
            if recalibrate:
                from .diagnostics.drift import make_recalibration_state

                diag._recalibrate = True
                if diag.drift is not None \
                        and diag.drift.recompile_state is None:
                    diag.drift.recompile_state = \
                        make_recalibration_state(self)
            if rules is not None:
                fflog.warning(
                    "enable_diagnostics: custom rules ignored — this "
                    "model's diagnostics manager already runs its rule "
                    "set (pass rules on the FIRST enable_diagnostics "
                    "call)")
        return self._diagnostics

    def get_diagnostics(self):
        """The model's DiagnosticsManager, or None when diagnostics is
        off."""
        return self._diagnostics

    def _maybe_enable_diagnostics(self):
        """Config-driven lazy attach (--diagnostics); without
        --telemetry-dir it warns once instead of silently doing
        nothing."""
        from .telemetry import log as fflog

        if self._diagnostics is not None or not self.config.diagnostics:
            return self._diagnostics
        if self._telemetry is None and not self.config.telemetry_dir:
            if not self._diag_warned:
                self._diag_warned = True
                fflog.warning(
                    "--diagnostics ignored: no --telemetry-dir (the "
                    "report/alert artifacts need a telemetry directory)")
            return None
        return self.enable_diagnostics()

    def enable_elastic(self, **kwargs):
        """Attach the elastic re-planning controller (elastic/) to this
        model — the programmatic twin of --elastic. kwargs pass through
        to ElasticController (cooldown_steps, horizon_steps, dry_run,
        visible_devices_fn for tests, capacity_check_every). Reuses /
        attaches diagnostics when configured so the drift trigger stream
        is live. On a mesh, every rank calls it at the same point."""
        from .elastic import ElasticController

        diag = self._maybe_enable_diagnostics()
        self._elastic = ElasticController(self, diag, **kwargs)
        return self._elastic

    def _maybe_enable_elastic(self, diag):
        """Config-driven lazy attach (--elastic), mirroring the
        diagnostics lazy attach; an existing controller (enable_elastic)
        is reused, picking up diagnostics if it attached later."""
        if self._elastic is not None:
            if diag is not None and self._elastic.diag is None:
                self._elastic.attach_diagnostics(diag)
            return self._elastic
        if not self.config.elastic:
            return None
        from .elastic import ElasticController

        self._elastic = ElasticController(self, diag)
        return self._elastic

    def _ensure_step_profiler(self):
        """The model's ffscope StepProfiler (scope/profile.py), made on
        first use from config (--profile-every; trace dirs under
        <telemetry-dir>/ffscope when there is a telemetry dir)."""
        if self._scope_prof is None:
            import os

            from .scope.profile import StepProfiler

            root = (os.path.join(self.config.telemetry_dir, "ffscope")
                    if self.config.telemetry_dir else None)
            self._scope_prof = StepProfiler(
                every=self.config.profile_every, trace_root=root)
        return self._scope_prof

    def profile_step(self):
        """Arm a one-shot op-grain profile: the next fit step runs eagerly
        under torch.profiler and its attributed per-op device time lands
        in strategy_report.json's `profile` section (the programmatic
        twin of --profile-every K)."""
        self._ensure_step_profiler().arm()

    def _nonfinite_localization(self, loss_val) -> dict:
        """The sanitizer's (op, phase, step) of a non-finite loss, as
        extra keys of the health record (NaNLossRule folds them into its
        alert). Empty when the loss is finite, the sanitizer is off or
        nothing was localized. Reads the probe tables (one copy each),
        only on this already-dead path."""
        import math as _math

        if (loss_val is None or _math.isfinite(loss_val)
                or not self.config.sanitize_numerics):
            return {}
        from . import sanitize

        info = sanitize.get_monitor().first_nonfinite()
        if info is None:
            return {}
        return {"nonfinite_op": info["op"],
                "nonfinite_phase": info["phase"],
                "nonfinite_step": info["step"]}

    def _start_watchdog(self, tel, diag):
        """--watchdog-timeout: the hang watchdog (scope/watchdog.py),
        started, its heartbeats under the telemetry (else checkpoint)
        dir, a firing recorded as a `hang_watchdog` alert when
        diagnostics are on. None when off."""
        if self.config.watchdog_timeout <= 0:
            return None
        from .distributed import process_index
        from .scope.watchdog import HangWatchdog

        wd_dir = (tel.directory if tel is not None
                  else self.config.telemetry_dir
                  or self.config.checkpoint_dir or None)

        def _wd_alert(info, _diag=diag):
            if _diag is not None:
                _diag._alerts.record(
                    "alert", rule="hang_watchdog", level="error",
                    step=info.get("last_step"),
                    stalled_s=info.get("stalled_s"),
                    deadline_s=info.get("deadline_s"),
                    lagging_host=info.get("lagging_host"),
                    message="hang watchdog fired: no step-boundary "
                            "progress (flight.json dumped)")

        return HangWatchdog(
            timeout_s=self.config.watchdog_timeout,
            multiplier=self.config.watchdog_multiplier,
            directory=wd_dir, host_index=process_index(),
            abort=self.config.watchdog_abort, on_fire=_wd_alert).start()

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

    # ================================================== checkpoints

    def save_checkpoint(self, path: str):
        """Synchronous atomic checkpoint of the full training state into
        the checkpoint root `path` (resilience/checkpointer.py). Returns
        the committed checkpoint directory."""
        from .resilience import ResilienceManager

        # keep=0: explicit save_checkpoint calls never prune
        mgr = ResilienceManager(self, path, keep=0)
        mgr.save(self._py_step(), blocking=True)
        return mgr.checkpointer.last_committed

    def load_checkpoint(self, path: str):
        """Restore the newest committed checkpoint under root `path` (or a
        single checkpoint dir) in place, resharding onto this model's mesh
        and plan: the saving run's mesh may differ
        (resilience/reshard.py)."""
        import os

        from .resilience import latest_checkpoint, restore_model

        target = path
        if not os.path.exists(os.path.join(path, "manifest.json")):
            found = latest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {path!r} (expected a "
                    f"step_*/manifest.json layout)")
            target = found
        restore_model(self, target)
        return self

    def serve(self, **kwargs):
        """Build a ServingEngine on this model (JAX `model.py:2277-2332`):
        the decode graph of the same layer list (causal attention becomes
        incremental attention over a paged or contiguous KV cache, placed
        by the plan on this model's mesh), this model's weights adopted
        by name, and continuous batching over a fixed slot set. kwargs
        override ServingSpec fields: slots, max_seq_len, prefill_chunk,
        max_new_tokens, kv_layout, kv_block_size, kv_num_blocks,
        prefix_sharing, prefix_cache, role, config_overrides, strategy.

        `disaggregate=True` (or --serve-disaggregate) builds a
        DisaggregatedServingEngine: prefill on the torchrun world's first
        ranks and decode on the rest (serve_prefill_chips sizes the
        prefill side), each request's KV handed over device to device.
        `speculate=True, draft_model=<a compiled LM>` builds a
        SpeculativeServingEngine: the drafter proposes K tokens a round
        and the target verifies them in one call, gated by the
        acceptance-calibrated payoff inequality; the token streams stay
        those of plain decode (serve_draft_chips puts the drafter on the
        world's last ranks)."""
        if not self._compiled:
            raise RuntimeError("call compile() before serve()")
        from .distributed import world_size

        # chip budgets past the world fail here, naming the flag
        n_dev = world_size()
        for flag, field in (("--serve-prefill-chips", "serve_prefill_chips"),
                            ("--serve-draft-chips", "serve_draft_chips")):
            chips = int(getattr(self.config, field, 0) or 0)
            if chips >= n_dev:
                raise ValueError(
                    f"{flag}={chips} but only {n_dev} device(s) are "
                    f"visible; both sides of the split need at least one "
                    f"chip")
        disaggregate = kwargs.pop("disaggregate",
                                  bool(self.config.serve_disaggregate))
        speculate = kwargs.pop("speculate", False)
        if disaggregate and speculate:
            raise ValueError(
                "serve(): disaggregate=True and speculate=True are "
                "mutually exclusive for now (speculative decoding of the "
                "disaggregated decode pool is a ROADMAP item)")
        if disaggregate:
            kwargs.pop("draft_model", None)
            from .serving import DisaggregatedServingEngine

            return DisaggregatedServingEngine(self, **kwargs)
        if speculate:
            from .serving import SpeculativeServingEngine

            return SpeculativeServingEngine(self, **kwargs)
        kwargs.pop("draft_model", None)
        from .serving import ServingEngine

        return ServingEngine(self, **kwargs)
