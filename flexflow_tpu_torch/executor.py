"""Executor: runs a compiled graph on this rank's device, alone or as one
rank of a mesh.

The twin of `flexflow_tpu/executor.py`. Its single-device half:
`init_variables` (554), `_apply` (589), `_cast_compute` (442),
`_restore_state_dtypes` (541), `make_loss_fn` (493), `_train_step_body`
(690), `build_train_step` (742), `build_eval_step` (783),
`build_decode_step` (799), `build_block_copy` (862) and `build_forward`
(945). Gradients come from autograd through `_apply` (the training forward
builds the graph; the eval, forward and decode steps run it under
`no_grad`).

The JAX executor jits each step into one donated executable. The port's
twin: on a CUDA device `build_train_step`, `build_eval_step` and
`build_decode_step` return a `CapturedStep`, which records the step into
a CUDA graph, one per shape signature of its inputs (jit's shape
specialisation), and replays it. Donation is in-place update: the
optimizers update the masters and slots in place, the step counter and
the metric counters advance in place, and the incremental attention ops
write the KV state in place, so every replay reads and writes the same
tensors. `eager()` is the twin of `jax.disable_jit()`: under it a step
runs op by op. On the CPU the steps are plain functions. The granular
`build_forward` and the COW block copy stay eager.
`build_chunked_train_step(n)` (the pipelined engine's, engine/) captures
n train steps over staged `(n, batch, ...)` inputs in one graph.

The decode step reads the parameters in the compute dtype from a cache
(`compute_params`): each copy is cast once and again only when its master
changes (another tensor, or a newer `_version`), in place, so a captured
decode graph keeps reading the same copies. The train step casts inside
the step, since its masters change every step.

On a mesh of more than one device every rank runs the same step on its
blocks of the tensors (the sharded half, JAX 171-440, 554-741, 920-990):
each node's output stays in the placement the plan gave it (`_plan`),
moved between placements by `parallel/spmd.py`'s collectives where the
JAX executor's sharding constraints let XLA insert them. A node runs
batch-local (its inputs' batch rows only), on the rows of its output's
leading dims where a plan splits the sequence too and the op works on
each token alone (`_token_local`), elementwise on any placement, or
whole (inputs and weights gathered); a Linear pair, attention and an
embedding whose weights the plan shards run the Megatron way on this
rank's columns, rows or heads, with the all-reduce of a row-parallel
product in the forward and of a column-parallel input's gradient in the
backward. Ring attention runs on this rank's block of the sequence over
`seq` whatever the plan gives its input (`_mha_rule`); the pipelined
block stack on its stage's blocks, the input and output whole over
`pipe` (`_pipe_rule`). The loss runs on the logits' rows, the sequence
split where they are, normalised by the whole batch's positions. Each
rank keeps the sum of its own rows' weight gradients; `sync_grads`
reduces them over the axes `grad_sync_axes` names by one reduce-scatter
then an all-gather (an all-reduce for a weight with no shardable dim),
the axes its rules ran it split over among them. Under weight-update
sharding the masters and slots live 1/dp at rest (`update_specs`): stage
2 gathers each weight at its first use in a step, stage 3 at every use
by the ring all-gather, the copy dropped after the op and gathered again
for the backward (saved-tensor hooks); the gather's backward is the same
reduce-scatter, so every stage sums the same elements in the same order
and the trajectories are bit-equal.

Observability (JAX 454-524, 592-735): with `--sanitize-numerics` every
op output, and the loss, passes a probe (`sanitize.probe`) before its
consumers read it, folding its finiteness and its cotangent's into this
executor's device table; `set_numeric_fault` plants a NaN in one op's
output or cotangent from a step on. Under `scoped()` (a sampled profile)
the steps run eagerly with a `torch.profiler.record_function` range
around each op's forward and around the runtime scopes (`grad_sync`,
`param_gather`, `weight_update` or `weight_update_shard`, `metrics`,
and `loss`, which the JAX package's loss has none of), the twins of the
JAX executor's `jax.named_scope`s; otherwise no range is opened. `drop_steps` drops every built step with its graphs.

Float settings: TF32 is switched off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) when an executor is built, so
an fp32 run is full fp32 on the card, as the reference's fp32 path is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import math
import os
import traceback
from typing import Any, Optional

import torch

from .config import FFConfig
from .fftype import ActiMode, LossType, OperatorType as OT, dtype_to_torch
from .initializer import initializer_by_name
from .loss import loss_terms
from .ops.base import OpContext
from .pcg.graph import Graph, OpNode


def _stable_seed(seed: int, name: str) -> int:
    """Per-weight generator seed from the model seed and the weight's
    (node, weight) name: independent of evaluation order."""
    h = hashlib.md5(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def set_float_policy():
    """Full-precision fp32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- capture

_EAGER_DEPTH = 0


@contextlib.contextmanager
def eager():
    """The twin of `jax.disable_jit()`: inside it every step runs op by op
    on the current stream, with no CUDA graph captured or replayed. For
    tests and for comparing a captured step with its eager self; not a
    user option."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


@contextlib.contextmanager
def _no_collection():
    """Hold Python's cyclic garbage collector off for the block (a CUDA
    graph's capture): a finalizer it would run there (a dropped graph's
    reset, a freed pool) is an operation the capture forbids. Cycles
    made meanwhile are collected after it, as usual."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _leaves(tree) -> list:
    """The leaves of nested dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    """`tree` with `fn` applied to every leaf (new containers)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _signature(tree, path=()) -> tuple:
    """Keys, shapes and dtypes of a tree's tensors (other leaves by
    value): what a jitted JAX function specialises on."""
    if isinstance(tree, dict):
        return tuple(x for k, v in tree.items()
                     for x in _signature(v, path + (k,)))
    if isinstance(tree, (tuple, list)):
        return tuple(x for i, v in enumerate(tree)
                     for x in _signature(v, path + (i,)))
    if torch.is_tensor(tree):
        return ((path, tuple(tree.shape), tree.dtype),)
    return ((path, tree),)


def _culprit(exc: BaseException) -> str:
    """The first error behind a failed capture and the line outside torch
    that raised it."""
    root = exc
    for _ in range(16):  # the capture's own error chains the first one
        nxt = root.__cause__ or root.__context__
        if nxt is None:
            break
        root = nxt
    frames = traceback.extract_tb(root.__traceback__)
    torch_dir = os.path.dirname(torch.__file__)
    outside = [f for f in frames if not f.filename.startswith(torch_dir)]
    where = (outside or frames)[-1] if frames else None
    at = (f"{where.filename}:{where.lineno} in {where.name} "
          f"({where.line})" if where else "an unknown line")
    return f"{at}: {type(root).__name__}: {root}"


class _Graph:
    """One captured signature: the graph, the tensors it holds, its input
    buffers, its outputs and its kernel counts."""

    def __init__(self, graph, held, static, out, counts):
        self.graph = graph
        self.held = held
        self.static = static
        self.out = out
        self.held_ids = {id(x) for x in held}
        self.counts = counts

    def holds(self, held: list) -> bool:
        return (len(held) == len(self.held)
                and all(a is b for a, b in zip(held, self.held)))


class CapturedStep:
    """A step run as CUDA graphs: the twin of a jitted, donated JAX
    executable.

    `fn(*args)` is the eager step. The arguments at the positions in
    `held` are the tensors the graph reads and writes in place (params,
    state, optimizer slots, step, counters; a generator): a call must
    pass the very tensors the graph was captured on, and one that passes
    another there (after `set_weight`, say) captures anew. The other
    arguments are staged: copied, from the host or the device, into the
    graph's own input buffers, one graph per signature of theirs (keys,
    shapes, dtypes; `_signature`). A `torch.Generator` among the held
    arguments is registered with the graph, so replays advance it as
    eager calls do. Outputs that are not held tensors are cloned after
    each replay, so a caller may keep them (a JAX step returns new
    arrays).

    The first call of a signature runs `fn` eagerly on the step's side
    stream: the warm-up, which also does every lazy set-up on that
    stream (cuBLAS handles and workspaces, the kernel libraries, the
    decode kernels' scratch, keyed by stream). The second captures `fn`
    on that stream, which runs nothing, then replays it; later calls
    replay. A capture that fails raises `CaptureError` naming the step and
    the line that broke it, with nothing run: no step falls back to eager
    behind the caller's back. Graphs given the same `pool` share its
    memory (the decode widths: one graph replays at a time, and its
    outputs are cloned before the next).

    Kernel counts: a wrapper bumps its `KernelCounter` on the host where
    it launches, which under capture happens once, with no launch on the
    device. So the capture's counts are taken back, and every replay adds
    them: the counters count device launches.

    Python's cyclic garbage collector is held off while a capture runs
    (`_no_collection`). A model lives in reference cycles (its
    diagnostics manager holds it; a caught exception's traceback holds
    the fit that raised), so a dropped model's graphs are freed by
    whatever allocation next triggers a collection, and a graph reset
    inside another capture is an operation the capture forbids: it
    invalidates that capture, on some ranks and not others, and the
    ranks that went on wait in a collective forever. A failed capture resets its own graph before it
    raises, so nothing is left half captured. `release()` drops every
    graph of the step at once, with their memory pools (an elastic
    re-plan's old executor).
    """

    def __init__(self, name: str, fn, device: torch.device, held,
                 pool=None):
        self.name = name
        self.fn = fn
        self.device = device
        self.held = frozenset(held)
        self.pool = pool
        self.stream = torch.cuda.Stream(device)
        self._graphs: dict[tuple, Any] = {}  # signature -> _Graph or None
        self.captures = 0
        # what the last call did: "warm-up", "capture" (then a replay),
        # "replay" or "eager" (under `eager()`); a caller timing its calls
        # (fit's health records) leaves the first two out
        self.last_call = ""

    def _split(self, args):
        held = [x for i, a in enumerate(args) if i in self.held
                for x in _leaves(a)]
        staged = tuple(None if i in self.held else a
                       for i, a in enumerate(args))
        return held, staged

    def __call__(self, *args):
        if _EAGER_DEPTH:
            self.last_call = "eager"
            return self.fn(*args)
        held, staged = self._split(args)
        sig = _signature(staged)
        if sig not in self._graphs:
            self._graphs[sig] = None
            self.last_call = "warm-up"
            return self._warm_up(args)
        graph = self._graphs[sig]
        self.last_call = "replay"
        if graph is None or not graph.holds(held):
            self._graphs[sig] = None  # frees a stale graph's pool first
            del graph
            graph = self._graphs[sig] = self._capture(args, held)
            self.last_call = "capture"
        return self._replay(graph, args)

    def _warm_up(self, args):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.fn(*args)
        cur.wait_stream(self.stream)
        for x in _leaves(out):
            if torch.is_tensor(x) and x.is_cuda:
                x.record_stream(cur)
        return out

    def release(self):
        """Drop every captured graph (and its memory pool); the next call
        of a signature warms up and captures anew."""
        self._graphs.clear()

    def _capture(self, args, held) -> _Graph:
        from .kernels import counters

        def buffer(x):
            if torch.is_tensor(x):
                return torch.empty(x.shape, dtype=x.dtype,
                                   device=self.device)
            return x

        static = tuple(a if i in self.held else _map(buffer, a)
                       for i, a in enumerate(args))
        graph = torch.cuda.CUDAGraph()
        for x in held:
            if isinstance(x, torch.Generator):
                graph.register_generator_state(x)
        cs = counters()
        before = {n: c.state() for n, c in cs.items()}
        try:
            # thread_local: another thread's legitimate calls (the chunk
            # prefetcher's pinned allocations and event waits) do not
            # invalidate this thread's capture
            with _no_collection(), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                out = self.fn(*static)
        except Exception as exc:
            for n, c in cs.items():
                c.restore(before[n])
            graph.reset()  # nothing half captured survives the raise
            raise CaptureError(
                f"{self.name}: the CUDA-graph capture failed at "
                f"{_culprit(exc)}. The step did not run. A captured step "
                f"may not read a tensor on the host, make a synchronising "
                f"CUDA call or need a new allocation on replay; "
                f"executor.eager() runs it op by op.") from exc
        counts = {}
        for n, c in cs.items():
            delta = c.since(before[n])
            c.restore(before[n])
            if any(delta):
                counts[n] = delta
        self.captures += 1
        return _Graph(graph, held, static, out, counts)

    def _replay(self, graph: _Graph, args):
        from .kernels import counters

        for i, a in enumerate(args):
            if i in self.held:
                continue
            for buf, x in zip(_leaves(graph.static[i]), _leaves(a)):
                if torch.is_tensor(buf) and buf is not x:
                    buf.copy_(x)
        graph.graph.replay()
        cs = counters()
        for n, delta in graph.counts.items():
            cs[n].add(delta)
        return _map(lambda x: x.clone() if torch.is_tensor(x)
                    and id(x) not in graph.held_ids else x, graph.out)


def dtype_policy(config: FFConfig, device: torch.device) -> tuple:
    """(compute_dtype, matmul_dtype) of a model: compute_dtype != None ->
    bf16/fp16 activations over fp32 master weights; matmul_dtype -> the
    tensor-op input cast for fp32 matmuls, on CUDA (the JAX package
    applies it on the TPU)."""
    compute = (dtype_to_torch(config.computation_dtype)
               if config.computation_dtype is not None else None)
    matmul = (torch.bfloat16 if config.allow_tensor_op_math_conversion
              and torch.device(device).type == "cuda" else None)
    return compute, matmul


def _write_back(state: dict, new_state: dict) -> dict:
    """Donation of the state: the step's new state written into the
    given state's tensors where it is not already there."""
    with torch.no_grad():
        for n, ws in new_state.items():
            mine = state.setdefault(n, {})
            for k, v in ws.items():
                if k not in mine:
                    mine[k] = v
                elif mine[k] is not v:
                    mine[k].copy_(v)
    return state


def _elementwise_ops() -> frozenset:
    from .ops.elementwise import _BINARY_FNS, _SCALAR_FNS, _UNARY_FNS

    return frozenset(_UNARY_FNS) | frozenset(_SCALAR_FNS) | frozenset(
        _BINARY_FNS) | {OT.OP_CAST}


_ELEMENTWISE = _elementwise_ops()
# ops whose rows (dim 0) are independent, whatever their params
_ROW_INDEPENDENT = _ELEMENTWISE | {
    OT.OP_LINEAR, OT.OP_CONV2D, OT.OP_POOL2D, OT.OP_FLAT, OT.OP_EMBEDDING,
    OT.OP_MULTIHEAD_ATTENTION, OT.OP_BATCHMATMUL, OT.OP_TOPK}


def _token_local(node: OpNode) -> bool:
    """Whether the op works on each position of its leading dims alone,
    reading only the last dim (features): a Linear, a per-index
    embedding lookup, a LayerNorm or softmax over the last dim, an
    elementwise op. Its output's rows over any of the leading dims are
    then the op on the same rows of its inputs."""
    from .fftype import AggrMode

    op, p = node.op_type, node.params
    nd = len(node.output_shapes[0]) if node.output_shapes else 0
    if op in _ELEMENTWISE or op == OT.OP_LINEAR:
        return True
    if op == OT.OP_EMBEDDING:
        return p.aggr == AggrMode.AGGR_MODE_NONE
    if op == OT.OP_LAYERNORM:
        return all(a % nd == nd - 1 for a in p.axes)
    if op == OT.OP_SOFTMAX:
        return p.dim % nd == nd - 1
    return False


def _batch_local(node: OpNode) -> bool:
    """Whether the op on a block of rows gives the same rows of its
    output: true of row-independent ops, and of the ops that work along
    a dim (a norm, a softmax, a reduction, a concat...) when that dim is
    not the first. Dropout (its mask drawn over the whole batch) and
    BatchNorm (statistics over the batch) are not; neither is a reshape
    (its params hold the whole batch)."""
    op, p = node.op_type, node.params
    if op in _ROW_INDEPENDENT:
        return True
    nd = len(node.input_shapes[0]) if node.input_shapes else 0
    if not nd:
        return False
    if op == OT.OP_LAYERNORM:
        return all(a % nd != 0 for a in p.axes)
    if op == OT.OP_SOFTMAX:
        return p.dim % nd != 0
    if op == OT.OP_TRANSPOSE:
        return p.perm[0] == 0
    if op in (OT.OP_CONCAT, OT.OP_SPLIT, OT.OP_REVERSE):
        return p.axis % nd != 0
    if op == OT.OP_GATHER:
        return p.dim % nd != 0
    if op in (OT.OP_REDUCE_SUM, OT.OP_REDUCE_MEAN, OT.OP_REDUCE_MAX,
              OT.OP_REDUCE_MIN, OT.OP_REDUCE_PROD, OT.OP_MEAN):
        return all(a % nd != 0 for a in p.axes)
    return False


class Executor:
    def __init__(self, graph: Graph, config: FFConfig, device: torch.device,
                 logits_node: OpNode, loss_type: LossType = None,
                 metrics=None, optimizer=None, mesh=None,
                 update_sharding=None):
        set_float_policy()
        self.graph = graph
        self.mesh = mesh
        # one rank of a mesh of more than one device: the sharded half
        self.spmd = mesh is not None and mesh.size > 1
        self.config = config
        self.device = device
        self.order = graph.topo_order()
        self._by_name = {n.name: n for n in self.order}
        self.logits_node = logits_node
        self.loss_type = loss_type
        self.metrics = metrics
        self.optimizer = optimizer
        # a graph that ends in softmax hands probabilities to the loss
        self.last_op_is_softmax = logits_node.op_type == OT.OP_SOFTMAX
        self._train_step = None
        # chunk length -> the step running that many train steps at once
        # (build_chunked_train_step)
        self._chunk_steps: dict[int, Any] = {}
        self._eval_step = None
        self._forward_fn = None
        self.compute_dtype, self.matmul_dtype = dtype_policy(config, device)
        # --sanitize-numerics (sanitize.py): a probe on every op output,
        # folding its finiteness into this executor's device table;
        # set_numeric_fault's (op, phase, step) fault, else None
        self.sanitize_numerics = bool(config.sanitize_numerics)
        self._numeric_fault: Optional[tuple] = None
        self._probes = None
        if self.sanitize_numerics:
            self._probes = self._probe_table()
        # op and runtime ranges (torch.profiler.record_function) are
        # opened only while a profile is taken (`scoped`)
        self._scoped = False
        # the serving weight cache: (node, weight) -> (master, its
        # _version when seen, its compute-dtype copy or, without a compute
        # dtype, the master); `weight_refreshes` counts the entries made
        # (each a cast where there is a compute dtype)
        self._weight_cache: dict[tuple[str, str], tuple] = {}
        self.weight_refreshes = 0
        # constant inputs, made at first use (`_constant`)
        self._constants: dict[str, torch.Tensor] = {}
        # weight-update sharding (ZeRO stages 2/3; the decision record of
        # search/unity.choose_update_sharding): update_specs[(node,
        # weight)] = (at-rest PartitionSpec, shape) of each sharded
        # master, slot and gradient; gather_specs[(node, weight)] = (the
        # compute spec, the update spec, the update axes, the dim) of
        # each weight stage 3 gathers at every use; gather_schedule the
        # owners in topological order, each after the one before
        self.update_sharding = dict(update_sharding or {"enabled": False})
        self.update_stage = int(self.update_sharding.get(
            "stage", 2 if self.update_sharding.get("enabled") else 0))
        self.update_specs: dict[tuple[str, str], tuple] = {}
        self.gather_specs: dict[tuple[str, str], tuple] = {}
        self.gather_schedule: list[tuple[str, Optional[str]]] = []
        if self.spmd:
            self._plan()
            if self.update_sharding.get("enabled"):
                self._build_update_specs()

    # ------------------------------------------------------------ placements

    def _norm(self, assignment) -> tuple:
        from .parallel.spmd import normalize

        return normalize(assignment, self.mesh)

    def _wlayout(self, node: OpNode, ws) -> tuple:
        """A weight's compute placement, size-1 axes dropped."""
        from .tensor import spec_assignment

        return self._norm(spec_assignment(node.weight_axes.get(ws.name),
                                          len(ws.shape)))

    def _plan(self):
        """The placement of every node output and weight, the rule each
        node runs by (`_node_rule`), and each trainable weight's gradient
        sync (the axes its gradient is summed over, its update dim). Makes
        every process group the steps use, in graph order, so that each
        rank makes them in the same sequence."""
        from .parallel.ops import choose_update_dim, grad_sync_axes
        from .parallel.spmd import layout_axes
        from .tensor import spec_assignment

        mesh = self.mesh
        axis_sizes = {k: int(v) for k, v in mesh.shape.items()}
        self._layout: dict[tuple[int, int], tuple] = {}
        self._rules: dict[int, dict] = {}
        # (owner, weight) -> (sync axes, update dim for the reduce-scatter)
        self._sync: dict[tuple[str, str], tuple] = {}
        for node in self.order:
            for i, pt in enumerate(node.outputs):
                self._layout[(node.guid, i)] = self._norm(pt.axis_assignment)
        # the axes each owner's weight gradients are partial sums over:
        # its output's, and the rows its rules run on (ring attention
        # runs on this rank's sequence rows whatever the plan gives its
        # output)
        partial_of: dict[str, set] = {}
        for node in self.order:
            if node.op_type == OT.OP_INPUT:
                continue
            rule = self._rules[node.guid] = self._node_rule(node)
            owner = getattr(node, "weight_source", None) or node.name
            partial_of.setdefault(owner, set()).update(rule["partial"])
        for node in self.order:
            if getattr(node, "weight_source", None):
                continue
            out_axes = (layout_axes(self._layout[(node.guid, 0)])
                        if node.outputs else set())
            out_axes = out_axes | partial_of.get(node.name, set())
            for ws in node.weight_specs:
                if not ws.trainable:
                    continue
                base = self._wlayout(node, ws)
                axes = tuple(ax for ax in grad_sync_axes(
                    out_axes, layout_axes(base)) if axis_sizes[ax] > 1)
                dim = choose_update_dim(ws.shape, spec_assignment(
                    node.weight_axes.get(ws.name), len(ws.shape)), axes,
                    axis_sizes)
                self._sync[(node.name, ws.name)] = (axes, dim)
                mesh.group(axes)
        for node in self.order:
            if node.op_type == OT.OP_INPUT:
                continue
            rule = self._rules[node.guid]
            owner = getattr(node, "weight_source", None) or node.name
            owner_node = self._by_name[owner]
            rule["mask"] = {}
            for ws in owner_node.weight_specs:
                if not ws.trainable:
                    continue
                sync_axes = set(self._sync[(owner, ws.name)][0])
                partial = rule["partial"] - layout_axes(
                    self._wlayout(owner_node, ws))
                if partial - sync_axes:
                    raise NotImplementedError(
                        f"{node.name}.{ws.name}: its gradient is a partial "
                        f"sum over {sorted(partial - sync_axes)}, axes its "
                        f"update does not reduce (placements "
                        f"{[self._layout[(node.guid, i)] for i in range(len(node.outputs))]})")
                rule["mask"][ws.name] = tuple(sorted(sync_axes - partial))
            for g in rule["groups"]:
                mesh.group(g)
        logits = self._layout[(self.logits_node.guid, 0)]
        # the loss runs on the logits' rows (every dim but the classes:
        # the batch, and the sequence where a plan splits it); labels
        # are staged so, and the loss and metrics are summed over them
        self._loss_layout = tuple(logits[:-1]) + ((),)
        self._loss_axes = tuple(ax for entry in logits[:-1] for ax in entry)
        self._batch_group = mesh.group(self._loss_axes)

    def _in_layouts(self, node: OpNode) -> list:
        out = [None] * len(self.graph.in_edges[node.guid])
        for e in self.graph.in_edges[node.guid]:
            out[e.dst_idx] = self._layout[(e.src, e.src_idx)]
        return out

    def _node_rule(self, node: OpNode) -> dict:
        """How a node runs on this rank: the placement each input is moved
        to (`run`), the placement of its raw outputs (`nat`, moved on to
        the plan's), the weights it gathers whole, the groups of its
        column-parallel inputs' backward all-reduce (`enter`) and of its
        row-parallel output's forward all-reduce (`reduce`), the params it
        calls the op with, and the axes its weight gradients are partial
        sums over (`partial`)."""
        from .parallel.spmd import layout_axes

        ins = self._in_layouts(node)
        outs = [self._layout[(node.guid, i)] for i in range(len(node.outputs))]
        wnode = self._by_name[getattr(node, "weight_source", None)
                              or node.name]
        wl = {ws.name: self._wlayout(wnode, ws) for ws in wnode.weight_specs}
        rule = None
        if node.is_parallel_op:
            rule = dict(kind="parallel", run=[outs[0]], nat=[outs[0]])
        elif node.op_type == OT.OP_LINEAR:
            rule = self._linear_rule(node, ins, wl)
        elif node.op_type == OT.OP_MULTIHEAD_ATTENTION:
            rule = self._mha_rule(node, ins, wl)
        elif node.op_type == OT.OP_EMBEDDING:
            rule = self._embedding_rule(node, ins, wl)
        elif node.op_type == OT.OP_PIPE_BLOCKS:
            rule = self._pipe_rule(node, ins, wl)
        elif node.op_type in (OT.OP_INC_MULTIHEAD_ATTENTION,
                              OT.OP_PAGED_INC_MULTIHEAD_ATTENTION):
            rule = self._kv_rule(node, ins, wl)
        if rule is None:
            rule = self._generic_rule(node, ins, outs, wl)
        rule.setdefault("gather_w", ())
        rule.setdefault("enter", None)
        rule.setdefault("reduce", None)
        rule.setdefault("params", node.params)
        rule.setdefault("partial", set())
        rule["bias"] = ({"row": "bias", "mha": "bo"}.get(rule["kind"])
                        or ("bo" if rule["kind"] == "kv" and rule["reduce"]
                            else None))
        rule["groups"] = [g for g in (rule["enter"], rule["reduce"]) if g]
        return rule

    def _linear_rule(self, node, ins, wl):
        from .parallel.spmd import layout_axes

        k, b = wl["kernel"], wl.get("bias")
        lead = ins[0][:-1]
        lead_axes = layout_axes(lead)
        p = node.params
        if not k[0] and k[1] and (b is None or b == (k[1],)) \
                and not set(k[1]) & lead_axes:
            # column parallel: this rank's output columns
            return dict(kind="col", run=[lead + ((),)],
                        nat=[lead + (k[1],)], enter=k[1],
                        partial=set(lead_axes))
        if k[0] and not k[1] and (b is None or not b[0]) \
                and not set(k[0]) & lead_axes:
            # row parallel: this rank's input features, the partial
            # product all-reduced, then the bias and the activation
            return dict(kind="row", run=[lead + (k[0],)],
                        nat=[lead + ((),)], reduce=k[0],
                        params=dataclasses.replace(
                            p, use_bias=False,
                            activation=ActiMode.AC_MODE_NONE),
                        partial=set(lead_axes))
        return None

    def _mha_rule(self, node, ins, wl):
        """Attention's rows: the batch as its inputs have it; the
        sequence whole, or, for ring attention on a mesh with a `seq`
        axis, this rank's block of it over `seq` (the ring's group),
        whatever the plan gives the inputs; the features whole. Head
        parallel where the plan shards the projections by heads (the
        Megatron pattern), else the weights gathered whole."""
        from .machine import AXIS_SEQ
        from .parallel.spmd import layout_axes

        p = node.params
        ring = p.impl == "ring" and self.mesh.shape.get(AXIS_SEQ, 1) > 1
        seq = (AXIS_SEQ,) if ring else ()
        run = [(l[0], seq) + ((),) * (len(l) - 2) for l in ins]
        nat = [run[0]]
        lead_axes = set().union(*(layout_axes(l[:-1]) for l in run))
        a = wl["wq"][1]
        n = self.mesh.axes_size(a)
        want = {"wq": ((), a), "wk": ((), a), "wv": ((), a), "wo": (a, ())}
        if p.use_bias:
            want.update(bq=(a,), bk=(a,), bv=(a,), bo=((),))
        if (not a or any(wl[w] != v for w, v in want.items())
                or p.num_heads % n or set(a) & lead_axes):
            if not ring:
                return None
            # ring attention with the weights whole on every rank
            return dict(kind="ring", run=run, nat=nat,
                        gather_w=tuple(w for w, l in wl.items() if any(l)),
                        partial=lead_axes)
        # head parallel: this rank's heads, the output projection's
        # partial sum all-reduced, then its bias
        return dict(kind="mha", run=run, nat=nat, enter=a, reduce=a,
                    params=dataclasses.replace(
                        p, num_heads=p.num_heads // n,
                        embed_dim=p.embed_dim // n),
                    partial=lead_axes)

    def _kv_rule(self, node, ins, wl):
        """Incremental attention (the decode graph's KV ops) on a mesh,
        the placement the JAX package gives it (`ops/inc_attention.py:
        1-13`): this rank's slots, as its token input has them; its heads
        where the plan shards the projections by heads (wq/wk/wv column,
        wo row parallel: the partial output all-reduced, then `bo`), else
        the projections gathered whole. The KV state rests as the plan
        places it: its feature dim over the heads' axes, the paged pool's
        block dims whole (replicated over the slots' axes: the new rows
        are gathered over them before the write), the contiguous cache's
        slot dim over the slots' axes or whole (then written like the
        pool, and read at this rank's slot rows)."""
        p = node.params
        paged = node.op_type == OT.OP_PAGED_INC_MULTIHEAD_ATTENTION
        slots = ins[0][0]
        a = wl["wq"][1]
        n = self.mesh.axes_size(a)
        want = {"wq": ((), a), "wk": ((), a), "wv": ((), a), "wo": (a, ())}
        if p.use_bias:
            want.update(bq=(a,), bk=(a,), bv=(a,), bo=((),))
        heads = (bool(a) and all(wl[w] == v for w, v in want.items())
                 and p.num_heads % n == 0 and not set(a) & set(slots))
        if not heads:
            a = ()
        ck = "pool_k" if paged else "cache_k"
        st = wl[ck]
        if wl["pool_v" if paged else "cache_v"] != st:
            raise NotImplementedError(
                f"{node.name}: the K and V state must rest alike "
                f"({wl})")
        if st[-1] != a or (paged and any(st[:-1])) or (
                not paged and (st[1] or st[0] not in ((), slots))):
            raise NotImplementedError(
                f"{node.name}: the KV state must rest with its feature dim "
                f"over the heads' axes {a or '()'} and its slot dim over the "
                f"slots' axes {slots or '()'} or whole (the paged pool's "
                f"block dims whole); the plan gives {st}")
        split = not paged and st[0] == slots
        group = None if split else self.mesh.group(slots)
        kv = {"gather": group, "take": group if not paged else None}
        run = [(slots,) + ((),) * (len(l) - 1) for l in ins]
        rule = dict(kind="kv", run=run, nat=[run[0]],
                    gather_w=tuple(w for w, l in wl.items()
                                   if any(l) and w not in (
                                       "cache_k", "cache_v", "pool_k",
                                       "pool_v")),
                    partial=set(slots), kv=kv)
        if heads:
            rule.update(gather_w=(), enter=a, reduce=a,
                        params=dataclasses.replace(
                            p, num_heads=p.num_heads // n,
                            embed_dim=p.embed_dim // n))
        return rule

    def _pipe_rule(self, node, ins, wl):
        """The pipelined block stack: its weights sharded over `pipe` on
        the layer dim (each stage its L/P blocks), its input and output
        whole over `pipe` and split over the batch as its input is; the
        schedule moves the activations between stages itself. A weight
        whole over a pipe axis would need its gradient summed over the
        stages, which the schedule does not do: such a plan raises."""
        from .machine import AXIS_PIPE

        batch = tuple(ax for ax in ins[0][0] if ax != AXIS_PIPE)
        lay = (batch,) + ((),) * (len(ins[0]) - 1)
        pipe = self.mesh.shape.get(AXIS_PIPE, 1) > 1
        if pipe and not all(l[0] == (AXIS_PIPE,) and not any(l[1:])
                            for l in wl.values()):
            raise NotImplementedError(
                f"{node.name}: on a mesh with a pipe axis the stacked "
                f"block weights run sharded over 'pipe' on their layer "
                f"dim only (the plan gives {wl})")
        return dict(kind="pipe", run=[lay], nat=[lay],
                    partial=set(batch))

    def _embedding_rule(self, node, ins, wl):
        from .fftype import AggrMode
        from .parallel.spmd import layout_axes

        k = wl["kernel"]
        if k[0] or not k[1] or set(k[1]) & layout_axes(ins[0]):
            return None
        lead = (ins[0] if node.params.aggr == AggrMode.AGGR_MODE_NONE
                else ins[0][:-1])
        # column parallel: this rank's columns of the table
        return dict(kind="emb", run=[ins[0]], nat=[lead + (k[1],)],
                    partial=layout_axes(ins[0]))

    def _generic_rule(self, node, ins, outs, wl):
        """Elementwise ops on the output's own placement (first: a
        sequence-split operand must not be gathered by the batch rule);
        an op that works on each token alone (`_token_local`) on the rows
        of the output's leading dims, where the plan splits one past the
        batch; batch-local where the op's rows are independent and the
        plan shards the output's batch dim; any other op whole on every
        rank (its weight gradient then full on each: masked)."""
        from .parallel.spmd import layout_axes

        gather_w = tuple(w for w, l in wl.items() if any(l))
        out0 = outs[0] if outs else ()
        batch = out0[0] if out0 else ()
        rows = node.output_shapes[0][0] if node.output_shapes and \
            node.output_shapes[0] else None

        def rep(layout):
            return ((),) * len(layout)

        def batch_only(layout):
            return (batch,) + ((),) * (len(layout) - 1)

        if (node.op_type in _ELEMENTWISE and len(outs) == 1
                and all(tuple(s) == tuple(node.output_shapes[0])
                        for s in node.input_shapes)):
            return dict(kind="elementwise", run=[out0] * len(ins),
                        nat=[out0], gather_w=gather_w,
                        partial=layout_axes(out0))
        lead = out0[:-1]
        if (len(outs) == 1 and any(lead[1:]) and not out0[-1]
                and _token_local(node)):
            # every token on its own (the sequence-parallel trunk): the
            # rows of the output's leading dims, the features whole
            nl = len(lead)
            run = [lead + ((),) * (len(l) - nl)
                   if tuple(node.input_shapes[i][:nl])
                   == tuple(node.output_shapes[0][:nl]) else rep(l)
                   for i, l in enumerate(ins)]
            return dict(kind="rows", run=run, nat=[out0],
                        gather_w=gather_w, partial=layout_axes(lead))
        if batch and _batch_local(node) and all(
                len(o) and o[0] == batch for o in outs):
            run = [batch_only(l) if len(l) and node.input_shapes[i][0] == rows
                   else rep(l) for i, l in enumerate(ins)]
            return dict(kind="batch", run=run,
                        nat=[batch_only(o) for o in outs],
                        gather_w=gather_w, partial=set(batch))
        return dict(kind="whole", run=[rep(l) for l in ins],
                    nat=[rep(o) for o in outs], gather_w=gather_w)

    # ------------------------------------------------- weight-update sharding

    def _build_update_specs(self):
        """Per-weight update shardings through the helpers of
        `parallel/ops` (JAX 171-297): every trainable, untied weight whose
        gradient is reduced over some axes and has a dim those axes divide
        lives sharded along it at rest. Emits the weight_update telemetry
        event and a grad_sync counter per bucket (a weight-owning node)."""
        from . import telemetry
        from .parallel.ops import weight_update_spec
        from .tensor import PartitionSpec

        axis_sizes = {k: int(v) for k, v in self.mesh.shape.items()}
        total_bytes = buckets = 0
        used_axes: set = set()
        max_shards = 1
        for node in self.order:
            if getattr(node, "weight_source", None):
                continue
            bucket_bytes = 0
            for ws in node.weight_specs:
                sync = self._sync.get((node.name, ws.name))
                if sync is None or not sync[0] or sync[1] is None:
                    continue
                axes, dim = sync
                base = node.weight_axes.get(ws.name, PartitionSpec())
                spec = weight_update_spec(ws.shape, base, axes, axis_sizes)
                self.update_specs[(node.name, ws.name)] = (
                    spec, tuple(ws.shape))
                if self.update_stage >= 3:
                    self.gather_specs[(node.name, ws.name)] = (
                        base, spec, tuple(axes), dim)
                used_axes.update(axes)
                max_shards = max(max_shards, self.mesh.axes_size(axes))
                nbytes = math.prod(ws.shape) * 4
                bucket_bytes += nbytes
                total_bytes += nbytes
            if bucket_bytes:
                buckets += 1
                telemetry.counter("grad_sync", {
                    "bucket": buckets, "bytes": bucket_bytes})
        self.update_sharding.update(buckets=buckets,
                                    sharded_weights=len(self.update_specs),
                                    bytes=total_bytes)
        if self.gather_specs:
            owners = []
            for node in self.order:
                if any((node.name, ws.name) in self.gather_specs
                       for ws in node.weight_specs):
                    owners.append(node.name)
            self.gather_schedule = [
                (name, owners[i - 1] if i > 0 else None)
                for i, name in enumerate(owners)]
            telemetry.event(
                "param_gather", layers=len(owners),
                sharded_weights=len(self.gather_specs),
                bytes=sum(math.prod(shape) * 4
                          for key, (_, shape) in self.update_specs.items()
                          if key in self.gather_specs))
        if self.update_specs:
            self.update_sharding["axes"] = sorted(used_axes)
            self.update_sharding["shards"] = max_shards
            telemetry.event(
                "weight_update", stage=self.update_stage,
                shards=max_shards, buckets=buckets,
                sharded_weights=len(self.update_specs), bytes=total_bytes)
        else:
            # nothing divisible: nothing runs sharded, and the record says
            self.update_sharding.update(
                enabled=False, stage=0, shards=1, axes=[],
                reason=self.update_sharding.get("reason", "")
                + "+no_shardable_weight")
            self.update_stage = 0

    def _rest_layout(self, owner: str, wname: str) -> tuple:
        """A weight's placement at rest: its update spec where it has one,
        else its compute placement."""
        from .tensor import spec_assignment

        ws = self._weight_spec(owner, wname)
        upd = self.update_specs.get((owner, wname))
        spec = (upd[0] if upd is not None
                else self._by_name[owner].weight_axes.get(wname))
        return self._norm(spec_assignment(spec, len(ws.shape)))

    def _weight_spec(self, owner: str, wname: str):
        return next(ws for ws in self._by_name[owner].weight_specs
                    if ws.name == wname)

    def weight_shape(self, owner: str, wname: str) -> tuple:
        return tuple(self._weight_spec(owner, wname).shape)

    def local_weight(self, owner: str, wname: str, full: torch.Tensor):
        """This rank's at-rest block of a whole weight."""
        if not self.spmd:
            return full
        from .parallel.spmd import take_local

        return take_local(full, self._rest_layout(owner, wname), self.mesh)

    @torch.no_grad()
    def full_weight(self, owner: str, wname: str, local: torch.Tensor):
        """The whole weight from this rank's at-rest block (collective). A
        0-d tensor of a weight that is not 0-d (SGD's scalar slot at
        momentum 0) is whole on every rank already."""
        if not self.spmd or (local.dim() == 0
                             and len(self.weight_shape(owner, wname))):
            return local
        from .parallel.spmd import redistribute

        rest = self._rest_layout(owner, wname)
        return redistribute(local, rest, ((),) * len(rest), self.mesh)

    @torch.no_grad()
    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole logits from this rank's block (collective)."""
        if not self.spmd:
            return logits
        from .parallel.spmd import redistribute

        lay = self._layout[(self.logits_node.guid, 0)]
        return redistribute(logits, lay, ((),) * len(lay), self.mesh)

    def build_param_gather(self):
        """Every weight sharded at rest gathered back to its compute
        placement, in one call (JAX 920): a reader's view of the
        stage-2/3 masters; other weights pass through."""
        from .parallel.spmd import gather_param

        @torch.no_grad()
        def gather_params(params):
            out = {}
            for name, ws in params.items():
                nw = dict(ws)
                for k in ws:
                    upd = self.update_specs.get((name, k))
                    if upd is not None:
                        axes, dim = self._sync[(name, k)]
                        nw[k] = gather_param(ws[k], self.mesh.group(axes),
                                             dim, self.update_stage >= 3)
                out[name] = nw
            return out

        return gather_params

    def _host_blocks(self, arrays: dict, specs: dict) -> dict:
        """Host arrays -> CPU tensors of this rank's block of each, by its
        PartitionSpec in `specs` (absent: whole)."""
        from .parallel.spmd import take_local
        from .tensor import spec_assignment

        out = {}
        for name, arr in arrays.items():
            t = torch.as_tensor(arr)
            if self.spmd:
                t = take_local(t, self._norm(spec_assignment(
                    specs.get(name), t.dim())), self.mesh)
            out[name] = t
        return out

    def shard_batch(self, arrays: dict, specs: dict) -> dict:
        """Host arrays -> this rank's blocks on the device, each by its
        PartitionSpec in `specs` (absent: whole), the twin of JAX's
        `shard_batch` (977)."""
        return {k: v.to(self.device)
                for k, v in self._host_blocks(arrays, specs).items()}

    def _compute_weight(self, owner: str, wname: str, t: torch.Tensor,
                        cache: dict):
        """A weight in its compute placement from its at-rest block: a
        stage-2 weight gathered at its first use in the step (`cache`),
        a stage-3 weight by the ring at every use."""
        from .parallel.spmd import ParamGather

        key = (owner, wname)
        if key not in self.update_specs:
            return t
        if self.update_stage < 3 and key in cache:
            return cache[key]
        axes, dim = self._sync[key]
        with self._scope("param_gather"):
            w = ParamGather.apply(t, self.mesh.group(axes), dim,
                                  self.update_stage >= 3)
        if self.update_stage < 3:
            cache[key] = w
        return w

    def sync_grads(self, grads: dict) -> dict:
        """The local weight gradients summed over their sync axes (JAX:
        GSPMD's psum): a reduce-scatter then an all-gather along the
        update dim, or one all-reduce where no dim divides. A weight
        sharded at rest already got its reduce-scatter in its gather's
        backward."""
        if not self.spmd:
            return grads
        from .parallel.spmd import sync_grad

        out = {}
        with self._scope("grad_sync"):
            for n, ws in grads.items():
                mine = out[n] = {}
                for k, g in ws.items():
                    axes, dim = self._sync.get((n, k), ((), None))
                    if (n, k) in self.update_specs or not axes:
                        mine[k] = g
                    else:
                        mine[k] = sync_grad(g, self.mesh.group(axes), dim)
        return out

    def _apply_spmd(self, params, state, inputs, *, training, rng,
                    seq_length, step=None):
        """`_apply` on this rank's blocks: each node's inputs moved to the
        placement its rule runs on, its weights to their compute
        placement, its raw outputs on to the plan's."""
        vals: dict[tuple[int, int], Any] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        ctx = OpContext(training=training, rng=rng, seq_length=seq_length,
                        matmul_dtype=self.matmul_dtype,
                        flash_packed=self.config.flash_packed_layout,
                        mesh=self.mesh)
        gathered: dict = {}
        for node in self.order:
            if node.op_type == OT.OP_INPUT:
                vals[(node.guid, 0)] = (
                    self._local_constant(node) if node.constant is not None
                    else inputs[node.name])
                continue
            with self._scope(node.name):
                outs = self._node_spmd(node, params, new_state, vals,
                                       gathered, ctx)
            for i, out in enumerate(self._outputs(node, outs, step)):
                vals[(node.guid, i)] = out
        return vals[(self.logits_node.guid, 0)], new_state

    def _node_spmd(self, node, params, new_state, vals, gathered, ctx):
        """One node of `_apply_spmd`: its outputs in the plan's
        placements (its op state written into `new_state`)."""
        from .parallel.spmd import (
            mask_grad,
            redistribute,
            reduce_backward,
            reduce_forward,
        )

        mesh = self.mesh
        rule = self._rules[node.guid]
        src = [None] * len(self.graph.in_edges[node.guid])
        lays = self._in_layouts(node)
        for e in self.graph.in_edges[node.guid]:
            src[e.dst_idx] = vals[(e.src, e.src_idx)]
        ins, entered = [], {}
        for x, lay, run in zip(src, lays, rule["run"]):
            key = (id(x), run)
            if key not in entered:
                y = redistribute(x, lay, run, mesh)
                if rule["enter"]:
                    y = reduce_backward(y, mesh.group(rule["enter"]))
                entered[key] = y
            ins.append(entered[key])
        if rule.get("kv") is not None:
            ctx = dataclasses.replace(ctx, kv=rule["kv"])
        wsrc = getattr(node, "weight_source", None) or node.name
        weights, regather = {}, []
        for k, t in params.get(wsrc, {}).items():
            w = self._compute_weight(wsrc, k, t, gathered)
            if k in rule["gather_w"]:
                base = self._wlayout(self._by_name[wsrc],
                                     self._weight_spec(wsrc, k))
                w = redistribute(w, base, ((),) * len(base), mesh)
            w = mask_grad(w, rule["mask"].get(k, ()), mesh)
            weights[k] = w
            if self.update_stage >= 3 and (wsrc, k) in self.update_specs:
                regather.append(k)
        # a row-parallel product's bias is added after its all-reduce
        tail = self._cast_compute(
            {"bias": weights.pop(rule["bias"])}
            if rule["bias"] in weights else {})
        weights = dict(self._cast_compute(weights))
        weights.update(new_state.get(wsrc, {}))
        with self._dropping(wsrc, [k for k in regather if k in weights],
                            weights, params.get(wsrc, {})):
            # inside the caller's range (`_apply_spmd` opens
            # `self._scope(node.name)` around this call)
            outs, op_state = node.op_def.forward(  # fflint: ok unnamed_op_scope
                rule["params"], ins, weights, new_state.get(node.name),
                ctx)
        if op_state:
            new_state.setdefault(node.name, {}).update(op_state)
        outs = list(outs)
        if rule["reduce"]:
            y = reduce_forward(outs[0], mesh.group(rule["reduce"]))
            b = tail.get("bias")
            if b is not None:
                y = y + b.to(y.dtype)
            if rule["kind"] == "row":
                from .ops.core import apply_activation

                y = apply_activation(y, node.params.activation)
            outs[0] = y
        return [redistribute(out, rule["nat"][i],
                             self._layout[(node.guid, i)], mesh)
                for i, out in enumerate(outs)]

    @contextlib.contextmanager
    def _dropping(self, owner: str, keys: list, weights: dict, shards: dict):
        """Stage 3: while the op runs, what its backward saves of a
        gathered weight (or of its compute-dtype copy) is swapped for the
        means to gather it again, so the copy is freed after the op and
        the backward gathers anew (JAX: the remat region whose policy
        refuses to save the gathered copies)."""
        if not keys:
            yield
            return
        from .parallel.spmd import gather_param

        def again(k, dtype):
            def make():
                axes, dim = self._sync[(owner, k)]
                with torch.no_grad():
                    w = gather_param(shards[k], self.mesh.group(axes), dim,
                                     True)
                return w.to(dtype)
            return make

        by_storage = {weights[k].untyped_storage().data_ptr():
                      again(k, weights[k].dtype) for k in keys}

        def pack(t):
            make = by_storage.get(t.untyped_storage().data_ptr())
            if make is None:
                return t
            return (make, t.size(), t.stride(), t.storage_offset())

        def unpack(p):
            if torch.is_tensor(p):
                return p
            make, size, stride, offset = p
            return torch.as_strided(make(), size, stride, offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield

    def _local_constant(self, node: OpNode) -> torch.Tensor:
        from .parallel.spmd import local_shape

        t = self._constant(node)
        lay = self._layout[(node.guid, 0)]
        shape = local_shape(t.shape, lay, self.mesh)
        return t if tuple(shape) == tuple(t.shape) else t[
            tuple(slice(0, s) for s in shape)]


    # --------------------------------------------- sanitizer and profiling

    def _probe_table(self):
        """The sanitizer's device table: a probe per op output (JAX's
        label, `name` or `name#out<i>`, and topo index) and the loss's,
        one past the last op."""
        from .sanitize import ProbeTable, get_monitor

        labels, topos = [], []
        for topo, node in enumerate(self.order):
            if node.op_type == OT.OP_INPUT:
                continue
            for i in range(len(node.outputs)):
                labels.append(node.name if i == 0
                              else f"{node.name}#out{i}")
                topos.append(topo)
        labels.append("loss")
        topos.append(len(self.order))
        table = ProbeTable(labels, topos, self.device)
        get_monitor().attach(table)
        return table

    def drop_steps(self):
        """Drop every built step (train, eval, forward, chunked), each
        with its CUDA graphs and their memory pools: the next call builds
        and captures it anew."""
        self._train_step = None
        self._eval_step = None
        self._forward_fn = None
        self._chunk_steps.clear()

    def set_numeric_fault(self, op: Optional[str], phase: str = "fwd",
                          step: int = 0):
        """Install (or clear, op=None) a numeric fault: the named op's
        output (or its cotangent, phase="bwd"; op "loss" targets the
        scalar loss) goes NaN from global step `step` on (JAX
        `executor.py:454`). Test/debug hook for the sanitizer's
        localization matrix — the built steps are dropped so the next
        call captures with the fault in it."""
        if op is not None:
            if phase not in ("fwd", "bwd"):
                raise ValueError(f"phase must be fwd|bwd, got {phase!r}")
            if op != "loss" and all(n.name != op for n in self.order):
                raise ValueError(f"no op named {op!r} in the graph")
        self._numeric_fault = (
            None if op is None else (op, phase, int(step)))
        self.drop_steps()

    def _maybe_poison(self, x, name: str, step, phase: str):
        """Apply the installed numeric fault to tensor `name`, for the
        given phase only: a fwd fault before the probe (the probe sees
        the poisoned value), a bwd fault after it (the probe's backward
        sees the poisoned cotangent)."""
        fault = self._numeric_fault
        if fault is None or fault[0] != name or fault[1] != phase:
            return x
        from . import sanitize

        at = fault[2]
        if phase == "fwd":
            return sanitize.inject_nonfinite(x, step, at)
        return sanitize.inject_grad_nonfinite(x, step, at)

    def _instrument(self, out, name: str, label: str, step, first: bool):
        """An op output (or the loss) through the fault and the probe."""
        if first and self._numeric_fault is not None:
            out = self._maybe_poison(out, name, step, "fwd")
        if self._probes is not None:
            from . import sanitize

            out = sanitize.probe(out, self._probes, label)
        if first and self._numeric_fault is not None:
            out = self._maybe_poison(out, name, step, "bwd")
        return out

    def flush_probes(self, step=None):
        """The sanitizer's probes of the pass that just ran folded into
        its table with `step` (None: a step-less pass). Nothing when the
        sanitizer is off."""
        if self._probes is not None:
            self._probes.flush(step)

    @contextlib.contextmanager
    def scoped(self):
        """Run the steps eagerly with a `record_function` range around
        each op's forward and each runtime scope (the twin of the JAX
        executor's `jax.named_scope`s): a profiled step's kernels are then
        attributable (scope/attribution.py). A CUDA-graph replay would
        show its kernels with no range, so the step runs op by op: the
        same function, the same kernels. Off, no range is opened."""
        prev = self._scoped
        self._scoped = True
        try:
            with eager():
                yield
        finally:
            self._scoped = prev

    def _scope(self, name: str):
        if not self._scoped:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    # ------------------------------------------------------------ variables

    def init_variables(self, seed: int):
        """Params (trainable) and state (non-trainable weights: the KV
        caches, BatchNorm's running statistics), each drawn from its own
        generator, on the model's device. A node with tied weights
        (`weight_source`) gets none: it reads its source's. On a mesh
        every rank draws the whole tensor from the seed and keeps its
        block at rest (`local_weight`), so every mesh starts from the same
        masters."""
        params, state = {}, {}
        for node in self.order:
            if getattr(node, "weight_source", None):
                continue
            p, s = {}, {}
            for ws in node.weight_specs:
                init = node.initializers.get(
                    ws.name, initializer_by_name(ws.initializer))
                gen = torch.Generator().manual_seed(
                    _stable_seed(seed, f"{node.name}/{ws.name}"))
                arr = init(gen, ws.shape, dtype_to_torch(ws.dtype), self.device)
                arr = self.local_weight(node.name, ws.name, arr)
                (p if ws.trainable else s)[ws.name] = arr
            if p:
                params[node.name] = p
            if s:
                state[node.name] = s
        return params, state

    # ------------------------------------------------------------ apply

    def _cast_compute(self, tree: dict) -> dict:
        """Cast float tensors of a (nested) dict to the compute dtype."""
        cd = self.compute_dtype
        if cd is None:
            return tree
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self._cast_compute(v)
            elif torch.is_tensor(v) and v.is_floating_point():
                out[k] = v.to(cd)
            else:
                out[k] = v
        return out

    def compute_params(self, params: dict) -> dict:
        """`params` in the compute dtype, from the serving weight cache:
        each copy is cast once, and cast again, in place into the same
        storage, only when its master changed: another tensor (after
        `set_weight` or a new `adopt_params`) or a newer `_version` (a
        write in place). The bits are those of the per-step cast. Without
        a compute dtype the masters themselves, their changes seen alike.
        Each change seen counts one `weight_refreshes`."""
        cd = self.compute_dtype
        out: dict = {}
        for n, ws in params.items():
            mine = out[n] = {}
            for k, w in ws.items():
                if not (torch.is_tensor(w) and w.is_floating_point()):
                    mine[k] = w
                    continue
                hit = self._weight_cache.get((n, k))
                if hit is None or hit[0] is not w or hit[1] != w._version:
                    copy = w
                    if cd is not None:
                        copy = hit[2] if hit is not None else None
                        if copy is not None and copy.shape == w.shape:
                            with torch.no_grad():
                                copy.copy_(w)
                        else:
                            copy = w.detach().to(cd)
                    hit = self._weight_cache[(n, k)] = (w, w._version, copy)
                    self.weight_refreshes += 1
                mine[k] = hit[2]
        return out

    def _restore_state_dtypes(self, new_state: dict) -> dict:
        """Non-trainable state is kept fp32 across steps."""
        if self.compute_dtype is None:
            return new_state
        return {
            name: {k: (v.float() if v.is_floating_point() else v)
                   for k, v in ws.items()}
            for name, ws in new_state.items()
        }

    def _constant(self, node: OpNode) -> torch.Tensor:
        """The tensor of a constant input (`FFModel.create_constant`),
        made once on the model's device, float constants in the compute
        dtype (where the JAX package's user passes them as inputs, which
        its step casts)."""
        t = self._constants.get(node.name)
        if t is None:
            shape, dtype, value = node.constant
            dt = dtype_to_torch(dtype)
            if self.compute_dtype is not None and dt.is_floating_point:
                dt = self.compute_dtype
            t = self._constants[node.name] = torch.full(
                shape, value, dtype=dt, device=self.device)
        return t

    def _outputs(self, node: OpNode, outs, step):
        """A node's outputs through the fault and the sanitizer's probes
        (each output before its consumers read it), where either is on."""
        if self._probes is None and self._numeric_fault is None:
            return outs
        return [self._instrument(out, node.name, node.name if i == 0
                                 else f"{node.name}#out{i}", step, i == 0)
                for i, out in enumerate(outs)]

    def _apply(self, params, state, inputs, *, training: bool = False,
               rng=None, seq_length: int = -1, step=None):
        """Run the graph forward. Returns (logits, new_state). Autograd
        records it unless the caller runs it under `no_grad`. `rng` is the
        torch.Generator dropout draws from (training only); `seq_length`
        reaches the ops' context (batch_matmul's truncation); `step` (the
        step tensor, None on step-less passes) feeds the sanitizer's
        probes and the fault injector. On a mesh, `_apply_spmd`: the
        logits are this rank's block."""
        if self.spmd:
            return self._apply_spmd(params, state, inputs, training=training,
                                    rng=rng, seq_length=seq_length,
                                    step=step)
        vals: dict[tuple[int, int], Any] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        ctx = OpContext(training=training, rng=rng, seq_length=seq_length,
                        matmul_dtype=self.matmul_dtype,
                        flash_packed=self.config.flash_packed_layout,
                        mesh=self.mesh)
        for node in self.order:
            if node.op_type == OT.OP_INPUT:
                vals[(node.guid, 0)] = (
                    self._constant(node) if node.constant is not None
                    else inputs[node.name])
                continue
            ins = [None] * len(self.graph.in_edges[node.guid])
            for e in self.graph.in_edges[node.guid]:
                ins[e.dst_idx] = vals[(e.src, e.src_idx)]
            # tied weights read the source node's parameter set; autograd
            # then sums every use's gradient into that one set
            wsrc = getattr(node, "weight_source", None) or node.name
            with self._scope(node.name):
                # the compute-dtype cast at the consumer: each node casts
                # only its own weights (state stays fp32 — ops own its
                # handling)
                weights = dict(self._cast_compute(params.get(wsrc, {})))
                weights.update(new_state.get(wsrc, {}))
                outs, op_state = node.op_def.forward(
                    node.params, ins, weights, new_state.get(node.name), ctx)
            if op_state:
                new_state.setdefault(node.name, {}).update(op_state)
            for i, out in enumerate(self._outputs(node, outs, step)):
                vals[(node.guid, i)] = out
        return vals[(self.logits_node.guid, 0)], new_state

    def host_inputs(self, xs: dict) -> dict:
        """Host arrays -> CPU tensors of this rank's block of each (on a
        mesh, by its input node's placement): what `stage_inputs` moves
        to the device, and what the pipelined engine's prefetch thread
        stages (engine/pipelined.py)."""
        return self._host_blocks(xs, {
            n.name: n.outputs[0].partition_spec() for n in self.order
            if n.op_type == OT.OP_INPUT} if self.spmd else {})

    def host_labels(self, labels) -> torch.Tensor:
        """Host labels -> a CPU tensor of this rank's rows of them (the
        placement of the logits' rows)."""
        import numpy as np

        y = torch.as_tensor(np.asarray(labels))
        if self.spmd:
            from .parallel.spmd import take_local

            rows = self._loss_layout[:-1]
            y = take_local(y, tuple(rows[i] if i < len(rows) else ()
                                    for i in range(y.dim())), self.mesh)
        return y

    def stage_inputs(self, xs: dict) -> dict:
        """Host arrays -> tensors on the model's device; on a mesh this
        rank's block of each, by its input node's placement."""
        return {k: v.to(self.device)
                for k, v in self.host_inputs(xs).items()}

    def stage_labels(self, labels) -> torch.Tensor:
        """Host labels -> this rank's rows of them on the device (the
        placement of the logits' rows)."""
        return self.host_labels(labels).to(self.device)

    def _loss_logits(self, logits):
        """The logits on the loss's placement (this rank's rows, the
        classes whole) and the number of row blocks the rows are cut
        into."""
        if not self.spmd:
            return logits, 1
        from .parallel.spmd import redistribute

        lay = self._layout[(self.logits_node.guid, 0)]
        return (redistribute(logits, lay, self._loss_layout, self.mesh),
                self.mesh.axes_size(self._loss_axes))

    @torch.no_grad()
    def add_metrics(self, counters, logits, labels, scce_sum=None):
        """One batch's metrics added into `counters`; on a mesh each rank
        counts its rows and the counts are summed over the batch's
        ranks."""
        from_logits = not self.last_op_is_softmax
        if self._batch_group_of() is None:
            return self.metrics.compute(counters, logits, labels,
                                        from_logits=from_logits,
                                        scce_sum=scce_sum)
        from .parallel.spmd import all_reduce

        delta = self.metrics.zero_counters(logits.device)
        self.metrics.compute(delta, logits, labels, from_logits=from_logits,
                             scce_sum=scce_sum)
        keys = list(delta)
        total = all_reduce(torch.stack([delta[k] for k in keys]),
                           self._batch_group)
        for i, k in enumerate(keys):
            counters[k].add_(total[i])
        return counters

    def _batch_group_of(self):
        return self._batch_group if self.spmd else None

    def global_loss(self, lval):
        """The loss over the whole batch (each rank's is its rows' share)."""
        if self._batch_group_of() is None:
            return lval
        from .parallel.spmd import all_reduce

        return all_reduce(lval.detach(), self._batch_group)

    # ------------------------------------------------------------ training

    def make_loss_fn(self, state, x_inputs, labels, rng=None,
                     seq_length: int = -1, step=None):
        """The mixed-precision loss closure of the train step and of the
        granular `FFModel.backward`: the inputs are cast to the compute
        dtype once, each node casts its own weights inside `_apply`, and
        the cast's backward takes every gradient back to the f32 master.
        The logits stay in the compute dtype (the loss reduces them in
        f32). `step` (the train step's step tensor) reaches the
        sanitizer's probes and the fault injector; the loss has its own
        probe, one past the last op in topo order. Returns
        loss_fn(params) -> (loss, (logits, new_state, ce_sum))."""
        xc = self._cast_compute(x_inputs)

        def loss_fn(p):
            logits, new_state = self._apply(p, state, xc, training=True,
                                            rng=rng, seq_length=seq_length,
                                            step=step)
            with self._scope("loss"):
                logits, shards = self._loss_logits(logits)
                lval, ce_sum = loss_terms(
                    self.loss_type, logits, labels, self.last_op_is_softmax,
                    shards, self.mesh.axes_size(self._loss_layout[0])
                    if self.spmd else 1)
            if self._probes is not None or self._numeric_fault is not None:
                lval = self._instrument(lval, "loss", "loss", step, True)
            return lval, (logits, new_state, ce_sum)

        return loss_fn

    def value_and_grad(self, loss_fn, params):
        """(loss, aux, grads) of `loss_fn` at `params`, the twin of
        `jax.value_and_grad(has_aux=True)`: the gradients are taken with
        respect to detached views of the masters, and a parameter the loss
        does not reach gets zeros, as JAX gives."""
        leaves = {n: {k: t.detach().requires_grad_(True)
                      for k, t in ws.items()} for n, ws in params.items()}
        keys = [(n, k) for n, ws in leaves.items() for k in ws]
        with torch.enable_grad():
            lval, aux = loss_fn(leaves)
            grads = torch.autograd.grad(
                lval, [leaves[n][k] for n, k in keys],
                allow_unused=True) if keys else []
        out: dict = {}
        for (n, k), g in zip(keys, grads):
            out.setdefault(n, {})[k] = (g if g is not None
                                        else torch.zeros_like(params[n][k]))
        return lval.detach(), aux, out

    def train_step(self, params, state, opt_slots, step, counters, batch,
                   rng=None):
        """One iteration: forward, loss, backward, optimizer, metrics.
        Returns (params, state, opt_slots, step, counters, loss): the first
        five are the given tensors, updated in place (the JAX step's
        donated arguments 0-4; the state's new values, BatchNorm's running
        statistics among them, written into its tensors); `step` is one
        more. `rng` is the model's torch.Generator, which dropout draws
        from and advances (the JAX step takes a fresh key per step)."""
        x_inputs, labels = batch
        loss_fn = self.make_loss_fn(state, x_inputs, labels, rng,
                                    step=step)
        lval, (logits, new_state, ce_sum), grads = self.value_and_grad(
            loss_fn, params)
        self.flush_probes(step)
        grads = self.sync_grads(grads)
        _write_back(state, self._restore_state_dtypes(new_state))
        # a sharded update (stages 2/3) touches only this rank's shard of
        # each master: JAX's `weight_update_shard` scope
        with self._scope("weight_update_shard" if self.update_specs
                         else "weight_update"):
            params, opt_slots = self.optimizer.update(grads, params,
                                                      opt_slots, step)
        with torch.no_grad():
            step.add_(1)
        with self._scope("metrics"):
            self.add_metrics(counters, logits.detach(), labels, ce_sum)
        return (params, state, opt_slots, step, counters,
                self.global_loss(lval))

    def _compiled(self, name: str, fn, held, pool=None):
        """`fn` as a step of this device: captured on CUDA
        (`CapturedStep`, held tensors at the positions `held`), as it is
        on the CPU."""
        if self.device.type != "cuda":
            return fn
        return CapturedStep(name, fn, self.device, held, pool)

    def build_train_step(self):
        """The train step: one CUDA graph per batch signature on the card
        (masters, state, slots, step, counters and the generator held:
        updated in place; the generator registered with the graph, so
        each replay draws new dropout masks), `train_step` itself on the
        CPU."""
        self._train_step = self._compiled("train_step", self.train_step,
                                          held=(0, 1, 2, 3, 4, 6))
        return self._train_step

    def build_chunked_train_step(self, num_steps: int):
        """`num_steps` train iterations as ONE step (the twin of JAX's
        chunked `lax.scan` executable, `executor.py:751-784`): on the card
        one CUDA graph per batch signature, the held tensors and the
        generator as in `build_train_step`. The generator is registered
        once and its offset advances through the capture step by step,
        so a replay draws what `num_steps` single-step replays draw. The
        graph's pool gives the memory one step frees to the next step
        inside the capture, so its peak does not grow with
        `num_steps`. The step returns (params, state, opt_slots, step,
        counters, the per-step loss vector), the first five updated in
        place. Cached
        per chunk length: an epoch tail shorter than the pipeline depth
        costs one more capture, once."""
        num_steps = int(num_steps)
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        cached = self._chunk_steps.get(num_steps)
        if cached is not None:
            return cached

        def chunk_step(params, state, opt_slots, step, counters, batches,
                       rng=None):
            # one train_step after another over the staged batches (each
            # input and the labels with a leading num_steps axis): the
            # math is the per-step loop's
            xs, ys = batches
            losses = []
            for i in range(num_steps):
                out = self.train_step(
                    params, state, opt_slots, step, counters,
                    ({k: v[i] for k, v in xs.items()}, ys[i]), rng)
                losses.append(out[5])
            return (params, state, opt_slots, step, counters,
                    torch.stack(losses))

        fn = self._compiled(f"chunk_step[{num_steps}]", chunk_step,
                            held=(0, 1, 2, 3, 4, 6))
        self._chunk_steps[num_steps] = fn
        return fn

    def build_eval_step(self):
        """The eval step: metrics of a batch added into `counters` in
        place; captured per batch signature on the card."""

        @torch.no_grad()
        def eval_step(params, state, counters, batch):
            x_inputs, labels = batch
            logits, _ = self._apply(params, state,
                                    self._cast_compute(x_inputs))
            self.flush_probes()
            return self.add_metrics(counters, self._loss_logits(logits)[0],
                                    labels)

        self._eval_step = self._compiled("eval_step", eval_step,
                                         held=(0, 1, 2))
        return self._eval_step

    def build_forward(self):
        """The granular forward: logits and the new state (written into
        the given state's tensors). In training mode dropout draws from a
        generator seeded 0 at each call, as the JAX forward's fixed
        `jax.random.key(0)`."""
        @torch.no_grad()
        def forward(params, state, x_inputs, training, seq_length=-1):
            rng = (torch.Generator(self.device).manual_seed(0)
                   if training else None)
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(x_inputs),
                                            training=training, rng=rng,
                                            seq_length=seq_length)
            self.flush_probes()
            return logits, _write_back(
                state, self._restore_state_dtypes(new_state))

        self._forward_fn = forward
        return forward

    # ------------------------------------------------------------ serving

    def _slot_logits(self, logits):
        """The decode graph's logits at this rank's slot rows with the
        vocab whole (gathered over the axes a column-parallel head splits
        it by), and the group over the slots' axes (None: every slot
        here)."""
        if not self.spmd:
            return logits, None
        from .parallel.spmd import redistribute

        lay = self._layout[(self.logits_node.guid, 0)]
        rows = (lay[0],) + ((),) * (len(lay) - 1)
        return (redistribute(logits, lay, rows, self.mesh),
                self.mesh.group(lay[0]))

    def _all_slots(self, x, group):
        """A per-slot result of this rank's slots, gathered over the
        slots' axes: every rank's scheduler advances on the same
        tokens."""
        if group is None:
            return x
        from .parallel.spmd import all_gather

        return all_gather(x, group, 0)

    def _decode_pool(self):
        """The memory pool every serving graph of this executor shares
        (the decode widths, the verify widths, the KV inject): one of
        them replays at a time, its outputs cloned before the next."""
        if self.device.type != "cuda":
            return None
        if getattr(self, "_serving_pool", None) is None:
            self._serving_pool = torch.cuda.graph_pool_handle()
        return self._serving_pool

    def build_decode_step(self):
        """ONE serving iteration: forward the decode graph (incremental
        attention reads and writes the KV state in place), then pick the
        next token per slot from the logits row `read_idx` names — argmax
        where `temperature[slot] == 0`, Gumbel sampling otherwise, drawn
        from the caller's torch.Generator (the JAX step draws from a
        jax.random key). The inputs may be on the host; only the (slots,)
        token vector leaves the device. The weights come from the serving
        weight cache (`compute_params`). On the card one CUDA graph per q
        width (1 and the prefill buckets), all sharing one memory pool
        (and the NCCL calls of a mesh inside); the returned step's
        `captured` is that `CapturedStep` (None on the CPU).

        On a mesh `x_inputs` are this rank's blocks (`host_inputs`),
        `read_idx` and `temperature` whole. Each rank draws the uniform
        noise of every slot, (slots, vocab), from a generator seeded
        alike, and uses its rows: the draws are one rank's. The (slots,)
        token vector is gathered over the slots' axes, so every rank
        returns it whole."""

        @torch.no_grad()
        def decode_body(params, state, x_inputs, read_idx, gen,
                        temperature):
            dev = self.device
            xs = {k: v.to(dev) for k, v in x_inputs.items()}
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(xs))
            self.flush_probes()
            logits, group = self._slot_logits(logits)
            n_all = read_idx.shape[0]
            rows = logits.shape[0]
            lo = group.index * rows if group is not None else 0
            idx = read_idx.to(dev).long()[lo:lo + rows]
            sel = logits[torch.arange(rows, device=dev),
                         idx].float()  # (slots here, vocab)
            t = temperature.to(dev).float()[lo:lo + rows, None]
            u = torch.rand((n_all,) + tuple(sel.shape[1:]), generator=gen,
                           device=dev)[lo:lo + rows]
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
            noisy = torch.where(t > 0.0, sel / t.clamp_min(1e-6) + gumbel, sel)
            next_tok = torch.argmax(noisy, dim=-1).to(torch.int32)
            return (_write_back(state, self._restore_state_dtypes(new_state)),
                    self._all_slots(next_tok, group))

        run = self._compiled("decode_step", decode_body, held=(0, 1, 4),
                             pool=self._decode_pool())

        def decode_step(params, state, x_inputs, read_idx, gen, temperature):
            return run(self.compute_params(params), state, x_inputs,
                       read_idx, gen, temperature)

        decode_step.captured = run if isinstance(run, CapturedStep) else None
        return decode_step

    def build_verify_step(self):
        """Speculative decoding's verify call (JAX `executor.py:831-858`):
        forward q = K+1 tokens per slot through the decode graph (the
        incremental attention ops take (slots, q) positions, the chunked
        prefill's multi-token path) and return EVERY row's greedy argmax,
        (slots, q) int32, the KV state written in place. Row j is the
        target's token for position `positions[s, j] + 1`; rejected rows
        need no device-side rollback (the host rewinds its cursor). On
        the card a `CapturedStep`, one graph per q width, sharing the
        decode step's pool; on a mesh the argmax of this rank's slots is
        gathered over the slots' axes."""

        @torch.no_grad()
        def verify_body(params, state, x_inputs):
            dev = self.device
            xs = {k: v.to(dev) for k, v in x_inputs.items()}
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(xs))
            self.flush_probes()
            logits, group = self._slot_logits(logits)
            toks = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            return (_write_back(state, self._restore_state_dtypes(new_state)),
                    self._all_slots(toks, group))

        run = self._compiled("verify_step", verify_body, held=(0, 1),
                             pool=self._decode_pool())

        def verify_step(params, state, x_inputs):
            return run(self.compute_params(params), state, x_inputs)

        verify_step.captured = run if isinstance(run, CapturedStep) else None
        return verify_step

    def build_kv_inject(self):
        """The disaggregated handoff's landing (JAX `executor.py:888-917`):
        write the rows `rows_k`/`rows_v`, (layers, B, block_size, embed
        here), into the pool blocks `blocks` (B,) of every layer, in
        sorted pool-layer order (the order the extracting side reads),
        in place. The engine pads B to a power of two with (scratch,
        zero-rows) pairs, so the set of shapes stays O(log blocks a
        prompt). On the card a `CapturedStep`, one graph per B, sharing
        the decode step's pool."""

        @torch.no_grad()
        def inject_body(state, blocks, rows_k, rows_v):
            dev = self.device
            idx = blocks.to(dev).long()
            i = 0
            for name in sorted(state):
                ws = state[name]
                if "pool_k" in ws:
                    ws["pool_k"][idx] = rows_k[i].to(dev, ws["pool_k"].dtype)
                    ws["pool_v"][idx] = rows_v[i].to(dev, ws["pool_v"].dtype)
                    i += 1
            return state

        run = self._compiled("kv_inject", inject_body, held=(0,),
                             pool=self._decode_pool())

        def kv_inject(state, blocks, rows_k, rows_v):
            return run(state, blocks, rows_k, rows_v)

        kv_inject.captured = run if isinstance(run, CapturedStep) else None
        return kv_inject

    def build_block_copy(self):
        """Copy-on-write support for the paged KV layout: duplicate pool
        blocks src[i] -> dst[i] across every layer's pool_k/pool_v, in
        place (the JAX version donates the state). The right side gathers
        every source block before any destination is written."""

        @torch.no_grad()
        def copy_blocks(state, src, dst):
            src = src.long()
            dst = dst.long()
            for ws in state.values():
                for pool in ("pool_k", "pool_v"):
                    buf = ws.get(pool)
                    if buf is not None:
                        buf[dst] = buf[src]
            return state

        return copy_blocks
