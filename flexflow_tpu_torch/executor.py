"""Executor: runs a compiled graph on one torch device.

The twin of the single-device half of `flexflow_tpu/executor.py`:
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
`build_forward` and the COW block copy stay eager, as does
`fit(pipeline_steps > 1)`'s engine when it comes (ROADMAP A10).

The decode step reads the parameters in the compute dtype from a cache
(`compute_params`): each copy is cast once and again only when its master
changes (another tensor, or a newer `_version`), in place, so a captured
decode graph keeps reading the same copies. The train step casts inside
the step, since its masters change every step.

Float settings: TF32 is switched off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) when an executor is built, so
an fp32 run is full fp32 on the card, as the reference's fp32 path is.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import traceback
from typing import Any

import torch

from .config import FFConfig
from .fftype import LossType, OperatorType as OT, dtype_to_torch
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

    def _split(self, args):
        held = [x for i, a in enumerate(args) if i in self.held
                for x in _leaves(a)]
        staged = tuple(None if i in self.held else a
                       for i, a in enumerate(args))
        return held, staged

    def __call__(self, *args):
        if _EAGER_DEPTH:
            return self.fn(*args)
        held, staged = self._split(args)
        sig = _signature(staged)
        if sig not in self._graphs:
            self._graphs[sig] = None
            return self._warm_up(args)
        graph = self._graphs[sig]
        if graph is None or not graph.holds(held):
            self._graphs[sig] = None  # frees a stale graph's pool first
            del graph
            graph = self._graphs[sig] = self._capture(args, held)
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
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self.stream):
                out = self.fn(*static)
        except Exception as exc:
            for n, c in cs.items():
                c.restore(before[n])
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


class Executor:
    def __init__(self, graph: Graph, config: FFConfig, device: torch.device,
                 logits_node: OpNode, loss_type: LossType = None,
                 metrics=None, optimizer=None):
        set_float_policy()
        self.graph = graph
        self.config = config
        self.device = device
        self.order = graph.topo_order()
        self.logits_node = logits_node
        self.loss_type = loss_type
        self.metrics = metrics
        self.optimizer = optimizer
        # a graph that ends in softmax hands probabilities to the loss
        self.last_op_is_softmax = logits_node.op_type == OT.OP_SOFTMAX
        self._train_step = None
        self._eval_step = None
        self._forward_fn = None
        # mixed precision: compute_dtype != None -> bf16/fp16 activations
        # over fp32 master weights; matmul_dtype -> the tensor-op input cast
        # for fp32 matmuls, on CUDA (the JAX package applies it on the TPU)
        self.compute_dtype = (
            dtype_to_torch(config.computation_dtype)
            if config.computation_dtype is not None else None)
        self.matmul_dtype = (
            torch.bfloat16
            if config.allow_tensor_op_math_conversion and device.type == "cuda"
            else None)
        # the serving weight cache: (node, weight) -> (master, its
        # _version when seen, its compute-dtype copy or, without a compute
        # dtype, the master); `weight_refreshes` counts the entries made
        # (each a cast where there is a compute dtype)
        self._weight_cache: dict[tuple[str, str], tuple] = {}
        self.weight_refreshes = 0
        # constant inputs, made at first use (`_constant`)
        self._constants: dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ variables

    def init_variables(self, seed: int):
        """Params (trainable) and state (non-trainable weights: the KV
        caches, BatchNorm's running statistics), each drawn from its own
        generator, on the model's device. A node with tied weights
        (`weight_source`) gets none: it reads its source's."""
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

    def _apply(self, params, state, inputs, *, training: bool = False,
               rng=None, seq_length: int = -1):
        """Run the graph forward. Returns (logits, new_state). Autograd
        records it unless the caller runs it under `no_grad`. `rng` is the
        torch.Generator dropout draws from (training only); `seq_length`
        reaches the ops' context (batch_matmul's truncation)."""
        vals: dict[tuple[int, int], Any] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        ctx = OpContext(training=training, rng=rng, seq_length=seq_length,
                        matmul_dtype=self.matmul_dtype,
                        flash_packed=self.config.flash_packed_layout)
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
            # the compute-dtype cast at the consumer: each node casts only
            # its own weights (state stays fp32 — ops own its handling)
            weights = dict(self._cast_compute(params.get(wsrc, {})))
            weights.update(new_state.get(wsrc, {}))
            outs, op_state = node.op_def.forward(
                node.params, ins, weights, new_state.get(node.name), ctx)
            if op_state:
                new_state.setdefault(node.name, {}).update(op_state)
            for i, out in enumerate(outs):
                vals[(node.guid, i)] = out
        return vals[(self.logits_node.guid, 0)], new_state

    def stage_inputs(self, xs: dict) -> dict:
        """Host arrays -> tensors on the model's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in xs.items()}

    # ------------------------------------------------------------ training

    def make_loss_fn(self, state, x_inputs, labels, rng=None,
                     seq_length: int = -1):
        """The mixed-precision loss closure of the train step and of the
        granular `FFModel.backward`: the inputs are cast to the compute
        dtype once, each node casts its own weights inside `_apply`, and
        the cast's backward takes every gradient back to the f32 master.
        The logits stay in the compute dtype (the loss reduces them in
        f32). Returns loss_fn(params) -> (loss, (logits, new_state,
        ce_sum))."""
        xc = self._cast_compute(x_inputs)

        def loss_fn(p):
            logits, new_state = self._apply(p, state, xc, training=True,
                                            rng=rng, seq_length=seq_length)
            lval, ce_sum = loss_terms(self.loss_type, logits, labels,
                                      self.last_op_is_softmax)
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
        loss_fn = self.make_loss_fn(state, x_inputs, labels, rng)
        lval, (logits, new_state, ce_sum), grads = self.value_and_grad(
            loss_fn, params)
        _write_back(state, self._restore_state_dtypes(new_state))
        params, opt_slots = self.optimizer.update(grads, params, opt_slots,
                                                  step)
        with torch.no_grad():
            step.add_(1)
        self.metrics.compute(
            counters, logits.detach(), labels,
            from_logits=not self.last_op_is_softmax, scce_sum=ce_sum)
        return params, state, opt_slots, step, counters, lval

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

    def build_eval_step(self):
        """The eval step: metrics of a batch added into `counters` in
        place; captured per batch signature on the card."""

        @torch.no_grad()
        def eval_step(params, state, counters, batch):
            x_inputs, labels = batch
            logits, _ = self._apply(params, state,
                                    self._cast_compute(x_inputs))
            return self.metrics.compute(
                counters, logits, labels,
                from_logits=not self.last_op_is_softmax)

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
            return logits, _write_back(
                state, self._restore_state_dtypes(new_state))

        self._forward_fn = forward
        return forward

    # ------------------------------------------------------------ serving

    def build_decode_step(self):
        """ONE serving iteration: forward the decode graph (incremental
        attention reads and writes the KV state in place), then pick the
        next token per slot from the logits row `read_idx` names — argmax
        where `temperature[slot] == 0`, Gumbel sampling otherwise, drawn
        from the caller's torch.Generator (the JAX step draws from a
        jax.random key). The inputs may be on the host; only the (slots,)
        token vector leaves the device. The weights come from the serving
        weight cache (`compute_params`). On the card one CUDA graph per q
        width (1 and the prefill buckets), all sharing one memory pool;
        the returned step's `captured` is that `CapturedStep` (None on the
        CPU)."""

        @torch.no_grad()
        def decode_body(params, state, x_inputs, read_idx, gen,
                        temperature):
            dev = self.device
            xs = {k: v.to(dev) for k, v in x_inputs.items()}
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(xs))
            slots = logits.shape[0]
            sel = logits[torch.arange(slots, device=dev),
                         read_idx.to(dev).long()].float()  # (slots, vocab)
            t = temperature.to(dev).float()[:, None]
            u = torch.rand(sel.shape, generator=gen, device=dev)
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
            noisy = torch.where(t > 0.0, sel / t.clamp_min(1e-6) + gumbel, sel)
            next_tok = torch.argmax(noisy, dim=-1).to(torch.int32)
            return (_write_back(state, self._restore_state_dtypes(new_state)),
                    next_tok)

        run = self._compiled(
            "decode_step", decode_body, held=(0, 1, 4),
            pool=(torch.cuda.graph_pool_handle()
                  if self.device.type == "cuda" else None))

        def decode_step(params, state, x_inputs, read_idx, gen, temperature):
            return run(self.compute_params(params), state, x_inputs,
                       read_idx, gen, temperature)

        decode_step.captured = run if isinstance(run, CapturedStep) else None
        return decode_step

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
