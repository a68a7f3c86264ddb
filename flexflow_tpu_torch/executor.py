"""Executor: runs a compiled graph eagerly on one torch device.

The twin of the single-device half of `flexflow_tpu/executor.py`:
`init_variables` (554), `_apply` (589), `_cast_compute` (442),
`_restore_state_dtypes` (541), `make_loss_fn` (493), `_train_step_body`
(690), `build_train_step` (742), `build_eval_step` (783),
`build_decode_step` (799), `build_block_copy` (862) and `build_forward`
(945). The JAX executor traces one jitted, donated program; PyTorch runs
eagerly, so a "step" here is a plain function. Gradients come from
autograd through `_apply` (the training forward builds the graph; the
eval, forward and decode steps run it under `no_grad`). Where the JAX code
donates the KV state or the optimizer slots to update them in place, the
port updates those tensors in place (the ops' `index_put_`, the block
copy's indexed assignment, the optimizers' `_foreach_` ops).

Float settings: TF32 is switched off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) when an executor is built, so
an fp32 run is full fp32 on the card, as the reference's fp32 path is.
"""

from __future__ import annotations

import hashlib
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

    # ------------------------------------------------------------ variables

    def init_variables(self, seed: int):
        """Params (trainable) and state (non-trainable weights, e.g. the KV
        caches), each drawn from its own generator, on the model's device."""
        params, state = {}, {}
        for node in self.order:
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

    def _restore_state_dtypes(self, new_state: dict) -> dict:
        """Non-trainable state is kept fp32 across steps."""
        if self.compute_dtype is None:
            return new_state
        return {
            name: {k: (v.float() if v.is_floating_point() else v)
                   for k, v in ws.items()}
            for name, ws in new_state.items()
        }

    def _apply(self, params, state, inputs, *, training: bool = False):
        """Run the graph forward. Returns (logits, new_state). Autograd
        records it unless the caller runs it under `no_grad`."""
        vals: dict[tuple[int, int], Any] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        ctx = OpContext(training=training, matmul_dtype=self.matmul_dtype,
                        flash_packed=self.config.flash_packed_layout)
        for node in self.order:
            if node.op_type == OT.OP_INPUT:
                vals[(node.guid, 0)] = inputs[node.name]
                continue
            ins = [None] * len(self.graph.in_edges[node.guid])
            for e in self.graph.in_edges[node.guid]:
                ins[e.dst_idx] = vals[(e.src, e.src_idx)]
            # the compute-dtype cast at the consumer: each node casts only
            # its own weights (state stays fp32 — ops own its handling)
            weights = dict(self._cast_compute(params.get(node.name, {})))
            weights.update(new_state.get(node.name, {}))
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

    def make_loss_fn(self, state, x_inputs, labels):
        """The mixed-precision loss closure of the train step and of the
        granular `FFModel.backward`: the inputs are cast to the compute
        dtype once, each node casts its own weights inside `_apply`, and
        the cast's backward takes every gradient back to the f32 master.
        The logits stay in the compute dtype (the loss reduces them in
        f32). Returns loss_fn(params) -> (loss, (logits, new_state,
        ce_sum))."""
        xc = self._cast_compute(x_inputs)

        def loss_fn(p):
            logits, new_state = self._apply(p, state, xc, training=True)
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
                lval, [leaves[n][k] for n, k in keys], allow_unused=True)
        out: dict = {}
        for (n, k), g in zip(keys, grads):
            out.setdefault(n, {})[k] = (g if g is not None
                                        else torch.zeros_like(params[n][k]))
        return lval.detach(), aux, out

    def train_step(self, params, state, opt_slots, step, counters, batch):
        """One iteration: forward, loss, backward, optimizer, metrics.
        Returns (params, state, opt_slots, step + 1, counters, loss); the
        parameters are new tensors, the slots are updated in place."""
        x_inputs, labels = batch
        loss_fn = self.make_loss_fn(state, x_inputs, labels)
        lval, (logits, new_state, ce_sum), grads = self.value_and_grad(
            loss_fn, params)
        new_state = self._restore_state_dtypes(new_state)
        new_params, new_slots = self.optimizer.update(grads, params,
                                                      opt_slots, step)
        counters = self.metrics.compute(
            counters, logits.detach(), labels,
            from_logits=not self.last_op_is_softmax, scce_sum=ce_sum)
        return new_params, new_state, new_slots, step + 1, counters, lval

    def build_train_step(self):
        self._train_step = self.train_step
        return self._train_step

    def build_eval_step(self):
        @torch.no_grad()
        def eval_step(params, state, counters, batch):
            x_inputs, labels = batch
            logits, _ = self._apply(params, state,
                                    self._cast_compute(x_inputs))
            return self.metrics.compute(
                counters, logits, labels,
                from_logits=not self.last_op_is_softmax)

        self._eval_step = eval_step
        return eval_step

    def build_forward(self):
        @torch.no_grad()
        def forward(params, state, x_inputs, training):
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(x_inputs),
                                            training=training)
            return logits, self._restore_state_dtypes(new_state)

        self._forward_fn = forward
        return forward

    # ------------------------------------------------------------ serving

    def build_decode_step(self):
        """ONE serving iteration: forward the decode graph (incremental
        attention reads and writes the KV state in place), then pick the
        next token per slot from the logits row `read_idx` names — argmax
        where `temperature[slot] == 0`, Gumbel sampling otherwise, drawn
        from the caller's torch.Generator (the JAX step draws from a
        jax.random key). Only the (slots,) token vector leaves the device."""

        @torch.no_grad()
        def decode_step(params, state, x_inputs, read_idx, gen, temperature):
            logits, new_state = self._apply(params, state,
                                            self._cast_compute(x_inputs))
            slots = logits.shape[0]
            sel = logits[torch.arange(slots, device=logits.device),
                         read_idx.long()].float()  # (slots, vocab)
            t = temperature.float()[:, None]
            u = torch.rand(sel.shape, generator=gen, device=sel.device)
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
            noisy = torch.where(t > 0.0, sel / t.clamp_min(1e-6) + gumbel, sel)
            next_tok = torch.argmax(noisy, dim=-1).to(torch.int32)
            return self._restore_state_dtypes(new_state), next_tok

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
