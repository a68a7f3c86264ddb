"""Executor: runs a compiled graph eagerly on one torch device.

The twin of the single-device serving half of `flexflow_tpu/executor.py`:
`init_variables` (554), `_apply` (589), `_cast_compute` (442),
`_restore_state_dtypes` (541), `build_decode_step` (799) and
`build_block_copy` (862). The JAX executor traces one jitted, donated
program; PyTorch runs eagerly, so a "step" here is a plain function, and
where the JAX code donates the KV state to update it in place, the port
updates the state tensors in place (the ops' `index_put_`, the block copy's
indexed assignment).

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
from .fftype import OperatorType as OT, dtype_to_torch
from .initializer import initializer_by_name
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
                 logits_node: OpNode):
        set_float_policy()
        self.graph = graph
        self.config = config
        self.device = device
        self.order = graph.topo_order()
        self.logits_node = logits_node
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

    @torch.no_grad()
    def _apply(self, params, state, inputs, *, training: bool = False):
        """Run the graph forward. Returns (logits, new_state)."""
        vals: dict[tuple[int, int], Any] = {}
        new_state = {k: dict(v) for k, v in state.items()}
        ctx = OpContext(training=training, matmul_dtype=self.matmul_dtype)
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

    # ------------------------------------------------------------ steps

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
