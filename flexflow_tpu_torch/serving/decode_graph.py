"""Decode-graph construction (twin of `flexflow_tpu/serving/decode_graph.py`).

The serving engine does not fork the model definition: it replays the
trained FFModel's layer list into a fresh FFModel whose inputs are
(slots, 1)-shaped, one new token per continuous-batching slot, and whose
causal `multihead_attention` layers become incremental attention over
per-layer KV-cache state (ops/inc_attention.py). Every other layer replays
verbatim under the same name, so the trained parameters transfer by
(node, weight) name (`adopt_params`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..fftype import CompMode, DataType, OperatorType as OT


@dataclass
class ServingSpec:
    """Engine-level serving parameters (model.serve(**overrides))."""

    slots: int = 4
    max_seq_len: int = 0  # 0 -> the model's training sequence length
    prefill_chunk: int = 16
    max_new_tokens: int = 32  # per-request default
    eos_id: Optional[int] = None  # per-request default (None = never)
    # KV-cache layout: "paged" = block pool + per-slot page tables with
    # COW prefix sharing (the default); "contiguous" = the
    # (slots, max_seq+1, embed) per-slot region
    kv_layout: str = "paged"
    kv_block_size: int = 16  # pool rows per block (paged only)
    # physical pool blocks incl. the reserved scratch block; 0 -> sized
    # from the device memory budget, capped at contiguous capacity parity
    kv_num_blocks: int = 0
    prefix_sharing: bool = True  # COW prompt-prefix reuse (paged only)
    # cross-request radix prefix cache; None defers to
    # config.serve_prefix_cache. False = live sharing only.
    prefix_cache: Optional[bool] = None
    # which side of a split this decode compile serves ("" unified,
    # "prefill", "decode", "draft"): it joins the warm-start plan
    # fingerprint through config.serve_role, so the sides cache apart
    role: str = ""
    # extra FFConfig fields applied to the decode compile only (a decode
    # mesh re-plan's {"mesh_axis_sizes": ...}; a side's window,
    # {"mesh_axis_sizes": ..., "mesh_device_offset": ...})
    config_overrides: dict = field(default_factory=dict)
    # explicit decode-plan overrides (a Strategy or its overrides dict),
    # applied with set_strategy (plan_source "manual"); None: the
    # search, the plan cache or the data-parallel default
    strategy: object = None


def _decode_config(model, spec: ServingSpec):
    """The decode compile's FFConfig: the trainer's, with the slot count
    as its batch and the spec's layout, minus the subsystems that belong
    to the training job (its telemetry session and diagnostics, its
    checkpoints, its chunked fit, its strategy files, its elastic
    controller: the ENGINE owns decode-mesh elasticity), as the JAX
    package's, plus `spec.config_overrides`. The sanitizer carries over:
    the engine checks the decode step's probes."""
    cfg = copy.copy(model.config)  # plain copy: __post_init__ re-parses argv
    cfg.batch_size = spec.slots
    cfg.serve_kv_layout = spec.kv_layout
    cfg.serve_role = spec.role
    cfg.telemetry_dir = ""
    cfg.xprof_dir = ""
    cfg.diagnostics = False
    cfg.elastic = False
    cfg.profiling = False
    cfg.checkpoint_dir = ""
    cfg.auto_resume = False
    cfg.pipeline_steps = 1
    cfg.import_strategy_file = ""
    cfg.export_strategy_file = ""
    cfg.export_strategy_computation_graph_file = ""
    for k, v in (spec.config_overrides or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"config_overrides: FFConfig has no field {k!r}")
        setattr(cfg, k, v)
    return cfg


def _weight_bytes(model) -> int:
    return sum(w.numel() * w.element_size()
               for ws in (model._params or {}).values() for w in ws.values())


def resolve_pool_blocks(model, spec: ServingSpec, max_seq: int) -> int:
    """Physical block count for the paged pool (incl. the reserved scratch
    block 0). spec.kv_num_blocks > 0 pins it; 0 sizes the pool from the
    card's memory (`torch.cuda.mem_get_info`) minus the trained weights,
    capped at contiguous capacity parity (every slot can reach max_seq),
    floored at one block per slot. On the CPU, capacity parity."""
    bs = spec.kv_block_size
    if bs < 1:
        raise ValueError(f"kv_block_size must be >= 1, got {bs}")
    table_width = -(-max_seq // bs)
    if spec.kv_num_blocks:
        if spec.kv_num_blocks < 2:
            raise ValueError(
                f"kv_num_blocks must be >= 2 (scratch + 1), got "
                f"{spec.kv_num_blocks}")
        return spec.kv_num_blocks
    capacity = spec.slots * table_width + 1
    if model.device.type != "cuda":
        return capacity
    _free, total = torch.cuda.mem_get_info(model.device)
    attn = [l for l in model.layers
            if l.op_type == OT.OP_MULTIHEAD_ATTENTION]
    block_bytes = sum(2 * bs * l.params.embed_dim * 4 for l in attn)
    if block_bytes <= 0:
        return capacity
    budget = 0.9 * total - _weight_bytes(model)
    fit = int(budget // block_bytes)
    return max(spec.slots + 1, min(capacity, fit))


def infer_max_seq_len(model) -> int:
    """Default KV-cache length: the training graph's sequence extent (dim 1
    of the first rank-2 input), so decode never outruns the learned
    positional table."""
    for t in model._input_tensors:
        if len(t.dims) >= 2:
            return int(t.dims[1])
    raise ValueError("cannot infer max_seq_len: no rank-2 input "
                     "(pass max_seq_len explicitly)")


def build_decode_model(model, spec: ServingSpec):
    """Replay `model`'s layers into a compiled decode FFModel. Raises for
    graphs serving can't express: non-causal or cross-attention."""
    from ..model import FFModel
    from ..ops import (
        IncMultiHeadAttentionParams,
        PagedIncMultiHeadAttentionParams,
    )

    if spec.kv_layout not in ("contiguous", "paged"):
        raise ValueError(
            f"kv_layout must be 'contiguous' or 'paged', got "
            f"{spec.kv_layout!r}")
    max_seq = spec.max_seq_len or infer_max_seq_len(model)
    paged = spec.kv_layout == "paged"
    num_blocks = resolve_pool_blocks(model, spec, max_seq) if paged else 0
    dec = FFModel(_decode_config(model, spec))
    over = spec.config_overrides or {}
    if "mesh_device_offset" in over:
        # a side's window of the torchrun world: ranks [off, off + n),
        # the world's other ranks parked (the whole world: the plain
        # mesh); the window's end past the world is refused there
        from ..distributed import world_size

        if world_size() > 1:
            off = int(over["mesh_device_offset"] or 0)
            n = dec.config.mesh_shape().num_devices
            dec._mesh_ranks = list(range(off, off + n))

    # inputs: (batch, seq, ...) -> (slots, 1, ...); the `positions` input
    # doubles as every attention layer's position feed
    tensor_map: dict[int, object] = {}
    positions = None
    for t in model._input_tensors:
        if len(t.dims) < 2:
            raise ValueError(
                f"serving input {t.name!r} is rank {len(t.dims)}; decode "
                f"inputs need a (batch, seq, ...) shape")
        nt = dec.create_tensor((spec.slots, 1) + tuple(t.dims[2:]),
                               t.dtype, create_grad=False, name=t.name)
        tensor_map[t.tensor_guid] = nt
        if t.name == "positions":
            positions = nt
    if positions is None:
        positions = dec.create_tensor((spec.slots, 1), DataType.DT_INT32,
                                      create_grad=False, name="positions")
    page_table = None
    if paged:
        # one page table feeds every attention layer: block ids index the
        # same physical block across all layers' pools
        table_width = -(-max_seq // spec.kv_block_size)
        page_table = dec.create_tensor(
            (spec.slots, table_width), DataType.DT_INT32,
            create_grad=False, name="page_table")

    for layer in model.layers:
        ins = []
        for t in layer.inputs:
            mapped = tensor_map.get(t.tensor_guid)
            if mapped is None:
                raise ValueError(
                    f"layer {layer.name!r} reads a tensor serving did not "
                    f"replay ({t.name!r})")
            ins.append(mapped)
        if layer.op_type == OT.OP_MULTIHEAD_ATTENTION:
            p = layer.params
            if not p.causal:
                raise ValueError(
                    f"{layer.name}: serving decode requires causal "
                    f"attention")
            if not (layer.inputs[0] is layer.inputs[1] is layer.inputs[2]):
                raise ValueError(
                    f"{layer.name}: serving decode supports "
                    f"self-attention only (q, k, v must be one tensor)")
            if (p.kdim not in (0, p.embed_dim)
                    or p.vdim not in (0, p.embed_dim)):
                raise ValueError(
                    f"{layer.name}: kdim/vdim != embed_dim not supported "
                    f"in the decode graph")
            if paged:
                np_ = PagedIncMultiHeadAttentionParams(
                    p.embed_dim, p.num_heads, max_seq,
                    spec.kv_block_size, num_blocks, p.use_bias)
                new = dec._add_layer(
                    OT.OP_PAGED_INC_MULTIHEAD_ATTENTION, np_,
                    [ins[0], positions, page_table],
                    name=layer.name, data_type=layer.data_type)
            else:
                np_ = IncMultiHeadAttentionParams(
                    p.embed_dim, p.num_heads, max_seq, p.use_bias)
                new = dec._add_layer(
                    OT.OP_INC_MULTIHEAD_ATTENTION, np_, [ins[0], positions],
                    name=layer.name, data_type=layer.data_type)
        else:
            new = dec._add_layer(
                layer.op_type, layer.params, ins, name=layer.name,
                initializers=dict(layer.initializers),
                data_type=layer.data_type)
        for t_out, d_out in zip(layer.outputs, new.outputs):
            tensor_map[t_out.tensor_guid] = d_out

    if spec.strategy is not None:
        dec.set_strategy(spec.strategy)
    dec.compile(comp_mode=CompMode.COMP_MODE_INFERENCE)
    return dec, max_seq


def adopt_params(dec, model) -> int:
    """Copy the trained model's parameters into the decode model by
    (node, weight) name. Each is a copy of its own, as the JAX package's
    `set_weight` places a new array: an engine keeps the weights it had
    when it was built, and a later `fit` step, which updates the trained
    model's masters in place, reaches only an engine built after it. The
    KV caches keep their zero init. Returns the number of weights
    adopted (0 on a rank the decode mesh parks: it holds none). On a
    mesh each rank keeps its block of each weight (`local_weight`)."""
    moved = 0
    trained = model._params
    if model.executor is not None and model.executor.spmd:
        # the trained masters whole, on every rank of the trained mesh
        # (collective), parked decode ranks included
        trained = {n: {w: model.executor.full_weight(n, w, t)
                       for w, t in ws.items()} for n, ws in trained.items()}
    if dec._params is None:
        return moved
    ex = dec.executor
    for node_name, ws in dec._params.items():
        for wname in ws:
            src = ex.local_weight(node_name, wname,
                                  trained[node_name][wname].to(dec.device))
            if tuple(src.shape) != tuple(ws[wname].shape):
                raise ValueError(
                    f"{node_name}.{wname}: trained shape "
                    f"{tuple(src.shape)} != decode shape "
                    f"{tuple(ws[wname].shape)}")
            ws[wname] = src.detach().clone()
            moved += 1
    return moved
