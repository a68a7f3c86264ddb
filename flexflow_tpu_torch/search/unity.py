"""The update-dimension decision of the Unity search (twin of
`flexflow_tpu/search/unity.py:choose_update_sharding`, its plain rules
only).

The JAX package prices replicated, stage-2 and stage-3 updates with its
cost model and keeps the cheapest; the cost model is ROADMAP A7. What is
here decides without it: no gradient sync (one data shard, nothing
trainable) or an inference compile stays replicated, and the flags force
the rest (`--weight-update-sharding=stage2|stage3|off`,
`--no-weight-update-sharding`). A decision that needs pricing (no flag,
or the bare `--weight-update-sharding`, whose stage JAX prices) raises,
naming A7.
"""

from __future__ import annotations

from ..config import not_ported
from ..fftype import CompMode
from ..machine import batch_axes_for


def choose_update_sharding(graph, mesh, config) -> dict:
    """The decision record: `enabled`, `stage` (0, 2 or 3), `shards`,
    `axes`, `reason` and the forcing flags, as the JAX package records
    it."""
    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    axes = batch_axes_for(axis_sizes)
    shards = 1
    for ax in axes:
        shards *= axis_sizes.get(ax, 1)
    decision = {
        "enabled": False,
        "stage": 0,
        "shards": shards,
        "axes": list(axes),
        "forced": config.weight_update_sharding,
        "forced_stage": config.weight_update_stage,
    }
    trainable = any(
        ws.trainable
        for n in graph.topo_order()
        if not getattr(n, "weight_source", None)
        for ws in n.weight_specs)
    if (shards <= 1 or not trainable
            or config.computation_mode != CompMode.COMP_MODE_TRAINING):
        decision["reason"] = ("no_grad_sync" if shards <= 1 or not trainable
                              else "inference")
        return decision
    if config.weight_update_sharding is not None:
        enabled = config.weight_update_sharding
        if not enabled:
            stage = 0
        elif config.weight_update_stage in (2, 3):
            stage = config.weight_update_stage
        else:
            raise not_ported(
                "the bare --weight-update-sharding (its stage is priced by "
                "the cost model; pass =stage2 or =stage3)", "A7 (Unity "
                "search: the update-sharding decision)")
        decision["reason"] = "flag"
    elif config.weight_update_stage == 0:
        enabled, stage = False, 0
        decision["reason"] = "flag"
    else:
        raise not_ported(
            f"the unforced weight-update sharding decision over {shards} "
            f"data shards (pass --weight-update-sharding=stage2|stage3|off)",
            "A7 (Unity search: the update-sharding decision)")
    decision["enabled"] = bool(enabled)
    decision["stage"] = int(stage)
    return decision
