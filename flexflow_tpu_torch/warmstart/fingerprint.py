"""Plan fingerprints: content addresses for cached parallelization plans
(twin of `flexflow_tpu/warmstart/fingerprint.py`).

The reference caches every measured operator cost inside the simulator
keyed by (OperatorParameters, MachineView) precisely because re-measuring
dominates search time (simulator.h:691-783); the warm-start subsystem
extends the same idea to the whole compile: a searched plan is valid for
exactly the inputs the search consumed, so those inputs — hashed — become
the plan's content address. Alpa (OSDI'22) treats auto-parallelization
output as an offline artifact for the same reason.

Two fingerprints, two uses:

- **structural** — graph signature (topology + op params + dtypes + weight
  specs + tied-weight links), configured mesh shape, the search-relevant
  FFConfig fields (with referenced files hashed by content), device kind,
  and the cost-model constants (opt_slots, mfu). Deterministic across
  process restarts, independent of any on-chip measurement — this is the
  key under which the resilience checkpoint manifest records the plan, so
  `--auto-resume` can re-adopt the interrupted run's exact plan without a
  search even when calibration would re-measure different numbers.
- **full** — structural + a hash of the calibration entries the cost model
  holds for this graph's ops. The plan-cache key: calibration data feeding
  the search is part of the plan's identity, so a recalibrated world (new
  chip, new toolchain, refreshed measurements) conservatively misses.

Invalidation is by construction: ANY component change → different address
→ miss → fresh search. There is no partial matching.
"""

from __future__ import annotations

import hashlib
import json
import os

# FFConfig fields that steer the search (and therefore the plan). A field
# added to the search MUST be added here, or two configs that search
# differently would share a fingerprint — when in doubt, include it.
_SEARCH_CONFIG_FIELDS = (
    "search_budget", "search_alpha", "search_overlap_backward_update",
    "only_data_parallel", "enable_sample_parallel",
    "enable_parameter_parallel", "enable_attribute_parallel",
    "enable_substitutions", "search_mesh_shapes", "search_calibrate",
    "base_optimize_threshold", "perform_memory_search",
    "search_num_nodes", "search_num_workers",
    "num_nodes", "workers_per_node",
    # overlap-capable collectives price as max(compute, comm) instead of
    # compute + comm (search/cost_model.py) — toggling it can flip the
    # winning strategy, so plans must not share an address across it
    "overlap_collectives",
    # weight-update sharding (ZeRO-style sharded optimizer / ZeRO-3
    # FSDP): forcing it changes how the search prices grad sync +
    # per-chip memory, and the raw None/True/False plus the forced stage
    # (None/0/2/3) are the deterministic inputs to the update-mode
    # decision (unity.choose_update_sharding) — plans must not share an
    # address across either, so the CHOSEN stage is part of the plan
    # fingerprint by construction (the decision is a pure function of
    # these fields + graph + mesh + calibration)
    "weight_update_sharding",
    "weight_update_stage",
    "computation_dtype", "allow_tensor_op_math_conversion",
    "force_tensor_op_math",
    # serving (serving/): a decode graph compiles under
    # COMP_MODE_INFERENCE — its plans must never share an address with a
    # training compile's (the graphs differ structurally too, but the
    # mode is the cheap, explicit discriminator)
    "computation_mode",
    # KV-cache layout (--serve-kv-layout): contiguous and paged decode
    # graphs must never share a plan address — the pool/page-table
    # tensors differ structurally too, but as with computation_mode the
    # field is the explicit discriminator the round-trip test pins
    "serve_kv_layout",
    # disaggregated serving (serving/disagg.py): the prefill and decode
    # sides are two independently searched plans over different
    # sub-meshes — the role (and the device offset carving the sub-mesh
    # out of the global device list) must keep their cache addresses
    # apart even when graph + mesh shape coincide
    "serve_role",
    "mesh_device_offset",
)


def _sha(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _file_digest(path: str) -> str:
    """Content hash of a config-referenced file; referenced-but-missing is
    its own distinct state (the compile would fail differently)."""
    if not path:
        return ""
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return f"missing:{os.path.basename(path)}"


def device_signature(device=None) -> dict:
    """The hardware and toolchain the plan was searched (and calibrated)
    for: the card's name, count and compute capability, torch's and CUDA's
    versions. A model on the CPU reads the CPU, with the world's ranks as
    its device count. `device` None: the card where there is one."""
    import torch

    from ..distributed import process_count

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    sig = {"platform": dev.type, "device_kind": "cpu",
           "device_count": process_count(), "capability": "",
           "torch": torch.__version__, "cuda": torch.version.cuda or ""}
    if dev.type == "cuda" and torch.cuda.is_available():
        index = dev.index if dev.index is not None else 0
        major, minor = torch.cuda.get_device_capability(index)
        sig.update(device_kind=torch.cuda.get_device_name(index),
                   device_count=torch.cuda.device_count(),
                   capability=f"{major}.{minor}")
    return sig


def graph_signature(graph) -> list:
    """JSON-able signature of a PCG: per-node (name, op type, params repr,
    output shapes/dtypes, weight specs, tied-weight source) plus the edge
    list in node-name space. Node names are part of the signature on
    purpose: the cached Strategy is keyed by name, so differently-named
    builds must not share a plan."""
    sig = []
    for node in graph.topo_order():
        sig.append({
            "name": node.name,
            "op": node.op_type.name,
            "params": repr(node.params),
            "outputs": [
                [list(pt.shape.logical_shape), pt.dtype.name]
                for pt in node.outputs
            ],
            "weights": [
                [ws.name, list(ws.shape), ws.dtype.name, bool(ws.trainable)]
                for ws in node.weight_specs
            ],
            "tied": getattr(node, "weight_source", "") or "",
            "in": sorted(
                [graph.nodes[e.src].name, e.src_idx, e.dst_idx]
                for e in graph.in_edges[node.guid]
            ),
        })
    return sig


def config_signature(config) -> dict:
    sig = {}
    for name in _SEARCH_CONFIG_FIELDS:
        v = getattr(config, name, None)
        if not isinstance(v, (bool, int, float, str, type(None))):
            v = str(v)
        sig[name] = v
    sig["substitution_json"] = _file_digest(
        config.substitution_json_path or "")
    sig["machine_model_file"] = _file_digest(config.machine_model_file)
    return sig


# ------------------------------------------------ copied from analysis/rules

def serialize_rule(xfer) -> dict:
    """Canonical JSON-able description of a GraphXfer: structure, static
    params, constraint specs where the JSON compiler recorded them, and
    opaque-constraint counts (a copy of the JAX package's
    `analysis/rules.serialize_rule`; ROADMAP A9 ports the module)."""
    src_ix = {op: i for i, op in enumerate(xfer.src_ops)}
    dst_ix = {op: i for i, op in enumerate(xfer.dst_ops)}

    def ref(tx):
        if tx.op is None:
            return ["$", tx.idx]
        if tx.op in src_ix:
            return ["src", src_ix[tx.op], tx.idx]
        if tx.op in dst_ix:
            return ["dst", dst_ix[tx.op], tx.idx]
        return ["?", -1, tx.idx]

    def static_params(op):
        mk = getattr(op, "make_params", None)
        if mk is None:
            return ""
        try:
            return repr(mk({}))
        except Exception:
            return "<match-dependent>"

    return {
        "name": xfer.name,
        "src": [{
            "op": op.op_type.name,
            "in": [ref(t) for t in op.inputs],
            "outs": len(op.outputs),
            "constraints": (list(getattr(op, "_constraint_specs", ()))
                            or len(op.constraints)),
        } for op in xfer.src_ops],
        "dst": [{
            "op": op.op_type.name,
            "in": [ref(t) for t in op.inputs],
            "match": src_ix.get(op.match_src, -1),
            "params": static_params(op),
        } for op in xfer.dst_ops],
        "map": [[ref(s), ref(d)] for s, d in xfer.mapped_outputs],
    }


def rules_fingerprint(xfers) -> str:
    """Content hash of a rule set, order-free (entries sorted): a
    changed/added/removed rule changes the plan address (a copy of the
    JAX package's `analysis/rules.rules_fingerprint`)."""
    entries = sorted(
        json.dumps(serialize_rule(x), sort_keys=True) for x in xfers)
    return hashlib.sha256(
        json.dumps({"v": 1, "rules": entries}).encode()).hexdigest()


def rules_signature(graph, mesh_axes: dict, config) -> str:
    """Content fingerprint of the substitution rule set THIS compile's
    search would rewrite with: the generated registry for this (mesh,
    config, graph), or the loaded --substitution-json rules. A changed
    rule changes the plan address, so a stale cached plan can never
    replay against a different rule set. The generator module's own
    source digest is folded in as the coarse backstop: a closure-body
    edit changes rule SEMANTICS without changing the serialized
    structure."""
    from ..search import substitution as _subs

    class _MeshShim:
        shape = {k: int(v) for k, v in mesh_axes.items()}

    src_digest = _file_digest(getattr(_subs, "__file__", ""))
    try:
        if config.substitution_json_path:
            xfers = _subs.load_rule_collection(
                config.substitution_json_path, _MeshShim)
        else:
            xfers = _subs.generate_all_pcg_xfers(_MeshShim, config, graph)
        return f"{rules_fingerprint(xfers)}:{src_digest}"
    except Exception as e:
        # an unloadable rule file is its own distinct state (the compile
        # would fail differently): never crash the fingerprint
        return f"unloadable:{type(e).__name__}:{src_digest}"


def structural_fingerprint(graph, mesh_axes: dict, config,
                           opt_slots: int = 1, mfu: float = 0.4) -> str:
    """Measurement-free plan identity (see module docstring)."""
    return _sha({
        "v": 2,
        "graph": graph_signature(graph),
        "mesh": {k: int(v) for k, v in mesh_axes.items()},
        "config": config_signature(config),
        "device": device_signature(config.device),
        "opt_slots": int(opt_slots),
        "mfu": repr(float(mfu)),
        # the rule set the search would rewrite with is part of the
        # plan's identity (ffrules pass 5): a changed registry must
        # invalidate every cached plan searched under the old one
        "rules": rules_signature(graph, mesh_axes, config),
    })


def calibration_fingerprint(cost_model, graph) -> str:
    """Hash of the calibration entries the search would consume for this
    graph (restricted to the graph's ops — unrelated DB entries must not
    churn the address). repr() keeps full float precision."""
    from ..search.cost_model import _params_key
    from .calibration_db import serialize_key

    entries = []
    seen = set()
    for node in graph.topo_order():
        if not node.inputs or not node.outputs:
            continue
        key = _params_key(node)
        if key in seen:
            continue
        seen.add(key)
        cal = cost_model._calibration.get(key)
        if cal is not None:
            entries.append([serialize_key(key), repr(cal[0]), repr(cal[1])])
    # collective-hop entries (reserved OP_NOOP keys written by
    # CostModel.calibrate_collectives): they price the sp ring traffic
    # via collective_rotate, so a refreshed hop measurement must change
    # the plan address like any other calibration the search consumed.
    # Iteration is explicitly sorted (fflint unsorted_dict_hash): dict
    # order is insertion order, which differs between a process that
    # MEASURED the entries and one that LOADED them from the DB
    for key, cal in sorted(cost_model._calibration.items(),
                           key=lambda kv: serialize_key(kv[0])):
        name = key[1] if len(key) > 1 else ""
        if isinstance(name, str) and name.startswith("__collective_"):
            entries.append([serialize_key(key), repr(cal[0]), repr(cal[1])])
    entries.sort()
    return _sha({"v": 1, "calibration": entries})


def full_fingerprint(structural: str, calibration: str) -> str:
    """The plan-cache address: structure AND the measurements that priced
    the candidates."""
    return hashlib.sha256(
        f"{structural}:{calibration}".encode()).hexdigest()
