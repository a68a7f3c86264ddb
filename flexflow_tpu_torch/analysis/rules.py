"""ffrules: substitution-rule verifier — the fourth static-analysis layer
(twin of `flexflow_tpu/analysis/rules.py`).

TASO (Jia et al., SOSP '19 — PAPERS.md "Substitution verification") showed
that rewrite-based graph optimizers must formally verify every substitution
against operator semantics rather than trust the rule author; PET (Wang et
al., OSDI '21) extended the discipline to partially-equivalent transforms
with automated correction. Our Unity-style candidate generator
(search/substitution.py) ships ~30 hand-coded `GraphXfer` generators plus a
JSON loader that injects *external* rules straight into the search — this
module is the trust boundary that proves a rule is safe to hand to the
search before any candidate it produces can win a plan.

Five passes, reported through the ffcheck findings machinery
(docs/analysis.md "ffrules" has the catalog):

1. **symbolic shape/dtype transfer** — instantiate the rule's src pattern
   with dimension variables valued at distinct primes × the LCM of the
   rule's harvested divisibility constraints (Schwartz–Zippel style: two
   disagreeing shape polynomials cannot coincide on two independent prime
   assignments), apply the rewrite, and require identical global
   shape/dtype on every `mapped_output` — for *all* legal inputs, not the
   one a concrete test happened to use.
2. **parallel-state soundness** — `propagate_parallel_state` on the
   instantiated dst must yield a valid degree configuration: degree
   products conserved per dim at the rewrite boundary, replica-dim
   bookkeeping consistent, and no partial-sum state escaping into a
   nonlinear consumer (each mapped output is probed with a downstream
   nonlinear op — the generalization of
   `test_partial_sum_through_nonlinear_rejected` to the whole registry).
3. **semantic equivalence oracle** — auto-build a minimal concrete graph
   instantiating the src pattern, apply the rewrite, execute BOTH graphs
   through the port's `Executor` on a 1-device mesh on the caller's
   device, in f32 (TF32 off, as the executor sets it; no tensor-op
   downcast), with weights equal by name-seeded init (parallel ops are
   identities on one device), and assert 128-ULP-bounded equality
   forward and backward (parameter gradients through torch.autograd).
4. **precondition completeness** — fuzz near-boundary shapes (indivisible
   dims, degree == dim, rank-1 tiny extents) and require that the matcher
   refuses, the rewrite raises (candidate discarded — fail-safe), or the
   result stays sound; a rule that can match-and-corrupt is reported as
   `rule_matcher_unsound`.
5. **registry determinism** — `generate_all_pcg_xfers` must emit a
   stable, content-hashable rule set (sorted by name, deduped); the
   resulting `rules_fingerprint` joins the warm-start plan fingerprint
   (warmstart/fingerprint.py) so a changed rule set can never replay a
   stale cached plan.

Gate: `load_rule_collection` (search/substitution.py) verifies every JSON
rule at load through `gate_loaded_rules` — an unsound external rule raises
a structured `RuleVerificationError` naming the rule and finding class;
`--no-verify-rules` downgrades to a logged warning, and the verdict is
recorded in strategy_report.json's `analysis` section via the `rule_verify`
compile pass (`run`). `verify_registry` sweeps the full generated
registry (the JAX package's `scripts/ffrules.py` CLI has no twin yet);
`selftest_classes` is the corruption corpus.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from types import SimpleNamespace

from ..fftype import ActiMode, DataType, OperatorType as OT
from .findings import (
    AnalysisResult,
    Finding,
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
)

PASS_NAME = "rule_verify"

# Stable finding codes (the ffrules corruption self-test keys on them):
#   rule_shape_mismatch        mapped output's global shape changes
#   rule_dtype_mismatch        mapped output's dtype drifts
#   rule_replica_dim_leak      replica dim dropped/leaked at the boundary
#   rule_degree_violation      degree products not conserved per dim
#   rule_partial_sum_nonlinear partial sums escape into a nonlinear op
#   rule_numeric_divergence    oracle fwd/bwd mismatch beyond ULP bound
#   rule_matcher_unsound       matcher accepts a boundary shape the
#                              rewrite then corrupts (match-and-corrupt)
#   rule_verification_crash    verification itself crashed on the rule
#                              (malformed params/constraints) — refused
#   rule_registry_nondeterministic  generator emits an unstable rule set
#   rule_uninstantiable        verifier could not synthesize a legal
#                              instance (warning — rule unverified)
#   rule_unassignable          degrees carry no legal mesh-axis
#                              assignment on this mesh (warning)
#   rule_oracle_skipped        oracle skipped (fresh dst weights /
#                              non-float output) — info
#   rules_clean / rules_fingerprint   markers (info)

_ERROR_CODES = (
    "rule_shape_mismatch", "rule_dtype_mismatch", "rule_replica_dim_leak",
    "rule_degree_violation", "rule_partial_sum_nonlinear",
    "rule_numeric_divergence", "rule_matcher_unsound",
    "rule_verification_crash", "rule_registry_nondeterministic",
)


class RuleVerificationError(ValueError):
    """Raised by the load gate when a substitution rule fails
    verification and --no-verify-rules was not passed. Carries the full
    AnalysisResult; the message names the offending rule(s) and finding
    class(es) so a refused external rule file is actionable."""

    def __init__(self, result: AnalysisResult):
        self.result = result
        errs = result.errors()
        by_rule: dict[str, list[str]] = {}
        for f in errs:
            by_rule.setdefault(f.where or "<registry>", []).append(f.code)
        head = "; ".join(
            f"{rule}: {sorted(set(codes))}"
            for rule, codes in list(by_rule.items())[:4])
        more = f" (+{len(by_rule) - 4} more)" if len(by_rule) > 4 else ""
        super().__init__(
            f"substitution-rule verification failed for "
            f"{len(by_rule)} rule(s): {head}{more} — fix the rule or pass "
            f"--no-verify-rules to load anyway (findings downgrade to "
            f"warnings)")


class InstantiationError(ValueError):
    """The verifier could not build a legal concrete instance of a rule's
    src pattern (constraints unsatisfiable by the param synthesizer)."""


# ------------------------------------------------------------- dim contexts

def _lcm(values) -> int:
    out = 1
    for v in values:
        v = int(v)
        if v > 1:
            out = out * v // math.gcd(out, v)
    return out


def harvest_degrees(xfer, mesh_sizes: dict) -> list[int]:
    """Divisibility constraints a rule imposes: the degrees of every
    statically-evaluable dst parallel-op param, `mod` constraint divisors
    recorded by the JSON compiler, and the mesh axis sizes the rule's
    declared axes ride (so instance dims divide cleanly everywhere)."""
    degs = set()
    for dx in getattr(xfer, "dst_ops", ()):
        mk = getattr(dx, "make_params", None)
        if mk is None:
            continue
        try:
            p = mk({})
        except Exception:
            continue  # match-dependent params — degrees found elsewhere
        d = getattr(p, "degree", None)
        if isinstance(d, int):
            degs.add(d)
        for ax in getattr(p, "axes", ()) or ():
            s = mesh_sizes.get(ax)
            if isinstance(s, int):
                degs.add(s)
    for ops in (getattr(xfer, "src_ops", ()), getattr(xfer, "dst_ops", ())):
        for op in ops:
            for spec in getattr(op, "_constraint_specs", ()) or ():
                if "mod" in spec:
                    try:
                        degs.add(int(spec["mod"]))
                    except (TypeError, ValueError):
                        pass
    return sorted(d for d in degs if d > 1)


def _dim_env(L: int, scheme: str) -> dict:
    """One dimension-variable assignment. `sym1`/`sym2` value each dim
    role at a distinct prime × L (L = lcm of the rule's divisibility
    constraints) — the polynomial-identity-testing trick: a shape
    function the rewrite changes cannot agree on two independent prime
    assignments. `oracle` keeps extents small enough to execute;
    `indivisible`/`degree_eq`/`tiny` are the pass-4 boundary probes."""
    Lh = max(1, L)
    if scheme == "sym1":
        e = dict(B=5, F=7, O=11, S=3, C=2, HW=6, V=13, EH=17)
    elif scheme == "sym2":
        e = dict(B=13, F=5, O=7, S=11, C=3, HW=10, V=19, EH=23)
    elif scheme == "oracle":
        e = dict(B=2, F=2, O=3, S=2, C=1, HW=2, V=5, EH=2)
    elif scheme == "degree_eq":
        # every dim exactly at the largest divisibility boundary
        return dict(B=Lh, F=Lh, O=Lh, S=Lh, C=Lh, HW=2 * Lh, V=Lh + 5,
                    heads=Lh, E=2 * Lh, K=2, scheme=scheme)
    elif scheme == "indivisible":
        # L+1 is coprime to every divisor of L — no rule degree divides it
        n = Lh + 1
        return dict(B=n, F=n, O=n, S=n, C=n, HW=2 * n, V=n + 6,
                    heads=Lh, E=3 * Lh, K=2, scheme=scheme)
    elif scheme == "tiny":
        return dict(B=1, F=1, O=1, S=1, C=1, HW=2, V=3, heads=1, E=1,
                    K=1, scheme=scheme)
    else:
        raise ValueError(f"unknown dim scheme {scheme!r}")
    env = {k: v * Lh for k, v in e.items() if k != "EH"}
    env["heads"] = Lh
    env["E"] = Lh * e["EH"]
    env["K"] = 2
    env["scheme"] = scheme
    return env


# --------------------------------------------------------- param synthesis

def _unary_types():
    return (OT.OP_RELU, OT.OP_GELU, OT.OP_SIGMOID, OT.OP_TANH, OT.OP_ELU,
            OT.OP_IDENTITY, OT.OP_EXP, OT.OP_SIN, OT.OP_COS, OT.OP_RSQRT)


def _param_candidates(op_type: OT, env: dict, n_inputs: int,
                      prior_params: list):
    """Candidate param structs for one pattern op, most-common first; the
    synthesizer picks the first satisfying every opaque constraint."""
    from ..ops.attention import MultiHeadAttentionParams
    from ..ops.core import (
        Conv2DParams,
        EmbeddingParams,
        LinearParams,
        Pool2DParams,
        SoftmaxParams,
    )
    from ..ops.elementwise import ElementBinaryParams, ElementUnaryParams
    from ..ops.shape_ops import CastParams, ConcatParams

    acts = (ActiMode.AC_MODE_NONE, ActiMode.AC_MODE_RELU,
            ActiMode.AC_MODE_SIGMOID, ActiMode.AC_MODE_GELU,
            ActiMode.AC_MODE_TANH)
    if op_type == OT.OP_LINEAR:
        for act in acts:
            for ub in (True, False):
                yield LinearParams(env["O"], use_bias=ub, activation=act)
    elif op_type == OT.OP_MULTIHEAD_ATTENTION:
        yield MultiHeadAttentionParams(embed_dim=env["E"],
                                       num_heads=env["heads"])
    elif op_type == OT.OP_CONV2D:
        for act in (ActiMode.AC_MODE_NONE, ActiMode.AC_MODE_RELU):
            for ub in (True, False):
                yield Conv2DParams(env["O"], 3, 3, 1, 1, 1, 1, groups=1,
                                   use_bias=ub, activation=act)
    elif op_type == OT.OP_POOL2D:
        yield Pool2DParams(2, 2, 2, 2, 0, 0)
    elif op_type == OT.OP_SOFTMAX:
        yield SoftmaxParams(-1)
    elif op_type in _unary_types():
        yield ElementUnaryParams(op_type)
    elif op_type in (OT.OP_EW_ADD, OT.OP_EW_SUB, OT.OP_EW_MUL,
                     OT.OP_EW_DIV, OT.OP_EW_MAX, OT.OP_EW_MIN):
        yield ElementBinaryParams(op_type)
    elif op_type == OT.OP_CONCAT:
        yield ConcatParams(axis=1, n=max(2, n_inputs))
    elif op_type == OT.OP_EMBEDDING:
        yield EmbeddingParams(env["V"], env["O"])
    elif op_type == OT.OP_CAST:
        yield CastParams(DataType.DT_FLOAT)
    elif op_type == OT.OP_GROUP_BY:
        from ..ops.moe import GroupByParams

        for n in (2, 4, 3, 1, 5, 6, 7, 8):
            yield GroupByParams(n, 1.0)
    elif op_type == OT.OP_AGGREGATE:
        from ..ops.moe import AggregateParams

        gb_n = next((p.n for p in prior_params
                     if hasattr(p, "n") and hasattr(p, "alpha")), 2)
        yield AggregateParams(gb_n)
    else:
        yield None


def _apply_spec_hints(params, specs, env):
    """Honor the JSON compiler's recorded eq/mod constraint specs on a
    candidate (opaque closures are probed instead)."""
    if params is None or not specs:
        return params
    for spec in specs:
        attr = spec.get("attr")
        if not attr or not hasattr(params, attr):
            return None
        try:
            if "eq" in spec:
                from ..search.substitution import _resolve_attr_value

                params = dataclasses.replace(
                    params, **{attr: _resolve_attr_value(spec["eq"])})
            elif "mod" in spec:
                d = int(spec["mod"])
                v = int(getattr(params, attr))
                if d > 0 and v % d:
                    params = dataclasses.replace(
                        params, **{attr: v + (-v % d)})
        except (TypeError, ValueError):
            return None
    return params


def _synthesize_params(px, env: dict, prior_params: list):
    specs = getattr(px, "_constraint_specs", ()) or ()
    for cand in _param_candidates(px.op_type, env, len(px.inputs),
                                  prior_params):
        cand = _apply_spec_hints(cand, specs, env)
        if cand is None and specs:
            continue
        probe = SimpleNamespace(params=cand)
        try:
            if all(c(probe) for c in px.constraints):
                return cand
        except Exception:
            continue
    raise InstantiationError(
        f"no synthesizable params satisfy the constraints of pattern op "
        f"{px.op_type.name}")


def _slot_template(op_type: OT, pos: int, env: dict, params):
    """(logical shape, dtype) of a free input slot, keyed by its first
    consumer's op type and argument position."""
    f32, i32 = DataType.DT_FLOAT, DataType.DT_INT32
    if op_type == OT.OP_MULTIHEAD_ATTENTION:
        return (env["B"], env["S"], env["E"]), f32
    if op_type in (OT.OP_CONV2D, OT.OP_POOL2D):
        return (env["B"], env["C"], env["HW"], env["HW"]), f32
    if op_type == OT.OP_EMBEDDING:
        return (env["B"], env["S"]), i32
    if op_type == OT.OP_GROUP_BY:
        if pos == 1:
            return (env["B"], env["K"]), i32
        return (env["B"], env["F"]), f32
    if op_type == OT.OP_AGGREGATE:
        if pos in (1, 2):
            return (env["B"], env["K"]), i32
        if pos == 3:
            return (env["B"], getattr(params, "n", 2)), f32
        return (env["B"], env["K"]), f32
    return (env["B"], env["F"]), f32


# ------------------------------------------------------------ instantiation

def instantiate_rule(xfer, env: dict):
    """Build a minimal concrete PCG instantiating `xfer`'s src pattern,
    with one nonlinear probe consumer per mapped output (the probe is how
    a partial-sum replica dim escaping the rewrite is detected, and how
    the mapped dst tensor is recovered after `apply` by name).

    Returns (graph, node_by_opx, probe_names). Raises InstantiationError
    when the pattern cannot be legally instantiated under `env`."""
    from ..pcg.graph import Graph, OpNode
    from ..search.substitution import propagate_parallel_state
    from ..tensor import ParallelTensor, ParallelTensorShape

    g = Graph()
    node_by_opx: dict = {}
    input_nodes: dict[int, OpNode] = {}
    prior_params: list = []

    def _out_dtype(op_type, params, in_dtypes):
        if op_type == OT.OP_EMBEDDING:
            return params.data_type
        if op_type == OT.OP_CAST:
            return params.dtype
        return in_dtypes[0] if in_dtypes else DataType.DT_FLOAT

    for i, px in enumerate(xfer.src_ops):
        params = _synthesize_params(px, env, prior_params)
        prior_params.append(params)
        wired = []
        for pos, tx in enumerate(px.inputs):
            if tx.op is None:
                node = input_nodes.get(tx.idx)
                if node is None:
                    shape, dt = _slot_template(px.op_type, pos, env, params)
                    node = OpNode(OT.OP_INPUT, None,
                                  name=f"__ffrules_in_{tx.idx}")
                    node.outputs = [ParallelTensor(
                        ParallelTensorShape.from_shape(shape, dt),
                        name=node.name)]
                    g.add_node(node)
                    input_nodes[tx.idx] = node
                wired.append((node, 0))
            else:
                src = node_by_opx.get(tx.op)
                if src is None:
                    raise InstantiationError(
                        f"pattern op input references an op declared "
                        f"later ({px.op_type.name} slot {pos})")
                wired.append((src, tx.idx))
        node = OpNode(px.op_type, params,
                      name=f"__ffrules_{px.op_type.name.lower()}_{i}")
        g.add_node(node)
        for pos, (src, sidx) in enumerate(wired):
            if sidx >= len(src.outputs):
                raise InstantiationError(
                    f"{src.name} has no output {sidx}")
            g.add_edge(src, node, sidx, pos)
        in_shapes = [src.outputs[sidx].shape.logical_shape
                     for src, sidx in wired]
        in_dtypes = [src.outputs[sidx].dtype for src, sidx in wired]
        try:
            node.weight_specs = node.op_def.weights(params, in_shapes)
        except NotImplementedError:
            node.weight_specs = []
        except Exception as e:
            raise InstantiationError(
                f"{px.op_type.name}.weights() rejected the instance: {e}")
        try:
            outs = node.op_def.infer_shapes(params, in_shapes)
        except Exception as e:
            raise InstantiationError(
                f"{px.op_type.name}.infer_shapes() rejected the "
                f"instance: {e}")
        dt = _out_dtype(px.op_type, params, in_dtypes)
        node.outputs = [ParallelTensor(
            ParallelTensorShape.from_shape(s, dt),
            name=f"{node.name}_out{j}") for j, s in enumerate(outs)]
        node_by_opx[px] = node

    from ..ops.elementwise import ElementUnaryParams

    probe_names = []
    for j, (src_tx, _) in enumerate(xfer.mapped_outputs):
        owner = node_by_opx.get(src_tx.op)
        if owner is None:
            raise InstantiationError("mapped output names no source op")
        probe = OpNode(OT.OP_RELU, ElementUnaryParams(OT.OP_RELU),
                       name=f"__ffrules_probe_{j}")
        g.add_node(probe)
        g.add_edge(owner, probe, src_tx.idx, 0)
        probe_names.append(probe.name)

    try:
        propagate_parallel_state(g)
    except ValueError as e:
        raise InstantiationError(f"src instance has invalid state: {e}")
    return g, node_by_opx, probe_names


def _intended_match(xfer, graph, node_by_opx):
    """The match binding each pattern op to the node we instantiated for
    it (the matcher may also bind probes; those are instrumentation
    artifacts, not the rule's own match)."""
    for m in xfer.find_matches(graph):
        if all(m.ops.get(px) is node for px, node in node_by_opx.items()):
            return m
    return None


def _mapped_pairs(src_graph, dst_graph, probe_names):
    """[(src tensor, dst tensor)] per mapped output, recovered through the
    probe consumers (clones keep names across `apply`)."""
    def probe_input(g, name):
        node = next(n for n in g.topo_order() if n.name == name)
        e = sorted(g.in_edges[node.guid], key=lambda e: e.dst_idx)[0]
        return g.nodes[e.src].outputs[e.src_idx]

    return [(probe_input(src_graph, nm), probe_input(dst_graph, nm))
            for nm in probe_names]


def _classify_apply_error(e: Exception) -> str:
    s = str(e).lower()
    if "nonlinear" in s or "partial" in s or "identical replicas" in s:
        return "rule_partial_sum_nonlinear"
    if "replica" in s:
        return "rule_replica_dim_leak"
    return "rule_degree_violation"


# ------------------------------------------------------------------ passes

def _check_transfer(xfer, env: dict, where: str,
                    fuzz: bool = False) -> list[Finding]:
    """Passes 1+2 (and, with fuzz=True, pass 4) on one dim assignment:
    instantiate, match, apply, compare the mapped boundary tensors."""
    sev = SEV_ERROR
    unsound = "rule_matcher_unsound" if fuzz else None

    def finding(code, msg, **details):
        return Finding(sev, unsound or code, msg, pass_name=PASS_NAME,
                       where=where,
                       details={"scheme": env.get("scheme"),
                                "underlying": code, **details})

    try:
        g, node_by_opx, probes = instantiate_rule(xfer, env)
    except InstantiationError as e:
        if fuzz:
            return []  # boundary instance illegal — nothing to match
        return [Finding(SEV_WARNING, "rule_uninstantiable",
                        f"could not instantiate src pattern: {e}",
                        pass_name=PASS_NAME, where=where,
                        details={"scheme": env.get("scheme")})]
    m = _intended_match(xfer, g, node_by_opx)
    if m is None:
        if fuzz:
            return []  # matcher refused the boundary shape — sound
        return [Finding(SEV_WARNING, "rule_uninstantiable",
                        "matcher does not match its own src pattern on a "
                        "legal instance", pass_name=PASS_NAME, where=where,
                        details={"scheme": env.get("scheme")})]
    try:
        ng = xfer.apply(g, m)
    except (ValueError, TypeError) as e:
        # TypeError covers malformed external rules whose params crash
        # the shape transforms — same refusal path, attributed
        if fuzz:
            return []  # rewrite refused the candidate — fail-safe
        code = _classify_apply_error(e)
        return [finding(code,
                        f"rewrite raises on every legal instance "
                        f"({type(e).__name__}: {e})")]

    out = []
    for j, (src_pt, dst_pt) in enumerate(_mapped_pairs(g, ng, probes)):
        tag = f"mapped_output {j}"
        if src_pt.shape.logical_shape != dst_pt.shape.logical_shape:
            out.append(finding(
                "rule_shape_mismatch",
                f"{tag}: global shape {src_pt.shape.logical_shape} -> "
                f"{dst_pt.shape.logical_shape}",
                src=repr(src_pt.shape), dst=repr(dst_pt.shape)))
            continue
        if src_pt.dtype != dst_pt.dtype:
            out.append(finding(
                "rule_dtype_mismatch",
                f"{tag}: dtype {src_pt.dtype.name} -> "
                f"{dst_pt.dtype.name}"))
        if (src_pt.shape.num_replica_dims
                != dst_pt.shape.num_replica_dims):
            out.append(finding(
                "rule_replica_dim_leak",
                f"{tag}: replica dims {src_pt.shape.num_replica_dims} -> "
                f"{dst_pt.shape.num_replica_dims} (a consumer outside the "
                f"rewrite would silently see replicated state)",
                src=repr(src_pt.shape), dst=repr(dst_pt.shape)))
            continue
        src_deg = [d.degree for d in src_pt.shape.dims
                   if not d.is_replica_dim]
        dst_deg = [d.degree for d in dst_pt.shape.dims
                   if not d.is_replica_dim]
        if src_deg != dst_deg:
            out.append(finding(
                "rule_degree_violation",
                f"{tag}: per-dim degrees {src_deg} -> {dst_deg} — the "
                f"rewrite changes the boundary tensor's parallel state "
                f"without combining back",
                src=repr(src_pt.shape), dst=repr(dst_pt.shape)))
    return out


def _check_assignable(xfer, env: dict, mesh_sizes: dict,
                      where: str) -> list[Finding]:
    """Pass-2 tail: the rewritten graph's degrees must admit a mesh-axis
    assignment on this mesh (axis products carry the degrees, no axis
    reused within one tensor)."""
    from ..search.substitution import assign_axes_from_degrees

    try:
        g, node_by_opx, _ = instantiate_rule(xfer, env)
        m = _intended_match(xfer, g, node_by_opx)
        if m is None:
            return []
        ng = xfer.apply(g, m)
    except (InstantiationError, ValueError):
        return []  # already reported by _check_transfer
    shim = SimpleNamespace(shape=dict(mesh_sizes))
    try:
        assign_axes_from_degrees(ng, shim)
    except ValueError as e:
        return [Finding(
            SEV_WARNING, "rule_unassignable",
            f"rewritten degrees admit no mesh-axis assignment on "
            f"{dict(mesh_sizes)}: {e}", pass_name=PASS_NAME, where=where)]
    return []


def _oracle_config(device: str = "cpu"):
    import sys

    from ..config import FFConfig

    saved = sys.argv
    sys.argv = saved[:1] or ["ffrules"]
    try:
        cfg = FFConfig(device=device)
    finally:
        sys.argv = saved
    cfg.mesh_axis_sizes = tuple(
        1 for _ in cfg.mesh_shape().axis_names)
    cfg.batch_size = 1
    # f32 on every device: no bf16 tensor-op input cast on the card
    cfg.allow_tensor_op_math_conversion = False
    cfg.computation_dtype = None
    return cfg


def _ulp_close(a, b, ulps: int = 128) -> bool:
    import numpy as np

    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    if not np.issubdtype(a.dtype, np.floating):
        return bool(np.array_equal(a, b))
    eps = float(np.finfo(a.dtype).eps)
    scale = max(1.0, float(np.max(np.abs(a))) if a.size else 1.0)
    return bool(np.allclose(np.asarray(a, np.float64),
                            np.asarray(b, np.float64),
                            rtol=ulps * eps, atol=ulps * eps * scale))


def _check_oracle(xfer, env: dict, where: str,
                  device: str = "cpu") -> list[Finding]:
    """Pass 3: execute src and rewritten graphs through the port's
    executor on a 1-device mesh on `device` and require ULP-bounded
    equality fwd + bwd. Weight equality across the two graphs is by
    construction: `init_variables` seeds every weight by (node name,
    weight name), and `apply` carries names through the rewrite."""
    import numpy as np
    import torch

    from ..executor import Executor
    from ..fftype import LossType
    from ..machine import build_mesh
    from ..metrics import Metrics
    from ..optimizer import SGDOptimizer

    def finding(code, msg, **details):
        return Finding(SEV_ERROR, code, msg, pass_name=PASS_NAME,
                       where=where, details={"scheme": "oracle", **details})

    try:
        g, node_by_opx, probes = instantiate_rule(xfer, env)
        m = _intended_match(xfer, g, node_by_opx)
        if m is None:
            raise InstantiationError("matcher found no match")
        ng = xfer.apply(g, m)
    except (InstantiationError, ValueError):
        return []  # pass 1/2 report instantiation/apply problems
    # fresh dst compute ops declare NEW weights the rewrite re-initializes
    # — numerics are not name-comparable
    matched_names = {n.name for n in node_by_opx.values()}
    for node in ng.topo_order():
        if (node.weight_specs and node.name not in matched_names
                and not node.name.startswith("__ffrules_")):
            return [Finding(
                SEV_INFO, "rule_oracle_skipped",
                f"dst op {node.name} declares fresh weights — oracle "
                f"compares name-seeded weights only", pass_name=PASS_NAME,
                where=where)]

    dev = torch.device(device)
    cfg = _oracle_config(dev.type)
    mesh = build_mesh(cfg.mesh_shape(), dev)
    loss = LossType.LOSS_IDENTITY
    metrics = Metrics.from_list(loss, [])
    opt = SGDOptimizer(lr=0.01)
    rs = np.random.RandomState(0)

    # one shared input dict (both graphs name inputs identically); int
    # inputs stay in the consumer's legal index range
    def _int_hi(graph, node):
        for e in graph.out_edges[node.guid]:
            dst = graph.nodes[e.dst]
            if dst.op_type == OT.OP_EMBEDDING:
                return dst.params.num_entries
            if dst.op_type == OT.OP_GROUP_BY and e.dst_idx == 1:
                return dst.params.n
            if dst.op_type == OT.OP_AGGREGATE and e.dst_idx in (1, 2):
                return dst.params.n
        return env["V"]

    inputs = {}
    for node in g.topo_order():
        if node.op_type != OT.OP_INPUT:
            continue
        shape = node.outputs[0].shape.logical_shape
        if node.outputs[0].dtype == DataType.DT_INT32:
            arr = rs.randint(0, max(2, _int_hi(g, node)),
                             shape).astype(np.int32)
        else:
            arr = rs.randn(*shape).astype(np.float32)
        inputs[node.name] = torch.from_numpy(arr).to(dev)

    def run(graph):
        probe = next(n for n in graph.topo_order()
                     if n.name == probes[0])
        e = sorted(graph.in_edges[probe.guid], key=lambda e: e.dst_idx)[0]
        mapped = graph.nodes[e.src]
        ex = Executor(graph, cfg, dev, mapped, loss, metrics, opt,
                      mesh=mesh)
        params, state = ex.init_variables(0)
        with torch.no_grad():
            out, _ = ex._apply(params, state, inputs, training=False)
        grads = None
        if torch.is_floating_point(out):
            leaves = [(n, w, t) for n, ws in sorted(params.items())
                      for w, t in sorted(ws.items())]
            for _, _, t in leaves:
                t.requires_grad_(True)
            flat = []
            if leaves:
                o, _ = ex._apply(params, state, inputs, training=False)
                flat = torch.autograd.grad(
                    o.float().sum(), [t for _, _, t in leaves],
                    allow_unused=True)
            grads = {}
            for (n, w, t), gr in zip(leaves, flat):
                grads.setdefault(n, {})[w] = (
                    torch.zeros_like(t) if gr is None else gr)
        host = {n: {w: t.detach().cpu().numpy() for w, t in ws.items()}
                for n, ws in params.items()}
        if grads is not None:
            grads = {n: {w: t.detach().cpu().numpy() for w, t in ws.items()}
                     for n, ws in grads.items()}
        return out.detach().cpu().numpy(), grads, host

    try:
        out_a, grads_a, params_a = run(g)
    except Exception as e:
        return [Finding(
            SEV_WARNING, "rule_oracle_skipped",
            f"oracle could not execute the SRC instance "
            f"({type(e).__name__}: {e}) — numerics unverified",
            pass_name=PASS_NAME, where=where)]
    try:
        out_b, grads_b, params_b = run(ng)
    except Exception as e:
        # the source instance executed fine and the REWRITTEN graph did
        # not: the rule emits graphs that crash at runtime
        return [finding(
            "rule_numeric_divergence",
            f"rewritten graph fails to execute "
            f"({type(e).__name__}: {e})")]

    out = []
    a, b = np.asarray(out_a), np.asarray(out_b)
    if a.dtype != b.dtype:
        out.append(finding(
            "rule_dtype_mismatch",
            f"executed mapped output dtype {a.dtype} -> {b.dtype}"))
    elif a.shape != b.shape:
        out.append(finding(
            "rule_shape_mismatch",
            f"executed mapped output shape {a.shape} -> {b.shape}"))
    elif not _ulp_close(a, b):
        diff = float(np.max(np.abs(a.astype(np.float64)
                                   - b.astype(np.float64))))
        out.append(finding(
            "rule_numeric_divergence",
            f"forward mapped output diverges (max |delta| = {diff:.3e} "
            f"beyond the {a.dtype} ULP bound)", max_abs_delta=diff))
    if grads_a is not None and grads_b is not None and not out:
        for name in sorted(set(params_a) & set(params_b)):
            for w in sorted(set(params_a[name]) & set(params_b[name])):
                ga = np.asarray(grads_a[name][w])
                gb = np.asarray(grads_b[name][w])
                if ga.shape != gb.shape or not _ulp_close(ga, gb,
                                                          ulps=256):
                    out.append(finding(
                        "rule_numeric_divergence",
                        f"backward diverges on d/d({name}.{w})"))
                    return out
    return out


# --------------------------------------------------------------- serialize

def serialize_rule(xfer) -> dict:
    """Canonical JSON-able description of a GraphXfer: structure, static
    params, constraint specs where the JSON compiler recorded them, and
    opaque-constraint counts. This is what the registry fingerprint and
    the determinism check hash."""
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
    """Content hash of a rule set — order-free (entries sorted), so it
    joins the warm-start plan fingerprint as a stable component: a
    changed/added/removed rule changes the plan address and a stale
    cached plan can never replay against a different rule set."""
    entries = sorted(
        json.dumps(serialize_rule(x), sort_keys=True) for x in xfers)
    return hashlib.sha256(
        json.dumps({"v": 1, "rules": entries}).encode()).hexdigest()


# ------------------------------------------------------------- entry points

def verify_rule(xfer, mesh, *, oracle: bool = True,
                fuzz: bool = True, device: str = "cpu") -> list[Finding]:
    """All per-rule passes (1-4) on one GraphXfer. `mesh` is anything
    with a `.shape` mapping (a Mesh or a {axis: size} shim); the oracle
    executes on `device`."""
    sizes = dict(getattr(mesh, "shape", mesh))
    where = f"rule:{xfer.name}"
    key = (json.dumps(serialize_rule(xfer), sort_keys=True),
           tuple(sorted(sizes.items())), bool(oracle), bool(fuzz),
           str(device))
    cached = _VERIFY_CACHE.get(key)
    if cached is not None:
        return list(cached)
    L = _lcm(harvest_degrees(xfer, sizes) + [s for s in sizes.values()])
    findings: list[Finding] = []
    # pass 1+2: symbolic transfer on two independent prime assignments
    for scheme in ("sym1", "sym2"):
        findings.extend(_check_transfer(xfer, _dim_env(L, scheme), where))
        if findings:
            break  # one assignment suffices to refuse; skip the second
    if not any(f.severity == SEV_ERROR for f in findings):
        findings.extend(
            _check_assignable(xfer, _dim_env(L, "sym1"), sizes, where))
        # pass 3: semantic equivalence oracle
        if oracle:
            findings.extend(
                _check_oracle(xfer, _dim_env(L, "oracle"), where, device))
        # pass 4: precondition completeness (boundary fuzz)
        if fuzz:
            for scheme in ("indivisible", "degree_eq", "tiny"):
                findings.extend(_check_transfer(
                    xfer, _dim_env(L, scheme), where, fuzz=True))
    _VERIFY_CACHE[key] = list(findings)
    return findings


_VERIFY_CACHE: dict = {}


def verify_rules(xfers, mesh, *, oracle: bool = True,
                 fuzz: bool = True, device: str = "cpu") -> AnalysisResult:
    """Verify a rule list (passes 1-4 per rule)."""
    import time

    xfers = list(xfers)
    result = AnalysisResult(passes_run=[PASS_NAME])
    t0 = time.perf_counter()
    for x in xfers:
        try:
            fs = verify_rule(x, mesh, oracle=oracle, fuzz=fuzz,
                             device=device)
        except Exception as e:
            # a rule that CRASHES verification (malformed params the
            # transforms choke on, a constraint that raises) is refused
            # with a structured error, never a raw traceback through
            # the load gate
            fs = [Finding(
                SEV_ERROR, "rule_verification_crash",
                f"rule crashed verification ({type(e).__name__}: {e}) "
                f"— an unverifiable rule cannot be trusted",
                pass_name=PASS_NAME,
                where=f"rule:{getattr(x, 'name', '?')}")]
        result.extend(fs, pass_name=PASS_NAME)
    if result.ok:
        result.extend([Finding(
            SEV_INFO, "rules_clean",
            f"{len(xfers)} rule(s) verified clean",
            pass_name=PASS_NAME,
            details={"fingerprint": rules_fingerprint(xfers),
                     "rules": len(xfers)})])
    result.elapsed_s = time.perf_counter() - t0
    return result


def verify_registry(mesh, config, graph=None, *, oracle: bool = True,
                    fuzz: bool = True, device: str = "cpu") -> AnalysisResult:
    """Pass 5 + per-rule passes over the FULL generated registry: two
    independent generator runs must serialize identically, sorted by name
    and deduped, and every rule must verify clean."""
    from ..search.substitution import generate_all_pcg_xfers

    shim = (mesh if hasattr(mesh, "shape")
            else SimpleNamespace(shape=dict(mesh)))
    a = generate_all_pcg_xfers(shim, config, graph)  # fflint: ok unverified_rule_load
    b = generate_all_pcg_xfers(shim, config, graph)  # fflint: ok unverified_rule_load
    findings: list[Finding] = []
    sa = [json.dumps(serialize_rule(x), sort_keys=True) for x in a]
    sb = [json.dumps(serialize_rule(x), sort_keys=True) for x in b]
    if sa != sb:
        findings.append(Finding(
            SEV_ERROR, "rule_registry_nondeterministic",
            "two generate_all_pcg_xfers runs serialize differently — the "
            "registry fingerprint (and the warm-start plan address) would "
            "churn per process", pass_name=PASS_NAME))
    names = [x.name for x in a]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        findings.append(Finding(
            SEV_ERROR, "rule_registry_nondeterministic",
            f"registry contains duplicate rule names: {dupes[:4]}",
            pass_name=PASS_NAME))
    if names != sorted(names):
        findings.append(Finding(
            SEV_ERROR, "rule_registry_nondeterministic",
            "registry is not name-sorted — emission order is not a "
            "stable content address", pass_name=PASS_NAME))
    result = verify_rules(a, mesh, oracle=oracle, fuzz=fuzz, device=device)
    result.findings = findings + result.findings
    return result


# ------------------------------------------------- corruption self-test

def selftest_classes() -> list:
    """The corruption corpus: one deliberately-unsound GraphXfer per
    unsound-rule class, each expected to be caught as EXACTLY its class.
    The same corpus as the JAX package's (tests/test_torch_ffrules.py
    holds each class to its code). Returns [(class name, xfer, expected
    finding code)]."""
    from ..ops.shape_ops import CastParams
    from ..parallel.ops import (
        ReductionParams,
        RepartitionParams,
        ReplicateParams,
    )
    from ..search.substitution import GraphXfer, OpX

    def lin_src(x):
        inp = x.new_input(0)
        return inp, OpX(OT.OP_LINEAR, (inp,), constraints=(
            lambda n: n.params.activation == ActiMode.AC_MODE_NONE,))

    out = []

    # 1) wrong output shape: the dst op silently doubles out_channels
    x = GraphXfer("selftest_wrong_output_shape")
    inp, lin1 = lin_src(x)
    bad = OpX(OT.OP_LINEAR, (inp,), match_src=lin1,
              make_params=lambda m, s=lin1: dataclasses.replace(
                  m[s].params, out_channels=m[s].params.out_channels * 2))
    x.src_ops = [lin1]
    x.dst_ops = [bad]
    x.map_output(lin1.outputs[0], bad.outputs[0])
    out.append(("wrong_output_shape", x, "rule_shape_mismatch"))

    # 2) dtype drift: a bf16 cast interposed before the mapped output
    x = GraphXfer("selftest_dtype_drift")
    inp, lin1 = lin_src(x)
    lin2 = OpX(OT.OP_LINEAR, (inp,), match_src=lin1)
    cast = OpX(OT.OP_CAST, (lin2.outputs[0],),
               make_params=lambda m: CastParams(DataType.DT_BFLOAT16))
    x.src_ops = [lin1]
    x.dst_ops = [lin2, cast]
    x.map_output(lin1.outputs[0], cast.outputs[0])
    out.append(("dtype_drift", x, "rule_dtype_mismatch"))

    # 3) dropped replica dim: Replicate inserted, never combined/reduced
    x = GraphXfer("selftest_dropped_replica_dim")
    inp = x.new_input(0)
    r1 = OpX(OT.OP_RELU, (inp,))
    repl = OpX(OT.OP_REPLICATE, (inp,),
               make_params=lambda m: ReplicateParams(2, ("data",)))
    r2 = OpX(OT.OP_RELU, (repl.outputs[0],), match_src=r1)
    x.src_ops = [r1]
    x.dst_ops = [repl, r2]
    x.map_output(r1.outputs[0], r2.outputs[0])
    out.append(("dropped_replica_dim", x, "rule_replica_dim_leak"))

    # 4) degree-product violation: Repartition with no Combine back —
    # the boundary tensor leaves the rewrite sharded
    x = GraphXfer("selftest_degree_product_violation")
    inp, lin1 = lin_src(x)
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, 2, ("data",)))
    lin2 = OpX(OT.OP_LINEAR, (rep.outputs[0],), match_src=lin1)
    x.src_ops = [lin1]
    x.dst_ops = [rep, lin2]
    x.map_output(lin1.outputs[0], lin2.outputs[0])
    out.append(("degree_product_violation", x, "rule_degree_violation"))

    # 5) partial sums through a nonlinear op: row-parallel Linear's
    # partial-sum output fed through ReLU before the Reduction
    x = GraphXfer("selftest_partial_sum_nonlinear")
    inp, lin1 = lin_src(x)
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(1, 2, ("data",)))
    lin2 = OpX(OT.OP_LINEAR, (rep.outputs[0],), match_src=lin1)
    relu = OpX(OT.OP_RELU, (lin2.outputs[0],))
    red = OpX(OT.OP_REDUCTION, (relu.outputs[0],),
              make_params=lambda m: ReductionParams(2, ("data",)))
    x.src_ops = [lin1]
    x.dst_ops = [rep, lin2, relu, red]
    x.map_output(lin1.outputs[0], red.outputs[0])
    out.append(("partial_sum_nonlinear", x, "rule_partial_sum_nonlinear"))

    # 6) matcher accepting indivisible dims: on even out_channels the
    # rewrite is the identity (every non-boundary pass is clean); on an
    # odd boundary shape it silently truncates the feature dim —
    # match-and-corrupt, exactly what precondition fuzzing exists for
    x = GraphXfer("selftest_matcher_indivisible")
    inp, lin1 = lin_src(x)
    bad = OpX(OT.OP_LINEAR, (inp,), match_src=lin1,
              make_params=lambda m, s=lin1: dataclasses.replace(
                  m[s].params,
                  out_channels=(m[s].params.out_channels // 2) * 2))
    x.src_ops = [lin1]
    x.dst_ops = [bad]
    x.map_output(lin1.outputs[0], bad.outputs[0])
    out.append(("matcher_indivisible", x, "rule_matcher_unsound"))

    # 7) numeric divergence with identical shape/dtype/parallel state:
    # the rewrite silently swaps in a sigmoid activation
    x = GraphXfer("selftest_numeric_divergence")
    inp, lin1 = lin_src(x)
    bad = OpX(OT.OP_LINEAR, (inp,), match_src=lin1,
              make_params=lambda m, s=lin1: dataclasses.replace(
                  m[s].params, activation=ActiMode.AC_MODE_SIGMOID))
    x.src_ops = [lin1]
    x.dst_ops = [bad]
    x.map_output(lin1.outputs[0], bad.outputs[0])
    out.append(("numeric_divergence", x, "rule_numeric_divergence"))
    return out


# ----------------------------------------------------------- the load gate

# load-time verdicts per JSON rule file (abspath), surfaced into
# strategy_report.json's analysis section by the rule_verify compile pass
_LOAD_RESULTS: dict[str, AnalysisResult] = {}


def gate_loaded_rules(xfers, mesh, config, path: str) -> AnalysisResult:
    """Verify externally-loaded (JSON) rules at load time. Errors raise
    RuleVerificationError naming rule + finding class unless
    --no-verify-rules, which downgrades to a logged warning; either way
    the verdict is recorded for the compile report. The oracle runs on
    the config's device."""
    from ..telemetry import log as fflog

    result = verify_rules(xfers, mesh,
                          device=str(getattr(config, "device", "cpu")))
    # the compile pass (run) reuses these instead of re-loading the file
    result.rules_fingerprint = rules_fingerprint(xfers)
    result.rules_count = len(list(xfers))
    _LOAD_RESULTS[os.path.abspath(path)] = result
    errs = result.errors()
    if errs:
        if getattr(config, "verify_rules", True):
            raise RuleVerificationError(result)
        fflog.warning(
            "ffrules: %d unsound substitution rule(s) in %s "
            "(--no-verify-rules: loading anyway): %s", len(errs), path,
            "; ".join(str(f) for f in errs[:5]))
    return result


# ------------------------------------------------- compile-gate pass hook

def run(graph, mesh, ctx) -> list[Finding]:
    """The `rule_verify` entry in the ffcheck pass pipeline. Cheap by
    design (the full per-rule verification runs at rule LOAD time, not
    per compile): it surfaces the
    recorded load-time verdict for --substitution-json files (errors
    downgraded — load already gated) and stamps the active rule set's
    fingerprint into the report so the plan is auditable against the
    rules that searched it."""
    cfg = getattr(ctx, "config", None)
    if cfg is None:
        return []
    path = getattr(cfg, "substitution_json_path", None) or ""
    # mirror the do_search trigger in FFModel._compile_impl: ANY compile
    # that could have rewritten its graph carries a rule-set fingerprint
    # in the report (a budget-only search uses the generated registry
    # just as much as --enable-substitutions does)
    sizes = dict(getattr(mesh, "shape", {}) or {})
    n_dev = 1
    for v in sizes.values():
        n_dev *= int(v)
    uses_rules = (
        n_dev > 1
        and not getattr(cfg, "only_data_parallel", False)
        and (bool(path)
             or getattr(cfg, "enable_substitutions", False)
             or getattr(cfg, "search_budget", 0) > 0
             or getattr(cfg, "enable_parameter_parallel", False)
             or getattr(cfg, "enable_attribute_parallel", False)))
    # a manual/imported plan was never produced by THIS rule set — the
    # do_search gate (`self._strategy is None`) skips the search for
    # those sources, so a stamped fingerprint would claim an audit
    # trail the plan doesn't have. Cache/checkpoint replays keep the
    # stamp: their plan address already includes the rules component,
    # so the active rule set IS the one that searched them.
    if getattr(ctx, "plan_source", "") in ("manual", "import"):
        uses_rules = False
    if not uses_rules:
        return []
    findings: list[Finding] = []
    res = _LOAD_RESULTS.get(os.path.abspath(path)) if path else None
    if res is not None:
        for f in res.findings:
            sev = SEV_WARNING if f.severity == SEV_ERROR else f.severity
            findings.append(Finding(
                sev, f.code, f.message, pass_name=PASS_NAME,
                where=f.where, details=dict(f.details)))
    fp_known = getattr(res, "rules_fingerprint", None)
    if fp_known:
        # the load gate already fingerprinted exactly this rule set —
        # don't re-read and re-compile the file per compile
        findings.append(Finding(
            SEV_INFO, "rules_fingerprint",
            f"active substitution rule set: "
            f"{res.rules_count} rule(s)",
            pass_name=PASS_NAME,
            details={"fingerprint": fp_known, "rules": res.rules_count,
                     "source": "json"}))
        return findings
    try:
        from ..search.substitution import (
            generate_all_pcg_xfers,
            load_rule_collection,
        )

        if path:
            # fingerprint only: the search's own load site is the
            # verifying gate for this file
            xfers = load_rule_collection(path, mesh)  # fflint: ok unverified_rule_load
        else:
            xfers = generate_all_pcg_xfers(mesh, cfg, graph)  # fflint: ok unverified_rule_load
        findings.append(Finding(
            SEV_INFO, "rules_fingerprint",
            f"active substitution rule set: {len(xfers)} rule(s)",
            pass_name=PASS_NAME,
            details={"fingerprint": rules_fingerprint(xfers),
                     "rules": len(xfers),
                     "source": "json" if path else "generated"}))
    except Exception as e:
        findings.append(Finding(
            SEV_WARNING, "rules_fingerprint",
            f"active rule set could not be fingerprinted: {e}",
            pass_name=PASS_NAME))
    return findings
