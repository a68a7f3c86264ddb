"""ffcheck: static plan verification and hazard lint as a compile gate
(twin of `flexflow_tpu/analysis/`).

GSPMD (Xu et al. 2021, PAPERS.md "Analysis") frames sharding propagation
as a dataflow analysis that can run independently of the executor; Unity
searched plans (PAPER.md §0) are only as trustworthy as the invariants
verifiable before launch. This package is that verifier for the port: a
pass pipeline over (PCG, Strategy, mesh) that `FFModel.compile` runs on
EVERY plan source (search | cache | checkpoint | import | manual |
default | broadcast) after the executor is built and before
`init_variables` allocates a weight.

Passes, in JAX's order:

1. `sharding_dataflow`  — per-tensor/per-edge shardings re-derived: axis
   reuse, oversharded/indivisible dims, replica-dim inconsistencies and
   implicit (unpriced) reshards.
2. `memory_liveness`    — static per-chip peak over the fwd+bwd schedule
   (masters, gradients, slots, the update sharding), JAX's terms plus the
   port's own buffers by name; a predicted OOM fails the compile before
   the card sees it (`-ll:fsize`, else the card's `hbm_bytes`).
3. `collective_uniformity` — ring permutations are bijections, update
   buckets in topological order, no collective behind a coordinator-only
   branch.
4. `donation_aliasing`  — no stale alias of a tensor a captured step
   holds (the port donates in place); the registry of held positions is
   re-derived from executor.py and cross-checked.
5. `dtype_flow`         — ffsan's precision lattice under the config's
   mixed-precision policy (numerics.py).
6. `spmd_uniformity`    — host-divergent branches; the module also holds
   the opt-in fingerprint barrier (`--spmd-barrier`).
7. `rule_verify`        — the ffrules verdict of the rules this compile's
   search used, and the active rule set's fingerprint.

**fftrans** (transition.py) verifies the TRANSITION between two plans —
a checkpoint's and a compiled model's on restore — and prices it.
**ffrules** (rules.py) verifies substitution rules: symbolic shape and
dtype transfer, parallel-state soundness, an oracle that runs the source
and rewritten graphs through the port's `Executor`, boundary fuzz and
registry determinism; `--substitution-json` rules are gated at load.

Findings land in the `analysis` section of strategy_report.json; errors
abort the compile unless `--no-verify-plan`. The JAX package's CLIs
(`scripts/ffcheck.py`, `fflint.py`, `ffrules.py`) have no twin yet;
`lint.lint_paths(["flexflow_tpu_torch"])` is fflint's library entry.
"""

from __future__ import annotations

import time
from typing import Optional

from . import (
    collectives,
    donation,
    lint,
    memory,
    numerics,
    rules,
    sharding,
    sources,
    spmd,
    transition,
)
from .findings import (
    AnalysisResult,
    Finding,
    PlanVerificationError,
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
)

__all__ = [
    "AnalysisContext", "AnalysisResult", "Finding",
    "PlanVerificationError", "RuleVerificationError", "run_analysis",
    "verify_plan",
    "verify_strategy", "PASSES", "SEV_ERROR", "SEV_WARNING", "SEV_INFO",
    "collectives", "donation", "lint", "memory", "numerics", "rules",
    "sharding", "sources", "spmd", "transition",
]

# (name, runner) in execution order; each runner is
# fn(graph, mesh, ctx) -> list[Finding]. Passes 5 and 6 are the ffsan
# layer (dtype-flow numerics + SPMD uniformity); pass 7 is the ffrules
# layer's compile-side hook (the heavy per-rule verification runs at rule
# load time: the compile pass surfaces the recorded load verdict and the
# active rule set's fingerprint into the report).
PASSES = (
    ("sharding_dataflow", sharding.run),
    ("memory_liveness", memory.run),
    ("collective_uniformity", collectives.run),
    ("donation_aliasing", donation.run),
    ("dtype_flow", numerics.run),
    ("spmd_uniformity", spmd.run),
    ("rule_verify", rules.run),
)

RuleVerificationError = rules.RuleVerificationError


class AnalysisContext:
    """Everything a pass may consult beyond (graph, mesh). All fields
    optional — passes degrade to the checks their inputs allow."""

    def __init__(self, machine=None, cost_model=None, opt_slots: int = 1,
                 update_specs=None, training: bool = True,
                 hbm_cap_bytes: float = 0.0, config=None,
                 update_stage: int = 0, plan_source: str = "",
                 device_type: str = "cpu"):
        self.machine = machine
        self.cost_model = cost_model
        self.opt_slots = opt_slots
        self.update_specs = update_specs or {}
        # weight-update sharding stage the executor runs (0 | 2 | 3):
        # stage 3 drops the resident gathered weight copies from the
        # persistent set and adds the two-layers-in-flight transient
        self.update_stage = update_stage
        self.training = training
        self.hbm_cap_bytes = hbm_cap_bytes
        # FFConfig (or None): the dtype-flow pass reads the
        # mixed-precision policy (computation_dtype / tensor-op math)
        # from the same source the executor lowers
        self.config = config
        # where the plan came from (search|cache|checkpoint|import|
        # manual|default|broadcast|replan — model._plan_source; replan
        # is a live ffelastic re-plan whose underlying origin rides
        # model._plan_origin): the ffrules
        # pass only stamps a rule-set fingerprint on plans a rewrite
        # search (now, or the cached search with the same rule address)
        # actually produced
        self.plan_source = plan_source
        # the torch device type the steps run on: the memory pass adds
        # the CUDA graphs' buffers only where the steps are captured
        self.device_type = device_type


def run_analysis(graph, mesh, ctx: Optional[AnalysisContext] = None,
                 passes=None) -> AnalysisResult:
    """Run the pass pipeline over a materialized (graph, mesh). A pass
    that crashes reports itself as an error finding instead of taking
    the compile down with an analysis bug."""
    result = AnalysisResult()
    t0 = time.perf_counter()
    for name, runner in (passes or PASSES):
        try:
            result.extend(runner(graph, mesh, ctx), pass_name=name)
        except Exception as e:
            # the verifier must not be the crash — AND a verifier bug
            # must not block every compile: a crashed pass is a WARNING
            # (visible in the report/logs), not an abort-grade error;
            # only findings about the PLAN carry error severity
            result.extend([Finding(
                SEV_WARNING, "analysis_crash",
                f"pass {name} crashed (its checks did NOT run): "
                f"{type(e).__name__}: {e}")],
                pass_name=name)
        result.passes_run.append(name)
    result.elapsed_s = time.perf_counter() - t0
    return result


def context_for_model(model, cost_model=None) -> AnalysisContext:
    """AnalysisContext off a model mid-compile (executor built)."""
    from ..fftype import CompMode
    from ..search.cost_model import CostModel
    from ..search.machine_model import machine_model_for_mesh

    machine = getattr(cost_model, "machine", None)
    if machine is None:
        machine = machine_model_for_mesh(
            model.mesh, num_hosts=model.config.num_nodes)
    if cost_model is None:
        # the memory cross-check needs the pricer's own estimate even
        # when no search ran this compile — build one pricing the
        # ADOPTED update mode (same rule choose_update_sharding leaves
        # the search's cost model in)
        cost_model = CostModel(
            machine,
            opt_slots=(model.optimizer.num_slots
                       if model.optimizer is not None else 1))
        upd = getattr(model, "_update_sharding", None) or {}
        cost_model.update_sharding = bool(upd.get("enabled"))
        cost_model.param_gather = upd.get("stage", 0) == 3
        # (the port prices the pair overlapped, as the JAX package does
        # by default: --no-overlap-collectives is inert, config.py)
        cost_model.overlap_update = bool(upd.get("enabled"))
    cap = (model.config.device_mem if model.config.device_mem > 0
           else machine.chip.hbm_bytes)
    return AnalysisContext(
        machine=machine,
        cost_model=cost_model,
        opt_slots=(model.optimizer.num_slots
                   if model.optimizer is not None else 1),
        update_specs=(model.executor.update_specs
                      if model.executor is not None else {}),
        update_stage=(model.executor.update_stage
                      if model.executor is not None else 0),
        training=(model.config.computation_mode
                  == CompMode.COMP_MODE_TRAINING),
        hbm_cap_bytes=cap,
        config=model.config,
        plan_source=getattr(model, "_plan_source", ""),
        device_type=getattr(model.device, "type", "cpu"),
    )


def verify_plan(model, cost_model=None) -> AnalysisResult:
    """The compile gate: run every pass on the model's materialized plan,
    stash the result (`model._analysis` — strategy_report.json picks it
    up), and raise PlanVerificationError on errors unless
    --no-verify-plan. Runs on every plan source, because each of them
    reaches the executor through the same compile. Reads no tensor and
    allocates none: it runs before `init_variables`."""
    from .. import telemetry
    from ..telemetry import log as fflog

    with telemetry.span("compile.verify"):
        ctx = context_for_model(model, cost_model=cost_model)
        result = run_analysis(model.graph, model.mesh, ctx)
    model._analysis = result
    s = result.summary()
    telemetry.event(
        "plan_verify", plan_source=getattr(model, "_plan_source", "none"),
        elapsed_s=result.elapsed_s, **s)
    errs = result.errors()
    if errs:
        if model.config.verify_plan:
            raise PlanVerificationError(result)
        fflog.warning(
            "plan verification found %d error(s) (--no-verify-plan: "
            "launching anyway): %s", len(errs),
            "; ".join(str(f) for f in errs[:5]))
    for f in result.warnings():
        fflog.debug("ffcheck: %s", f)
    return result


def verify_strategy(overrides: dict, graph, mesh_axes) -> None:
    """Strategy-level verification for the adoption paths (import, plan
    cache, checkpoint manifest): every problem the sharding pass can see
    without materialized placements. Raises ValueError listing all
    problems — the warm-start paths catch it as a cache miss and
    re-search; --import-strategy surfaces it to the user. `mesh_axes` is
    an {axis: size} mapping or anything with a `.shape` mapping."""
    axes = mesh_axes
    if hasattr(axes, "shape"):
        axes = dict(axes.shape)
    findings = sharding.verify_strategy(overrides, graph, axes)
    errs = [f for f in findings if f.severity == SEV_ERROR]
    if errs:
        raise ValueError(
            "strategy does not apply to this graph/mesh:\n  "
            + "\n  ".join(str(f) for f in errs))
