"""The apply half of elastic re-planning: recompile in place, price, gate,
then migrate or roll back — one step boundary, no restart (twin of
`flexflow_tpu/elastic/apply.py`).

`replan(model, ...)` is the controller's workhorse. It snapshots the live
plan + training state (the executor object with its captured steps
included), recompiles the SAME FFModel object through the normal compile
pipeline (warm-start cache consulted first, rank-0 search + broadcast on
a mesh, the full ffcheck/ffsan/ffrules verifier gate — the new plan is a
first-class plan source, labeled `replan`), prices the old→new move with
fftrans, evaluates the payoff inequality, and either executes
`migrate_state` (bit-exact, verified) or restores the snapshot as if
nothing happened: a declined, dry-run or failed re-plan puts the old
executor back with its CUDA graphs, so nothing is captured again. A
migrated re-plan releases the old executor's graphs and their memory
pools before the caller captures the new step. Every path — migrated,
declined, dry-run, failed — appends a decision record carrying both
sides of the inequality to `model._elastic_decisions`, emits a `replan`
telemetry event, and lands in strategy_report.json's `elastic` section.

On a world of more than one rank every rank of either mesh runs the same
re-plan (the controller agreed it). The payoff is priced on the planning
rank (the lowest rank of both meshes) and shared, so the ranks' own
step-time readings cannot split the decision. A shrink's new mesh is a
sub-mesh of the world (`new_ranks`): a rank outside it compiles nothing,
takes part in the migration as a source, and parks (the controller keeps
it waiting in the world's agreement until a regrow or the run's end).

Telemetry note: `model.compile()` and `migrate_state` both deactivate the
process-wide telemetry sink in their finallys (they assume they own the
session window). A mid-fit replan runs INSIDE fit's window, so this module
re-activates the saved session after each of those calls.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Optional

from ..telemetry import log as fflog
from .payoff import evaluate_payoff, load_fidelity

# everything a compile writes on the model, plus the live training state
# migrate_state moves: enough for the snapshot to satisfy the `old` model
# contract of PlanSide.from_model / model_state_tree / migrate_state, and
# for restore() to make a declined replan invisible
_SNAP_ATTRS = (
    "graph", "mesh", "executor", "optimizer", "loss_type", "metrics",
    "_mesh_ranks", "_weight_alias", "_goodput_anchor",
    "_strategy", "_plan_source", "_plan_origin", "_plan_fingerprint",
    "_plan_record", "_update_sharding", "_search_result", "_replay_search",
    "_analysis", "_spmd_barrier", "_transition", "_predicted_step_s",
    "_params", "_state", "_opt_slots", "_step", "_counters", "_rng",
)


class PlanSnapshot:
    """Frozen capture of a compiled model's plan and live state.

    Quacks like a compiled FFModel for fftrans's PlanSide.from_model and
    resilience.migrate_state's `old` argument (attribute surface: mesh,
    graph, executor, config, _update_sharding, _plan_source, the live
    state leaves), and restores every captured attribute for the
    rollback path."""

    def __init__(self, model):
        for a in _SNAP_ATTRS:
            setattr(self, a, getattr(model, a, None))
        # config is copied so the snapshot keeps the OLD mesh_axis_sizes
        # (PlanSide reads config.num_nodes / serve_kv_block_size off it)
        self.config = copy.copy(model.config)
        self.device = model.device
        self._telemetry = None
        self._compiled = True

    def restore(self, model):
        """Put every captured attribute back on the model; the config
        object is shared, so only the field replan mutates is reset, and
        the collectives' scope follows the restored mesh."""
        from ..distributed import set_scope

        for a in _SNAP_ATTRS:
            setattr(model, a, getattr(self, a))
        model.config.mesh_axis_sizes = self.config.mesh_axis_sizes
        model._compiled = True
        set_scope(self.mesh)


def _reset_plan_state(model):
    """Clear plan residue so _compile_impl runs a fresh plan decision
    (plan source branches key off these; a stale _plan_source would
    short-circuit the search)."""
    model._strategy = None
    model._plan_source = "none"
    model._plan_fingerprint = None
    model._plan_record = None
    model._search_result = None
    model._replay_search = None
    model._transition = None


def _agreed_payoff(snap, model, *, horizon_steps: int, measured_ema_s,
                   forced: bool):
    """(the transition plan or None, the payoff record) on every rank of
    either mesh: priced where the rank holds both plans, and on a world
    of more than one rank priced by the planning rank alone and shared."""
    from ..analysis import transition as fftrans
    from ..distributed import share_object, world_rank, world_size

    world = world_size()
    old_ranks, new_ranks = list(snap.mesh.ranks), list(model.mesh.ranks)
    both = sorted(set(old_ranks) & set(new_ranks))
    planner = both[0] if world > 1 and both else 0
    plan, payoff = None, None
    if world <= 1 or (world_rank() == planner and both):
        plan = fftrans.plan_model_transition(snap, model)
        ratio, nsamples = load_fidelity(model)
        baseline = (float(measured_ema_s) if measured_ema_s
                    else float(snap._predicted_step_s or 0.0))
        benefit = max(0.0, baseline - float(model._predicted_step_s or 0.0))
        payoff = evaluate_payoff(
            predicted_migration_s=plan.predicted_s, fidelity_ratio=ratio,
            benefit_s_per_step=benefit, horizon_steps=horizon_steps,
            forced=forced)
        payoff["fidelity_samples"] = nsamples
    if world > 1:
        if not both:
            raise RuntimeError(
                f"replan: no rank holds both plans (old ranks {old_ranks}, "
                f"new ranks {new_ranks})")
        payoff = share_object(payoff, planner,
                              sorted(set(old_ranks) | set(new_ranks)),
                              snap.mesh, model.mesh)
    return plan, payoff


def release_executor(executor):
    """Drop an executor's steps, their CUDA graphs and memory pools with
    them (a migrated re-plan's old executor; the caller captures anew)."""
    if executor is None:
        return
    from ..executor import CapturedStep

    for fn in [executor._train_step, executor._eval_step,
               *executor._chunk_steps.values()]:
        if isinstance(fn, CapturedStep):
            fn.release()
    executor.drop_steps()


def replan(model, *, step: int, trigger: str,
           horizon_steps: int, new_mesh_axes: Optional[tuple] = None,
           new_ranks: Optional[list] = None,
           measured_ema_s: Optional[float] = None, dry_run: bool = False,
           forced: bool = False, extra: Optional[dict] = None) -> dict:
    """One full re-plan attempt at a step boundary; returns the decision
    record (also appended to `model._elastic_decisions`).

    decision ∈ migrated | declined | dry_run | failed. The payoff rule:
    migrate iff predicted_migration_s × fidelity_ratio <
    benefit_s_per_step × horizon_steps, where benefit is the measured
    step-time EMA (falling back to the old plan's prediction) minus the
    new plan's predicted makespan. `forced` (capacity shrink) records
    the inequality but migrates regardless — the compiled mesh no
    longer exists. `new_ranks`: the world ranks the new mesh takes (a
    sub-mesh; None: the first ones of the world, or the mesh's own when
    the axes stay). Declined/dry-run/failed paths restore the snapshot
    bit-exactly."""
    from .. import telemetry
    from ..diagnostics.drift import recalibrate_model
    from ..distributed import world_size
    from ..resilience.migrate import migrate_state

    session = telemetry.active_session()
    t0 = time.perf_counter()
    decision: dict = {
        "step": int(step), "trigger": str(trigger),
        "dry_run": bool(dry_run),
    }
    if extra:
        decision.update(extra)
    snap = PlanSnapshot(model)
    decision["old_mesh_axes"] = {k: int(v)
                                 for k, v in snap.mesh.shape.items()}
    decision["old_predicted_step_s"] = snap._predicted_step_s
    decision["measured_ema_s"] = measured_ema_s
    if new_mesh_axes is not None and new_ranks is None:
        n = math.prod(int(s) for s in new_mesh_axes)
        new_ranks = list(range(n)) if n < world_size() else None
    migrated = False
    rolled_back = False
    try:
        with telemetry.span("elastic.replan", trigger=trigger, step=step):
            if trigger == "drift" and snap.executor is not None:
                # the monitor fired BECAUSE the calibration no longer
                # describes the device: refresh it (and the warm-start
                # DB, coordinator-only) so the re-search prices real
                # costs — and so the plan-cache fingerprint moves off
                # the stale entries
                recalibrate_model(model)
            t_search0 = time.perf_counter()
            _reset_plan_state(model)
            if new_mesh_axes is not None:
                model.config.mesh_axis_sizes = tuple(new_mesh_axes)
                model._mesh_ranks = new_ranks
            # relabel the recompile's outcome as plan_source "replan"
            # (the underlying origin — search/cache/broadcast — rides
            # the decision record as plan_origin)
            model._plan_source_hint = "replan"
            model.compile(
                optimizer=snap.optimizer, loss_type=snap.loss_type,
                metrics=getattr(model, "_metrics_arg", ()) or (),
                comp_mode=model.config.computation_mode)
        if session is not None:
            telemetry.activate(session)  # compile() deactivated it
        decision["research_s"] = time.perf_counter() - t_search0
        decision["plan_origin"] = getattr(model, "_plan_origin", None)
        decision["new_mesh_axes"] = {
            k: int(v) for k, v in model.mesh.shape.items()}
        decision["new_predicted_step_s"] = model._predicted_step_s
        plan, payoff = _agreed_payoff(
            snap, model, horizon_steps=horizon_steps,
            measured_ema_s=measured_ema_s, forced=forced)
        decision.update(payoff)
        if (decision["would_migrate"] or forced) and not dry_run:
            # gate_transition runs inside migrate_state; a verification
            # failure raises and rolls back below
            t_m0 = time.perf_counter()
            moved = migrate_state(snap, model, plan=plan)
            if session is not None:
                telemetry.activate(session)  # migrate_state deactivated it
            migrated = True
            decision["decision"] = "migrated"
            decision["migration_measured_s"] = moved.get("measured_s")
            decision["migration_wall_s"] = time.perf_counter() - t_m0
            decision["moved_bytes"] = moved.get("moved_bytes")
            # the old plan's graphs and pools go before the new step is
            # captured: at full width both would not fit on the card
            release_executor(snap.executor)
        else:
            decision["decision"] = "dry_run" if dry_run else "declined"
            snap.restore(model)
            rolled_back = True
    except Exception as e:
        snap.restore(model)
        rolled_back = True
        if session is not None:
            telemetry.activate(session)
        decision["decision"] = "failed"
        decision["error"] = f"{type(e).__name__}: {e}"
        fflog.error("elastic: replan failed (%s) — rolled back to the "
                    "running plan: %s", trigger, decision["error"])
    decision["total_s"] = time.perf_counter() - t0
    if not hasattr(model, "_elastic_decisions"):
        model._elastic_decisions = []
    model._elastic_decisions.append(decision)
    _finalize_artifacts(model, decision, rolled_back=rolled_back)
    return decision


def _finalize_artifacts(model, decision: dict, *, rolled_back: bool):
    """Record the decision everywhere the doctor looks: a `replan`
    telemetry event, an alert record, and a strategy_report rewrite so
    the `elastic` section includes this decision (on rollback, the
    report also reverts to the restored plan and the drift monitor
    re-arms at its prediction)."""
    from .. import telemetry

    if telemetry.active_session() is not None:
        telemetry.inc("elastic_replan_decisions_total",
                      decision=str(decision.get("decision", "unknown")),
                      trigger=str(decision.get("trigger", "unknown")))
        if decision.get("research_s") is not None:
            telemetry.observe("elastic_research_s",
                              decision["research_s"])
        telemetry.event("replan", **decision)
    else:
        # direct replan() call outside a fit window: land the event in
        # the model's own session so the doctor still sees it
        tel = getattr(model, "_telemetry", None)
        if tel is not None:
            tel.recorder.record("replan", **decision)
    diag = getattr(model, "_diagnostics", None)
    if diag is not None:
        msg = (f"elastic {decision['trigger']} trigger at step "
               f"{decision['step']}: {decision['decision']}"
               + (f" (lhs {decision['lhs_s'] * 1e3:.3f} ms vs rhs "
                  f"{decision['rhs_s'] * 1e3:.3f} ms)"
                  if "lhs_s" in decision else "")
               + (f" [{decision['error']}]"
                  if "error" in decision else ""))
        diag._alerts.record(
            "alert", rule="elastic_replan", level="warning",
            step=decision["step"], action=decision["decision"],
            message=msg)
        fflog.warning("diagnostics[elastic_replan]: %s", msg)
    if not model.mesh.member:
        return  # parked: no plan of its own to report
    if rolled_back:
        if diag is not None:
            # rewrite the report for the RESTORED plan (elastic section
            # included) and re-arm the drift monitor at its prediction
            diag.on_compile()
    else:
        session = getattr(model, "_telemetry", None)
        if session is not None:
            from ..diagnostics.explain import write_strategy_report

            try:
                write_strategy_report(model, session.directory)
            except Exception:  # a report must not fail a re-plan
                pass
