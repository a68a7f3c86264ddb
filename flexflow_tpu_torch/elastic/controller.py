"""ElasticController: drift/capacity-triggered live re-planning (twin of
`flexflow_tpu/elastic/controller.py`).

The drift monitor (diagnostics/drift.py) detects when the cost model no
longer describes the device, warm start (warmstart/) makes an online
re-search cheap, and fftrans (analysis/transition.py +
resilience/migrate.py) makes any plan→plan move verified, priced, and
executable in-process — this controller decides WHEN to use them.
Payoff-gated live reconfiguration follows Gemini (Wang et al., SOSP '23:
reconfigure only when the modeled benefit over the remaining horizon
exceeds the modeled cost of moving), with the re-search run as a fresh
Unity joint optimization against recalibrated measurements (Unity,
OSDI '22).

Wiring: `FFModel.fit` calls `maybe_replan(step)` at fit entry and after
each step (the pipelined engine at chunk boundaries; the serving engine
polls capacity between decode steps). Trigger streams:

- drift: the DiagnosticsManager forwards DriftMonitor advisories here
  (when a controller is attached the manager does NOT arm the monitor's
  own recompile hook, so one sustained excursion produces exactly one
  trigger);
- capacity: CapacityWatcher compares the visible device set against the
  compiled mesh.

A step-count cooldown (`--replan-cooldown-steps`) spaces consecutive
re-plan attempts so the loop never flaps; a capacity SHRINK bypasses it
(the compiled mesh no longer physically exists). `--elastic-dry-run`
runs the full trigger → search → gate → price pipeline and records the
decision, but never migrates.

On a world of more than one rank (`torchrun`) every decision is agreed:
the drift flag rides the step edge's all-reduce, and at each capacity
check the visible set is agreed over the whole world
(`PreemptionHandler.poll`, or `_check_view` for a direct call), so every
rank takes the same decision at the same step. A shrink
moves training onto a sub-mesh of the world and parks the ranks outside
it: a parked rank leaves the compute loop and waits in the world's
agreement (`_park`), which runs only at the active ranks' capacity
checks, so it reaches no other collective. It mirrors their capacity
decisions there, comes back on a regrow that takes it (the fit loop then
skips the steps it sat out: `FFModel._elastic_skip`), and leaves when the
active ranks leave fit (`release`). A capacity shrink covers cards a
scheduler withdraws while their processes live; a rank whose process
dies takes the NCCL world with it, and the way back is a torchrun
restart with --auto-resume.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

from ..telemetry import log as fflog
from .apply import replan
from .triggers import CapacityDelta, CapacityView, CapacityWatcher

# maybe_replan's `capacity` when no step-edge poll agreed one: the
# controller polls (and agrees) on its own cadence
POLL = object()


class ElasticController:
    def __init__(self, model, diag=None, *,
                 cooldown_steps: Optional[int] = None,
                 horizon_steps: Optional[int] = None,
                 dry_run: Optional[bool] = None,
                 visible_devices_fn: Optional[Callable[[], Sequence]] = None,
                 capacity_check_every: int = 8):
        from ..distributed import world_size

        cfg = model.config
        self.model = model
        self.diag = None
        self.cooldown_steps = int(
            cfg.replan_cooldown_steps if cooldown_steps is None
            else cooldown_steps)
        self.horizon_steps = int(
            cfg.replan_horizon_steps if horizon_steps is None
            else horizon_steps)
        self.dry_run = bool(
            cfg.elastic_dry_run if dry_run is None else dry_run)
        self.watcher = CapacityWatcher(
            model, visible_devices_fn, check_every=capacity_check_every)
        self._pending = None  # latest un-consumed DriftAdvisory
        # cooldown anchor: the step of the last re-plan ATTEMPT (any
        # outcome — a declined search is as expensive as a migrated one)
        self._anchor_step = (int(model._py_step())
                             if getattr(model, "_compiled", False)
                             and model._step is not None else 0)
        if not hasattr(model, "_elastic_decisions"):
            model._elastic_decisions = []
        self.decisions = model._elastic_decisions
        # world agreements this rank joined while parked
        self.parked_polls = 0
        if world_size() > 1:
            # the world's host group: made on every rank, here
            from ..resilience.policy import world_flag_group

            world_flag_group()
        if diag is not None:
            self.attach_diagnostics(diag)

    # ------------------------------------------------------------ triggers

    def attach_diagnostics(self, diag):
        """Wire the drift stream: the manager forwards advisories here,
        and the monitor's own recompile hook is disarmed so one excursion
        yields one trigger (the controller replaces it as the drift
        response; recalibration runs inside the replan instead)."""
        self.diag = diag
        diag.elastic = self
        if diag.drift is not None:
            diag.drift.recompile_state = None

    def on_advisory(self, adv):
        """One DriftAdvisory from the monitor (hysteresis already
        applied there). Kept pending until the next maybe_replan call;
        advisories landing inside the cooldown are dropped."""
        if self._in_cooldown(int(adv.step)):
            fflog.debug("elastic: drift advisory at step %d dropped "
                        "(cooldown)", adv.step)
            return
        self._pending = adv

    @property
    def has_advisory(self) -> bool:
        """A drift advisory waits for the next step edge."""
        return self._pending is not None

    def capacity_view(self) -> Optional[CapacityView]:
        """fit's step-edge hook: advance the capacity cadence and, at a
        check, this rank's view of the visible set for the step edge's
        agreement (`PreemptionHandler.poll`); None between checks."""
        if not self.watcher.due():
            return None
        return self._view(self.model._py_step())

    def _view(self, step: int) -> CapacityView:
        """This rank's view of the visible set at `step`, with the
        cooldown anchor the parked ranks take over."""
        view = self.watcher.view()
        view.step, view.anchor = int(step), int(self._anchor_step)
        return view

    def _check_view(self, step: int) -> Optional[CapacityView]:
        """A direct call's capacity check (no step edge agreed one): on
        the cadence, this rank's view, agreed over the world when it has
        more than one rank (collective: every rank calls it)."""
        from ..distributed import world_size

        if not self.watcher.due():
            return None
        view = self._view(step)
        return view if world_size() <= 1 else self._agree(view)[1]

    def _in_cooldown(self, step: int) -> bool:
        return (step - self._anchor_step) < self.cooldown_steps

    def _measured_ema(self) -> Optional[float]:
        if self.diag is not None and self.diag.drift is not None:
            return self.diag.drift.measured_ema
        return None

    # ------------------------------------------------------------ decide

    def maybe_replan(self, step: int, capacity=POLL,
                     drift: Optional[bool] = None) -> bool:
        """The fit-loop hook: consume pending triggers and re-plan when
        warranted. `capacity`: the view the step edge agreed (None
        between checks), else the controller checks on its own cadence;
        `drift`: whether any rank holds an advisory (agreed), else this
        rank's own. Returns True when the model's executor and state
        changed (a migration, or this rank parked and came back or was
        released): the caller's step function is stale and must be
        rebuilt from model.executor."""
        step = int(step)
        adv, self._pending = self._pending, None
        view = self._check_view(step) if capacity is POLL else capacity
        if view is not None and view.anchor >= 0:
            self._anchor_step = view.anchor
        cap = self.watcher.delta(step, view)
        moved = self._decide(step, cap, adv,
                             adv is not None if drift is None else drift)
        if moved and not self.model.mesh.member:
            self._park()
        return moved

    def _decide(self, step: int, cap: Optional[CapacityDelta], adv,
                drift: bool) -> bool:
        if cap is not None and cap.shrink:
            # forced: devices vanished from under the compiled mesh —
            # cooldown cannot apply, the old plan cannot run
            return self._on_capacity(step, cap)
        if self._in_cooldown(step):
            return False
        if cap is not None:
            return self._on_capacity(step, cap)
        if drift:
            return self._on_drift(step, adv)
        return False

    def _on_drift(self, step: int, adv) -> bool:
        self._anchor_step = step
        d = replan(
            self.model, step=step, trigger="drift",
            horizon_steps=self.horizon_steps,
            measured_ema_s=(adv.measured_ema_s if adv is not None
                            else self._measured_ema()),
            dry_run=self.dry_run,
            extra={"advisory": adv.to_record() if adv is not None
                   else None})
        return d.get("decision") == "migrated"

    def _on_capacity(self, step: int, cap: CapacityDelta) -> bool:
        from .. import telemetry

        self._anchor_step = step
        if cap.new_axes is None:
            # a visible count the fixed mesh axes cannot divide, or past
            # the torchrun world (or a multi-host mesh): record the
            # decline — no search ran, so the record carries no payoff
            # sides
            decision = {
                "step": step, "trigger": "capacity",
                "decision": "declined", "dry_run": self.dry_run,
                "capacity": cap.to_record(),
                "reason": cap.reason,
            }
            self.decisions.append(decision)
            telemetry.inc("elastic_replan_decisions_total",
                          decision="declined", trigger="capacity")
            telemetry.event("replan", **decision)
            if self.diag is not None:
                self.diag._alerts.record(
                    "alert", rule="elastic_replan", level="warning",
                    step=step, action="declined",
                    message=(f"capacity delta ({cap.compiled} -> "
                             f"{cap.visible} devices) but {cap.reason} "
                             f"— staying put"))
            return False
        d = replan(
            self.model, step=step, trigger="capacity",
            horizon_steps=self.horizon_steps,
            new_mesh_axes=cap.new_axes, new_ranks=cap.ranks,
            measured_ema_s=self._measured_ema(), dry_run=self.dry_run,
            forced=cap.shrink, extra={"capacity": cap.to_record()})
        return d.get("decision") == "migrated"

    # ------------------------------------------------------------ parking

    def _agree(self, view: CapacityView) -> tuple:
        """One world agreement of a parked rank: (flags, agreed view)."""
        from ..distributed import world_size
        from ..resilience.policy import agree_max, world_flag_group

        out = agree_max([0, 0, 0] + view.encode(world_size()),
                        world_flag_group())
        return out[:3], CapacityView.decode(out[3:], world_size())

    def _parked_elsewhere(self) -> bool:
        """Some rank of the world holds no device of the mesh."""
        from ..distributed import world_size

        return world_size() > 1 and (not self.model.mesh.member or len(
            self.model.mesh.ranks) < world_size())

    def enter_fit(self, step: int) -> bool:
        """fit's entry hook: a withdrawn or restored fleet re-plans
        BEFORE the first step (`maybe_replan`). While some rank is
        parked, the check is not left to the cadence: the active ranks
        agree over the world here, where the parked ranks wait (a parked
        rank goes straight into its wait, and counts the steps it sits
        out from this agreement on)."""
        self.model._elastic_skip = 0
        if not self.model.mesh.member:
            self._park(None)
            return True
        if not self._parked_elsewhere():
            return self.maybe_replan(step)
        self.watcher.due()  # the forced check takes the cadence's turn
        return self.maybe_replan(step,
                                 capacity=self._agree(self._view(step))[1])

    def _park(self, parked_at: Optional[int] = -1):
        """A rank outside the mesh: wait in the world's agreement, which
        the active ranks run at their capacity checks, at fit entry and
        when they leave fit, taking their capacity decisions with them,
        until a regrow brings this rank back (fit then skips the steps it
        sat out: those since `parked_at`, the active ranks' step where
        this rank's loop stands; None: the first agreement's) or the
        active ranks leave (fit skips the rest)."""
        model = self.model
        if parked_at == -1:
            parked_at = int(model._py_step())
        while not model.mesh.member:
            _flags, view = self._agree(self.watcher.view())
            self.parked_polls += 1
            if parked_at is None:
                parked_at = view.step
            if view.released:
                model._elastic_skip = math.inf
                return
            self._anchor_step = view.anchor
            self._decide(view.step, self.watcher.delta(view.step, view),
                         None, False)
        model._elastic_skip = int(model._py_step()) - parked_at

    def release(self):
        """The active ranks leave fit: the parked ranks leave their wait
        with them (collective over the world; a no-op where no rank is
        parked or this rank is one)."""
        mesh = self.model.mesh
        if not mesh.member or not self._parked_elsewhere():
            return
        view = CapacityView(count=int(mesh.devices.size),
                            ranks=tuple(mesh.ranks), released=True)
        self._agree(view)
