"""Run-health anomaly detection: a rule engine over per-step records (a
copy of `flexflow_tpu/diagnostics/health.py`: it imports neither JAX nor
torch).

Dapper's lesson (PAPERS.md): always-on structured diagnostics must be
cheap enough to leave enabled. Each rule sees the same per-step record the
telemetry session writes to metrics.jsonl (plus the loss value, fetched
only when diagnostics is on) and emits leveled alerts:

  nan_loss          loss went NaN/inf — the run is dead, say so at the step
                    it died, not at the end of the epoch
  step_spike        step time spiked vs its own EMA (compile storms,
                    straggler hosts, thermal throttling)
  data_wait_stall   sustained input-pipeline stall: data-wait fraction of
                    wall time above threshold (the host, not the device,
                    is the bottleneck)
  ckpt_stale        no committed checkpoint for too long — the data-loss
                    window (CheckFreq's metric) is growing silently

Alerts flow through telemetry/log.py (leveled, multihost-aware), land in
<telemetry-dir>/alerts.jsonl, and rules named in `abort_on` raise
HealthAbort instead of warning — fit stops with artifacts flushed.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional


class HealthAbort(RuntimeError):
    """Raised when a rule listed in `abort_on` fires: training must stop.
    Carries the alert so callers can render it."""

    def __init__(self, alert: "Alert"):
        super().__init__(alert.message)
        self.alert = alert


@dataclass
class Alert:
    """One leveled health alert (the alerts.jsonl record)."""

    rule: str
    level: str          # "warning" | "error"
    step: int
    message: str
    value: float = 0.0
    threshold: float = 0.0
    action: str = "warn"  # "warn" | "abort"
    # structured context (e.g. the sanitizer's nan_loss localization:
    # op / phase / at_step) — serialized only when present
    details: dict = field(default_factory=dict)

    def to_record(self) -> dict:
        rec = {
            "rule": self.rule, "level": self.level, "step": int(self.step),
            "message": self.message, "value": float(self.value),
            "threshold": float(self.threshold), "action": self.action,
        }
        if self.details:
            rec["details"] = dict(self.details)
        return rec


class Rule:
    """Base rule: observe per-step records, return an Alert or None.
    `fire_once` rules latch after their first alert (a dead run needs one
    nan_loss alert, not one per remaining step)."""

    name = "rule"
    fire_once = False

    def __init__(self):
        self._fired = False

    def check(self, rec: dict) -> Optional[Alert]:
        if self._fired and self.fire_once:
            return None
        alert = self._check(rec)
        if alert is not None:
            self._fired = True
        return alert

    def _check(self, rec: dict) -> Optional[Alert]:
        raise NotImplementedError


class NaNLossRule(Rule):
    """Loss is NaN or inf: the run is numerically dead. With
    --sanitize-numerics the step record additionally carries the
    sanitizer's localization (nonfinite_op/phase/step, sanitize.py) and
    the one alert — fire-once semantics unchanged — names the exact op
    and pass that produced the first non-finite tensor."""

    name = "nan_loss"
    fire_once = True

    def _check(self, rec):
        loss = rec.get("loss")
        if loss is None:
            return None
        loss = float(loss)
        if math.isfinite(loss):
            return None
        details = {}
        origin = ""
        op = rec.get("nonfinite_op")
        if op:
            phase = ("backward" if rec.get("nonfinite_phase") == "bwd"
                     else "forward")
            at = rec.get("nonfinite_step")
            origin = (f" — first non-finite tensor: {op} ({phase}) "
                      f"at step {at}")
            details = {"op": op,
                       "phase": rec.get("nonfinite_phase"),
                       "at_step": at}
        return Alert(
            rule=self.name, level="error", step=int(rec.get("step", 0)),
            message=(f"non-finite loss ({loss}) at step "
                     f"{rec.get('step', '?')} — the model diverged"
                     f"{origin}"),
            value=loss if math.isnan(loss) else math.inf,
            details=details)


class StepSpikeRule(Rule):
    """Step wall time spiked vs the run's own EMA. Warmup skips the first
    steps (step 1 carries the jit compile and is ALWAYS a spike)."""

    name = "step_spike"

    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 ema_alpha: float = 0.2, cooldown: int = 10):
        super().__init__()
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.ema_alpha = float(ema_alpha)
        self.cooldown = int(cooldown)
        self._ema: Optional[float] = None
        self._n = 0
        self._last_fire = -10**9

    def _check(self, rec):
        t = rec.get("step_time_s")
        if t is None or not math.isfinite(float(t)):
            return None
        t = float(t)
        self._n += 1
        if self._n <= self.warmup:
            # warmup steps (jit compile, cache cold) neither alert NOR
            # seed the EMA — a compile-sized first step would inflate the
            # baseline and mask real spikes for the rest of the run
            return None
        if self._ema is not None and t > self.factor * self._ema:
            # ANY over-threshold sample is excluded from the baseline —
            # including ones the cooldown keeps from alerting; folding a
            # suppressed spike into the EMA would inflate the baseline a
            # still-ongoing incident (or the next one) is judged against
            if self._n - self._last_fire > self.cooldown:
                self._last_fire = self._n
                return Alert(
                    rule=self.name, level="warning",
                    step=int(rec.get("step", 0)),
                    message=(f"step time spike: {t * 1e3:.1f} ms > "
                             f"{self.factor:.1f}× EMA "
                             f"{self._ema * 1e3:.1f} ms"),
                    value=t, threshold=self.factor * self._ema)
            return None
        a = self.ema_alpha
        self._ema = t if self._ema is None else (1 - a) * self._ema + a * t
        return None


class DataWaitStallRule(Rule):
    """Sustained input-pipeline stall: EMA of data_wait/step_time above
    `ratio` — the device is idle waiting for the host."""

    name = "data_wait_stall"

    def __init__(self, ratio: float = 0.5, warmup: int = 5,
                 ema_alpha: float = 0.2, cooldown: int = 50):
        super().__init__()
        self.ratio = float(ratio)
        self.warmup = int(warmup)
        self.ema_alpha = float(ema_alpha)
        self.cooldown = int(cooldown)
        self._ema: Optional[float] = None
        self._n = 0
        self._last_fire = -10**9

    def _check(self, rec):
        t = rec.get("step_time_s")
        w = rec.get("data_wait_s")
        if not t or w is None:
            return None
        frac = max(0.0, min(1.0, float(w) / float(t)))
        a = self.ema_alpha
        self._ema = (frac if self._ema is None
                     else (1 - a) * self._ema + a * frac)
        self._n += 1
        if (self._n > self.warmup and self._ema > self.ratio
                and self._n - self._last_fire > self.cooldown):
            self._last_fire = self._n
            return Alert(
                rule=self.name, level="warning",
                step=int(rec.get("step", 0)),
                message=(f"input pipeline stall: data-wait is "
                         f"{self._ema:.0%} of step time (EMA) > "
                         f"{self.ratio:.0%} — the host, not the device, "
                         f"is the bottleneck"),
                value=self._ema, threshold=self.ratio)
        return None


class CheckpointStalenessRule(Rule):
    """The newest committed checkpoint is older than `max_age_s`: the
    data-loss window is growing. Fed the commit clock via
    `note_commit` (the manager reads the resilience checkpointer)."""

    name = "ckpt_stale"

    def __init__(self, max_age_s: float = 600.0, cooldown_s: float = 60.0):
        super().__init__()
        self.max_age_s = float(max_age_s)
        self.cooldown_s = float(cooldown_s)
        self._last_commit_t: Optional[float] = None
        self._last_fire_t = -10**12

    def note_commit(self, t: Optional[float]):
        if t is not None:
            self._last_commit_t = float(t)

    def _check(self, rec):
        if self._last_commit_t is None:
            return None
        now = rec.get("t", time.time())
        age = now - self._last_commit_t
        if age <= self.max_age_s or now - self._last_fire_t < self.cooldown_s:
            return None
        self._last_fire_t = now
        return Alert(
            rule=self.name, level="warning",
            step=int(rec.get("step", 0)),
            message=(f"checkpoint staleness: last commit {age:.0f}s ago "
                     f"> {self.max_age_s:.0f}s — a preemption now loses "
                     f"that much work"),
            value=age, threshold=self.max_age_s)


def default_rules(config=None) -> list[Rule]:
    """The standard rule set. `ckpt_stale` is always present so
    `--health-abort-on ckpt_stale` validates regardless of whether THIS
    run checkpoints — the rule stays dormant until a commit clock is fed
    (note_commit), which only happens when checkpointing is on."""
    every_s = (getattr(config, "checkpoint_every_seconds", 0.0) or 0.0
               if config is not None else 0.0)
    # stale = several missed periods; default 10 min when the policy is
    # step-based (no wall-clock period to scale from)
    max_age = max(5 * every_s, 600.0) if every_s else 600.0
    return [NaNLossRule(), StepSpikeRule(), DataWaitStallRule(),
            CheckpointStalenessRule(max_age_s=max_age)]


class HealthMonitor:
    """Runs every rule over each per-step record; routes alerts to the
    caller-supplied sink (DiagnosticsManager writes alerts.jsonl + the
    leveled log + a trace instant) and raises HealthAbort for rules listed
    in `abort_on`."""

    def __init__(self, rules: Optional[list[Rule]] = None,
                 abort_on: tuple = (), sink=None):
        self.rules = rules if rules is not None else default_rules()
        self.sink = sink
        self.alerts: list[Alert] = []
        self.abort_on: frozenset = frozenset()
        self.set_abort_on(abort_on)

    def set_abort_on(self, abort_on) -> None:
        """Replace the abort set (validated against the running rules) —
        lets a later enable_diagnostics(abort_on=...) upgrade rules from
        warn to abort mid-setup instead of being silently dropped."""
        abort_on = frozenset(abort_on)
        unknown = abort_on - {r.name for r in self.rules}
        if unknown:
            raise ValueError(
                f"--health-abort-on names unknown rules {sorted(unknown)}; "
                f"known: {sorted(r.name for r in self.rules)}")
        self.abort_on = abort_on

    def rule(self, name: str) -> Optional[Rule]:
        return next((r for r in self.rules if r.name == name), None)

    def observe_step(self, rec: dict) -> list[Alert]:
        """Run all rules over one step record. Returns the alerts fired;
        raises HealthAbort (after sinking the alert) when an abort-listed
        rule fires."""
        fired = []
        for r in self.rules:
            alert = r.check(rec)
            if alert is None:
                continue
            if r.name in self.abort_on:
                alert.action = "abort"
                alert.level = "error"
            self.alerts.append(alert)
            fired.append(alert)
            if self.sink is not None:
                self.sink(alert)
            if alert.action == "abort":
                raise HealthAbort(alert)
        return fired
