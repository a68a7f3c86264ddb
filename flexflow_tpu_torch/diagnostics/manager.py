"""DiagnosticsManager: one run's explain + drift + health, wired to fit
(twin of `flexflow_tpu/diagnostics/manager.py`; the same artifacts,
record for record).

Owned by FFModel (`--diagnostics` / `model.enable_diagnostics()` / the
keras Diagnostics callback). Lifecycle:

  compile end  → write strategy_report.{json,md}; stash the plan's
                 predicted makespan for the drift monitor
  each step    → health rules over the step record (loss included — the
                 scalar fetch happens only with diagnostics on), drift
                 monitor over measured device time
  fit end      → drain alerts; summary counts into the metrics log

All artifacts live in the telemetry session's directory:

  strategy_report.json / strategy_report.md
  alerts.jsonl          one JSON record per alert/advisory
"""

from __future__ import annotations

import os
from typing import Optional

from ..telemetry import log as fflog
from ..telemetry.recorder import MetricsRecorder
from .drift import DriftMonitor, make_recalibration_state
from .explain import write_strategy_report
from .health import HealthMonitor, default_rules


class DiagnosticsManager:
    def __init__(self, model, session, drift_threshold: float = 0.5,
                 abort_on: tuple = (), recalibrate: bool = False,
                 rules=None):
        self.model = model
        self.session = session
        self.directory = session.directory
        self.alerts_path = os.path.join(self.directory, "alerts.jsonl")
        self._alerts = MetricsRecorder(self.alerts_path)
        self.health = HealthMonitor(
            rules if rules is not None
            else default_rules(getattr(model, "config", None)),
            abort_on=tuple(abort_on), sink=self._sink_alert)
        self.drift_threshold = float(drift_threshold)
        self._recalibrate = bool(recalibrate)
        self.drift: Optional[DriftMonitor] = None
        self.report: Optional[dict] = None
        # elastic controller (elastic/controller.py), set by
        # ElasticController.attach_diagnostics: when present it is the
        # single consumer of drift advisories (on_step forwards them) and
        # the monitor's own recompile hook stays disarmed — one sustained
        # excursion, one trigger
        self.elastic = None

    # ------------------------------------------------------------ compile

    def on_compile(self):
        """Write the strategy explain report and arm the drift monitor
        with the chosen plan's predicted makespan."""
        from .. import telemetry

        with telemetry.span("diagnostics.explain"):
            self.report = write_strategy_report(self.model, self.directory)
        if self.report is None:
            return
        predicted = self.report["total_predicted_s"]
        self.model._predicted_step_s = predicted
        rs = (make_recalibration_state(self.model)
              if self._recalibrate and self.elastic is None else None)
        self.drift = DriftMonitor(predicted,
                                  threshold=self.drift_threshold,
                                  recompile_state=rs)
        telemetry.event(
            "strategy_report", path=os.path.join(
                self.directory, "strategy_report.json"),
            total_predicted_s=predicted,
            mode=self.report["mode"],
            runner_ups=len(self.report["runner_ups"]))
        fflog.info(
            "diagnostics: strategy report written to %s "
            "(predicted step makespan %.3f ms, mode=%s)",
            os.path.join(self.directory, "strategy_report.md"),
            predicted * 1e3, self.report["mode"])

    # ------------------------------------------------------------ steps

    def on_step(self, rec: dict):
        """One per-step record (the metrics.jsonl step schema + loss).
        Raises health.HealthAbort when an abort-listed rule fires."""
        # health first: a NaN-loss abort should not be preceded by a
        # drift advisory computed from the same broken step
        self.health.observe_step(rec)
        if self.drift is not None:
            dev = rec.get("device_time_s")
            if dev is not None:
                adv = self.drift.observe(int(rec.get("step", 0)),
                                         float(dev))
                if adv is not None:
                    self._alerts.record("advisory", **adv.to_record())
                    fflog.warning("diagnostics: %s", adv.message)
                    if self.elastic is not None:
                        self.elastic.on_advisory(adv)

    def on_profile(self, section: dict):
        """One profiled step's op-grain attribution (ffscope): annotate
        with the plan's predictions, persist as the report's `profile`
        section, feed the ffpulse registry, and let the drift monitor
        derive op-grain advisories (the targeted-recalibration
        trigger). Also the landing path for profiling.py's standalone
        per-op numbers — one schema, two sources."""
        from .. import telemetry
        from ..scope.attribution import annotate_with_predictions
        from .explain import rewrite_strategy_report

        if self.report is not None:
            annotate_with_predictions(section, self.report)
            self.report["profile"] = section
            rewrite_strategy_report(self.report, self.directory)
        for row in section.get("ops", []):
            if row.get("measured_s", 0.0) > 0:
                telemetry.observe("op_time_s", row["measured_s"],
                                  op=row["name"])
        telemetry.event("profile", step=section.get("step"),
                        source=section.get("source"),
                        attributed_s=section.get("attributed_s"),
                        device_time_s=section.get("device_time_s"))
        # op-grain drift only from in-situ captures (the port's Kineto
        # trace keeps the JAX package's source name, "xplane", which both
        # packages' doctors gate on): standalone
        # kernels are timed unfused, so their fidelity says nothing
        # about the entries the running plan was priced with
        if self.drift is not None and section.get("source") == "xplane":
            for adv in self.drift.note_profile(section):
                self._alerts.record("advisory", **adv.to_record())
                fflog.warning("diagnostics: %s", adv.message)

    def note_checkpoint_commit(self, t: Optional[float]):
        rule = self.health.rule("ckpt_stale")
        if rule is not None:
            rule.note_commit(t)

    # ------------------------------------------------------------ alerts

    def _sink_alert(self, alert):
        from .. import telemetry

        self._alerts.record("alert", **alert.to_record())
        telemetry.instant(f"alert.{alert.rule}", step=alert.step,
                          level=alert.level)
        emit = fflog.error if alert.level == "error" else fflog.warning
        emit("diagnostics[%s]: %s", alert.rule, alert.message)

    # ------------------------------------------------------------ lifecycle

    def on_fit_end(self):
        """Summarize into the metrics log; alerts.jsonl stays open for a
        later fit() on the same model (close() finalizes)."""
        from .. import telemetry

        n_alerts = len(self.health.alerts)
        n_adv = len(self.drift.advisories) if self.drift else 0
        telemetry.event("diagnostics_summary", alerts=n_alerts,
                        drift_advisories=n_adv,
                        drift_error_ema=(self.drift.error_ema
                                         if self.drift else None))
        if n_alerts or n_adv:
            fflog.warning(
                "diagnostics: %d health alert(s), %d drift advisory/ies — "
                "see %s", n_alerts, n_adv, self.alerts_path)

    def close(self):
        self._alerts.close()
