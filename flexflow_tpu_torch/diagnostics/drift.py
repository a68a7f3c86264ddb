"""Online cost-model drift monitoring (twin of
`flexflow_tpu/diagnostics/drift.py`; `recalibrate_model` times the ops
on the model's device through the port's `CostModel.calibrate_graph` /
`calibrate_nodes`, `search/cost_model.py`).

FlexFlow earns trust in its search by measuring ops on the real device;
this module keeps checking that trust *during training*: each step's
measured device time (metrics.jsonl already splits it out of wall time) is
compared against the search's predicted step makespan, an EMA of the
relative prediction error is maintained, every sample lands in the
telemetry trace as a `costmodel.drift` counter, and when the EMA crosses
the threshold a structured advisory fires — once per sustained excursion —
which can drive `recompile.RecompileState` re-calibration
(`make_recalibration_state` builds the canonical one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class DriftAdvisory:
    """Structured drift advisory (also serialized into alerts.jsonl)."""

    step: int
    predicted_s: float
    measured_ema_s: float
    error_ema: float        # EMA of |measured − predicted| / predicted
    threshold: float
    message: str = ""

    def to_record(self) -> dict:
        return {
            "rule": "costmodel_drift", "level": "warning",
            "step": int(self.step),
            "predicted_s": float(self.predicted_s),
            "measured_ema_s": float(self.measured_ema_s),
            "error_ema": float(self.error_ema),
            "threshold": float(self.threshold),
            "message": self.message,
        }


@dataclass
class OpDriftAdvisory:
    """Op-grain drift advisory (ffscope): one profiled step's measured
    device time for ONE op deviated from its predicted cost beyond the
    threshold — the targeted-recalibration trigger, so the response
    refreshes exactly this op's calibration entry."""

    step: int
    op: str
    predicted_s: float
    measured_s: float
    fidelity: float          # measured_s / predicted_s
    threshold: float
    message: str = ""

    def to_record(self) -> dict:
        return {
            "rule": "costmodel_op_drift", "level": "warning",
            "step": int(self.step),
            "op": self.op,
            "predicted_s": float(self.predicted_s),
            "measured_s": float(self.measured_s),
            "fidelity": float(self.fidelity),
            "threshold": float(self.threshold),
            "message": self.message,
        }


class DriftMonitor:
    """EMA drift detector over per-step (predicted, measured) pairs.

    - warmup: the first `warmup` samples only feed the EMA (step 1 carries
      jit compile; early EMAs are noise);
    - hysteresis: after an advisory the monitor re-arms only when the EMA
      falls back under threshold/2 (or after a recalibration resets the
      prediction), so a sustained excursion yields ONE advisory, not one
      per step;
    - `recompile_state`: an optional recompile.RecompileState whose
      trigger/alter pair runs when an advisory fires — the reference's
      dynamic re-optimization hook (recompile_state.cc) pointed at
      cost-model re-calibration.
    """

    def __init__(self, predicted_s: float, threshold: float = 0.5,
                 warmup: int = 5, ema_alpha: float = 0.2,
                 recompile_state=None):
        self.predicted_s = float(predicted_s)
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.ema_alpha = float(ema_alpha)
        self.recompile_state = recompile_state
        self.error_ema: Optional[float] = None
        self.measured_ema: Optional[float] = None
        self.samples = 0
        self.advisories: list[DriftAdvisory] = []
        self._armed = True
        # ffscope op-grain state: advisories from profiled steps and the
        # set of op names whose calibration entries await a targeted
        # refresh (consumed by recalibrate_model(ops=...))
        self.op_advisories: list[OpDriftAdvisory] = []
        self.pending_op_refresh: set = set()

    def set_prediction(self, predicted_s: float):
        """Point the monitor at a fresh prediction (post-recalibration);
        resets the error EMA so stale error doesn't instantly re-fire."""
        self.predicted_s = float(predicted_s)
        self.error_ema = None
        self.samples = 0
        self._armed = True

    def observe(self, step: int, measured_s: float
                ) -> Optional[DriftAdvisory]:
        """Feed one step's measured device time; returns an advisory when
        sustained drift crosses the threshold (else None)."""
        from .. import telemetry

        if (not math.isfinite(measured_s) or measured_s <= 0.0
                or self.predicted_s <= 0.0):
            return None
        err = abs(measured_s - self.predicted_s) / self.predicted_s
        a = self.ema_alpha
        self.error_ema = (err if self.error_ema is None
                          else (1 - a) * self.error_ema + a * err)
        self.measured_ema = (measured_s if self.measured_ema is None
                             else (1 - a) * self.measured_ema
                             + a * measured_s)
        self.samples += 1
        telemetry.counter("costmodel.drift", {
            "error_ema": self.error_ema,
            "predicted_ms": self.predicted_s * 1e3,
            "measured_ms": measured_s * 1e3,
        })
        if self.samples <= self.warmup:
            return None
        if not self._armed:
            if self.error_ema < self.threshold / 2:
                self._armed = True
            return None
        if self.error_ema <= self.threshold:
            return None
        self._armed = False
        adv = DriftAdvisory(
            step=step, predicted_s=self.predicted_s,
            measured_ema_s=self.measured_ema, error_ema=self.error_ema,
            threshold=self.threshold,
            message=(f"cost-model drift: EMA prediction error "
                     f"{self.error_ema:.2f} > {self.threshold:.2f} "
                     f"(predicted {self.predicted_s * 1e3:.3f} ms, "
                     f"measured EMA {self.measured_ema * 1e3:.3f} ms)"))
        self.advisories.append(adv)
        telemetry.instant("costmodel.drift.advisory", step=step,
                          error_ema=self.error_ema)
        if self.recompile_state is not None and self.recompile_state.trigger():
            self.recompile_state.alter()
        return adv

    def note_profile(self, section: dict) -> list:
        """Feed one profiled step's op-grain measurements (the report
        ``profile`` section) and return the op advisories it produced.

        An op drifts when its fidelity (measured/predicted) deviates
        from the step-level fidelity by more than the threshold — the
        step-level baseline absorbs the global measured-vs-predicted
        scale (a CPU mesh runs every op slower than the roofline by
        roughly the same factor; what matters for *targeted* refresh is
        the op whose ratio broke away from the pack). Drifted op names
        accumulate in `pending_op_refresh` until a recalibration
        consumes them."""
        from .. import telemetry

        step = int(section.get("step", 0))
        rows = [r for r in section.get("ops", [])
                if r.get("predicted_s") and r.get("measured_s", 0.0) > 0]
        if not rows:
            return []
        fids = [r["measured_s"] / r["predicted_s"] for r in rows]
        fids.sort()
        baseline = fids[len(fids) // 2]  # median fidelity
        if baseline <= 0:
            return []
        out = []
        for r in rows:
            fid = r["measured_s"] / r["predicted_s"]
            rel = abs(fid - baseline) / baseline
            if rel <= self.threshold:
                continue
            adv = OpDriftAdvisory(
                step=step, op=r["name"],
                predicted_s=float(r["predicted_s"]),
                measured_s=float(r["measured_s"]),
                fidelity=fid, threshold=self.threshold,
                message=(f"op-grain drift: {r['name']} fidelity "
                         f"{fid:.2f} vs step median {baseline:.2f} "
                         f"(rel dev {rel:.2f} > {self.threshold:.2f})"))
            self.op_advisories.append(adv)
            self.pending_op_refresh.add(r["name"])
            telemetry.instant("costmodel.op_drift.advisory",
                              step=step, op=r["name"], fidelity=fid)
            out.append(adv)
        return out


def recalibrate_model(model, top_k: int = 4, ops=None) -> Optional[float]:
    """Re-measure the plan's dominant ops on the local device
    (CostModel.calibrate_graph, remeasure=True) and refresh the model's
    predicted step makespan — the canonical drift response, shared by the
    recompile hook (make_recalibration_state) and the elastic controller's
    replan path. Persisting the refreshed readings into the warm-start DB
    happens HERE and only here (coordinator-only), so however the
    recalibration was triggered the entries land exactly once. Returns
    the refreshed prediction, or None when the model carries no search
    result to recalibrate."""
    # warm-started runs (plan cache / checkpoint / broadcast) carry no
    # search result; the explain report reconstructed an equivalent
    # (UnitySearch, choice) for the ADOPTED plan — use it, so drift
    # recalibration works exactly on the runs that reload persisted
    # calibration entries
    sr = (getattr(model, "_search_result", None)
          or getattr(model, "_replay_search", None))
    if sr is None:
        return None
    us, choice = sr
    diag = getattr(model, "_diagnostics", None)
    device = getattr(model, "device", None)
    if device is not None and device.type == "cuda":
        import torch

        # called between steps: the replay in flight ends before the ops
        # are timed (on graphs of their own, on tensors of their own; the
        # tensors the training steps hold are not touched)
        torch.cuda.synchronize(device)
    # ffscope targeted refresh: when the trigger was an op-grain
    # advisory, only the drifted ops' entries are re-measured and
    # persisted — undrifted ops keep their (still valid) measurements
    if ops is None and diag is not None and diag.drift is not None \
            and diag.drift.pending_op_refresh:
        ops = sorted(diag.drift.pending_op_refresh)
    refreshed_keys = None
    if ops:
        refreshed_keys = us.cm.calibrate_nodes(
            model.graph, ops, remeasure=True)
        if diag is not None and diag.drift is not None:
            diag.drift.pending_op_refresh.difference_update(ops)
    else:
        # remeasure: the monitor fired BECAUSE the cached measurements
        # no longer describe the device — refresh them, don't skip them
        us.cm.calibrate_graph(model.graph, top_k=top_k, remeasure=True)
    us.cm._cache.clear()
    warm = getattr(model, "_warmstart", None)
    if warm is not None:
        # persist the refreshed readings (coordinator-only inside
        # save_from's caller contract): the stale DB entries were
        # feeding the plan-cache fingerprint, so the next restart
        # would otherwise reload them and re-fire drift forever
        from ..distributed import is_coordinator

        if is_coordinator():
            if refreshed_keys is not None:
                warm.calibration_db.save_entries(us.cm, refreshed_keys)
            else:
                warm.calibration_db.save_from(us.cm)
    t, _ = us.evaluate(choice)
    model._predicted_step_s = t
    if diag is not None and diag.drift is not None:
        diag.drift.set_prediction(t)
    return t


def make_recalibration_state(model, top_k: int = 4):
    """A RecompileState whose alter() runs `recalibrate_model` — the
    drift response when NO elastic controller is attached. Attach it via
    DiagnosticsManager(..., recalibrate=True) or pass it to a
    DriftMonitor directly. (With --elastic the controller consumes the
    advisory instead and recalibrates inside its replan, so the manager
    does not arm this hook — one excursion, one trigger.)"""
    from ..recompile import RecompileState

    def _alter(ff):
        recalibrate_model(ff, top_k=top_k)

    return RecompileState(trigger_func=lambda ff: True,
                          alter_func=_alter, ffmodel=model)
