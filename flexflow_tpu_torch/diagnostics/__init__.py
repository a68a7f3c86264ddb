"""Diagnostics: strategy explain, cost-model drift, run-health anomalies
(twin of `flexflow_tpu/diagnostics/`; `health.py` is a copy).

Three coupled pieces on top of the telemetry substrate
(docs/observability.md → "Diagnostics & run doctor"):

1. **Strategy explain** (explain.py) — after compile, attribute the chosen
   plan's predicted makespan per op/segment (compute vs comm vs reshard)
   and report the runner-up plans with the margin by which they lost:
   `strategy_report.json` + `strategy_report.md`.
2. **Drift monitor** (drift.py) — during fit, compare predicted step
   makespan against measured device time, EMA the prediction error, emit
   `costmodel.drift` trace counters, and raise a structured advisory
   (optionally driving recompile.RecompileState re-calibration) when the
   cost model no longer matches reality.
3. **Health monitor** (health.py) — a rule engine over per-step records
   (NaN/inf loss, step-time spikes, data-wait stalls, checkpoint
   staleness) emitting leveled alerts into `alerts.jsonl` with
   configurable warn/abort actions.

Enable with `--diagnostics` (requires `--telemetry-dir`) or
`model.enable_diagnostics()` (or the keras `Diagnostics` callback);
`doctor.diagnose` / `doctor.render` give a post-mortem of any telemetry
dir.
"""

from .drift import DriftAdvisory, DriftMonitor, make_recalibration_state
from .explain import (
    build_strategy_report,
    render_markdown,
    verify_report_total,
    write_strategy_report,
)
from .health import (
    Alert,
    CheckpointStalenessRule,
    DataWaitStallRule,
    HealthAbort,
    HealthMonitor,
    NaNLossRule,
    Rule,
    StepSpikeRule,
    default_rules,
)
from .manager import DiagnosticsManager

__all__ = [
    "DiagnosticsManager",
    "DriftAdvisory", "DriftMonitor", "make_recalibration_state",
    "build_strategy_report", "render_markdown", "verify_report_total",
    "write_strategy_report",
    "Alert", "HealthAbort", "HealthMonitor", "Rule", "default_rules",
    "NaNLossRule", "StepSpikeRule", "DataWaitStallRule",
    "CheckpointStalenessRule",
]
