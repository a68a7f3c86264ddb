"""ffelastic: drift/capacity-triggered live re-planning (twin of
`flexflow_tpu/elastic/`, docs/elastic.md).

The subsystem that turns the verification layers and the migration engine
into behavior: an ElasticController wired into fit (and the serving
engine's step loop) consumes DriftMonitor advisories and visible-device
capacity deltas, re-runs the Unity search online against recalibrated
measurements, gates the winner through the full compile-time verifier
stack (plan_source "replan"), prices the move with fftrans, and fires
migrate_state exactly when

    predicted_migration_s x fidelity_ratio < benefit_s_per_step x horizon

recording every decision (both sides of the inequality) as a `replan`
telemetry event, an `elastic` strategy-report section, and the doctor's
alerts. On a torchrun world the decisions are agreed over the ranks, and
a capacity shrink parks the ranks outside the new sub-mesh until a
regrow (controller.py).
"""

from .apply import PlanSnapshot, replan
from .controller import ElasticController
from .payoff import evaluate_payoff, load_fidelity, record_fidelity
from .triggers import CapacityDelta, CapacityWatcher

__all__ = [
    "CapacityDelta",
    "CapacityWatcher",
    "ElasticController",
    "PlanSnapshot",
    "evaluate_payoff",
    "load_fidelity",
    "record_fidelity",
    "replan",
]
