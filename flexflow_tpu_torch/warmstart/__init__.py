"""Warm start (twin of `flexflow_tpu/warmstart/`): the persistent plan
cache and calibration DB.

Makes the second compile of the same job skip its search
(`--warmstart-dir`):

1. plan cache     — the searched Strategy + mesh shape, content-addressed
                    by a fingerprint of everything the search consumed
                    (the card, torch and CUDA versions among them)
2. calibration DB — persisted on-card op measurements; calibration only
                    measures misses

Plus the `--auto-resume` fast path: the resilience checkpoint manifest
records the plan + structural fingerprint, so a preempted run restores its
plan here without searching. The JAX package's third layer, XLA's
persistent executable cache, has no counterpart on the card
(`enable_executable_cache` returns False).
"""

from .calibration_db import CalibrationDB
from .fingerprint import (
    calibration_fingerprint,
    full_fingerprint,
    graph_signature,
    structural_fingerprint,
)
from .manager import (
    WarmStartManager,
    enable_executable_cache,
    restore_plan,
    store_plan,
)
from .plan_cache import PlanCache

__all__ = [
    "CalibrationDB", "PlanCache", "WarmStartManager",
    "enable_executable_cache", "restore_plan", "store_plan",
    "graph_signature", "structural_fingerprint",
    "calibration_fingerprint", "full_fingerprint",
]
