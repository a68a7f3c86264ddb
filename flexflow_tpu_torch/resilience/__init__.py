"""Resilience subsystem (twin of `flexflow_tpu/resilience/`): async
atomic checkpointing, cross-mesh elastic resume and preemption-safe
training.

- `checkpointer`: copy-on-snapshot to pinned host buffers (queued on the
  step's stream, an event marking its end) + a background writer thread
  + atomic commit (tmp-dir -> fsync -> rename -> manifest), in the JAX
  package's file format, so a checkpoint of either package reads in the
  other;
- `reshard`: restore a checkpoint saved under one mesh and plan onto
  another, each rank its block of every whole array, written in place,
  after the fftrans gate (`verify_restore_transition`) verified the
  transition;
- `policy`: CheckpointPolicy (every N steps / T seconds) and the SIGTERM
  PreemptionHandler that drains the in-flight save and writes a final
  snapshot;
- `fault`: deterministic kill-after-step-K injection for tests;
- `manager`: ResilienceManager gluing the above into FFModel.fit, plus
  the `auto_resume` entry point;
- `migrate`: `migrate_state`, the in-process migration of live state
  between two compiled plans (the elastic re-planner's apply half), over
  the meshes' own process groups.
"""

from .checkpointer import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
)
from .fault import FaultInjector, SimulatedPreemption
from .manager import ResilienceManager, auto_resume
from .migrate import MigrationError, migrate_state
from .policy import CheckpointPolicy, PreemptionHandler
from .reshard import restore_model, restore_tree, verify_restore_transition

__all__ = [
    "AsyncCheckpointer",
    "CheckpointCorruptError",
    "CheckpointPolicy",
    "FaultInjector",
    "MigrationError",
    "PreemptionHandler",
    "ResilienceManager",
    "SimulatedPreemption",
    "auto_resume",
    "latest_checkpoint",
    "list_checkpoints",
    "load_checkpoint",
    "migrate_state",
    "restore_model",
    "restore_tree",
    "verify_restore_transition",
]
