"""ResilienceManager: glue between FFModel.fit and the checkpoint stack
(twin of `flexflow_tpu/resilience/manager.py`).

Owns one AsyncCheckpointer + CheckpointPolicy for a compiled model, knows
how to snapshot the model's full training state (whole tensors:
reshard.logical_state_tree) with the fit loop's cursor, and restores the
newest committed checkpoint (`auto_resume`) before training.
"""

from __future__ import annotations

from typing import Optional

from .checkpointer import AsyncCheckpointer, latest_checkpoint
from .policy import CheckpointPolicy
from .reshard import RNG_KIND, logical_state_tree, restore_model


class ResilienceManager:
    def __init__(self, ffmodel, directory: str,
                 policy: Optional[CheckpointPolicy] = None, keep: int = 3):
        self.ffmodel = ffmodel
        self.directory = directory
        self.policy = policy or CheckpointPolicy()
        self.checkpointer = AsyncCheckpointer(directory, keep=keep)

    @classmethod
    def from_config(cls, ffmodel) -> Optional["ResilienceManager"]:
        """Build from FFConfig's --checkpoint-* flags; None when
        checkpointing is not configured."""
        cfg = ffmodel.config
        if not cfg.checkpoint_dir:
            return None
        policy = CheckpointPolicy(
            every_n_steps=cfg.checkpoint_every,
            every_t_seconds=cfg.checkpoint_every_seconds,
        )
        return cls(ffmodel, cfg.checkpoint_dir, policy,
                   keep=cfg.checkpoint_keep)

    # ------------------------------------------------------------ saving

    def _extras(self, step: int, cursor: Optional[dict]) -> dict:
        mesh = self.ffmodel.mesh
        extras = {
            # cursor epochs are ABSOLUTE (epochs completed since compile):
            # model.fit maps them back onto its within-call loop index and
            # keys the deterministic shuffle order on them
            "cursor": dict(cursor or {}),
            "py_step": int(step),
            "mesh_axes": {k: int(v) for k, v in mesh.shape.items()}
            if mesh is not None else {},
            # the ['rng'] leaf is a torch.Generator's state
            "rng_kind": RNG_KIND,
        }
        upd = getattr(self.ffmodel, "_update_sharding", None)
        if upd is not None:
            # how the saving run ran its weight update: informational,
            # since checkpoints hold whole arrays that a resume re-places
            # under the restoring compile's update mode
            extras["update_sharding"] = {
                "enabled": bool(upd.get("enabled")),
                "stage": int(upd.get("stage", 0)),
                "shards": int(upd.get("shards", 1)),
                "axes": list(upd.get("axes", [])),
            }
        plan = getattr(self.ffmodel, "_plan_record", None)
        if plan:
            # the applied plan + structural fingerprint: --auto-resume
            # restores the plan from this manifest at compile
            # (warmstart/), so recovery skips the search
            extras["plan"] = plan
        return extras

    def maybe_save(self, step: int, cursor: Optional[dict] = None) -> bool:
        """Policy-gated async save after optimizer step `step`."""
        if not self.policy.should_save(step):
            return False
        self.save(step, cursor, blocking=False)
        return True

    def save(self, step: int, cursor: Optional[dict] = None,
             blocking: bool = False):
        self.checkpointer.save(
            step, logical_state_tree(self.ffmodel),
            extras=self._extras(step, cursor), blocking=blocking)
        self.policy.notify_saved()

    def last_commit_walltime(self) -> Optional[float]:
        """Wall-clock time of the newest committed checkpoint, or None
        before the first commit (the checkpointer stamps commits on the
        monotonic clock)."""
        import time

        lc = self.checkpointer._last_commit_t
        if lc is None:
            return None
        return time.time() - (time.monotonic() - lc)

    def finalize(self, step: Optional[int] = None,
                 cursor: Optional[dict] = None, final_save: bool = False):
        """Drain the in-flight async save; optionally write one last
        synchronous snapshot (the preemption path)."""
        self.checkpointer.wait()
        if final_save and step is not None:
            self.save(step, cursor, blocking=True)

    # ------------------------------------------------------------ restore

    def peek_latest(self) -> Optional[tuple]:
        """(path, extras) of the newest committed checkpoint WITHOUT
        restoring it: fit uses this to judge cursor staleness before
        rewinding any live state. None when no committed checkpoint
        exists."""
        import json
        import os

        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        return path, dict(manifest.get("extras") or {})

    def restore_path(self, path: str) -> dict:
        """Restore one committed checkpoint dir (resharding onto this
        model's mesh and plan); returns its extras."""
        import time

        from .. import telemetry

        t0 = time.perf_counter()
        with telemetry.span("ckpt.restore", path=path):
            extras = restore_model(self.ffmodel, path)
        self.last_restore_s = time.perf_counter() - t0
        telemetry.event("restore", path=path, duration_s=self.last_restore_s)
        # the fftrans gate put the verified TransitionPlan on the model:
        # land it in strategy_report.json (the compile-time report
        # predates the restore)
        _rewrite_report(self.ffmodel)
        return extras

    def restore_latest(self) -> Optional[dict]:
        """Restore the newest committed checkpoint. Returns the saved
        extras (cursor...) or None when no committed checkpoint exists."""
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_model(self.ffmodel, path)

    last_restore_s: Optional[float] = None


def _rewrite_report(model) -> Optional[dict]:
    """Re-write strategy_report.json after a restore so the `transition`
    section lands next to the compile-time attribution (JAX
    `resilience/migrate._rewrite_report`). No-op without diagnostics'
    report or a telemetry session."""
    session = getattr(model, "_telemetry", None)
    if session is None:
        return None
    from ..diagnostics.explain import write_strategy_report

    try:
        return write_strategy_report(model, session.directory)
    except Exception:  # a report must not fail a restore
        return None


def auto_resume(ffmodel, directory: Optional[str] = None) -> Optional[dict]:
    """Discover the newest committed checkpoint under `directory` (default:
    the model's --checkpoint-dir) and restore it into the compiled model.
    Returns the saved extras dict, or None when starting fresh."""
    directory = directory or ffmodel.config.checkpoint_dir
    if not directory:
        return None
    path = latest_checkpoint(directory)
    if path is None:
        return None
    return restore_model(ffmodel, path)
