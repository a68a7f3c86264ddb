"""DEPRECATED module-level checkpoint API (twin of
`flexflow_tpu/checkpoint.py`): `save_checkpoint` and `restore_checkpoint`
route through the resilience subsystem (atomic commit, cross-mesh
restore) and warn. Use `FFModel.save_checkpoint`/`load_checkpoint`,
`FFModel.enable_checkpointing` or `flexflow_tpu_torch.resilience`
directly.
"""

from __future__ import annotations

import warnings
from typing import Optional


def save_checkpoint(ffmodel, path: str, step: Optional[int] = None):
    """Deprecated: use FFModel.save_checkpoint (atomic, resilience-backed).
    Saves the full training state as a committed checkpoint under root
    `path`; returns the committed checkpoint directory."""
    warnings.warn(
        "flexflow_tpu_torch.checkpoint.save_checkpoint is deprecated; use "
        "FFModel.save_checkpoint or flexflow_tpu_torch.resilience",
        DeprecationWarning, stacklevel=2)
    return ffmodel.save_checkpoint(path)


def restore_checkpoint(ffmodel, path: str):
    """Deprecated: use FFModel.load_checkpoint (reshard-aware — the saving
    mesh may differ from this model's)."""
    warnings.warn(
        "flexflow_tpu_torch.checkpoint.restore_checkpoint is deprecated; use "
        "FFModel.load_checkpoint or flexflow_tpu_torch.resilience",
        DeprecationWarning, stacklevel=2)
    return ffmodel.load_checkpoint(path)
