"""Leveled, multihost-aware logging for the framework.

Replaces bare `print(...)` progress reporting (the reference prints from
every rank; a 64-host pod interleaves 64 copies of every epoch line).

- Levels: debug < info < warning < error. The threshold comes from
  `FF_LOG_LEVEL` (name or number; default "info") and can be changed at
  runtime with `set_level`.
- Multihost: by default only process 0 emits (`FF_LOG_ALL_HOSTS=1` opts
  every host in; warnings and errors always emit everywhere — a rank-3
  failure must not be invisible).
- Output goes to stdout for info/debug (the reference's epoch lines are
  stdout, and AE scripts grep them there) and stderr for warning/error.

Usage: `from flexflow_tpu_torch.telemetry import log; log.info("epoch %d", e)`.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40
_NAMES = {"debug": DEBUG, "info": INFO, "warning": WARNING, "error": ERROR}
_LABELS = {DEBUG: "DEBUG", INFO: "INFO", WARNING: "WARNING", ERROR: "ERROR"}

_level: Optional[int] = None  # resolved lazily so env set after import works


def _resolve_level() -> int:
    global _level
    if _level is None:
        raw = os.environ.get("FF_LOG_LEVEL", "info").strip().lower()
        _level = _NAMES.get(raw)
        if _level is None:
            try:
                _level = int(raw)
            except ValueError:
                _level = INFO
    return _level


def set_level(level) -> None:
    """Set the threshold: a name ("debug") or a numeric level."""
    global _level
    if isinstance(level, str):
        _level = _NAMES.get(level.strip().lower(), INFO)
    else:
        _level = int(level)


def _is_host0() -> bool:
    """Rank 0 of torch.distributed when it is initialised, else True."""
    return process_index() == 0


def process_index() -> int:
    """This process's rank in torch.distributed, or 0 when no process
    group is initialised (the twin of `jax.process_index()`)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def process_count() -> int:
    """The world size of torch.distributed, or 1 without a process group
    (the twin of `jax.process_count()`)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def _emit(level: int, msg: str, *args) -> None:
    if level < _resolve_level():
        return
    if (level < WARNING and not _is_host0()
            and os.environ.get("FF_LOG_ALL_HOSTS", "") != "1"):
        return
    if args:
        try:
            msg = msg % args
        except (TypeError, ValueError):
            msg = " ".join([msg] + [str(a) for a in args])
    stream = sys.stderr if level >= WARNING else sys.stdout
    if level == INFO:
        print(msg, file=stream)  # epoch lines stay grep-compatible
    else:
        print(f"[{_LABELS.get(level, level)}] {msg}", file=stream)
    stream.flush()


def debug(msg: str, *args) -> None:
    _emit(DEBUG, msg, *args)


def info(msg: str, *args) -> None:
    _emit(INFO, msg, *args)


def warning(msg: str, *args) -> None:
    _emit(WARNING, msg, *args)


def error(msg: str, *args) -> None:
    _emit(ERROR, msg, *args)
