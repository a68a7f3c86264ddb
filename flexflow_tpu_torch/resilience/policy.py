"""When to checkpoint, and how to die gracefully (twin of
`flexflow_tpu/resilience/policy.py`).

CheckpointPolicy decides *when* a snapshot is taken (every N steps, every T
seconds, or both, whichever fires first). PreemptionHandler turns SIGTERM
(a cloud preemption notice) into a flag the fit loop polls between steps:
on notice, the loop drains the in-flight async save, writes one final
snapshot, and returns; the final save is the only synchronous one.

Under a process group of more than one rank the flag is agreed at each
step boundary (`PreemptionHandler.poll`: one small all-reduce, MAX, over
a gloo group on the host), so ranks whose signals land at different
steps all stop at the same one; the JAX package reads each process's own
flag.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass


@dataclass
class CheckpointPolicy:
    """every_n_steps=0 and every_t_seconds=0 -> only explicit/final saves."""

    every_n_steps: int = 0
    every_t_seconds: float = 0.0

    def __post_init__(self):
        self._last_save_time = time.monotonic()
        if self.every_t_seconds > 0:
            from ..distributed import process_count

            if process_count() > 1:
                # wall-clock triggers read each rank's own clock: skew
                # would make ranks decide to save at different steps, and
                # the snapshot's gather is a collective. Only the
                # step-count trigger is deterministic across ranks.
                import warnings

                warnings.warn(
                    "every_t_seconds is not multi-host safe (clock skew "
                    "diverges the save decision across processes); "
                    "disabled — use every_n_steps", stacklevel=2)
                self.every_t_seconds = 0.0

    def should_save(self, step: int) -> bool:
        if self.every_n_steps > 0 and step % self.every_n_steps == 0:
            return True
        if (self.every_t_seconds > 0
                and time.monotonic() - self._last_save_time
                >= self.every_t_seconds):
            return True
        return False

    def should_save_range(self, start_step: int, end_step: int) -> bool:
        """True when ANY step in (start_step, end_step] triggers the
        policy: the pipelined engine's chunk-boundary form (a chunk that
        ran steps 5..8 with every_n_steps=4 must still save)."""
        if end_step <= start_step:
            return False
        if (self.every_n_steps > 0
                and end_step // self.every_n_steps
                > start_step // self.every_n_steps):
            return True
        if (self.every_t_seconds > 0
                and time.monotonic() - self._last_save_time
                >= self.every_t_seconds):
            return True
        return False

    def notify_saved(self):
        self._last_save_time = time.monotonic()


# the host group the preemption flag is agreed over, made once per world
# (making a group is collective: every rank makes it at its first fit
# with checkpointing, in the same order)
_FLAG_GROUP: dict = {}


def _flag_group():
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None  # the default group already runs on the host
    world = dist.get_world_size()
    if world not in _FLAG_GROUP:
        _FLAG_GROUP[world] = dist.new_group(backend="gloo")
    return _FLAG_GROUP[world]


class PreemptionHandler:
    """Context manager installing a SIGTERM (and optionally SIGINT) handler
    that records the preemption instead of killing the process mid-save.
    The previous handler is chained on exit; installation is skipped off the
    main thread (signal module restriction): `preempted` then only reflects
    `request()` calls (the test hook)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._previous: dict = {}
        self._group = None

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def request(self):
        """Programmatic preemption notice (tests / external schedulers)."""
        self._flag.set()

    def poll(self) -> bool:
        """The flag, agreed over the process group (collective: every
        rank calls it at the same step boundary): true on every rank once
        any rank got the notice."""
        from ..distributed import process_count

        if process_count() <= 1:
            return self.preempted
        import torch
        import torch.distributed as dist

        flag = torch.tensor([1 if self.preempted else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
        if int(flag[0]):
            self._flag.set()
        return self.preempted

    def _handle(self, signum, frame):
        self._flag.set()

    def __enter__(self):
        from ..distributed import process_count

        if process_count() > 1:
            self._group = _flag_group()
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not on the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:  # pragma: no cover - defensive
                pass
        self._previous.clear()
        return False
