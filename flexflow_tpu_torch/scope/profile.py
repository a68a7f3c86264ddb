"""Sampled op-grain step capture (``--profile-every K`` /
``model.profile_step()``; twin of `flexflow_tpu/scope/profile.py`).

One profiled step runs under ``torch.profiler.profile(activities=[CPU,
CUDA])`` (the JAX package's ``jax.profiler.start_trace``), its Chrome
trace is exported under the trace root and fed through
:mod:`flexflow_tpu_torch.scope.attribution` to produce the report
``profile`` section: per-op ``measured_s`` next to the plan's
``predicted_s``. Captures are sampled (every K steps, or a one-shot armed
by ``model.profile_step()``) because tracing a step is not free, and the
sampled step runs eagerly (its caller runs it under the executor's
`scoped()`): a CUDA-graph replay shows its kernels but no host range to
attribute them by. The section says so (``"mode": "eager_sampled"``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterable, Optional

from . import attribution

__all__ = ["StepProfiler", "profiler_active", "xprof_trace"]


def profiler_active() -> bool:
    """Whether a torch.profiler capture is running in this process (a
    second one cannot start inside it)."""
    import torch

    return bool(torch.autograd.profiler._is_profiler_enabled)


def activities() -> list:
    """The host, and the card where there is one."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def xprof_trace(directory: str):
    """--xprof-dir: everything inside runs under torch.profiler, its
    Chrome trace exported to `directory` at the end (the JAX package's
    `jax.profiler.trace` passthrough). Inside a capture already running
    (e.g. a surrounding profile) it does nothing."""
    from torch.profiler import profile

    if profiler_active():
        yield
        return
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        directory, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


class StepProfiler:
    """Owns capture cadence + trace dirs for op-grain profiling."""

    def __init__(self, every: int = 0, trace_root: Optional[str] = None,
                 keep_traces: bool = False):
        self.every = int(every)
        self.trace_root = trace_root
        self.keep_traces = bool(keep_traces)
        self._armed = False           # one-shot via model.profile_step()
        self._capturing: Optional[str] = None
        self._prof = None
        self._t0 = 0.0
        self._owns_root = False
        self.last_section: Optional[Dict[str, Any]] = None
        # the last capture's raw attribution (scope/attribution.py), with
        # the device events no op or scope took
        self.last_attr: Optional[Dict[str, Any]] = None

    @property
    def enabled(self) -> bool:
        return self.every > 0 or self._armed

    def arm(self) -> None:
        """Request a one-shot capture of the next step."""
        self._armed = True

    def should_capture(self, step: int) -> bool:
        if self._armed:
            return True
        # Skip step 0: it folds warm-up and capture time into the trace.
        return self.every > 0 and step > 0 and step % self.every == 0

    # ---------------------------------------------------------- capture

    def _root(self) -> str:
        if self.trace_root is None:
            self.trace_root = tempfile.mkdtemp(prefix="ffscope-")
            self._owns_root = True
        os.makedirs(self.trace_root, exist_ok=True)
        return self.trace_root

    def begin(self, step: int) -> bool:
        """Start tracing one step. Returns False when a capture is
        already running (``--xprof-dir`` wraps the whole fit): the
        profiler does not nest. A profiler that fails to start raises."""
        from torch.profiler import profile

        if profiler_active():
            self._armed = False
            return False
        trace_dir = os.path.join(self._root(), "step%06d" % step)
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities())
        prof.__enter__()
        self._prof = prof
        self._capturing = trace_dir
        self._t0 = time.perf_counter()
        return True

    def end(self, step: int, op_names: Iterable[str],
            device_time_s: Optional[float] = None
            ) -> Optional[Dict[str, Any]]:
        """Stop tracing, attribute, and return the profile section.

        ``device_time_s`` defaults to the wall-clock window from `begin`
        (the caller synchronized the device before calling this).
        """
        trace_dir, self._capturing = self._capturing, None
        prof, self._prof = self._prof, None
        self._armed = False
        if trace_dir is None:
            return None
        wall_s = time.perf_counter() - self._t0
        prof.__exit__(None, None, None)
        if device_time_s is None:
            device_time_s = wall_s
        names = list(op_names)
        try:
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            attr = attribution.attribute_trace(trace_dir, names)
        finally:
            if not self.keep_traces:
                shutil.rmtree(trace_dir, ignore_errors=True)
        section = attribution.build_profile_section(
            attr, step=step, device_time_s=float(device_time_s),
            source="xplane", all_op_names=names)
        section["mode"] = "eager_sampled"
        self.last_section = section
        self.last_attr = attr
        return section

    def abandon(self) -> None:
        """Stop a capture without attribution (the step raised)."""
        if self._capturing is None:
            return
        trace_dir, self._capturing = self._capturing, None
        prof, self._prof = self._prof, None
        self._armed = False
        prof.__exit__(None, None, None)
        shutil.rmtree(trace_dir, ignore_errors=True)

    def close(self) -> None:
        self.abandon()
        if self._owns_root and self.trace_root and not self.keep_traces:
            shutil.rmtree(self.trace_root, ignore_errors=True)
