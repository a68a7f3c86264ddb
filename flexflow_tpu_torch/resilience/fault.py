"""Deterministic failure injection for resilience tests (a copy of
`flexflow_tpu/resilience/fault.py`).

A FaultInjector installed via `FFModel.set_fault_hook` is called after
every optimizer step with the global step number; at step K it raises
SimulatedPreemption — the mid-run death the test suite uses to prove
kill → auto-resume (onto a different mesh) → identical final metrics.
"""

from __future__ import annotations


class SimulatedPreemption(RuntimeError):
    """Raised by FaultInjector to simulate the process dying mid-fit."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption after step {step}")
        self.step = step


class FaultInjector:
    """kill_after_step=K → raise on the K-th completed optimizer step.
    `fired` records whether the fault triggered (a test that configured a
    kill which never fired is itself broken)."""

    def __init__(self, kill_after_step: int):
        if kill_after_step <= 0:
            raise ValueError("kill_after_step must be positive")
        self.kill_after_step = int(kill_after_step)
        self.fired = False

    def __call__(self, step: int):
        if step >= self.kill_after_step and not self.fired:
            self.fired = True
            raise SimulatedPreemption(step)
