"""Runtime NaN-provenance sanitizer (`--sanitize-numerics`; twin of
`flexflow_tpu/sanitize.py`).

The `nan_loss` health rule can only say "the run is dead"; this module
says WHICH op killed it. With the flag on, the executor puts a probe on
every op output, before the output fans out to its consumers:

  - forward: the output's minimum and maximum (`aminmax`, one kernel,
    one pass: a NaN propagates into both, an infinity into one) noted in
    a preallocated device buffer;
  - backward: an identity `torch.autograd.Function` whose backward notes
    the output's cotangent the same way;
  - at the end of each pass (the train step after its backward; eval,
    forward and decode after their forward) one `flush` folds every
    probe into a device table that keeps, per (probe, phase), the first
    step whose tensor was not finite: a `torch.where` on the step tensor
    the step holds, then a minimum. No host read, so it runs inside a
    captured step and inside a chunk's graph, where each step of the
    chunk flushes with its own step value (the chunk's base plus i), as
    JAX's probes carry the traced step inside `lax.scan`.

The JAX package's probe is a `jax.debug.callback` to the host, which a
CUDA graph cannot hold: here the host reads the table (one copy a
table) only when asked (`NumericsMonitor.snapshot`), which fit does at
the loss fetch it already makes, when the loss is not finite, and the
serving engine after a decode step's token fetch. A step-less pass (eval,
the granular forward, decode) sets its probe's step-less flag: its
events carry step -1.

Localization semantics (`NumericsMonitor.first_nonfinite`), JAX's:

  fwd — the FIRST op in topo order whose output is non-finite at the
        earliest affected step (NaN propagates downstream; the minimum
        is the origin).
  bwd — the op with the LARGEST topo index whose output cotangent is
        non-finite (the backward pass runs in reverse topo order, so
        cotangent NaN propagates toward smaller indices; the maximum is
        where the gradient first went bad).

The table keeps each probe's first non-finite step only; the events at
the earliest affected step, which localization reads, are all there.

Zero-cost when off: the executor inserts no probes. With the flag on the
probes are value-preserving identities (a view forward, the cotangent
passed through backward), put on each output before its consumers read
it, so the cotangent sums keep their order: the trajectory is
bit-identical.

`inject_nonfinite` / the grad twin are the matching fault injectors
(the executor's `set_numeric_fault` poisons exactly one op at one step).
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

# "no non-finite step seen" in a probe table's stepped column
NONE = 2 ** 31 - 1
_PHASES = ("fwd", "bwd")


class ProbeTable:
    """The device side of one executor's probes: an int32 tensor of
    (probes, 2 phases, 2): column 0 the first step whose tensor was not
    finite (NONE: none), column 1 the step-less flag. Probe i is
    (labels[i], topos[i]): JAX's op label (`name`, `name#out<i>`, or
    `loss`) and topo index.

    A probe (`fold`) is one kernel: its tensor's minimum and maximum
    written into `seen`, a buffer of the tensor's dtype, at the probe's
    (slot, phase). Once a pass has run, `flush` folds every probe's
    finiteness into the table at once: a few kernels a pass, where the
    fold of each probe into the table would be six a probe."""

    def __init__(self, labels, topos, device):
        self.labels = list(labels)
        self.topos = list(topos)
        self.index = {lab: i for i, lab in enumerate(self.labels)}
        n = len(self.labels)
        self.table = torch.empty((n, 2, 2), dtype=torch.int32,
                                 device=device)
        self.seen = {dt: torch.zeros((n, 2, 2), dtype=dt, device=device)
                     for dt in (torch.float32, torch.bfloat16,
                                torch.float16)}
        self.clear()

    def clear(self):
        with torch.no_grad():
            self.table[..., 0].fill_(NONE)
            self.table[..., 1].zero_()
            for buf in self.seen.values():
                buf.zero_()

    def fold(self, slot: int, phase: int, x: torch.Tensor):
        """Note `x`'s minimum and maximum at (slot, phase): one kernel,
        on the device."""
        with torch.no_grad():
            buf = self.seen.get(x.dtype)
            if buf is not None:
                torch.aminmax(x.detach(), out=(buf[slot, phase, 0],
                                               buf[slot, phase, 1]))
            else:
                lo, hi = torch.aminmax(x.detach())
                self.seen[torch.float32][slot, phase].copy_(
                    torch.stack([lo, hi]).float())

    def flush(self, step):
        """Fold the pass's probes into the table and clear them: for
        each (probe, phase) whose tensor was not finite, the table keeps
        min(its first step, `step`), or, step-less (`step` None), its
        flag. Device ops only."""
        with torch.no_grad():
            bad = None
            for buf in self.seen.values():
                b = torch.logical_not(torch.isfinite(buf).all(-1))
                bad = b if bad is None else bad | b
                buf.zero_()
            if step is None:
                cell = self.table[..., 1]
                torch.maximum(cell, bad.to(torch.int32), out=cell)
            else:
                cell = self.table[..., 0]
                torch.minimum(cell, torch.where(bad, step, NONE), out=cell)

    def read(self) -> list:
        """The table's events (one host copy)."""
        t = self.table.cpu().tolist()
        out = []
        for i, per_phase in enumerate(t):
            for p, (first, stepless) in enumerate(per_phase):
                if first != NONE:
                    out.append({"op": self.labels[i], "phase": _PHASES[p],
                                "topo": int(self.topos[i]),
                                "step": int(first)})
                if stepless:
                    out.append({"op": self.labels[i], "phase": _PHASES[p],
                                "topo": int(self.topos[i]), "step": -1})
        return out


class NumericsMonitor:
    """Host-side collector of non-finite reports. One per process
    (module singleton via get_monitor()): the events `report` was given
    and, at each `snapshot`, those of every live probe table."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self._tables: list = []  # weakrefs to ProbeTable

    def attach(self, table: ProbeTable):
        with self._lock:
            self._tables.append(weakref.ref(table))

    def _live(self) -> list:
        with self._lock:
            live = [r() for r in self._tables]
            self._tables = [r for r, t in zip(self._tables, live)
                            if t is not None]
            return [t for t in live if t is not None]

    def reset(self):
        with self._lock:
            self.events = []
        for t in self._live():
            t.clear()

    def report(self, op: str, phase: str, topo: int, step: int):
        with self._lock:
            self.events.append(
                {"op": op, "phase": phase, "topo": int(topo),
                 "step": int(step)})

    def snapshot(self) -> list[dict]:
        with self._lock:
            out = list(self.events)
        for t in self._live():
            out += t.read()
        return out

    def localize(self, step=None) -> Optional[dict]:
        """The origin (op, phase, step) record — at `step` when given,
        else at the earliest affected step. None when nothing non-finite
        was ever reported. Step-less reports (eval/forward/decode record
        step -1) only win when NO stepped event exists — an interleaved
        eval NaN must not outrank the training-step origin the nan_loss
        alert is attributing."""
        events = self.snapshot()
        if step is not None:
            events = [e for e in events if e["step"] == int(step)]
        stepped = [e for e in events if e["step"] >= 0]
        events = stepped or events
        if not events:
            return None
        s0 = min(e["step"] for e in events)
        at = [e for e in events if e["step"] == s0]
        fwd = [e for e in at if e["phase"] == "fwd"]
        if fwd:
            return min(fwd, key=lambda e: e["topo"])
        return max(at, key=lambda e: e["topo"])

    def first_nonfinite(self) -> Optional[dict]:
        return self.localize()


_MONITOR = NumericsMonitor()


def get_monitor() -> NumericsMonitor:
    return _MONITOR


# ---------------------------------------------------------------- probes


class _GradProbe(torch.autograd.Function):
    """Identity forward (a view); backward notes the cotangent in the
    probe table and passes it on unchanged."""

    @staticmethod
    def forward(ctx, x, table, slot):
        ctx.table, ctx.slot = table, slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.numel():
            ctx.table.fold(ctx.slot, 1, g)
        return g, None, None


def probe(x, table: ProbeTable, label: str):
    """Instrument one op output: its minimum and maximum noted in `table`
    (which the pass's `flush` folds with its step), and its cotangent's
    by the identity twin. Identity on the value."""
    if not (torch.is_tensor(x) and x.is_floating_point()) or not x.numel():
        return x
    slot = table.index[label]
    table.fold(slot, 0, x)
    if not x.requires_grad:
        return x
    return _GradProbe.apply(x, table, slot)


# ------------------------------------------------------- fault injection


def inject_nonfinite(x, step, at_step: int):
    """Forward fault injector: the tensor becomes NaN from `at_step` on
    (always, when no step counter is threaded — eval/decode paths)."""
    if step is None:
        return torch.full_like(x, float("nan"))
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(step >= at_step, nan, x)


class _InjectGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, at_step):
        ctx.step, ctx.at_step = step, at_step
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.step is None:  # a step-less pass counts as step -1
            return (g * float("nan") if ctx.at_step <= -1 else g), None, None
        one = torch.ones((), dtype=g.dtype, device=g.device)
        nan = torch.full((), float("nan"), dtype=g.dtype, device=g.device)
        return g * torch.where(ctx.step >= ctx.at_step, nan, one), None, None


def inject_grad_nonfinite(x, step, at_step: int):
    """Backward fault injector: identity forward; the output's cotangent
    is multiplied into NaN from `at_step` on."""
    if not x.requires_grad:
        return x
    return _InjectGrad.apply(x, step, at_step)
