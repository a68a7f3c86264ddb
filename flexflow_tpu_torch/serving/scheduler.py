"""Continuous-batching scheduler: iteration-level request admission.

Orca (OSDI '22, PAPERS.md) is the grounding: the unit of scheduling is ONE
decode iteration, not one request. The engine keeps a fixed set of `slots`
(the decode graph's batch dim); every iteration the scheduler admits
pending requests into free slots (prefill) and evicts completed ones, so
a long generation never holds short requests hostage behind a static
batch — the throughput lever serving systems live on.

A copy of `flexflow_tpu/serving/scheduler.py`.
This module is pure host-side policy (no torch): Request/Slot bookkeeping,
admission order (FCFS), and completion rules (EOS token, per-request
max_new_tokens, KV-cache capacity). The device work lives in engine.py.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

_request_ids = itertools.count(1)


@dataclass
class Request:
    """One generation request and, after completion, its result."""

    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 → greedy
    eos_id: Optional[int] = None
    request_id: int = field(default_factory=lambda: next(_request_ids))
    # lifecycle (filled by the engine)
    generated: list[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""  # eos | max_tokens | length
    submit_t: float = field(default_factory=time.perf_counter)
    admit_t: Optional[float] = None  # slot assignment (queue wait ends)
    first_token_t: Optional[float] = None  # TTFT anchor
    last_token_t: Optional[float] = None  # previous token (TBT anchor)
    finish_t: Optional[float] = None
    # longest cached prefix extent the radix cache matched at admission
    # (block-granular; 0 on a cold miss, None before admission)
    matched_prefix_len: Optional[int] = None

    @property
    def trace_id(self) -> str:
        """Request-grain trace id threaded through every span/event of
        this request's lifecycle (queued→admitted→prefill→tokens→done)."""
        return f"req-{self.request_id}"

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def tokens(self) -> list[int]:
        """prompt + generated — the full sequence as the model saw it."""
        return list(self.prompt) + list(self.generated)


class Slot:
    """One row of the fixed decode batch."""

    def __init__(self, index: int):
        self.index = index
        self.request: Optional[Request] = None
        self.length = 0  # cache rows filled (prompt + generated fed back)
        self.last_token = 0  # next decode iteration's input token
        # chunked prefill cursor: prompt tokens already written to the
        # cache (admission sets it — nonzero when a shared prefix was
        # mapped instead of recomputed); None once decoding
        self.prefill_pos: Optional[int] = None
        self.admit_seq = 0  # admission order (prefill scheduling is FCFS)

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return self.request is not None and self.prefill_pos is not None

    @property
    def decoding(self) -> bool:
        return self.request is not None and self.prefill_pos is None

    def assign(self, request: Request):
        self.request = request
        self.length = 0
        self.last_token = 0
        self.prefill_pos = 0

    def release(self) -> Request:
        req = self.request
        self.request = None
        self.length = 0
        self.prefill_pos = None
        return req


class ContinuousBatchingScheduler:
    """Fixed-slot FCFS admission + per-iteration completion policy."""

    def __init__(self, num_slots: int, max_seq_len: int):
        if num_slots < 1:
            raise ValueError(f"need at least 1 slot, got {num_slots}")
        self.slots = [Slot(i) for i in range(num_slots)]
        self.max_seq_len = int(max_seq_len)
        self.pending: list[Request] = []
        self.completed: list[Request] = []
        self._admit_counter = 0  # admission order (prefill FCFS key)

    # ------------------------------------------------------------ intake

    def submit(self, request: Request) -> Request:
        if not request.prompt:
            raise ValueError("empty prompt")
        if len(request.prompt) > self.max_seq_len:
            raise ValueError(
                f"prompt of {len(request.prompt)} tokens exceeds the KV "
                f"cache ({self.max_seq_len} rows); raise max_seq_len")
        self.pending.append(request)
        return request

    # ------------------------------------------------------------ state

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    @property
    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]

    @property
    def free_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.free]

    @property
    def drained(self) -> bool:
        return not self.pending and not self.active_slots

    def admissions(self, can_admit=None) -> list[tuple[Slot, Request]]:
        """Admit pending requests into free slots (FCFS), one batch of
        admissions per iteration — the Orca admission point. `can_admit`
        (optional callable Request -> bool) is the engine's resource gate
        (paged: enough free pool blocks for the request's worst case); a
        False answer BLOCKS the queue head rather than admitting a later
        request past it, so admission order — and therefore slot
        assignment and token streams — never depends on pool pressure."""
        out = []
        for slot in self.free_slots:
            if not self.pending:
                break
            if can_admit is not None and not can_admit(self.pending[0]):
                break
            req = self.pending.pop(0)
            slot.assign(req)
            req.admit_t = time.perf_counter()
            self._admit_counter += 1
            slot.admit_seq = self._admit_counter
            out.append((slot, req))
        return out

    # ------------------------------------------------------------ completion

    def note_token(self, slot: Slot, token: int) -> bool:
        """Record one sampled token for `slot`'s request; apply the
        completion rules and release the slot when any fires. Returns
        whether the request finished. The engine owns `slot.length` (cache
        rows already written); this only decides continue-vs-finish.
        Rules, in order:
          - eos: the request's eos_id was sampled (the eos token is kept
            in `generated` so the caller sees why decoding stopped)
          - max_tokens: the request hit its max_new_tokens budget
          - length: the KV cache is full — feeding this token back would
            write past the last real cache row
        """
        req = slot.request
        req.generated.append(int(token))
        now = time.perf_counter()
        if req.first_token_t is None:
            req.first_token_t = now
        req.last_token_t = now
        reason = ""
        if req.eos_id is not None and int(token) == int(req.eos_id):
            reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            reason = "max_tokens"
        elif slot.length >= self.max_seq_len:
            reason = "length"
        if reason:
            req.finished = True
            req.finish_reason = reason
            req.finish_t = now
            self.completed.append(slot.release())
            return True
        slot.last_token = int(token)
        return False
