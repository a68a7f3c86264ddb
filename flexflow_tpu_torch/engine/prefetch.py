"""Background input pipeline: stage the NEXT chunk while this one runs
(twin of `flexflow_tpu/engine/prefetch.py`).

The per-step fit loop pays a synchronous host slice + copy inside every
step window. The prefetcher moves that work onto a daemon thread: for each
planned chunk it calls `stage_fn(chunk)` (the pipelined engine's: gather
the chunk's samples in epoch order into pinned host memory, copy them to
the device on a side stream, record an event) while the device is still
running the previous chunk. The queue is bounded (double-buffered by
default) so at most `depth` staged chunks wait; the consumer's
`data_wait` collapses to a queue pop. Given a CUDA `device`, the worker
makes it the thread's current device before it stages anything.

Shutdown contract (tested): `shutdown()` always leaves the thread dead:
on normal completion, on consumer-side aborts (injected preemptions), and
on staging errors, which are re-raised at the next `get()` rather than
vanishing on the worker thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional


class PrefetchExhausted(RuntimeError):
    """get() was called more times than there were chunks to stage."""


class ChunkPrefetcher:
    """Stages `stage_fn(chunk)` for each chunk on a background thread.

    `get()` returns staged payloads in chunk order; a staging exception
    is re-raised there (the training loop, not the worker, owns error
    handling). `shutdown()` is idempotent and safe from any state,
    including a worker blocked on a full queue."""

    def __init__(self, stage_fn: Callable, chunks: Iterable,
                 depth: int = 2, name: str = "ff-prefetch", device=None):
        self._stage_fn = stage_fn
        self._chunks = list(chunks)
        # the card the worker stages onto: a thread starts on card 0,
        # whatever this thread's current card is
        self._card = None
        if device is not None and device.type == "cuda":
            import torch

            self._card = (device.index if device.index is not None
                          else torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ worker

    def _put(self, item) -> bool:
        """Stop-aware blocking put: a consumer that aborted mid-epoch
        would otherwise leave the worker blocked on a full queue
        forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._card is not None:
                import torch

                torch.cuda.set_device(self._card)
            for chunk in self._chunks:
                if self._stop.is_set():
                    return
                staged = self._stage_fn(chunk)
                if not self._put(("ok", staged)):
                    return
            self._put(("done", None))
        except BaseException as e:  # noqa: BLE001 - must cross threads
            self._put(("error", e))

    # ------------------------------------------------------------ consumer

    def get(self, timeout: Optional[float] = None):
        """Next staged chunk payload (blocks while the worker stages).
        Raises the worker's exception if staging failed, and
        PrefetchExhausted past the last chunk."""
        kind, payload = self._q.get(timeout=timeout)
        if kind == "error":
            raise payload
        if kind == "done":
            raise PrefetchExhausted(
                "prefetcher exhausted: more get() calls than chunks")
        return payload

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def shutdown(self, timeout: float = 10.0) -> bool:
        """Stop the worker and join it. Idempotent; drains the queue so a
        blocked put wakes up. Called in the engine's finally, so no path
        (normal, SimulatedPreemption, staging error) leaks the thread.
        Returns False (and says so in the log) when the worker is wedged
        past `timeout` (a copy stuck against a lost device), instead of
        silently breaking the no-leak contract."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            from ..telemetry import log as fflog

            fflog.warning(
                "prefetcher: staging thread did not exit within %.0fs of "
                "shutdown (wedged device transfer?) — daemon thread left "
                "behind", timeout)
            return False
        return True
