"""Pipelined execution engine: fused multi-step dispatch for FFModel.fit
(twin of `flexflow_tpu/engine/pipelined.py`).

The per-step fit loop stages each batch synchronously inside its step
window and launches one replay a step. The engine runs the same math in
chunks:

  - **fused multi-step dispatch**: chunks of `pipeline_steps` train steps
    run as ONE replay of a CUDA graph that holds all of them
    (`Executor.build_chunked_train_step`), over batches staged with a
    leading chunk axis. Chunks are sub-epoch, the generator's draws and
    the step counters are the per-step loop's, and the per-step loss
    rides out as a vector: training is bit-identical to
    `pipeline_steps=1` (tested).
  - **async input pipeline**: a ChunkPrefetcher thread gathers the next
    chunk's samples (this rank's block of each) into pinned host memory
    and copies them to the device on a side stream, recording an event,
    while the device runs the current chunk. The step's stream waits on
    that event before the replay reads the chunk. The buffers rotate over
    `prefetch_depth + 2` slots, and a slot is refilled only after the
    event recorded behind the replay that read it, so a chunk in flight
    is never overwritten.
  - **deferred metrics sync**: ONE host fetch per chunk (the loss vector)
    and only under telemetry, whose per-step records are reconstructed
    from the chunk window (device time attributed as chunk/N), and with
    diagnostics (`diag`, JAX `engine/pipelined.py:126-291`) the health
    records too: each step's loss from the vector, the drift monitor fed
    chunk/N, the checkpoint staleness clock once a chunk.

Periodic work (checkpoints, preemption drain, a health abort agreed over
the ranks, fault hooks, the watchdog's beat) runs at chunk boundaries
only, so the resume cursor always lands on a chunk edge; on HealthAbort
the prefetch thread is shut down like on every other exit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from .chunking import plan_chunks
from .prefetch import ChunkPrefetcher


class _Slot:
    """One staging buffer set: pinned host and device tensors per input
    (and the labels), the event after its host-to-device copy, and the
    event after the replay that read it."""

    def __init__(self):
        self.host: dict = {}
        self.dev: dict = {}
        self.ready: Optional[torch.cuda.Event] = None
        self.consumed: Optional[torch.cuda.Event] = None

    def buffers(self, key, shape: tuple, dtype, device):
        h = self.host.get(key)
        if h is None or tuple(h.shape) != shape or h.dtype != dtype:
            h = self.host[key] = torch.empty(shape, dtype=dtype,
                                             pin_memory=True)
            self.dev[key] = torch.empty(shape, dtype=dtype, device=device)
        return h, self.dev[key]


class PipelinedEngine:
    """Drives one model's fit epochs in fused chunks. Constructed per fit
    call (cheap: the chunked steps live in the executor's cache)."""

    def __init__(self, model, pipeline_steps: int, prefetch_depth: int = 2):
        if pipeline_steps < 2:
            raise ValueError(
                f"PipelinedEngine needs pipeline_steps >= 2, got "
                f"{pipeline_steps} (use the eager loop for 1)")
        self.model = model
        self.pipeline_steps = int(pipeline_steps)
        self.prefetch_depth = int(prefetch_depth)
        self.device = model.device
        self._on_card = self.device.type == "cuda"
        if self._on_card:
            self._side = torch.cuda.Stream(self.device)
            self._slots = [_Slot() for _ in range(self.prefetch_depth + 2)]
            self._next_slot = 0

    # ------------------------------------------------------------ staging

    def _stage_chunk(self, x_dict: dict, y, order, start_b: int, n: int,
                     batch_size: int):
        """Host work for one chunk (runs on the prefetch thread): gather
        the chunk's samples in epoch order, this rank's block of each
        batch, stacked along a leading chunk axis; on the card through a
        pinned slot and a side-stream copy. Returns (slot, (xs, ys),
        ready event); slot and event are None on the CPU."""
        ex = self.model.executor
        with telemetry.span("prefetch.stage", steps=n, start_batch=start_b):
            lo = start_b * batch_size
            batches = []
            for i in range(n):
                idx = order[lo + i * batch_size: lo + (i + 1) * batch_size]
                batches.append((
                    ex.host_inputs({k: v[idx] for k, v in x_dict.items()}),
                    ex.host_labels(y[idx])))
            if not self._on_card:
                xs = {k: torch.stack([b[0][k] for b in batches])
                      for k in batches[0][0]}
                ys = torch.stack([b[1] for b in batches])
                return None, (xs, ys), None
            slot = self._slots[self._next_slot % len(self._slots)]
            self._next_slot += 1
            # the slot's last copy and the replay that read it are done
            # before its buffers are written again
            for ev in (slot.ready, slot.consumed):
                if ev is not None:
                    ev.synchronize()
            parts = {("x", k): [b[0][k] for b in batches]
                     for k in batches[0][0]}
            parts[("y", None)] = [b[1] for b in batches]
            out = {}
            for key, rows in parts.items():
                host, dev = slot.buffers(
                    key, (n,) + tuple(rows[0].shape), rows[0].dtype,
                    self.device)
                for i, r in enumerate(rows):
                    host[i].copy_(r)
                out[key] = (host, dev)
            with torch.cuda.stream(self._side):
                for host, dev in out.values():
                    dev.copy_(host, non_blocking=True)
                slot.ready = torch.cuda.Event()
                slot.ready.record(self._side)
            xs = {k: out[("x", k)][1] for k in batches[0][0]}
            return slot, (xs, out[("y", None)][1]), slot.ready

    # ------------------------------------------------------------ epoch

    def run_epoch(self, *, x_dict: dict, y, order, b0: int,
                  num_batches: int, batch_size: int, abs_e: int,
                  py_step: int, tel, resil, preempt, fault_hook,
                  tokens_per_example: int, diag=None,
                  watchdog=None) -> tuple[int, bool]:
        """Run batches [b0, num_batches) of one epoch in fused chunks.
        Mutates the model's training state in place (exactly like the
        per-step loop) and returns (py_step, preempted). HealthAbort and
        SimulatedPreemption propagate to fit's handlers; the prefetch
        thread is shut down on every exit path."""
        from ..model import peer_abort
        from ..scope import flightrec

        model = self.model
        chunks = plan_chunks(b0, num_batches, self.pipeline_steps)
        if not chunks:
            return py_step, False

        def stage(c):
            return self._stage_chunk(x_dict, y, order, c[0], c[1],
                                     batch_size)

        prefetcher = ChunkPrefetcher(stage, chunks,
                                     depth=self.prefetch_depth,
                                     device=self.device)
        preempted = False
        try:
            for start_b, n in chunks:
                t_chunk0 = time.perf_counter()
                slot, staged, ready = prefetcher.get()
                t_pop1 = time.perf_counter()
                chunk_fn = model.executor.build_chunked_train_step(n)
                with telemetry.span("chunk", steps=n, step0=py_step + 1):
                    if ready is not None:
                        torch.cuda.current_stream(self.device).wait_event(
                            ready)
                    (model._params, model._state, model._opt_slots,
                     model._step, model._counters, losses) = chunk_fn(
                        model._params, model._state, model._opt_slots,
                        model._step, model._counters, staged, model._rng)
                    if slot is not None:
                        slot.consumed = torch.cuda.Event()
                        slot.consumed.record(
                            torch.cuda.current_stream(self.device))
                    loss_host = None
                    if tel is not None:
                        # one fetch a chunk, under telemetry only: its
                        # records are timed to the chunk's end
                        loss_host = losses.detach().float().cpu().numpy()
                t_run1 = time.perf_counter()
                # a chunk that warmed up or captured its graph is no
                # sample of the chunk's time: its records keep the losses
                warming = getattr(chunk_fn, "last_call", "replay") not in (
                    "replay", "eager")
                py_step += n
                flightrec.note_step(py_step)
                if watchdog is not None:
                    watchdog.beat(py_step)
                end_b = start_b + n
                # the cursor names the NEXT batch to run on resume, always
                # a chunk edge; epochs are ABSOLUTE (since compile)
                if end_b >= num_batches:
                    cursor = {"epoch": abs_e + 1, "batch": 0}
                else:
                    cursor = {"epoch": abs_e, "batch": end_b}
                abort = None
                if diag is not None:
                    abort = self._health_records(
                        diag=diag, resil=resil, n=n, step0=py_step - n + 1,
                        abs_e=abs_e, t_chunk0=t_chunk0, t_pop1=t_pop1,
                        t_run1=t_run1, loss_host=loss_host,
                        warming=warming)
                if preempt is not None:
                    preempt.poll(abort=abort is not None)
                if abort is not None or (preempt is not None
                                         and preempt.aborted):
                    if tel is not None:
                        t_now = time.perf_counter()
                        self._synthesize_step_records(
                            tel=tel, n=n, step0=py_step - n + 1,
                            abs_e=abs_e, t_chunk0=t_chunk0, t_pop1=t_pop1,
                            t_run1=t_now, t_save1=t_now, loss_host=None,
                            batch_size=batch_size,
                            tokens_per_example=tokens_per_example)
                    raise abort or peer_abort(diag, py_step)
                if resil is not None:
                    if preempt is not None and preempt.preempted:
                        # the running chunk completed (a replay cannot be
                        # interrupted): drain the in-flight async save and
                        # take the one final synchronous snapshot here
                        telemetry.instant("preempted", step=py_step)
                        resil.finalize(py_step, cursor, final_save=True)
                        preempted = True
                    elif resil.policy.should_save_range(py_step - n,
                                                        py_step):
                        resil.save(py_step, cursor, blocking=False)
                t_save1 = time.perf_counter()
                if tel is not None:
                    self._synthesize_step_records(
                        tel=tel, n=n, step0=py_step - n + 1, abs_e=abs_e,
                        t_chunk0=t_chunk0, t_pop1=t_pop1, t_run1=t_run1,
                        t_save1=t_save1, loss_host=loss_host,
                        batch_size=batch_size,
                        tokens_per_example=tokens_per_example)
                if fault_hook is not None:
                    for s in range(py_step - n + 1, py_step + 1):
                        fault_hook(s)
                if preempted:
                    telemetry.event("preempted", step=py_step)
                    return py_step, True
        finally:
            prefetcher.shutdown()
        return py_step, False

    # ------------------------------------------------------------ telemetry

    def _health_records(self, *, diag, resil, n: int, step0: int,
                        abs_e: int, t_chunk0: float, t_pop1: float,
                        t_run1: float, loss_host: Optional[np.ndarray],
                        warming: bool):
        """The health and drift records of one chunk's steps (JAX
        `_synthesize_step_records`' diag half): each step's loss from the
        chunk's loss vector, its timings the chunk window's over n (device
        time chunk/N; the window ends before the boundary's save). A
        chunk that warmed up or captured reports its losses only: its
        timings would seed the spike and drift baselines wrong. Returns
        the HealthAbort an abort-listed rule raised (the caller agrees it
        over the ranks first), else None."""
        from ..diagnostics.health import HealthAbort

        data_wait = (t_pop1 - t_chunk0) / n
        step_time = (t_run1 - t_chunk0) / n
        if resil is not None:
            # the staleness clock advances once a chunk (saves only
            # happen at boundaries)
            diag.note_checkpoint_commit(resil.last_commit_walltime())
        for i in range(n):
            loss_i = (float(loss_host[i]) if loss_host is not None
                      else None)
            rec = {
                "step": step0 + i, "epoch": abs_e, "t": time.time(),
                "step_time_s": None if warming else step_time,
                "data_wait_s": None if warming else data_wait,
                "save_latency_s": None if warming else 0.0,
                "device_time_s": None if warming else max(
                    0.0, step_time - data_wait),
                "loss": loss_i,
            }
            # the probes carried each step of the chunk, so localization
            # names the step inside it
            rec.update(self.model._nonfinite_localization(loss_i))
            try:
                diag.on_step(rec)
            except HealthAbort as e:
                return e
        return None

    def _synthesize_step_records(self, *, tel, n: int, step0: int,
                                 abs_e: int, t_chunk0: float, t_pop1: float,
                                 t_run1: float, t_save1: float,
                                 loss_host: Optional[np.ndarray],
                                 batch_size: int, tokens_per_example: int):
        """Per-step telemetry records from one chunk's wall window, so
        every consumer (the metrics.jsonl schema, the trace's step lanes)
        keeps working: device time is attributed as chunk/N, the queue pop
        as the chunk's data_wait, the boundary save as its save_latency,
        spread evenly over the chunk's steps (their sum reproduces the
        chunk's wall time)."""
        data_wait = (t_pop1 - t_chunk0) / n
        save_lat = (t_save1 - t_run1) / n
        step_time = (t_save1 - t_chunk0) / n
        for i in range(n):
            step = step0 + i
            t0 = t_chunk0 + i * step_time
            tel.tracer.complete("step", t0, t0 + step_time, step=step,
                                synthesized=True)
            tel.tracer.complete("data_wait", t0, t0 + data_wait,
                                synthesized=True)
            tel.record_step(step, abs_e, step_time, data_wait, save_lat,
                            batch_size, tokens_per_example)
