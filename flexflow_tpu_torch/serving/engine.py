"""ServingEngine: continuous-batching inference on the decode graph (twin
of `flexflow_tpu/serving/engine.py`).

scheduler.py is the policy side, paged.py the block-pool side. Every
`step()` runs exactly ONE device call (`Executor.build_decode_step`): at
most one prefill CHUNK (plan_chunks buckets, power-of-two widths) in the
admitted slot's rows, while every DECODING slot advances one token in
column 0 of the same call. Padding columns point at the scratch row /
scratch block, so slot rows are computed independently and a decoding
slot's token stream is the same either way.

KV layouts: "paged" (default) keeps per-layer block pools + per-slot page
tables with copy-on-write prompt-prefix sharing managed host-side by
paged.BlockManager; COW copies run through `Executor.build_block_copy`
before the step that writes. "contiguous" keeps the (slots, max_seq+1,
embed) per-slot cache.

A pure-decode iteration (q_len 1) runs the decode kernels K2/K3 and the
LayerNorm kernel K1 on CUDA. On the card the decode step is a CUDA graph
per q width (`Executor.build_decode_step`): 1 and the power-of-two prefill
buckets, O(log chunk) graphs, as the JAX engine's bucketing bounds its
executables; the step's inputs go from the host into that graph's own
buffers, and the weights come from the decode model's cache of
compute-dtype copies.

Telemetry (JAX `serving/engine.py:184-222, 446-545, 662-686, 811-1045`):
an engine-owned metrics registry (queue-wait, TTFT, TBT, end-to-end and
device-step histograms, slot and block-pool gauges, token and
completion counters), attached to the trained model's telemetry session
where it has one, whose spans and events the engine's operations write
(`_active`); `metrics_summary` gives their percentiles mid-run or after
a drain (`note_drain`), `reset_stats` opens a measured window,
`profile_step` attributes one iteration's device time to the ops (run
eagerly), --xprof-dir runs the drain loop under torch.profiler, and with
--sanitize-numerics each decode step's probes are checked
(`_check_numerics`: a `serve.nonfinite` event once per op and phase).
The token fetch already syncs every step, so none of these adds a sync.
Elastic re-planning, KV handoff and the speculative engine of the JAX
package are later slices of the port.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..engine.chunking import plan_chunks
from ..fftype import OperatorType as OT
from .decode_graph import ServingSpec, adopt_params, build_decode_model
from .paged import BlockManager
from .scheduler import ContinuousBatchingScheduler, Request


class ServingEngine:
    def __init__(self, model, **overrides):
        cfg = model.config
        spec = ServingSpec(
            slots=cfg.serve_slots,
            max_seq_len=cfg.serve_max_seq_len,
            prefill_chunk=cfg.serve_prefill_chunk,
            kv_layout=cfg.serve_kv_layout,
            kv_block_size=cfg.serve_kv_block_size,
            kv_num_blocks=cfg.serve_kv_blocks,
        )
        for k, v in overrides.items():
            if not hasattr(spec, k):
                raise ValueError(f"serve(): unknown option {k!r}")
            setattr(spec, k, v)
        if spec.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if spec.prefix_cache is None:
            spec.prefix_cache = bool(cfg.serve_prefix_cache)
        self.model = model
        self.spec = spec
        self.telemetry = model._telemetry
        with self._active():
            t0 = time.perf_counter()
            with telemetry.span("serve.compile", slots=spec.slots):
                self.decode_model, self.max_seq_len = build_decode_model(
                    model, spec)
                self.adopted = adopt_params(self.decode_model, model)
                self._step_fn = (
                    self.decode_model.executor.build_decode_step())
            telemetry.event(
                "serve.compile", duration_s=time.perf_counter() - t0,
                slots=spec.slots, max_seq_len=self.max_seq_len,
                prefill_chunk=spec.prefill_chunk, kv_layout=spec.kv_layout,
                plan_source=self.decode_model._plan_source,
                weights_adopted=self.adopted,
                mesh_axes={k: int(v) for k, v
                           in self.decode_model.mesh.shape.items()})
            if self.telemetry is not None:
                self.telemetry.flush()
        self.scheduler = ContinuousBatchingScheduler(spec.slots,
                                                     self.max_seq_len)
        self.num_chips = int(self.decode_model.mesh.size)
        self._gen: Optional[torch.Generator] = None  # Gumbel sampling
        # paged layout: host-side block manager + the in-place COW copy;
        # pool geometry comes from the BUILT op
        self.block_manager = None
        self._copy_fn = None
        if spec.kv_layout == "paged":
            attn = next(
                n for n in self.decode_model.graph.topo_order()
                if n.op_type == OT.OP_PAGED_INC_MULTIHEAD_ATTENTION)
            p = attn.params
            self.block_manager = BlockManager(
                p.num_blocks, p.block_size, p.blocks_per_slot,
                sharing=spec.prefix_sharing,
                cross_time=bool(spec.prefix_cache))
            self._copy_fn = self.decode_model.executor.build_block_copy()
        # graph input roles: exactly one token stream + the positions /
        # page-table feeds
        self._token_input = None
        for t in self.decode_model._input_tensors:
            if t.name in ("positions", "page_table"):
                continue
            if self._token_input is not None:
                raise ValueError(
                    f"serving needs exactly one token input; model has "
                    f"{self._token_input!r} and {t.name!r}")
            self._token_input = t.name
        if self._token_input is None:
            raise ValueError("serving: model has no token input")
        # sanitizer baseline: reports from before this engine (a training
        # NaN earlier in the process) are not decode corruption
        self._numerics_reported: set = set()
        if self.decode_model.config.sanitize_numerics:
            from ..sanitize import get_monitor

            self._numerics_reported = {
                (e["op"], e["phase"]) for e in get_monitor().snapshot()}
        # run accounting (stats())
        self._decode_iterations = 0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._device_s = 0.0
        self._last_wall_s = 0.0
        self._last_step_device_s = 0.0
        self.last_profile = None
        # the metrics plane: engine-owned, so metrics_summary works with
        # no telemetry dir and reset_stats zeroes the serving series
        # alone; every series a step touches is made here
        from ..telemetry.metrics import MetricsRegistry

        reg = self.metrics = MetricsRegistry()
        self._h_queue_wait = reg.histogram("serve_queue_wait_s")
        self._h_ttft = reg.histogram("serve_ttft_s")
        self._h_tbt = reg.histogram("serve_tbt_s")
        self._h_e2e = reg.histogram("serve_e2e_s")
        self._h_step_device = reg.histogram("serve_step_device_s")
        self._g_slots_active = reg.gauge("serve_slots_active")
        self._g_slots_total = reg.gauge("serve_slots_total")
        self._g_slots_total.set(spec.slots)
        self._g_queue_depth = reg.gauge("serve_queue_depth")
        self._g_blocks_free = reg.gauge("serve_kv_blocks_free")
        self._g_blocks_used = reg.gauge("serve_kv_blocks_used")
        self._g_blocks_reserved = reg.gauge("serve_kv_blocks_reserved")
        self._c_cow_copies = reg.counter("serve_cow_copies_total")
        self._g_prefix_cached = reg.gauge(
            "serve_prefix_cache_blocks", state="cached")
        self._g_prefix_pinned = reg.gauge(
            "serve_prefix_cache_blocks", state="pinned")
        self._c_prefix_hits = reg.counter("serve_prefix_cache_hits_total")
        self._c_prefix_misses = reg.counter(
            "serve_prefix_cache_misses_total")
        self._c_prefix_evictions = reg.counter(
            "serve_prefix_cache_evictions_total")
        self._h_matched_prefix = reg.histogram("serve_matched_prefix_len")
        self._evictions_seen = 0
        self._c_tokens_out = reg.counter("serve_tokens_generated_total")
        self._c_prefill_tok = reg.counter("serve_prefill_tokens_total")
        self._c_completed = {
            r: reg.counter("serve_requests_completed_total", reason=r)
            for r in ("eos", "max_tokens", "length")}
        if self.telemetry is not None:
            self.telemetry.attach_registry(reg)
            if cfg.metrics_interval or cfg.metrics_port:
                self.telemetry.start_exporter(
                    interval_s=cfg.metrics_interval,
                    port=cfg.metrics_port)

    # ------------------------------------------------------------ session

    @contextlib.contextmanager
    def _active(self):
        """Route module-level telemetry to the trained model's session for
        one engine operation. No flush here: step() runs once a token."""
        tel = self.telemetry
        if tel is None:
            yield
            return
        telemetry.activate(tel)
        try:
            yield
        finally:
            telemetry.deactivate(tel)

    # ------------------------------------------------------------ intake

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None) -> Request:
        """Queue one request (FCFS). Defaults come from the ServingSpec. A
        request the paged pool could never serve is rejected here."""
        req = Request(
            prompt=[int(t) for t in prompt],
            max_new_tokens=(self.spec.max_new_tokens
                            if max_new_tokens is None else max_new_tokens),
            temperature=0.0 if temperature is None else float(temperature),
            eos_id=self.spec.eos_id if eos_id is None else eos_id,
        )
        mgr = self.block_manager
        if mgr is not None:
            needed = mgr.blocks_needed(len(req.prompt), req.max_new_tokens)
            if needed > mgr.num_blocks - 1:
                raise ValueError(
                    f"request needs {needed} KV blocks worst-case but the "
                    f"pool only has {mgr.num_blocks - 1} allocatable "
                    f"blocks; raise kv_num_blocks (or lower "
                    f"max_new_tokens / kv_block_size)")
        return self.scheduler.submit(req)

    # ------------------------------------------------------------ device step

    def _bucket(self, n: int) -> int:
        """Smallest power-of-two >= n, capped at prefill_chunk: the
        length-bucket set of prefill widths."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.spec.prefill_chunk)

    def _feed(self, tokens: np.ndarray, positions: np.ndarray) -> dict:
        """One decode-graph call's inputs on the host: the token stream,
        positions and, for the paged layout, the page tables."""
        xs = {self._token_input: tokens, "positions": positions}
        if self.block_manager is not None:
            mgr = self.block_manager
            xs["page_table"] = np.asarray(
                [mgr.table(i) for i in range(self.spec.slots)], np.int32)
        return xs

    def _stage_inputs(self, tokens: np.ndarray,
                      positions: np.ndarray) -> dict:
        """`_feed`'s inputs on the model's device."""
        return self.decode_model.executor.stage_inputs(
            self._feed(tokens, positions))

    def _run_step(self, tokens: np.ndarray, positions: np.ndarray,
                  read_idx: np.ndarray) -> np.ndarray:
        """One decode-graph call: the host inputs go to the step (into its
        graph's buffers on the card), which updates the KV state in place;
        returns the sampled tokens."""
        dec = self.decode_model
        xs = {k: torch.as_tensor(v)
              for k, v in self._feed(tokens, positions).items()}
        if self._gen is None:
            self._gen = torch.Generator(device=dec.device).manual_seed(
                dec.config.seed)
        temp = np.zeros((self.spec.slots,), np.float32)
        for s in self.scheduler.active_slots:
            temp[s.index] = s.request.temperature
        t0 = time.perf_counter()
        dec._state, next_tok = self._step_fn(
            dec._params, dec._state, xs,
            torch.as_tensor(read_idx, dtype=torch.int32), self._gen,
            torch.as_tensor(temp))
        out = next_tok.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0  # fflint: ok raw_timer_in_hot_path
        self._device_s += dt
        self._last_step_device_s = dt
        self._h_step_device.observe(dt)
        if dec.config.sanitize_numerics:
            self._check_numerics()
        return out

    def _check_numerics(self):
        """Sanitizer check after a decode step (--sanitize-numerics): the
        token fetch above drained the step, so its probes' table is
        current; a new non-finite report surfaces once per (op, phase)
        as a `serve.nonfinite` event and an error log, instead of the
        engine sampling from a NaN'd logits row in silence."""
        from ..sanitize import get_monitor
        from ..telemetry import log as fflog

        seen = self._numerics_reported
        for e in get_monitor().snapshot():
            key = (e["op"], e["phase"])
            if key in seen:
                continue
            seen.add(key)
            telemetry.event("serve.nonfinite", op=e["op"],
                            phase=e["phase"])
            fflog.error(
                "serving: non-finite tensor at op %s (%s) during decode — "
                "the KV cache or weights are numerically dead",
                e["op"], e["phase"])

    # ------------------------------------------------------------ paged

    def _can_admit(self, req: Request) -> bool:
        """Paged admission gate: reserve the request's worst case so a
        decode write can never exhaust the pool mid-flight."""
        return self.block_manager.reserve(
            req.request_id, len(req.prompt), req.max_new_tokens)

    def _apply_copies(self, copies):
        """Run this iteration's COW copies on the pool state, in place.
        (The JAX engine pads the vectors to a power of two to bound its
        set of compiled executables; eager PyTorch compiles nothing.)"""
        if not copies:
            return
        dec = self.decode_model
        src = torch.as_tensor([c.src for c in copies]).to(dec.device)
        dst = torch.as_tensor([c.dst for c in copies]).to(dec.device)
        self._c_cow_copies.inc(len(copies))
        with telemetry.span("serve.cow_copy", blocks=len(copies)):
            dec._state = self._copy_fn(dec._state, src, dst)

    def _prepare_writes(self, slot_positions: dict[int, range]):
        """Paged pre-step bookkeeping: make every block this iteration
        writes slot-owned (allocating / COW-copying via the BlockManager)
        and apply the copies to the device pools BEFORE the step runs."""
        if self.block_manager is None:
            return
        copies = []
        for idx, positions in slot_positions.items():
            copies.extend(self.block_manager.ensure_writable(idx, positions))
        self._apply_copies(copies)

    def _note_completion(self, slot, req: Request):
        if self.block_manager is not None:
            self.block_manager.release(slot.index)
        self.record_completion(req)

    def record_completion(self, req: Request):
        """Request-grain completion accounting: the end-to-end histogram,
        the reason counter, and the `serve.request` event."""
        if req.e2e_s is not None:
            self._h_e2e.observe(req.e2e_s)
        c = self._c_completed.get(req.finish_reason)
        if c is None:  # unknown reason: its labeled child made off-path
            c = self.metrics.counter("serve_requests_completed_total",
                                     reason=req.finish_reason or "unknown")
        c.inc()
        telemetry.instant("serve.done", request=req.request_id,
                          trace=req.trace_id, reason=req.finish_reason)
        telemetry.event(
            "serve.request", request_id=req.request_id,
            trace=req.trace_id,
            prompt_tokens=len(req.prompt), new_tokens=len(req.generated),
            finish_reason=req.finish_reason,
            ttft_s=req.ttft_s,
            queue_wait_s=req.queue_wait_s,
            matched_prefix_len=req.matched_prefix_len,
            total_s=(req.finish_t - req.submit_t
                     if req.finish_t is not None else None))

    # ------------------------------------------------------------ iterate

    def next_feed(self):
        """Admit pending requests, then assemble this iteration's call:
        (tokens, positions, read_idx, pre, start, n, decoding). `pre` is
        the slot whose prefill chunk [start, start+n) rides the call, or
        None; `decoding` are the slots advancing one token. Paged blocks
        the call writes are made writable here, so the returned feed can
        be run as it is."""
        sched = self.scheduler
        gate = self._can_admit if self.block_manager is not None else None
        for slot, req in sched.admissions(can_admit=gate):
            if self.block_manager is not None:
                self.block_manager.bind_reservation(req.request_id,
                                                    slot.index)
            self._h_queue_wait.observe(req.queue_wait_s)
            telemetry.instant("serve.admitted", trace=req.trace_id,
                              slot=slot.index,
                              queue_wait_s=req.queue_wait_s)
        prefilling = [s for s in sched.slots if s.prefilling]
        decoding = [s for s in sched.slots if s.decoding]
        self._publish_slot_gauges(prefilling, decoding)
        if not prefilling and not decoding:
            return None

        # ---- this iteration's single prefill chunk (FCFS)
        pre = min(prefilling, key=lambda s: s.admit_seq) \
            if prefilling else None
        start = n = b = 0
        if pre is not None:
            mgr = self.block_manager
            if mgr is not None and pre.index not in mgr._tables:
                # lazy page-table build at first-chunk time, so a burst
                # of same-prefix requests still shares
                matched = mgr.match_prefix(pre.request.prompt)
                skip = mgr.admit(pre.index, pre.request.prompt)
                pre.prefill_pos = skip
                pre.request.matched_prefix_len = matched
                self._h_matched_prefix.observe(matched)
                (self._c_prefix_hits if skip
                 else self._c_prefix_misses).inc()
                if skip:
                    telemetry.instant(
                        "serve.prefix_hit", slot=pre.index,
                        shared_tokens=skip, matched_prefix_len=matched,
                        prompt_tokens=len(pre.request.prompt))
            L = len(pre.request.prompt)
            start, n = plan_chunks(pre.prefill_pos, L,
                                   self.spec.prefill_chunk)[0]
            b = self._bucket(n)
        q = max(b, 1)

        tokens = np.zeros((self.spec.slots, q), np.int32)
        # scratch positions everywhere but live elements: no other slot's
        # cache state moves
        positions = np.full((self.spec.slots, q), self.max_seq_len,
                            np.int32)
        read_idx = np.zeros((self.spec.slots,), np.int32)
        writes: dict[int, range] = {}
        if pre is not None:
            prompt = pre.request.prompt
            tokens[pre.index, :n] = prompt[start:start + n]
            positions[pre.index, :n] = np.arange(start, start + n,
                                                 dtype=np.int32)
            read_idx[pre.index] = n - 1
            writes[pre.index] = range(start, start + n)
        for s in decoding:
            tokens[s.index, 0] = s.last_token
            positions[s.index, 0] = s.length
            writes[s.index] = range(s.length, s.length + 1)
        self._prepare_writes(writes)
        return tokens, positions, read_idx, pre, start, n, decoding

    def _publish_slot_gauges(self, prefilling, decoding):
        """Per-iteration occupancy and block-pool gauges."""
        sched = self.scheduler
        self._g_slots_active.set(len(prefilling) + len(decoding))
        self._g_queue_depth.set(sched.queue_depth)
        if self.block_manager is not None:
            mgr = self.block_manager
            self._g_blocks_free.set(mgr.free_blocks)
            self._g_blocks_used.set(mgr.blocks_in_use)
            self._g_blocks_reserved.set(mgr.reserved_total)
            cached_only = mgr.cached_only_blocks
            self._g_prefix_cached.set(cached_only)
            self._g_prefix_pinned.set(mgr.cached_blocks - cached_only)
            ev = mgr.stats.radix_evictions
            if ev > self._evictions_seen:
                self._c_prefix_evictions.inc(ev - self._evictions_seen)
                self._evictions_seen = ev
        telemetry.counter("serve.slots", {
            "active": len(prefilling) + len(decoding),
            "queue": sched.queue_depth,
            "occupancy": (len(prefilling) + len(decoding))
            / max(1, len(sched.slots))})

    def step(self) -> list[Request]:
        """ONE scheduler iteration, ONE device call. Returns the requests
        that completed during this iteration."""
        sched = self.scheduler
        done_before = len(sched.completed)
        with self._active():
            feed = self.next_feed()
            if feed is None:
                return sched.completed[done_before:]
            tokens, positions, read_idx, pre, start, n, decoding = feed
            span = telemetry.span(
                "serve.prefill", slot=pre.index, trace=pre.request.trace_id,
                start=start, tokens=n, prompt_tokens=len(pre.request.prompt),
                decoding=len(decoding)) if pre is not None else \
                telemetry.span("serve.step", active=len(decoding))
            with span:
                next_tok = self._run_step(tokens, positions, read_idx)

            # ---- prefill bookkeeping (the chunk's writes landed)
            if pre is not None:
                self._prefill_tokens += n
                self._c_prefill_tok.inc(n)
                self._prefill_calls += 1
                pre.prefill_pos += n
                req = pre.request
                if pre.prefill_pos >= len(req.prompt):
                    pre.length = len(req.prompt)
                    pre.prefill_pos = None
                    if self.block_manager is not None:
                        self.block_manager.register_prompt(pre.index,
                                                           req.prompt)
                    # the final chunk's last live logits row samples the
                    # request's first token (TTFT lands here)
                    self._decode_tokens += 1
                    prev_t = req.last_token_t
                    if sched.note_token(pre, int(next_tok[pre.index])):
                        self._note_completion(pre, req)
                    self._observe_token(req, prev_t)
            # ---- decode bookkeeping
            if decoding:
                self._decode_iterations += 1
            for s in decoding:
                s.length += 1
                req = s.request
                self._decode_tokens += 1
                prev_t = req.last_token_t
                if sched.note_token(s, int(next_tok[s.index])):
                    self._note_completion(s, req)
                self._observe_token(req, prev_t)
        return sched.completed[done_before:]

    def _observe_token(self, req: Request, prev_t):
        """Latency bookkeeping for one sampled token: the request's first
        token lands TTFT, every later one a TBT observation."""
        self._c_tokens_out.inc()
        if prev_t is None:
            self._h_ttft.observe(req.ttft_s)
            telemetry.instant("serve.first_token", trace=req.trace_id,
                              ttft_s=req.ttft_s)
        else:
            self._h_tbt.observe(req.last_token_t - prev_t)

    @contextlib.contextmanager
    def _maybe_xprof(self):
        """--xprof-dir beyond fit: the drain loop runs under torch.profiler
        (scope/profile.xprof_trace), its Chrome trace exported there."""
        xdir = self.model.config.xprof_dir
        if not xdir:
            yield
            return
        from ..scope.profile import xprof_trace

        with xprof_trace(xdir):
            yield

    def profile_step(self) -> Optional[dict]:
        """ONE scheduler iteration under torch.profiler, its device time
        attributed to the serving model's ops (ffscope) — the serving twin
        of `model.profile_step()`. The iteration runs eagerly (a replay's
        kernels have no host range to attribute them by): the same
        function, the same kernels. Returns the profile section (also
        `self.last_profile`), or None when a capture is already running
        (--xprof-dir)."""
        from ..scope.profile import StepProfiler

        prof = StepProfiler()
        it = self._decode_iterations
        if not prof.begin(it):
            return None
        try:
            with self.decode_model.executor.scoped():
                self.step()
            if self.decode_model.device.type == "cuda":
                torch.cuda.synchronize(self.decode_model.device)
        except BaseException:
            prof.abandon()
            raise
        names = [n.name for n in self.model.graph.topo_order()]
        section = prof.end(it, names)
        prof.close()
        section["source"] = "serving"
        with self._active():
            for row in section["ops"]:
                if row["measured_s"] > 0:
                    telemetry.observe("op_time_s", row["measured_s"],
                                      op=row["name"])
        self.last_profile = section
        return section

    def run_until_drained(self, max_iterations: int = 0) -> list[Request]:
        """Iterate until queue and slots are empty; returns every request
        completed during the call. `max_iterations` > 0 bounds the loop."""
        done: list[Request] = []
        t0 = time.perf_counter()
        it = 0
        with self._maybe_xprof():
            while not self.scheduler.drained:
                done.extend(self.step())
                it += 1
                if max_iterations and it >= max_iterations:
                    break
        self.note_drain(time.perf_counter() - t0)
        return done

    def note_drain(self, wall_s: float):
        """Close one measured window: its wall-clock, the `serve.summary`
        event, and a drained metrics snapshot. The drain loop calls this;
        callers that step the engine themselves call it when their trace
        completes."""
        self._last_wall_s = wall_s
        with self._active():
            telemetry.event("serve.summary", **self.metrics_summary())
        if self.telemetry is not None:
            self.telemetry.write_metrics_snapshot(
                reason="serve_drain", drained=bool(self.scheduler.drained))
            self.telemetry.flush()

    def generate(self, prompts: Sequence[Sequence[int]],
                 **request_kw) -> list[list[int]]:
        """Submit every prompt, drain, return the generated token lists in
        submission order."""
        reqs = [self.submit(p, **request_kw) for p in prompts]
        self.run_until_drained()
        return [r.generated for r in reqs]

    # ------------------------------------------------------------ stats

    def reset_stats(self) -> None:
        """Zero the run accounting (and the completed-request list):
        a benchmark calls this after a warm-up drain so the measured
        window starts clean. Live slots and queue are untouched."""
        self.scheduler.completed.clear()
        self._decode_iterations = 0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._device_s = 0.0
        self._last_wall_s = 0.0
        # the series survive (the step loop holds them); the stats_reset
        # event marks the window's edge
        self.metrics.reset(prefix="serve_")
        self._g_slots_total.set(self.spec.slots)
        with self._active():
            telemetry.event("serve.stats_reset")
        if self.block_manager is not None:
            from .paged import PagedStats

            fresh = PagedStats()
            # live blocks carry over: the window's peak must dominate what
            # is resident when it opens
            fresh.blocks_in_use_peak = self.block_manager.blocks_in_use
            self.block_manager.stats = fresh
            self._evictions_seen = 0

    def stats(self) -> dict:
        """Run metrics of the last drain: rates over its wall-clock
        window (per chip of the decode mesh, and for the engine), with
        `device_s` the time spent inside device calls."""
        completed = self.scheduler.completed
        sched = self.scheduler
        wall = self._last_wall_s
        ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
        # requests that never emitted a token are no TTFT sample, but
        # they count here
        no_token = (len(sched.pending)
                    + sum(1 for s in sched.active_slots
                          if s.request.first_token_t is None)
                    + sum(1 for r in completed if r.first_token_t is None))
        out = {
            "no_token_requests": no_token,
            "slots": self.spec.slots,
            "max_seq_len": self.max_seq_len,
            "num_chips": self.num_chips,
            "device": str(self.decode_model.device),
            "requests_completed": len(completed),
            "decode_iterations": self._decode_iterations,
            "decode_tokens": self._decode_tokens,
            "prefill_tokens": self._prefill_tokens,
            "prefill_calls": self._prefill_calls,
            "wall_s": wall,
            "device_s": self._device_s,
            "plan_source": self.decode_model._plan_source,
            "kv_layout": self.spec.kv_layout,
        }
        if self.block_manager is not None:
            mgr = self.block_manager
            out.update({
                "kv_block_size": mgr.block_size,
                "kv_pool_blocks": mgr.num_blocks,
                "kv_blocks_in_use_peak": mgr.stats.blocks_in_use_peak,
                "prefix_hit_rate": mgr.stats.prefix_hit_rate,
                "prefix_shared_tokens": mgr.stats.shared_tokens,
                "cow_copies": mgr.stats.cow_copies,
                "prefix_cache": bool(self.spec.prefix_cache),
                "cross_time_hits": mgr.stats.cross_time_hits,
                "radix_evictions": mgr.stats.radix_evictions,
                "radix_evicted_blocks": mgr.stats.radix_evicted_blocks,
                "prefix_cached_blocks": mgr.cached_blocks,
                "prefix_cached_only_blocks": mgr.cached_only_blocks,
                "kv_peak_vs_contiguous": (
                    self.spec.slots * (self.max_seq_len + 1)
                    / max(1, mgr.stats.blocks_in_use_peak
                          * mgr.block_size)),
            })
        if ttfts:
            out["ttft_p50_s"] = float(np.percentile(np.asarray(ttfts), 50))
            out["ttft_max_s"] = float(max(ttfts))
        if wall > 0:
            out["requests_per_sec"] = len(completed) / wall
            out["decode_tokens_per_sec"] = self._decode_tokens / wall
            out["requests_per_sec_per_chip"] = (
                len(completed) / wall / self.num_chips)
            out["decode_tokens_per_sec_per_chip"] = (
                self._decode_tokens / wall / self.num_chips)
        return out

    def metrics_summary(self) -> dict:
        """stats() plus request-grain latency percentiles (p50, p95, p99,
        max, mean of queue wait, TTFT, TBT and end to end) rebuilt from
        the engine's histograms: callable mid-run, and the drain's
        `serve.summary` event is exactly this dict."""
        from ..telemetry.metrics import percentile_from_hist

        out = self.stats()
        for short, h in (("queue_wait", self._h_queue_wait),
                         ("ttft", self._h_ttft),
                         ("tbt", self._h_tbt),
                         ("e2e", self._h_e2e)):
            if h.count == 0:
                continue
            hd = h.to_dict()
            for q in (50, 95, 99):
                out[f"{short}_p{q}_s"] = percentile_from_hist(hd, q)
            out[f"{short}_max_s"] = h.max
            out[f"{short}_mean_s"] = h.sum / h.count
        return out
