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
compute-dtype copies. Telemetry, elastic re-planning, KV handoff and the
speculative engine of the JAX package are later slices of the port.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

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
        self.decode_model, self.max_seq_len = build_decode_model(model, spec)
        self.adopted = adopt_params(self.decode_model, model)
        self._step_fn = self.decode_model.executor.build_decode_step()
        self.scheduler = ContinuousBatchingScheduler(spec.slots,
                                                     self.max_seq_len)
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
        # run accounting (stats())
        self._decode_iterations = 0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._device_s = 0.0
        self._last_wall_s = 0.0

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
        self._device_s += time.perf_counter() - t0
        return out

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
        prefilling = [s for s in sched.slots if s.prefilling]
        decoding = [s for s in sched.slots if s.decoding]
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
                pre.prefill_pos = mgr.admit(pre.index, pre.request.prompt)
                pre.request.matched_prefix_len = matched
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

    def step(self) -> list[Request]:
        """ONE scheduler iteration, ONE device call. Returns the requests
        that completed during this iteration."""
        sched = self.scheduler
        done_before = len(sched.completed)
        feed = self.next_feed()
        if feed is None:
            return sched.completed[done_before:]
        tokens, positions, read_idx, pre, start, n, decoding = feed
        next_tok = self._run_step(tokens, positions, read_idx)

        # ---- prefill bookkeeping (the chunk's writes landed)
        if pre is not None:
            self._prefill_tokens += n
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
                # request's first token
                self._decode_tokens += 1
                if sched.note_token(pre, int(next_tok[pre.index])):
                    self._note_completion(pre, req)
        # ---- decode bookkeeping
        if decoding:
            self._decode_iterations += 1
        for s in decoding:
            s.length += 1
            req = s.request
            self._decode_tokens += 1
            if sched.note_token(s, int(next_tok[s.index])):
                self._note_completion(s, req)
        return sched.completed[done_before:]

    def run_until_drained(self, max_iterations: int = 0) -> list[Request]:
        """Iterate until queue and slots are empty; returns every request
        completed during the call. `max_iterations` > 0 bounds the loop."""
        done: list[Request] = []
        t0 = time.perf_counter()
        it = 0
        while not self.scheduler.drained:
            done.extend(self.step())
            it += 1
            if max_iterations and it >= max_iterations:
                break
        self._last_wall_s = time.perf_counter() - t0
        return done

    def generate(self, prompts: Sequence[Sequence[int]],
                 **request_kw) -> list[list[int]]:
        """Submit every prompt, drain, return the generated token lists in
        submission order."""
        reqs = [self.submit(p, **request_kw) for p in prompts]
        self.run_until_drained()
        return [r.generated for r in reqs]

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Run metrics of the last drain: rates over its wall-clock
        window, `device_s` the time spent inside device calls."""
        completed = self.scheduler.completed
        wall = self._last_wall_s
        out = {
            "slots": self.spec.slots,
            "max_seq_len": self.max_seq_len,
            "device": str(self.decode_model.device),
            "requests_completed": len(completed),
            "decode_iterations": self._decode_iterations,
            "decode_tokens": self._decode_tokens,
            "prefill_tokens": self._prefill_tokens,
            "prefill_calls": self._prefill_calls,
            "wall_s": wall,
            "device_s": self._device_s,
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
                "cross_time_hits": mgr.stats.cross_time_hits,
            })
        if wall > 0:
            out["requests_per_sec"] = len(completed) / wall
            out["decode_tokens_per_sec"] = self._decode_tokens / wall
        return out
