"""Serving cells in a closed loop: `clients` callers, each sending its next
request as soon as its last one has finished, through the program's
`FFModel.serve` engine (`submit` and `step`), greedy, with no
end-of-sequence token.

Requests come from one generator over the traffic file: blocks of `pool`
requests whose prompt and output lengths sit at the quantiles of two
clipped lognormals, the same set in every block and for every seed, which
the seed orders and pairs within each block, and uniform tokens from the
seed. So a window covers nearly the same work whatever the seed. Every prefill width the traffic can
use (the powers of two up to `prefill_chunk`) is warmed up in set-up;
the window opens once every client has had one request finish, and
closes with the first step that ends `seconds` after it opened.

Latencies are the client's: a request's send time is taken just before
`submit`, and a token's time is the end of the `step` call after which
the client sees it. Once the window has closed, a sample of the requests
it finished, drawn from the seed with the longest among them, is
compared with the plain reference's full forward pass over each prompt
and its served tokens.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from dataclasses import dataclass, field

import numpy as np

import harness
import program
from reference import gpt as ref


def _stratified(spec: dict, n: int) -> np.ndarray:
    nd = statistics.NormalDist()
    mu = math.log(spec["median"])
    out = [min(spec["max"], max(spec["min"], round(math.exp(
        mu + spec["sigma"] * nd.inv_cdf((i + 0.5) / n))))) for i in range(n)]
    return np.asarray(out, np.int64)


class Requests:
    """The traffic's requests in the order the seed gives them:
    `next()` -> (prompt token list, max new tokens)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic, self.vocab = traffic, vocab
        n = int(traffic["pool"])
        self.prompts = _stratified(traffic["prompt"], n)
        self.outputs = _stratified(traffic["output"], n)
        self.rng = np.random.default_rng([int(seed), 0x5E7E])
        self.order: list = []

    def next(self):
        if not self.order:
            n = len(self.prompts)
            self.order = list(zip(self.rng.permutation(n),
                                  self.rng.permutation(n)))[::-1]
        i, j = self.order.pop()
        p = int(self.prompts[i])
        o = min(int(self.outputs[j]), int(self.traffic["max_total"]) - p)
        toks = self.rng.integers(0, self.vocab, p).tolist()
        return toks, o


@dataclass
class Sent:
    client: int
    prompt: list
    send_t: float
    req: object = None
    seen: int = 0
    times: list = field(default_factory=list)  # one per token seen
    failed: bool = False


def warm_widths(engine, traffic: dict, vocab: int):
    """Every prefill width the traffic can use, twice (a step's first call
    at a width runs it, the second captures its graph), then drained."""
    rng = np.random.default_rng(0)
    w = 1
    while w <= int(traffic["prefill_chunk"]):
        for _ in range(2):
            engine.submit(rng.integers(0, vocab, w).tolist(),
                          max_new_tokens=2)
            engine.run_until_drained()
        w *= 2


class ClosedLoop:
    """The clients and what they saw."""

    def __init__(self, engine, requests: Requests, clients: int, spans):
        self.engine, self.requests, self.spans = engine, requests, spans
        self.inflight: list[Sent] = []
        self.finished: list[Sent] = []
        self.sent: list[Sent] = []
        self.done_clients: set = set()
        self.steps = 0
        for c in range(clients):
            self.send(c)

    def send(self, client: int):
        prompt, max_new = self.requests.next()
        s = Sent(client, prompt, time.perf_counter())
        try:
            with self.spans.span("submit"):
                s.req = self.engine.submit(prompt, max_new_tokens=max_new)
        except ValueError:
            s.failed = True
            self.finished.append(s)
            self.sent.append(s)
            return
        self.inflight.append(s)
        self.sent.append(s)

    def decode_context(self) -> tuple:
        """(context sum, decoding slots) of the requests that hold a slot
        past their prefill (every one that has seen a token): what a pure
        decode step reads."""
        dec = [s for s in self.inflight if s.seen > 0]
        return sum(len(s.prompt) + s.seen for s in dec), len(dec)

    def step(self):
        with self.spans.span("engine.step"):
            self.engine.step()
        now = time.perf_counter()
        self.steps += 1
        still = []
        for s in self.inflight:
            n = len(s.req.generated)
            if n > s.seen:
                s.times.extend([now] * (n - s.seen))
                s.seen = n
            if s.req.finished:
                self.finished.append(s)
                self.done_clients.add(s.client)
            else:
                still.append(s)
        gone = [s for s in self.inflight if s.req.finished]
        self.inflight = still
        for s in gone:
            self.send(s.client)
        return now


def window_numbers(loop: ClosedLoop, t_open: float, t_close: float) -> dict:
    """The window's tokens, TTFT and TBT samples, counted on the client,
    and the work the model did for them: the tokens it processed (a
    request's prompt when its first token came in the window, each output
    token fed back) and the attention contexts they read."""
    tokens, ttft, tbt, waits = 0, [], [], []
    attempted = failed = processed = context = first = 0
    for s in loop.sent:
        if t_open < s.send_t <= t_close:
            attempted += 1
            if s.failed:
                failed += 1
                ttft.append(math.inf)
        p = len(s.prompt)
        for i, t in enumerate(s.times):
            if t_open < t <= t_close:
                tokens += 1
                if i == 0:
                    ttft.append(t - s.send_t)
                    first += 1
                    processed += p
                    context += p * (p + 1) // 2
                else:
                    tbt.append(t - s.times[i - 1])
                    processed += 1
                    context += p + i
        req = s.req
        if req is not None and req.admit_t is not None \
                and t_open < req.admit_t <= t_close:
            waits.append(req.admit_t - s.send_t)
    return {"tokens": tokens, "ttft": ttft, "tbt": tbt, "queue_waits": waits,
            "attempted": attempted, "failed": failed,
            "processed_tokens": processed, "context_sum": context,
            "first_tokens": first}


def _sample_for_check(loop: ClosedLoop, t_open, t_close, check: dict,
                      seed: int) -> list:
    done = [s for s in loop.finished
            if not s.failed and s.times and t_open < s.times[-1] <= t_close]
    if not done:
        return []
    longest = max(done, key=lambda s: len(s.prompt) + s.seen)
    rng = np.random.default_rng([int(seed), 0xC4EC])
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    pick, n = [longest], longest.seen
    for s in rest:
        if len(pick) >= int(check["requests"]) and n >= int(
                check["min_tokens"]):
            break
        pick.append(s)
        n += s.seen
    return [(s.prompt, list(s.req.generated)) for s in pick]


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", variants=()) -> dict:
    """One run of a serving cell, as `kinds/train.run`: set-up (the model,
    the seed's weights, the engine, every prefill width, the loop filled
    until each client has had a request finish), the window, the profiled
    steps with `trace`, then the reference over a sample of the window's
    requests. `variants` ("control", readings.py only) adds the control's
    widest gap at the same positions."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic, config = cell.traffic, cell.config
    shape = ref.GPTShape.of(config)
    ff = program.build_serve_model(config, traffic, seed, device)
    dev = ff.device
    program.write_weights(ff, shape, seed, dev)
    engine = program.make_engine(ff, traffic, config)
    warm_widths(engine, traffic, shape.vocab)

    spans = harness.Spans()
    requests = Requests(traffic, shape.vocab, seed)
    clients = int(traffic["clients"])
    loop = ClosedLoop(engine, requests, clients, spans)
    while len(loop.done_clients) < clients:
        loop.step()
    engine.reset_stats()
    st0 = engine.stats()
    t_open = time.perf_counter()
    steps0 = loop.steps
    while True:
        now = loop.step()
        if now - t_open >= seconds:
            break
    t_close = now
    st1 = engine.stats()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    nums = window_numbers(loop, t_open, t_close)
    window_s = t_close - t_open
    window = {
        "window_s": window_s, "setup_s": t_open - t_start,
        "steps": loop.steps - steps0, "tokens": nums["tokens"],
        "tokens_per_s": nums["tokens"] / window_s,
        "ttft_p95_s": harness.percentile(nums["ttft"], 95),
        "tbt_p95_s": harness.percentile(nums["tbt"], 95),
        "ttft_samples": len(nums["ttft"]), "tbt_samples": len(nums["tbt"]),
        "queue_waits": nums["queue_waits"], "slots": int(traffic["slots"]),
        "processed_tokens": nums["processed_tokens"],
        "context_sum": nums["context_sum"],
        "first_tokens": nums["first_tokens"],
        "engine_delta": {k: st1[k] - st0[k] for k in (
            "decode_tokens", "decode_iterations", "prefill_tokens",
            "prefill_calls", "device_s")},
        "finished_in_window": [
            (len(s.prompt), s.seen) for s in loop.finished
            if not s.failed and s.times and t_open < s.times[-1] <= t_close],
    }
    traced = {}
    if trace:
        import devtrace as tr

        n = int(traffic["trace"]["steps"])
        decode_steps = []
        with tr.profiled(spans, torch) as got:
            with spans.span(tr.REGION):
                for _ in range(n):
                    with spans.span("harness"):
                        before = loop.decode_context()
                        calls = engine.stats()["prefill_calls"]
                    loop.step()
                    with spans.span("harness"):
                        # a step that ran no prefill chunk is a pure
                        # decode step (the engine's own counter)
                        if engine.stats()["prefill_calls"] == calls:
                            decode_steps.append(before)
                torch.cuda.synchronize(dev)
        traced = {"steps": n, "step_trace": got[0],
                  "decode_steps": decode_steps}
    sample = _sample_for_check(loop, t_open, t_close, traffic["check"], seed)
    del engine, loop, ff
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    W = ref.make_weights(shape, seed, dev)
    # the control (readings.py only): at the same positions, the gap of the
    # token the reference one precision step below the program's puts first
    gaps = ref.served_gaps(
        W, shape, sample,
        control_matmul=ref.fp8_matmul if "control" in variants else None)
    numbers = {"served_logit_gap": gaps["widest"] if sample else math.inf}
    if "control" in variants:
        numbers["control"] = {"served_logit_gap": gaps["control_widest"]}
    return {"window": window, "traced": traced, "numbers": numbers,
            "end_to_end": {
                "serve_output_tokens_per_s": window["tokens_per_s"],
                "serve_ttft_p95_ms": window["ttft_p95_s"] * 1e3,
                "serve_tbt_p95_ms": window["tbt_p95_s"] * 1e3,
                "setup_s": window["setup_s"]},
            "attempted": nums["attempted"], "failed": nums["failed"],
            "peak_bytes": peak,
            "readings": {"served_tokens_checked": gaps["tokens"],
                         "requests_checked": len(sample)}}
