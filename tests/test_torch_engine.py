"""The port's pipelined execution engine (`flexflow_tpu_torch/engine/`),
the twins of `tests/test_engine.py`, on the CPU.

The headline property: `fit(..., pipeline_steps=N)` is BIT-IDENTICAL to
the per-step loop (losses, masters, slots, generator, step and metric
counters over shuffled epochs) while running the epoch in ceil(B/N)
chunks, and resumes across kills to the same trajectory. The step spy is
the telemetry's per-step records plus a wrapper on the executor's
`train_step`, which both loops call (the JAX test's diagnostics spy is
ROADMAP A10b). On the CPU a chunk is its steps one after another; on the
card it is one CUDA graph (chip_smoke.py phase 19). Left out with
diagnostics (A10b): the health-abort and `--health-sample-every` tests
and the doctor's verdict.
"""

import json
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch


def _mlp(batch=8, seed=0, argv=(), dropout=0.25):
    sys.argv = ["test", *argv]
    from flexflow_tpu_torch import (
        ActiMode, FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
    )

    config = FFConfig(device="cpu")
    config.batch_size = batch
    config.seed = seed
    ff = FFModel(config)
    x = ff.create_tensor((batch, 16), name="x")
    t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
    # dropout draws from the model's generator: the chunks must draw what
    # the per-step loop draws
    t = ff.dropout(t, dropout, name="drop")
    t = ff.dense(t, 4, name="fc2")
    t = ff.softmax(t, name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def _data(n=64, d=16, k=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    y = rs.randint(0, k, (n, 1)).astype(np.int32)
    return x, y


def _state(ff) -> dict:
    from flexflow_tpu_torch.resilience.checkpointer import snapshot_to_host
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    return snapshot_to_host(model_state_tree(ff))


def _assert_same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _no_prefetch_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("ff-prefetch") and t.is_alive()]


# ===================================================================
# chunk planning + chunk-aware checkpoint policy
# ===================================================================

def test_plan_chunks():
    from flexflow_tpu_torch.engine import plan_chunks

    assert plan_chunks(0, 8, 4) == [(0, 4), (4, 4)]
    assert plan_chunks(0, 8, 3) == [(0, 3), (3, 3), (6, 2)]
    assert plan_chunks(5, 8, 4) == [(5, 3)]
    assert plan_chunks(8, 8, 4) == []
    assert plan_chunks(0, 1, 64) == [(0, 1)]
    with pytest.raises(ValueError):
        plan_chunks(0, 8, 0)


def test_checkpoint_policy_should_save_range():
    from flexflow_tpu_torch.resilience import CheckpointPolicy

    p = CheckpointPolicy(every_n_steps=3)
    assert p.should_save_range(4, 8)
    assert p.should_save_range(0, 4)
    assert not p.should_save_range(3, 5)
    assert not p.should_save_range(4, 4)
    assert not CheckpointPolicy().should_save_range(0, 100)


# ===================================================================
# prefetcher lifecycle
# ===================================================================

def test_prefetcher_delivers_in_order_and_exhausts():
    from flexflow_tpu_torch.engine import ChunkPrefetcher, PrefetchExhausted

    pf = ChunkPrefetcher(lambda c: c * 10, [1, 2, 3], depth=2)
    assert [pf.get(), pf.get(), pf.get()] == [10, 20, 30]
    with pytest.raises(PrefetchExhausted):
        pf.get(timeout=5)
    pf.shutdown()
    assert not pf.alive


def test_prefetcher_staging_error_propagates_to_consumer():
    from flexflow_tpu_torch.engine import ChunkPrefetcher

    pf = ChunkPrefetcher(lambda c: 1 // 0, [1, 2], depth=1)
    with pytest.raises(ZeroDivisionError):
        pf.get(timeout=5)
    pf.shutdown()
    assert not pf.alive


def test_prefetcher_shutdown_unblocks_worker_on_full_queue():
    from flexflow_tpu_torch.engine import ChunkPrefetcher

    pf = ChunkPrefetcher(lambda c: c, list(range(50)), depth=1)
    assert pf.get(timeout=5) == 0
    pf.shutdown()
    assert not pf.alive


# ===================================================================
# equivalence: pipelined fit == per-step fit, bit for bit
# ===================================================================

def _fit_with_spy(tmpdir, pipeline_steps, epochs=2, n=64):
    from flexflow_tpu_torch.telemetry import read_jsonl

    x, y = _data(n)
    ff = _mlp()
    ff.enable_telemetry(str(tmpdir))
    losses = []
    step = ff.executor.train_step

    def spy(*args):
        out = step(*args)
        losses.append(float(out[-1]))
        return out

    ff.executor.train_step = spy  # the chunks' steps call it too
    ff.executor._train_step = spy
    ff.fit(x, y, epochs=epochs, batch_size=8, shuffle=True,
           pipeline_steps=pipeline_steps, verbose=False)
    recs = read_jsonl(os.path.join(str(tmpdir), "metrics.jsonl"))
    return {"losses": losses,
            "steps": [r["step"] for r in recs if r["kind"] == "step"],
            "state": _state(ff),
            "chunks": sorted(ff.executor._chunk_steps)}


@pytest.mark.parametrize("pipeline_steps", [4, 3],
                         ids=["even-chunks", "ragged-tail"])
def test_pipelined_fit_bit_identical_to_eager(tmp_path, pipeline_steps):
    """2 shuffled epochs, same seed: per-step losses, masters, slots,
    generator, step and metric counters equal the per-step loop's bit for
    bit (pipeline_steps=3 runs the shorter tail chunk: 3+3+2)."""
    eager = _fit_with_spy(tmp_path / "eager", 1)
    piped = _fit_with_spy(tmp_path / "piped", pipeline_steps)
    assert eager["steps"] == piped["steps"] == list(range(1, 17))
    assert eager["losses"] == piped["losses"]  # bit-exact floats
    assert len(eager["losses"]) == 16
    _assert_same_state(eager["state"], piped["state"])
    assert eager["chunks"] == []
    assert piped["chunks"] == ([4] if pipeline_steps == 4 else [2, 3])


def test_chunked_step_returns_the_loss_vector():
    """build_chunked_train_step(n) is cached per length and runs n steps
    over (n, batch, ...) inputs, returning each step's loss, as n calls
    of the train step do."""
    x, y = _data(32)
    a, b = _mlp(), _mlp()
    ex = a.executor
    fn = ex.build_chunked_train_step(4)
    assert ex.build_chunked_train_step(4) is fn
    xs = {"x": torch.from_numpy(x).reshape(4, 8, 16)}
    ys = torch.from_numpy(y).reshape(4, 8, 1)
    out = fn(a._params, a._state, a._opt_slots, a._step, a._counters,
             (xs, ys), a._rng)
    want = []
    step = b.executor.build_train_step()
    for i in range(4):
        o = step(b._params, b._state, b._opt_slots, b._step, b._counters,
                 b._make_batch({"x": x[8 * i:8 * (i + 1)]},
                               y[8 * i:8 * (i + 1)]), b._rng)
        want.append(float(o[-1]))
    assert out[-1].shape == (4,) and out[-1].tolist() == want
    _assert_same_state(_state(a), _state(b))
    with pytest.raises(ValueError):
        ex.build_chunked_train_step(0)


def test_pipelined_telemetry_artifacts_schema_valid(tmp_path):
    """Per-step metrics records (the full time split), step/data_wait/
    chunk/prefetch.stage trace spans and checkpoint records."""
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = tmp_path / "t"
    x, y = _data(64)
    ff = _mlp(argv=["--telemetry-dir", str(tdir),
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--checkpoint-every", "4", "--pipeline-steps", "4"])
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=True, verbose=False)
    recs = read_jsonl(os.path.join(str(tdir), "metrics.jsonl"))
    steps = [r for r in recs if r["kind"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 9))
    for s in steps:
        for f in ("step_time_s", "data_wait_s", "save_latency_s",
                  "device_time_s", "ema_step_time_s"):
            assert f in s, f"step record missing {f}"
    assert [r for r in recs if r["kind"] == "checkpoint"]
    summ = [r for r in recs if r["kind"] == "summary"][-1]
    assert summ["steps"] == 8 and summ["examples_per_sec"] > 0
    with open(os.path.join(str(tdir), "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    for required in ("step", "data_wait", "chunk", "prefetch.stage"):
        assert required in names, f"trace missing {required!r}"


# ===================================================================
# resilience at chunk boundaries
# ===================================================================

def test_pipelined_kill_resume_bit_identical(tmp_path):
    """Death inside a chunk -> the resume cursor is a chunk edge, and the
    resumed pipelined run reproduces the uninterrupted PER-STEP run bit
    for bit."""
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption, latest_checkpoint,
        load_checkpoint)

    x, y = _data(64)
    root = str(tmp_path / "ck")
    ref = _mlp()
    ref.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    ff1 = _mlp(argv=["--checkpoint-dir", root, "--checkpoint-every", "3",
                     "--pipeline-steps", "4"])
    fault = FaultInjector(kill_after_step=6)
    ff1.set_fault_hook(fault)
    with pytest.raises(SimulatedPreemption):
        ff1.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    assert fault.fired
    assert _no_prefetch_threads(), "prefetch thread leaked across the kill"
    last = latest_checkpoint(root)
    assert last is not None
    _, manifest = load_checkpoint(last)
    cur = manifest["extras"]["cursor"]
    assert cur["batch"] % 4 == 0, f"cursor {cur} not on a chunk edge"
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume",
                     "--pipeline-steps", "4"])
    ff2.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    assert ff2._py_step() == 16
    _assert_same_state(_state(ref), _state(ff2))


def test_pipelined_sigterm_drains_at_chunk_boundary(tmp_path):
    """A SIGTERM at chunk 1's boundary (sent from step 2's fault hook,
    which runs after that boundary's poll) lets chunk 2 run, then its
    boundary drains and writes one final snapshot; the cursor is the
    chunk edge and fit returns early. Resumed, it ends where the
    uninterrupted run ends."""
    from flexflow_tpu_torch.resilience import (
        latest_checkpoint, load_checkpoint)

    x, y = _data(128)  # 16 batches an epoch: chunks of 4
    root = str(tmp_path / "ck")
    ff = _mlp(argv=["--checkpoint-dir", root, "--pipeline-steps", "4"])

    def notice(step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    ff.set_fault_hook(notice)
    ff.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    assert ff._py_step() == 8
    last = latest_checkpoint(root)
    assert last is not None and last.endswith("step_00000008")
    _, manifest = load_checkpoint(last)
    assert manifest["extras"]["cursor"] == {"epoch": 0, "batch": 8}
    assert _no_prefetch_threads()
    ref = _mlp()
    ref.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume",
                     "--pipeline-steps", "4"])
    ff2.fit(x, y, epochs=2, batch_size=8, shuffle=True, verbose=False)
    _assert_same_state(_state(ref), _state(ff2))


def test_dataloader_caches_partition_spec_lookup():
    """next_batch_sharded resolves whether its tensor is a graph input
    once, not by a scan of graph.sources() a batch."""
    ff = _mlp()
    data = np.random.RandomState(0).randn(32, 16).astype(np.float32)
    loader = ff.create_data_loader(ff._input_tensors[0], data)
    calls = []
    orig = ff.executor.graph.sources

    def counting_sources():
        calls.append(1)
        return orig()

    ff.executor.graph.sources = counting_sources
    try:
        b1 = loader.next_batch_sharded()
        b2 = loader.next_batch_sharded()
    finally:
        ff.executor.graph.sources = orig
    assert len(calls) == 1, f"sources() scanned {len(calls)}x for 2 batches"
    np.testing.assert_array_equal(b1.numpy(), data[:8])
    np.testing.assert_array_equal(b2.numpy(), data[8:16])


def test_set_learning_rate_drops_the_chunked_steps():
    """The rate is a constant of a captured chunk as of a captured step:
    a new rate drops both (JAX clears its chunked executables too)."""
    ff = _mlp()
    fn = ff.executor.build_chunked_train_step(4)
    ff.set_learning_rate(0.05)  # unchanged: the chunk step stays
    assert ff.executor.build_chunked_train_step(4) is fn
    ff.set_learning_rate(0.01)
    assert ff.executor._chunk_steps == {} and ff.optimizer.lr == 0.01
