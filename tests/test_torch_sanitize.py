"""The port's NaN-provenance sanitizer (`flexflow_tpu_torch/sanitize.py`,
`--sanitize-numerics`) against the JAX package's: the twin of
`tests/test_numerics.py`'s sanitizer half, on the CPU.

- the localization matrix: a NaN planted at step 2 into the first
  LINEAR, MULTIHEAD_ATTENTION and LAYERNORM node and into the loss, in
  the forward and in the backward, per step and in chunks of 4 (the
  fault mid-chunk), is named by the port as (op, phase, step) — the JAX
  package's answer for the same planted fault, which one case per op
  class also runs here; the matrix in f32 (bf16 matmuls crawl on the
  CPU), its LINEAR row also in bf16;
- a clean run reports nothing, and a fit resets an earlier fit's reports;
- stepped reports outrank step-less ones (eval reports step -1);
- the enriched, fire-once nan_loss alert, and alerts.jsonl naming the op
  end to end;
- sanitizer off and on give bit-identical trajectories, in f32 and bf16
  (the probes are identities put on each output before it fans out).
The device table inside a captured step and a chunk's graph is held on
the card (`tests/test_torch_cuda.py`).
"""

import json
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=64, hidden_size=32, num_heads=2, num_layers=2,
            sequence_length=16)
BATCH, FAULT_STEP = 4, 2


def _lm(pkg="flexflow_tpu_torch", dtype="bf16", sanitize=True, argv=(),
        **lm_kw):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    from flexflow_tpu_torch.fftype import DataType

    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = BATCH
    cfg.sanitize_numerics = sanitize
    if dtype == "bf16":
        cfg.computation_dtype = (DataType.DT_BFLOAT16
                                 if pkg == "flexflow_tpu_torch" else
                                 mod.fftype.DataType.DT_BFLOAT16)
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(
        ff, models.TransformerLMConfig(**{**TINY, **lm_kw}),
        batch_size=BATCH)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.01),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    seq, vocab = TINY["sequence_length"], TINY["vocab_size"]
    x = {"tokens": rs.randint(0, vocab, (n, seq)).astype(np.int32),
         "positions": np.tile(np.arange(seq, dtype=np.int32), (n, 1))}
    return x, rs.randint(0, vocab, (n, seq, 1)).astype(np.int32)


def _reset(ff):
    """Pristine training state and no fault, so a NaN'd fit leaks
    nothing into the next test."""
    ex = ff.executor
    ex.set_numeric_fault(None)
    ff._params, ff._state = ex.init_variables(ff.config.seed)
    ff._opt_slots = ff.optimizer.init(ff._params)
    ff._step = torch.zeros((), dtype=torch.int32)
    ff._counters = ff.metrics.zero_counters(ff.device)
    ff._rng = torch.Generator().manual_seed(ff.config.seed)


@pytest.fixture(scope="module")
def lm_bf16():
    """One sanitizer-on bf16 tiny LM shared by its tests (every test
    resets its state and fault)."""
    return _lm()


@pytest.fixture(scope="module")
def lm_f32():
    """The same in f32, shared by the localization matrix."""
    return _lm(dtype="f32")


def _target(ff, op_class: str) -> str:
    if op_class == "loss":
        return "loss"
    op = {"matmul": "OP_LINEAR", "attention": "OP_MULTIHEAD_ATTENTION",
          "layernorm": "OP_LAYERNORM"}[op_class]
    return next(n.name for n in ff.graph.topo_order()
                if n.op_type.name == op)


def _localize(ff, pkg, op_class, phase, pipeline):
    target = _target(ff, op_class)
    ff.executor.set_numeric_fault(target, phase, FAULT_STEP)
    san = __import__(f"{pkg}.sanitize", fromlist=["x"])
    san.get_monitor().reset()
    x, y = _data()
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False,
           pipeline_steps=pipeline)
    if pkg == "flexflow_tpu":
        import jax

        jax.effects_barrier()
    info = san.get_monitor().first_nonfinite()
    return target, info


@pytest.mark.parametrize("pipeline", [1, 4], ids=["per_step", "chunks4"])
@pytest.mark.parametrize("phase", ["fwd", "bwd"])
@pytest.mark.parametrize("op_class",
                         ["matmul", "attention", "layernorm", "loss"])
def test_nan_localization(lm_f32, op_class, phase, pipeline):
    """The matrix, in f32 (bf16 matmuls crawl on the CPU; the bf16 cases
    below and phase 20(b) on the card hold the bf16 path)."""
    ff = lm_f32
    _reset(ff)
    target, info = _localize(ff, "flexflow_tpu_torch", op_class, phase,
                             pipeline)
    assert info is not None, f"{op_class}/{phase}/{pipeline}: nothing"
    assert (info["op"], info["phase"], info["step"]) == (
        target, phase, FAULT_STEP), info


@pytest.mark.parametrize("pipeline", [1, 4], ids=["per_step", "chunks4"])
@pytest.mark.parametrize("phase", ["fwd", "bwd"])
def test_nan_localization_bf16(lm_bf16, phase, pipeline):
    """The LINEAR row of the matrix under bf16 compute (JAX's matrix
    dtype)."""
    ff = lm_bf16
    _reset(ff)
    op_class = "matmul"
    target, info = _localize(ff, "flexflow_tpu_torch", op_class, phase,
                             pipeline)
    assert info is not None, f"{op_class}/{phase}/{pipeline}: nothing"
    assert (info["op"], info["phase"], info["step"]) == (
        target, phase, FAULT_STEP), info


def _reset_jax(ff):
    """tests/test_numerics.py's `_reset_model`."""
    import jax
    import jax.numpy as jnp

    ff.executor.set_numeric_fault(None)
    ff._rng = jax.random.key(ff.config.seed)
    ff._params, ff._state = ff.executor.init_variables(ff._rng)
    ff._opt_slots = ff.executor.place_update_sharded(
        ff.executor.replicate(ff.optimizer.init(ff._params)))
    if ff._state:
        ff._state = ff.executor.replicate(ff._state)
    ff._step = ff.executor.replicate(jnp.zeros((), jnp.int32))
    ff._counters = ff.executor.replicate(ff.metrics.zero_counters())


@pytest.fixture(scope="module")
def lm_pair():
    """Both packages' tiny LM, f32, attention_impl "xla" (the JAX
    package's flash kernel runs in interpret mode on the CPU, which
    localization does not read)."""
    return {pkg: _lm(pkg, dtype="f32", attention_impl="xla")
            for pkg in ("flexflow_tpu", "flexflow_tpu_torch")}


@pytest.mark.parametrize("op_class",
                         ["matmul", "attention", "layernorm", "loss"])
def test_nan_localization_is_the_jax_packages(lm_pair, op_class):
    """The same planted fault (backward, step 2) in both packages' tiny
    LM: the same (op, phase, step)."""
    got = {}
    for pkg, ff in lm_pair.items():
        (_reset_jax if pkg == "flexflow_tpu" else _reset)(ff)
        target, info = _localize(ff, pkg, op_class, "bwd", 1)
        got[pkg] = (info["op"], info["phase"], info["step"])
    assert got["flexflow_tpu"] == got["flexflow_tpu_torch"] == (
        target, "bwd", FAULT_STEP)


def test_localization_clean_run_reports_nothing(lm_f32):
    from flexflow_tpu_torch import sanitize

    ff = lm_f32
    _reset(ff)
    sanitize.get_monitor().reset()
    x, y = _data()
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert sanitize.get_monitor().first_nonfinite() is None


def test_fit_resets_stale_monitor_state(lm_f32):
    from flexflow_tpu_torch import sanitize

    ff = lm_f32
    _reset(ff)
    ff.executor.set_numeric_fault(_target(ff, "matmul"), "fwd", 0)
    x, y = _data()
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert sanitize.get_monitor().first_nonfinite() is not None
    _reset(ff)  # no manual monitor reset: the fit starts a fresh window
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert sanitize.get_monitor().first_nonfinite() is None


def test_localize_prefers_stepped_events_over_stepless():
    from flexflow_tpu_torch.sanitize import NumericsMonitor

    mon = NumericsMonitor()
    mon.report("eval_op", "fwd", 1, -1)
    mon.report("train_op", "fwd", 2, 5)
    info = mon.first_nonfinite()
    assert (info["op"], info["step"]) == ("train_op", 5)
    mon2 = NumericsMonitor()
    mon2.report("eval_op", "fwd", 1, -1)
    assert mon2.first_nonfinite()["op"] == "eval_op"


def test_localization_stepless_paths(lm_f32):
    """eval runs the graph with no step counter: its probes report step
    -1 (the serving engine's serve.nonfinite check reads the same)."""
    from flexflow_tpu_torch import sanitize

    ff = lm_f32
    _reset(ff)
    target = _target(ff, "layernorm")
    ff.executor.set_numeric_fault(target, "fwd", 0)
    sanitize.get_monitor().reset()
    x, y = _data(n=4)
    ff.eval(x, y, batch_size=BATCH)
    info = sanitize.get_monitor().first_nonfinite()
    assert info is not None
    assert (info["op"], info["phase"], info["step"]) == (target, "fwd", -1)


def test_probe_table_keeps_the_first_step_per_op_and_phase():
    """The device table: the first non-finite step per (probe, phase),
    the step-less flag apart, each pass's probes folded by its flush (a
    bf16 tensor's too); a reset clears it."""
    from flexflow_tpu_torch.sanitize import NONE, NumericsMonitor, ProbeTable

    t = ProbeTable(["a", "b#out1", "loss"], [1, 1, 3], "cpu")
    good, bad = torch.ones(3), torch.tensor([1.0, float("inf"), 0.0])
    for step in (4, 2, 7):
        t.fold(0, 0, bad.to(torch.bfloat16))
        t.fold(1, 1, good)
        t.flush(torch.tensor(step, dtype=torch.int32))
    t.fold(2, 1, torch.tensor([float("nan")]))
    t.flush(None)
    assert int(t.table[0, 0, 0]) == 2 and int(t.table[1, 1, 0]) == NONE
    assert all(not b.any() for b in t.seen.values())  # flushed, cleared
    mon = NumericsMonitor()
    mon.attach(t)
    assert sorted(map(lambda e: (e["op"], e["phase"], e["step"]),
                      mon.snapshot())) == [("a", "fwd", 2),
                                           ("loss", "bwd", -1)]
    assert mon.first_nonfinite()["op"] == "a"
    mon.reset()
    assert mon.snapshot() == []


def test_nan_loss_rule_enriched_and_fire_once():
    from flexflow_tpu_torch.diagnostics.health import NaNLossRule

    rule = NaNLossRule()
    alert = rule.check({"step": 7, "loss": float("nan"),
                        "nonfinite_op": "l0_attn",
                        "nonfinite_phase": "bwd",
                        "nonfinite_step": 6})
    assert alert is not None
    assert "l0_attn" in alert.message and "backward" in alert.message
    assert alert.details == {"op": "l0_attn", "phase": "bwd", "at_step": 6}
    assert alert.to_record()["details"]["op"] == "l0_attn"
    assert rule.check({"step": 8, "loss": float("nan")}) is None


def test_nan_loss_rule_unenriched_without_sanitizer():
    from flexflow_tpu_torch.diagnostics.health import NaNLossRule

    alert = NaNLossRule().check({"step": 3, "loss": float("inf")})
    assert alert is not None and alert.details == {}
    assert "first non-finite" not in alert.message


@pytest.mark.parametrize("pipeline", [1, 4], ids=["per_step", "chunks4"])
def test_alerts_jsonl_names_op_end_to_end(tmp_path, pipeline):
    """--sanitize-numerics + diagnostics: the nan_loss record in
    alerts.jsonl carries the localization (JAX's test at step 1, and in
    chunks of 4)."""
    from flexflow_tpu_torch import sanitize, telemetry

    ff = _lm(dtype="f32")
    ff.enable_diagnostics(str(tmp_path))
    target = _target(ff, "matmul")
    ff.executor.set_numeric_fault(target, "bwd", 1)
    sanitize.get_monitor().reset()
    x, y = _data()
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False,
           pipeline_steps=pipeline)
    telemetry.deactivate()
    alerts = [json.loads(line) for line in open(tmp_path / "alerts.jsonl")
              if line.strip()]
    nan = [a for a in alerts if a.get("rule") == "nan_loss"]
    assert len(nan) == 1
    assert nan[0]["details"] == {"op": target, "phase": "bwd",
                                 "at_step": 1}


def _mlp(sanitize_on: bool):
    sys.argv = ["test"]
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                    SGDOptimizer)

    cfg = FFConfig(device="cpu")
    cfg.batch_size = 8
    cfg.sanitize_numerics = sanitize_on
    ff = FFModel(cfg)
    x = ff.create_tensor((8, 16), name="input_0")
    t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
    ff.softmax(ff.dense(t, 8, name="head"), name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _fit_mlp(ff, rng):
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 8, (32, 1)).astype(np.int32)
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False)
    return [t.clone() for ws in ff._params.values() for t in ws.values()]


def test_sanitizer_off_and_on_bit_identical():
    """Off: no probe is put in. On: the probes are identities, so the
    trajectory stays BIT-identical (JAX's MLP)."""
    base = _fit_mlp(_mlp(False), np.random.RandomState(0))
    off2 = _fit_mlp(_mlp(False), np.random.RandomState(0))
    on = _fit_mlp(_mlp(True), np.random.RandomState(0))
    for a, b, c in zip(base, off2, on):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pipeline", [1, 4], ids=["per_step", "chunks4"])
def test_sanitizer_off_and_on_bit_identical_tiny_lm(dtype, pipeline):
    """The tiny LM (every output fans out through residuals, attention's
    q/k/v, LayerNorm): the masters and every step's loss with the probes
    on are bit-equal to those with them off, in f32 and bf16, per step
    and in chunks."""
    out = []
    for on in (False, True):
        ff = _lm(dtype=dtype, sanitize=on)
        losses = []
        ex = ff.executor
        if pipeline == 1:
            step = ex.build_train_step()

            def rec(*a, _s=step):
                o = _s(*a)
                losses.append(o[-1].reshape(-1).clone())
                return o
            ex._train_step = rec
        x, y = _data()
        ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=True,
               verbose=False, pipeline_steps=pipeline)
        out.append(([t.clone() for ws in ff._params.values()
                     for t in ws.values()], losses))
    (p_off, l_off), (p_on, l_on) = out
    for a, b in zip(p_off, p_on):
        assert torch.equal(a, b)
    for a, b in zip(l_off, l_on):
        assert torch.equal(a, b)


def test_set_numeric_fault_validates():
    ff = _lm(dtype="f32", sanitize=False)
    with pytest.raises(ValueError, match="phase"):
        ff.executor.set_numeric_fault("loss", "sideways", 0)
    with pytest.raises(ValueError, match="no op named"):
        ff.executor.set_numeric_fault("no_such_op", "fwd", 0)
