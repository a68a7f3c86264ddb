"""The port's resilience subsystem (`flexflow_tpu_torch/resilience/`)
against the JAX package's, on the CPU: the twins of
`tests/test_resilience.py` plus the cross-package checks.

- the checkpointer: atomic commit, discovery, async saves, abort,
  overwrite, writer errors, bf16/int leaves, 9-digit steps;
- a checkpoint written by either package read by the other (the tiny LM:
  2 layers, hidden 64, 4 heads, seq 32, vocab 128): every section but
  `['rng']` bit-equal after the port's `load_checkpoint` + `restore_tree`
  of a JAX checkpoint; JAX's `load_checkpoint` of a port checkpoint gives
  the same keys, dtypes (bf16 included) and manifest schema; a foreign
  `['rng']` leaf raises naming it;
- kill-and-resume of the port bit-exact with its uninterrupted run, and
  that run's masters within F32_TOL (rtol = atol = 2e-5) of the JAX
  package's uninterrupted run from the same weights (`load_params`);
- cross-mesh resume over 4 gloo ranks: saved at dp 4 under stage 3,
  resumed at dp 2 x tp 2 and on one rank, within JAX's own rtol=2e-4,
  atol=1e-6 of the uninterrupted run;
- the SIGTERM drain, the preemption handler, the fault injector, the
  data loader's cursor, the deprecated wrappers, the architecture check,
  the per-epoch resume, auto-resume at most once, the shuffle order.

Where JAX's test runs on its 8-device virtual mesh, the port's runs on
one CPU rank (bit-exact) or on gloo ranks.
"""

import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
# JAX's own bound for a resume onto another mesh (tests/test_resilience.py)
MESH_TOL = dict(rtol=2e-4, atol=1e-6)
TINY = dict(vocab_size=128, hidden_size=64, num_heads=4, num_layers=2,
            sequence_length=32, attention_impl="flash")
LM_BATCH, LM_STEPS = 2, 4


def _mlp(batch=8, seed=0, argv=(), momentum=0.0, dropout=0.0):
    sys.argv = ["test", *argv]
    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )

    config = FFConfig(device="cpu")
    config.batch_size = batch
    config.seed = seed
    ff = FFModel(config)
    x = ff.create_tensor((batch, 16), name="x")
    t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
    if dropout:
        t = ff.dropout(t, dropout, name="drop")
    t = ff.dense(t, 4, name="fc2")
    t = ff.softmax(t, name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=momentum),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def _data(n=64, d=16, k=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    y = rs.randint(0, k, (n, 1)).astype(np.int32)
    return x, y


def _state(ff) -> dict:
    """Every trajectory-defining tensor of a one-rank port model."""
    from flexflow_tpu_torch.resilience.reshard import model_state_tree
    from flexflow_tpu_torch.resilience.checkpointer import snapshot_to_host

    return snapshot_to_host(model_state_tree(ff))


def _assert_same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ===================================================================
# checkpointer: atomicity + discovery + async semantics
# ===================================================================

def test_atomic_commit_discovery_ignores_tmp_and_torn(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, list_checkpoints)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    ck.save(3, {"params": {"w": torch.arange(4.0)}}, blocking=True)
    good = latest_checkpoint(root)
    assert good and good.endswith("step_00000003")
    os.makedirs(os.path.join(root, ".tmp-step_00000009-12345"))
    torn = os.path.join(root, "step_00000007")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write('{"committed": tr')  # truncated mid-write
    os.makedirs(os.path.join(root, "step_00000005"))
    assert latest_checkpoint(root) == good
    assert list_checkpoints(root) == [good]


def test_interrupted_async_save_never_corrupts_latest(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    ck.save(1, {"params": {"w": torch.full((4,), 1.0)}}, blocking=True)
    first = latest_checkpoint(root)

    def die(tmpdir):
        raise KeyboardInterrupt("process killed mid-save")

    ck._pre_commit_hook = die
    ck.save(2, {"params": {"w": torch.full((4,), 2.0)}}, blocking=False)
    with pytest.raises(KeyboardInterrupt):
        ck.wait()
    assert latest_checkpoint(root) == first
    flat, manifest = load_checkpoint(first)
    np.testing.assert_array_equal(flat["['params']['w']"], np.ones(4))
    assert manifest["step"] == 1
    ck._pre_commit_hook = None
    ck.save(3, {"params": {"w": torch.full((4,), 3.0)}}, blocking=True)
    assert latest_checkpoint(root).endswith("step_00000003")


def test_async_save_overlaps_and_prunes(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, list_checkpoints)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root, keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.full((8,), float(s))}, blocking=False)
    ck.wait()
    names = [os.path.basename(p) for p in list_checkpoints(root)]
    assert names == ["step_00000002", "step_00000003"]
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read() == "step_00000003"


def test_bf16_and_int_leaves_roundtrip(tmp_path):
    """bf16 goes to disk as raw 2-byte words with its dtype in the
    manifest and comes back as torch.bfloat16, bit for bit; ints and
    scalars survive."""
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)
    from flexflow_tpu_torch.resilience.checkpointer import snapshot_to_host

    tree = {"bf16": torch.arange(6, dtype=torch.bfloat16) / 3,
            "i32": torch.tensor(7, dtype=torch.int32),
            "f32": torch.ones((2, 2)) * 0.5}
    root = str(tmp_path / "ck")
    AsyncCheckpointer(root).save(0, tree, blocking=True)
    flat, manifest = load_checkpoint(latest_checkpoint(root))
    assert manifest["leaves"]["['bf16']"]["dtype"] == "bfloat16"
    want = snapshot_to_host(tree)
    for k, v in want.items():
        got = flat[k] if torch.is_tensor(flat[k]) else torch.from_numpy(
            np.array(flat[k]))
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_abort_discards_inflight_save(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, list_checkpoints)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    ck.save(1, {"w": torch.zeros(2)}, blocking=True)
    ck._pre_commit_hook = lambda tmpdir: ck._aborted.wait(5)
    ck.save(2, {"w": torch.ones(2)}, blocking=False)
    ck.abort()
    names = [os.path.basename(p) for p in list_checkpoints(root)]
    assert names == ["step_00000001"]
    ck._pre_commit_hook = None
    ck.save(3, {"w": torch.ones(2)}, blocking=True)
    assert [os.path.basename(p) for p in list_checkpoints(root)] == [
        "step_00000001", "step_00000003"]


def test_same_step_overwrite_stays_committed(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    ck.save(5, {"w": torch.full((2,), 1.0)}, blocking=True)
    ck.save(5, {"w": torch.full((2,), 2.0)}, blocking=True)
    flat, _ = load_checkpoint(latest_checkpoint(root))
    np.testing.assert_array_equal(flat["['w']"], np.full(2, 2.0, np.float32))
    assert not [n for n in os.listdir(root) if n.startswith(".old-")]


def test_writer_error_surfaces_on_wait(tmp_path):
    from flexflow_tpu_torch.resilience import AsyncCheckpointer

    ck = AsyncCheckpointer(str(tmp_path / "ck"))

    def boom(tmpdir):
        raise OSError("disk full")

    ck._pre_commit_hook = boom
    ck.save(1, {"w": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()


def test_discovery_handles_steps_past_eight_digits(tmp_path):
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, list_checkpoints)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root, keep=2)
    ck.save(99_999_999, {"w": torch.zeros(2)}, blocking=True)
    ck.save(100_000_000, {"w": torch.ones(2)}, blocking=True)
    ck.save(100_000_001, {"w": torch.ones(2)}, blocking=True)
    names = [os.path.basename(p) for p in list_checkpoints(root)]
    assert names == ["step_100000000", "step_100000001"]


def test_async_saves_do_not_block_the_caller(tmp_path):
    """An async save returns once its snapshot is taken: the write and
    commit run on the writer thread (held here at its commit point until
    the caller has moved on), and the snapshot is a copy, so writing the
    tensor after save() returns does not reach the checkpoint."""
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)

    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    go = threading.Event()
    ck._pre_commit_hook = lambda tmpdir: go.wait(10)
    w = torch.full((64,), 1.0)
    ck.save(1, {"w": w}, blocking=False)
    assert latest_checkpoint(root) is None  # not committed yet
    w.fill_(2.0)  # the next step's in-place update
    go.set()
    ck.wait()
    flat, _ = load_checkpoint(latest_checkpoint(root))
    np.testing.assert_array_equal(flat["['w']"], np.ones(64, np.float32))


def test_barrier_is_noop_single_process():
    from flexflow_tpu_torch.distributed import barrier

    barrier("test")


def test_flatten_tree_names_leaves_as_jax_keystr():
    """The on-disk leaf names are jax.tree_util.keystr's."""
    import jax

    from flexflow_tpu_torch.resilience.checkpointer import flatten_tree

    tree = {"params": {"l0_attn": {"wq": 1}, "b": [2, 3]},
            "step": 4, "opt_slots": {"v": {}}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {jax.tree_util.keystr(p): v for p, v in flat}
    assert flatten_tree(tree) == want


# ===================================================================
# both packages: one checkpoint format
# ===================================================================

def _lm_data():
    rs = np.random.RandomState(3)
    n = LM_BATCH * LM_STEPS
    seq, vocab = TINY["sequence_length"], TINY["vocab_size"]
    toks = rs.randint(0, vocab, (n, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (n, 1))
    labels = rs.randint(0, vocab, (n, seq, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def _lm(pkg, argv=(), momentum=0.9):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = LM_BATCH
    cfg.allow_tensor_op_math_conversion = False
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(**TINY),
                                batch_size=LM_BATCH)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05, momentum=momentum),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY,
                        mod.MetricsType
                        .METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def _jax_init(jff) -> dict:
    return {n: {w: np.asarray(v) for w, v in ws.items()}
            for n, ws in jff._params.items()}


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """The tiny LM in both packages from the JAX model's weights: each
    trained k = 2 steps and checkpointed (the JAX one with its own
    save_checkpoint), then on to the end of the epoch; and the port's
    uninterrupted run."""
    from flexflow_tpu_torch import load_params

    root = tmp_path_factory.mktemp("lm")
    x, y = _lm_data()
    half = ({k: v[:2 * LM_BATCH] for k, v in x.items()}, y[:2 * LM_BATCH])
    jff = _lm("flexflow_tpu")
    init = _jax_init(jff)
    jff.fit(*half, epochs=1, batch_size=LM_BATCH, shuffle=False,
            verbose=False)
    jpath = jff.save_checkpoint(str(root / "jax"))
    tff = _lm("flexflow_tpu_torch")
    load_params(tff, init)
    tff.fit(*half, epochs=1, batch_size=LM_BATCH, shuffle=False,
            verbose=False)
    tpath = tff.save_checkpoint(str(root / "port"))
    return dict(x=x, y=y, init=init, jff=jff, jpath=jpath, tff=tff,
                tpath=tpath)


def test_jax_checkpoint_restores_into_the_port(lm_runs):
    """The port's load_checkpoint + restore_tree of the JAX package's
    checkpoint: params, opt_slots, step and counters bit-equal to the
    JAX model's arrays at that step."""
    from flexflow_tpu_torch.resilience import load_checkpoint, restore_tree
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    jff = lm_runs["jff"]
    flat, manifest = load_checkpoint(lm_runs["jpath"])
    assert manifest["format_version"] == 1 and manifest["step"] == 2
    ff = _lm("flexflow_tpu_torch")
    template = model_state_tree(ff)
    template.pop("rng")
    restore_tree(template, flat, executor=ff.executor)
    assert int(ff._step) == int(np.asarray(jff._step)) == 2
    for n, ws in jff._params.items():
        for w, v in ws.items():
            np.testing.assert_array_equal(ff.get_weight(n, w), np.asarray(v),
                                          err_msg=f"{n}.{w}")
            np.testing.assert_array_equal(
                ff._opt_slots["v"][n][w].numpy(),
                np.asarray(jff._opt_slots["v"][n][w]), err_msg=f"v {n}.{w}")
    for k, v in ff._counters.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jff._counters[k]), k)


def test_port_checkpoint_reads_in_jax(lm_runs, tmp_path):
    """JAX's load_checkpoint of the port's checkpoint: the keys the JAX
    model's own checkpoint holds, their dtypes and shapes, the manifest's
    schema; the arrays are the port model's, and JAX's restore_tree puts
    them into a JAX model bit for bit (every section but ['rng']). A bf16
    leaf written by either package reads in the other bit for bit."""
    import jax.numpy as jnp

    from flexflow_tpu.resilience import AsyncCheckpointer as JCk
    from flexflow_tpu.resilience import latest_checkpoint as jlatest
    from flexflow_tpu.resilience import load_checkpoint as jload
    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)

    tflat, tman = jload(lm_runs["tpath"])
    jflat, jman = jload(lm_runs["jpath"])
    assert set(tman) == set(jman)
    assert set(tman["extras"]) >= set(jman["extras"]) - {"plan"}
    assert tman["extras"]["rng_kind"] == "torch"
    assert set(tflat) == set(jflat)
    for k in jflat:
        if k == "['rng']":
            continue
        assert tflat[k].dtype == jflat[k].dtype, k
        assert tflat[k].shape == jflat[k].shape, k
    tff = lm_runs["tff"]
    for n, ws in tff._params.items():
        for w in ws:
            np.testing.assert_array_equal(
                tflat[f"['params'][{n!r}][{w!r}]"], tff.get_weight(n, w))
    # and JAX's restore_tree takes every section but ['rng'] from it
    from flexflow_tpu.resilience import restore_tree as jrestore
    from flexflow_tpu.resilience.reshard import (
        model_state_tree as jstate_tree)

    template = jstate_tree(_lm("flexflow_tpu"))
    template.pop("rng")
    restored = jrestore(template, tflat)
    for n, ws in tff._params.items():
        for w in ws:
            np.testing.assert_array_equal(
                np.asarray(restored["params"][n][w]), tff.get_weight(n, w))
            np.testing.assert_array_equal(
                np.asarray(restored["opt_slots"]["v"][n][w]),
                tff._opt_slots["v"][n][w].numpy())
    assert int(np.asarray(restored["step"])) == int(tff._step)
    bits = torch.arange(-8, 8, dtype=torch.float32).to(torch.bfloat16) / 3
    AsyncCheckpointer(str(tmp_path / "t")).save(
        1, {"h": bits}, blocking=True)
    got, man = jload(jlatest(str(tmp_path / "t")))
    assert man["leaves"]["['h']"]["dtype"] == "bfloat16"
    assert got["['h']"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["['h']"]).view(np.int16),
                                  bits.view(torch.int16).numpy())
    JCk(str(tmp_path / "j")).save(
        1, {"h": jnp.asarray(got["['h']"])}, blocking=True)
    back, _ = load_checkpoint(latest_checkpoint(str(tmp_path / "j")))
    assert back["['h']"].dtype == torch.bfloat16
    assert torch.equal(back["['h']"], bits)


def test_foreign_rng_leaf_raises_naming_it(lm_runs):
    """A JAX checkpoint's ['rng'] is a jax.random key: restoring the
    whole checkpoint into the port raises naming the leaf, and writes
    nothing (no silent reseed)."""
    from flexflow_tpu_torch.resilience import (
        CheckpointCorruptError, restore_model)

    ff = _lm("flexflow_tpu_torch")
    before = _state(ff)
    with pytest.raises(CheckpointCorruptError, match=r"\['rng'\]"):
        restore_model(ff, lm_runs["jpath"])
    _assert_same_state(before, _state(ff))


def test_port_kill_and_resume_is_bit_exact_and_matches_jax(lm_runs,
                                                         tmp_path):
    """The tiny LM killed after step 3 (checkpoints every 2 steps, the
    kill after step 2's write committed), resumed in a fresh model with
    --auto-resume: bit-exact with the
    port's uninterrupted run (masters, slots, step, counters, generator);
    that run's masters within F32_TOL of the JAX package's uninterrupted
    run from the same weights."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption, latest_checkpoint)

    x, y, init = lm_runs["x"], lm_runs["y"], lm_runs["init"]
    root = str(tmp_path / "ck")
    ref = _lm("flexflow_tpu_torch")
    load_params(ref, init)
    ref.fit(x, y, epochs=2, batch_size=LM_BATCH, verbose=False)
    killed = _lm("flexflow_tpu_torch",
                 ["--checkpoint-dir", root, "--checkpoint-every", "2"])
    load_params(killed, init)
    fault = FaultInjector(kill_after_step=3)

    def kill(step):
        # step 2's write commits first: a kill discards a write in flight
        killed._resilience.checkpointer.wait()
        fault(step)

    killed.set_fault_hook(kill)
    with pytest.raises(SimulatedPreemption):
        killed.fit(x, y, epochs=2, batch_size=LM_BATCH, verbose=False)
    assert fault.fired and latest_checkpoint(root).endswith("00000002")
    resumed = _lm("flexflow_tpu_torch", ["--checkpoint-dir", root,
                                         "--auto-resume"])
    resumed.fit(x, y, epochs=2, batch_size=LM_BATCH, verbose=False)
    assert int(resumed._step) == 2 * LM_STEPS
    _assert_same_state(_state(ref), _state(resumed))
    jff = _lm("flexflow_tpu")  # the fixture's JAX model's initial weights
    for n, ws in jff._params.items():
        for w, v in ws.items():
            np.testing.assert_array_equal(np.asarray(v), init[n][w])
    jff.fit(x, y, epochs=2, batch_size=LM_BATCH, verbose=False)
    for n, ws in jff._params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(ref.get_weight(n, w), np.asarray(v),
                                       **F32_TOL, err_msg=f"{n}.{w}")


# ===================================================================
# resume on one rank (JAX: its 8-device mesh), bit-exact
# ===================================================================

def test_same_mesh_resume_bit_identical(tmp_path):
    """Save after one epoch, restore into a fresh model (auto_resume):
    the cursor and step come back, the tensors are written in place, and
    the second epoch reproduces the uninterrupted run bit for bit,
    dropout's generator included."""
    from flexflow_tpu_torch.resilience import auto_resume

    x, y = _data(64)
    root = str(tmp_path / "ck")
    ref = _mlp(momentum=0.9, dropout=0.25)
    ref.fit(x, y, epochs=2, batch_size=8, verbose=False)
    ff1 = _mlp(momentum=0.9, dropout=0.25)
    ff1.fit(x, y, epochs=1, batch_size=8, verbose=False)
    ff1.enable_checkpointing(root).save(
        ff1._py_step(), cursor={"epoch": 1, "batch": 0}, blocking=True)
    ff2 = _mlp(momentum=0.9, dropout=0.25,
               argv=["--checkpoint-dir", root, "--auto-resume"])
    held = [t.data_ptr() for n, ws in ff2._params.items()
            for t in ws.values()]
    extras = auto_resume(ff2, root)
    assert extras["cursor"] == {"epoch": 1, "batch": 0}
    assert extras["mesh_axes"]["data"] == 1 and int(ff2._step) == 8
    assert held == [t.data_ptr() for n, ws in ff2._params.items()
                    for t in ws.values()]  # written in place
    ff2.fit(x, y, epochs=2, batch_size=8, verbose=False)
    _assert_same_state(_state(ref), _state(ff2))


def test_resume_epoch_cursor_skips_done_epochs(tmp_path):
    x, y = _data(32)
    root = str(tmp_path / "ck")
    ff1 = _mlp()
    ff1.enable_checkpointing(root)
    ff1.fit(x, y, epochs=1, batch_size=8, verbose=False)
    ff1._resilience.save(ff1._py_step(), cursor={"epoch": 1, "batch": 0},
                         blocking=True)
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume"])
    assert ff2.config.auto_resume and ff2.config.checkpoint_dir == root
    ff2.fit(x, y, epochs=2, batch_size=8, verbose=False)
    assert ff2._py_step() == 8


def test_kill_after_step_k_auto_resume(tmp_path):
    """Death at step 5 (not on a checkpoint boundary) -> auto-resume ->
    the uninterrupted run's final state, bit for bit."""
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption, latest_checkpoint)

    x, y = _data(64)
    root = str(tmp_path / "ck")
    ref = _mlp(momentum=0.9)
    ref.fit(x, y, epochs=2, batch_size=8, verbose=False)
    ff1 = _mlp(momentum=0.9, argv=["--checkpoint-dir", root,
                                   "--checkpoint-every", "2"])
    fault = FaultInjector(kill_after_step=5)
    ff1.set_fault_hook(fault)
    with pytest.raises(SimulatedPreemption):
        ff1.fit(x, y, epochs=2, batch_size=8, verbose=False)
    assert fault.fired
    last = latest_checkpoint(root)
    assert last is not None and int(last[-8:]) <= 5
    ff2 = _mlp(momentum=0.9, argv=["--checkpoint-dir", root,
                                   "--auto-resume"])
    ff2.fit(x, y, epochs=2, batch_size=8, verbose=False)
    assert ff2._py_step() == 16
    _assert_same_state(_state(ref), _state(ff2))


def _capture_handler(monkeypatch):
    from flexflow_tpu_torch.resilience import policy as pol

    holder = [None]
    orig_enter = pol.PreemptionHandler.__enter__

    def capture_enter(self):
        holder[0] = self
        return orig_enter(self)

    monkeypatch.setattr(pol.PreemptionHandler, "__enter__", capture_enter)
    return holder


def test_sigterm_drains_and_writes_final_snapshot(tmp_path, monkeypatch):
    """A real SIGTERM after step 3 stops the loop after that step, drains
    the async save and commits a final snapshot whose cursor resumes
    where training stopped, to the uninterrupted run's end state."""
    from flexflow_tpu_torch.resilience import (
        latest_checkpoint, load_checkpoint)

    x, y = _data(64)
    root = str(tmp_path / "ck")
    ff = _mlp(argv=["--checkpoint-dir", root])

    def notice(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    ff.set_fault_hook(notice)
    before = signal.getsignal(signal.SIGTERM)
    ff.fit(x, y, epochs=2, batch_size=8, verbose=False)  # returns early
    assert signal.getsignal(signal.SIGTERM) is before
    assert ff._py_step() == 4  # the notice lands in step 4's window
    last = latest_checkpoint(root)
    assert last is not None and last.endswith("step_00000004")
    _, manifest = load_checkpoint(last)
    assert manifest["extras"]["cursor"] == {"epoch": 0, "batch": 4}
    ref = _mlp()
    ref.fit(x, y, epochs=2, batch_size=8, verbose=False)
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume"])
    ff2.fit(x, y, epochs=2, batch_size=8, verbose=False)
    _assert_same_state(_state(ref), _state(ff2))


def test_preemption_handler_signal():
    from flexflow_tpu_torch.resilience import PreemptionHandler

    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert not h.preempted and not h.poll()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.preempted and h.poll()
    assert signal.getsignal(signal.SIGTERM) is before


def test_fault_injector_contract():
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption)

    with pytest.raises(ValueError):
        FaultInjector(0)
    f = FaultInjector(3)
    f(1)
    f(2)
    with pytest.raises(SimulatedPreemption) as ei:
        f(3)
    assert ei.value.step == 3 and f.fired
    f(4)


# ===================================================================
# satellites
# ===================================================================

def test_dataloader_resumable_cursor():
    ff = _mlp(batch=4)
    data = np.random.RandomState(0).randn(12, 16).astype(np.float32)
    loader = ff.create_data_loader(ff._input_tensors[0], data)
    loader.next_batch()
    sd = loader.state_dict()
    assert sd == {"next_index": 4}
    b_expected = loader.next_batch()
    loader2 = ff.create_data_loader(ff._input_tensors[0], data)
    loader2.load_state_dict(sd)
    np.testing.assert_array_equal(loader2.next_batch(), b_expected)
    with pytest.raises(ValueError, match="out of range"):
        loader2.load_state_dict({"next_index": 999})


def test_deprecated_checkpoint_api_roundtrips(tmp_path):
    from flexflow_tpu_torch import checkpoint as ckpt

    ff = _mlp()
    x, y = _data(16)
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False)
    w = ff.get_weight("fc1", "kernel")
    path = str(tmp_path / "old_api")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        ckpt.save_checkpoint(ff, path)
    ff2 = _mlp(seed=1)
    with pytest.warns(DeprecationWarning):
        ckpt.restore_checkpoint(ff2, path)
    np.testing.assert_array_equal(ff2.get_weight("fc1", "kernel"), w)


def test_restore_rejects_architecture_mismatch(tmp_path):
    """A leaf of another shape raises naming it, before any tensor of the
    model is written. As in the JAX package, the refusal comes from the
    fftrans restore gate (PlanVerificationError naming the leaf and
    state_shape_change); CheckpointCorruptError stays the backstop under
    --no-verify-plan."""
    from flexflow_tpu_torch import (
        ActiMode, FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
    )
    from flexflow_tpu_torch.analysis import PlanVerificationError
    from flexflow_tpu_torch.resilience import CheckpointCorruptError

    ff = _mlp()
    path = str(tmp_path / "ck")
    ff.save_checkpoint(path)
    sys.argv = ["test"]
    config = FFConfig(device="cpu")
    config.batch_size = 8
    other = FFModel(config)
    xt = other.create_tensor((8, 16), name="x")
    t = other.dense(xt, 48, ActiMode.AC_MODE_RELU, name="fc1")  # 48 != 32
    t = other.dense(t, 4, name="fc2")
    t = other.softmax(t, name="sm")
    other.compile(optimizer=SGDOptimizer(lr=0.05),
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.METRICS_ACCURACY])
    before = _state(other)
    with pytest.raises((CheckpointCorruptError, PlanVerificationError),
                       match="shape"):
        other.load_checkpoint(path)
    _assert_same_state(before, _state(other))


def test_resume_through_per_epoch_fit_calls(tmp_path):
    """One fit(epochs=1) an epoch (the keras driver): a mid-epoch
    checkpoint lands its batch offset on the right ABSOLUTE epoch and the
    run reproduces the uninterrupted one bit for bit."""
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption)

    x, y = _data(64)
    root = str(tmp_path / "ck")
    ref = _mlp()
    for _ in range(3):
        ref.fit(x, y, epochs=1, batch_size=8, verbose=False)
    ff1 = _mlp(argv=["--checkpoint-dir", root, "--checkpoint-every", "3"])
    ff1.set_fault_hook(FaultInjector(kill_after_step=13))
    with pytest.raises(SimulatedPreemption):
        for _ in range(3):
            ff1.fit(x, y, epochs=1, batch_size=8, verbose=False)
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume"])
    for _ in range(3):
        ff2.fit(x, y, epochs=1, batch_size=8, verbose=False)
    assert ff2._py_step() == 24
    _assert_same_state(_state(ref), _state(ff2))


def test_auto_resume_fires_at_most_once_per_model(tmp_path):
    x, y = _data(32)
    root = str(tmp_path / "ck")
    ff1 = _mlp()
    ff1.enable_checkpointing(root)
    ff1.fit(x, y, epochs=1, batch_size=8, verbose=False)
    ff1._resilience.save(ff1._py_step(), cursor={"epoch": 1, "batch": 0},
                         blocking=True)
    ff2 = _mlp(argv=["--checkpoint-dir", root, "--auto-resume"])
    ff2.fit(x, y, epochs=2, batch_size=8, verbose=False)
    assert ff2._py_step() == 8
    ff2.fit(x, y, epochs=1, batch_size=8, verbose=False)
    assert ff2._py_step() == 12


def test_repeated_fit_calls_get_fresh_shuffle_orders():
    ff = _mlp()
    o0 = ff._epoch_order(32, 0, True)
    x, y = _data(16)
    ff.fit(x, y, epochs=1, batch_size=8, verbose=False)
    o1 = ff._epoch_order(32, 0, True)
    assert not np.array_equal(o0, o1)
    np.testing.assert_array_equal(o1, _mlp()._epoch_order(32, 1, True))


# ===================================================================
# cross-mesh resume over 4 gloo ranks
# ===================================================================

def _full_masters(ff) -> dict:
    return {f"{n}.{k}": ff.get_weight(n, k).copy()
            for n, ws in ff._params.items() for k in ws}


def cross_mesh_job(rank, root, init):
    """On each of 4 ranks: the tiny LM at dp 4 under stage 3, checkpoints
    every 2 steps, killed after step 3; then resumed at dp 2 x tp 2
    (megatron_transformer) to the end. Returns the whole masters and the
    local size of one master under each plan."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.parallel import megatron_transformer
    from flexflow_tpu_torch.resilience import (
        FaultInjector, SimulatedPreemption)

    x, y = _lm_data()
    saved = _mesh_lm(["--mesh", "4,1,1,1", "--weight-update-sharding=stage3",
                      "--checkpoint-dir", root, "--checkpoint-every", "2"])
    load_params(saved, init)
    local_saved = saved._params["l0_ffn1"]["kernel"].numel()
    saved.set_fault_hook(FaultInjector(kill_after_step=3))
    try:
        saved.fit(x, y, epochs=2, batch_size=LM_BATCH * 2, verbose=False)
        raise AssertionError("the fault did not fire")
    except SimulatedPreemption:
        pass
    if rank == 0:  # the one-rank resume's copy of the killed run's dir
        import shutil

        shutil.copytree(root, root + "_one")
    resumed = _mesh_lm(["--mesh", "2,2,1,1", "--checkpoint-dir", root,
                        "--auto-resume", "--weight-update-sharding=off"],
                       megatron_transformer)
    local_resumed = resumed._params["l0_ffn1"]["kernel"].numel()
    resumed.fit(x, y, epochs=2, batch_size=LM_BATCH * 2, verbose=False)
    return {"masters": _full_masters(resumed), "step": resumed._py_step(),
            "local": (local_saved, local_resumed)}


def _mesh_lm(argv, strategy=None):
    sys.argv = ["test", *argv]
    from flexflow_tpu_torch import (
        FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
    )
    from flexflow_tpu_torch.models import (
        TransformerLMConfig, build_transformer_lm,
    )

    cfg = FFConfig(device="cpu")
    cfg.batch_size = LM_BATCH * 2
    cfg.allow_tensor_op_math_conversion = False
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY),
                         batch_size=LM_BATCH * 2)
    if strategy is not None:
        ff.set_strategy(strategy(ff))
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def test_cross_mesh_resume_over_gloo_ranks(tmp_path):
    """Saved at dp 4 under stage 3 (the masters sharded at rest: the save
    gathers them), resumed at dp 2 x tp 2 on 4 gloo ranks and on one
    rank: both finish the run within JAX's rtol=2e-4, atol=1e-6 of the
    uninterrupted one-rank run from the same weights."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.distributed import spawn

    x, y = _lm_data()
    init = _jax_init(_lm("flexflow_tpu"))
    root = str(tmp_path / "ck")
    outs = spawn(cross_mesh_job, 4, root, init, timeout=300)
    ref = _mesh_lm([])
    load_params(ref, init)
    ref.fit(x, y, epochs=2, batch_size=LM_BATCH * 2, verbose=False)
    want = _full_masters(ref)
    one = _mesh_lm(["--checkpoint-dir", root + "_one", "--auto-resume"])
    one.fit(x, y, epochs=2, batch_size=LM_BATCH * 2, verbose=False)
    whole = int(np.prod(ref._params["l0_ffn1"]["kernel"].shape))
    for o in outs:
        assert o["step"] == 2 * LM_STEPS // 2
        assert o["local"] == (whole // 4, whole // 2), o["local"]
    for got in (outs[0]["masters"], _full_masters(one)):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **MESH_TOL, err_msg=k)
    for o in outs[1:]:
        for k, v in o["masters"].items():
            np.testing.assert_array_equal(v, outs[0]["masters"][k], k)


# ===================================================================
# chip_smoke.py's phase 19, rehearsed on the CPU
# ===================================================================

def test_phase19_checks_pass_on_the_cpu():
    """chip_smoke.py's phase 19 at the tiny LM on the CPU (float32): (a)
    chunks of 4 and 3 bit-equal to the per-step fit; (b) the per-step
    and chunked kills and the SIGTERM drain resumed bit-equal, in this
    process and in a fresh one (`chip_smoke.py --resume-child`); (c) the
    async snapshot not torn by the replays queued behind it; (d) the warm
    start on 2 gloo ranks: cache, then checkpoint, with 0 evaluations.
    Every check there is fatal; this test holds what they logged."""
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    sys.argv = ["test"]
    lm = TransformerLMConfig(**TINY)
    p = chip_smoke.phase19("cpu", lm, LM_BATCH, lm, dtype="f32")
    total = chip_smoke.P19_EPOCHS * chip_smoke.P19_BATCHES
    for name, r in p["chunks"].items():
        assert r["steps_run"] == total and r["py_step"] == total, name
    assert sorted(p["chunks"]["chunks of 3"]["captures"]) == [2, 3]
    b = p["resume"]
    assert b["per-step kill"]["killed"] and b["per-step kill"]["in_process"][
        "diff"] == []
    assert b["per-step SIGTERM"]["py_step"] == chip_smoke.P19_SIGTERM + 1
    fresh = {r["name"]: r for r in b["fresh_process"]["resumes"]}
    assert set(fresh) == {"per-step kill", "chunks of 4, kill",
                          "per-step SIGTERM"}
    for r in fresh.values():
        assert r["diff"] == [] and r["py_step"] == total and r["steps_run"]
    assert p["torn"]["torn"] == [] and p["torn"]["masters_moved"] > 0
    w = p["warm"]["ranks"][0]
    assert [w[t]["plan_source"] for t in ("cold", "warm", "resume")] == [
        "search", "cache", "checkpoint"]
    assert w["warm"]["evals"] == w["resume"]["evals"] == 0


# ===================================================================
# C3: SGD at momentum 0, one checkpoint format both ways
# ===================================================================

@pytest.fixture(scope="module")
def sgd0_runs(tmp_path_factory):
    """The tiny LM under SGD with momentum 0 in both packages, from the
    JAX model's weights, 2 steps each, checkpointed."""
    from flexflow_tpu_torch import load_params

    root = tmp_path_factory.mktemp("sgd0")
    x, y = _lm_data()
    half = ({k: v[:2 * LM_BATCH] for k, v in x.items()}, y[:2 * LM_BATCH])
    jff = _lm("flexflow_tpu", momentum=0.0)
    init = _jax_init(jff)
    jff.fit(*half, epochs=1, batch_size=LM_BATCH, shuffle=False,
            verbose=False)
    jpath = jff.save_checkpoint(str(root / "jax"))
    tff = _lm("flexflow_tpu_torch", momentum=0.0)
    load_params(tff, init)
    tff.fit(*half, epochs=1, batch_size=LM_BATCH, shuffle=False,
            verbose=False)
    tpath = tff.save_checkpoint(str(root / "port"))
    return dict(jff=jff, jpath=jpath, tff=tff, tpath=tpath)


def test_momentum_zero_checkpoints_restore_both_ways_bit_equal(sgd0_runs):
    """C3: JAX's restore_tree takes the port's checkpoint of a momentum-0
    SGD run, and the port's takes JAX's; each restore is bit-equal, leaf
    for leaf, to the other package's restore of the same checkpoint (the
    scalar slots included)."""
    from flexflow_tpu.resilience import load_checkpoint as jload
    from flexflow_tpu.resilience import restore_tree as jrestore
    from flexflow_tpu.resilience.reshard import (
        model_state_tree as jstate_tree)
    from flexflow_tpu_torch.resilience import load_checkpoint, restore_tree
    from flexflow_tpu_torch.resilience.checkpointer import flatten_tree
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    def port_restore(path):
        ff = _lm("flexflow_tpu_torch", momentum=0.0)
        flat, _ = load_checkpoint(path)
        tmpl = model_state_tree(ff)
        tmpl.pop("rng")
        restore_tree(tmpl, flat, executor=ff.executor)
        return {k: np.asarray(v.detach().cpu().float().numpy()
                              if v.dtype == torch.bfloat16
                              else v.detach().cpu().numpy())
                for k, v in flatten_tree(tmpl).items()}

    def jax_restore(path):
        import jax

        tmpl = jstate_tree(_lm("flexflow_tpu", momentum=0.0))
        tmpl.pop("rng")
        flat, _ = jload(path)
        restored = jrestore(tmpl, flat)
        leaves, _ = jax.tree_util.tree_flatten_with_path(restored)
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}

    tff = sgd0_runs["tff"]
    slot = tff._opt_slots["v"]["lm_head"]["kernel"]
    assert slot.shape == () and not slot
    for path in (sgd0_runs["tpath"], sgd0_runs["jpath"]):
        t, j = port_restore(path), jax_restore(path)
        assert set(t) == set(j)
        assert any(k.startswith("['opt_slots']['v']") for k in t)
        for k in t:
            assert t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
