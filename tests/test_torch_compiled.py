"""The port's compiled step on the CPU: donation as in-place updates, the
serving weight cache, `executor.eager()`, the capture machinery's host
side, the machine model and `bench_torch.py`.

On a CUDA device `Executor.build_train_step`, `build_eval_step` and
`build_decode_step` return `CapturedStep`s (CUDA graphs; held to their
eager selves by the card tests in `tests/test_torch_cuda.py`); on the CPU
they are the plain steps. What changes for both is that the training
state is updated in place, the twin of the JAX step's `donate_argnums`:
the optimizers update the masters and slots, the step counter and the
metric counters advance, in the tensors the caller passed. These tests
hold that to the JAX package's `fit` on the tiny LM (vocab 64, hidden
128, 2 heads, 2 layers, seq 128, weights copied by `load_params`) at
`tests/test_torch_train.py`'s tolerances: per-step losses at rtol 1e-5,
masters and slots at atol 1e-5, metrics exact in counts and at rtol 1e-5
in the loss.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import optimizer as jopt
from flexflow_tpu_torch import executor as texec
from flexflow_tpu_torch import optimizer as topt
from flexflow_tpu_torch.kernels import KernelCounter
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
            sequence_length=128, attention_impl="flash")
BATCH, STEPS = 2, 3


def _data(seed=5):
    rs = np.random.RandomState(seed)
    n = BATCH * STEPS
    toks = rs.randint(0, 64, (n, 128)).astype(np.int32)
    pos = np.tile(np.arange(128, dtype=np.int32), (n, 1))
    labels = rs.randint(0, 64, (n, 128, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def _metrics_list(pkg):
    return [pkg.MetricsType.METRICS_ACCURACY,
            pkg.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY]


def _jax_lm(opt):
    sys.argv = ["test"]
    import flexflow_tpu as jpkg
    from flexflow_tpu.models import TransformerLMConfig, build_transformer_lm

    cfg = jpkg.FFConfig()
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = BATCH
    ff = jpkg.FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=BATCH)
    ff.compile(optimizer=opt,
               loss_type=jpkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=_metrics_list(jpkg))
    return ff


def _torch_lm(opt, params=None, dtype=None):
    """The tiny LM in the port on the CPU, its weights `params` (numpy by
    name) when given."""
    sys.argv = ["test"]
    import flexflow_tpu_torch as tpkg
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    cfg = tpkg.FFConfig(device="cpu")
    cfg.batch_size = BATCH
    if dtype:
        cfg.parse_args(["--dtype", dtype])
    ff = tpkg.FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=BATCH)
    ff.compile(optimizer=opt,
               loss_type=tpkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=_metrics_list(tpkg))
    if params is not None:
        tpkg.load_params(ff, params)
    return ff


def _record_losses(ff):
    step = ff.executor.build_train_step()
    losses = []

    def wrapped(*args):
        out = step(*args)
        losses.append(float(np.asarray(out[-1], np.float32)))
        return out

    ff.executor._train_step = wrapped
    return losses


def _np_tree(tree):
    return {n: {k: np.asarray(v, np.float32) for k, v in ws.items()}
            for n, ws in tree.items()}


OPTIMIZERS = {
    "sgd_momentum": (lambda: jopt.SGDOptimizer(lr=0.05, momentum=0.9),
                     lambda: topt.SGDOptimizer(lr=0.05, momentum=0.9)),
    # epsilon 1e-6: some of the tiny LM's gradient entries are near 1e-8
    # (the key bias's is exactly 0: softmax ignores a constant per query
    # row), where Adam's default 1e-8 turns the two frameworks' f32
    # rounding differences into differences of a whole step (up to 3e-4
    # after 3 steps); at 1e-6 the masters agree within 4e-6
    "adam": (lambda: jopt.AdamOptimizer(alpha=0.01, epsilon=1e-6),
             lambda: topt.AdamOptimizer(alpha=0.01, epsilon=1e-6)),
}


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def fitted(request):
    """Both packages' tiny LM fitted 3 steps from the same weights; the
    port's state tensors before the fit, to check they were updated in
    place."""
    jmake, tmake = OPTIMIZERS[request.param]
    x, y = _data()
    jff = _jax_lm(jmake())
    tff = _torch_lm(tmake(), {n: {w: np.asarray(v) for w, v in ws.items()}
                              for n, ws in jff._params.items()})
    before = [t for ws in tff._params.values() for t in ws.values()]
    before += [t for slot in tff._opt_slots.values()
               for ws in slot.values() for t in ws.values()]
    before += [tff._step] + list(tff._counters.values())
    jl, tl = _record_losses(jff), _record_losses(tff)
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    tff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    return dict(name=request.param, jff=jff, tff=tff, jl=np.asarray(jl),
                tl=np.asarray(tl), before=before)


def test_in_place_training_matches_jax_fit(fitted):
    """Losses, masters and optimizer slots after 3 in-place steps (SGD
    with momentum, and Adam with its bias correction read from the
    in-place step counter) are the JAX package's."""
    jff, tff = fitted["jff"], fitted["tff"]
    assert len(fitted["tl"]) == len(fitted["jl"]) == STEPS
    np.testing.assert_allclose(fitted["tl"], fitted["jl"], rtol=1e-5)
    for n, ws in _np_tree(jff._params).items():
        for w, want in ws.items():
            np.testing.assert_allclose(tff.get_weight(n, w), want, atol=1e-5,
                                       err_msg=f"{n}.{w}")
    jslots = jax.device_get(jff._opt_slots)
    assert set(tff._opt_slots) == set(jslots)
    for slot, tree in jslots.items():
        for n, ws in _np_tree(tree).items():
            for w, want in ws.items():
                np.testing.assert_allclose(
                    tff._opt_slots[slot][n][w].numpy(), want, atol=1e-5,
                    err_msg=f"{slot} {n}.{w}")
    assert int(tff._step) == int(jax.device_get(jff._step)) == STEPS


def test_in_place_counters_match_jax_metrics(fitted):
    jm, tm = fitted["jff"].get_perf_metrics(), fitted["tff"].get_perf_metrics()
    assert tm.train_all == jm.train_all == BATCH * STEPS * 128
    assert tm.train_correct == jm.train_correct
    np.testing.assert_allclose(tm.get_mean_loss(), jm.get_mean_loss(),
                               rtol=1e-5)


def test_training_state_is_updated_in_place(fitted):
    """Donation: after fit the model holds the very tensors it held before
    (masters, slots, step, counters), each advanced in place."""
    tff = fitted["tff"]
    after = [t for ws in tff._params.values() for t in ws.values()]
    after += [t for slot in tff._opt_slots.values()
              for ws in slot.values() for t in ws.values()]
    after += [tff._step] + list(tff._counters.values())
    assert len(after) == len(fitted["before"])
    assert all(a is b for a, b in zip(after, fitted["before"]))
    measured = ("train_all", "train_correct", "sparse_cce_loss")
    assert all(t._version > 0 for t in after[:-len(tff._counters)])
    assert all(tff._counters[k]._version > 0 for k in measured)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_writes_the_given_tensors(name):
    """`update` returns the tensors it was given, changed in place, and
    leaves a copy taken before unchanged."""
    opt = OPTIMIZERS[name][1]()
    g = torch.Generator().manual_seed(3)
    params = {"a": {"w": torch.randn(4, 3, generator=g)}}
    grads = {"a": {"w": torch.randn(4, 3, generator=g)}}
    slots = opt.init(params)
    w, kept = params["a"]["w"], params["a"]["w"].clone()
    new, new_slots = opt.update(grads, params, slots,
                                torch.zeros((), dtype=torch.int32))
    assert new["a"]["w"] is w and new_slots is slots
    assert not torch.equal(w, kept)


def test_granular_update_and_reset_work_in_place():
    """The granular update advances the step in place; reset_metrics and
    eval zero their counters in place; a new learning rate drops the
    train step (a constant of the captured step), as JAX drops its
    executable."""
    x, y = _data()
    ff = _torch_lm(topt.SGDOptimizer(lr=0.05))
    step, counters = ff._step, dict(ff._counters)
    ff.start_batch({k: v[:BATCH] for k, v in x.items()}, y[:BATCH])
    ff.backward()
    ff.update()
    assert ff._step is step and int(step) == 1
    assert float(counters["train_all"]) == BATCH * 128
    ff.reset_metrics()
    assert all(ff._counters[k] is c and float(c) == 0
               for k, c in counters.items())
    first = ff.eval(x, y, batch_size=BATCH)
    again = ff.eval(x, y, batch_size=BATCH)
    assert first.train_all == again.train_all == BATCH * STEPS * 128
    assert first.get_mean_loss() == again.get_mean_loss()
    ff.executor.build_train_step()
    ff.set_learning_rate(0.05)  # unchanged: the step stays
    assert ff.executor._train_step is not None
    ff.set_learning_rate(0.01)
    assert ff.executor._train_step is None and ff.optimizer.lr == 0.01


# ------------------------------------------------------------ serving cache

# two prompts past three KV blocks of 4: the radix prefix cache holds
# their full blocks after a first generate
PROMPTS = [[5, 9, 1, 33, 7, 12, 40, 2, 8, 61, 3, 17, 4],
           [2, 2, 60, 11, 19, 40, 3, 8, 8, 27, 30, 1, 5, 44]]


def _serve(ff):
    return ff.serve(slots=2, max_new_tokens=6, prefill_chunk=4,
                    kv_block_size=4)


def _float_params(model) -> int:
    return sum(1 for ws in model._params.values() for w in ws.values()
               if w.is_floating_point())


def test_serving_weight_cache_casts_once_and_follows_its_masters():
    """bf16 serving casts each master once over many steps, and a second
    generate of the same prompts reads its prefix cache. A master the
    decode model replaces (`set_weight`) is cast again, once, into the
    copy's own storage: the engine's streams then equal a fresh engine's
    on a model with that weight, and differ from its first. A `fit` step
    on the trained model leaves the engine's weights as they were
    (`adopt_params` copies them): no cast, the same streams."""
    x, y = _data()
    ff = _torch_lm(topt.SGDOptimizer(lr=0.5), dtype="bf16")
    eng = _serve(ff)
    dec = eng.decode_model
    ex = dec.executor
    n = _float_params(dec)
    first = eng.generate(PROMPTS)
    assert ex.weight_refreshes == n
    hits = eng.stats()["cross_time_hits"]
    assert eng.generate(PROMPTS) == first  # from the prefix cache
    assert eng.stats()["cross_time_hits"] > hits
    assert ex.weight_refreshes == n

    copies = ex.compute_params(dec._params)
    rs = np.random.RandomState(7)
    # the head writes no KV row: the cached prefixes stay valid
    head = rs.randn(*ff._params["lm_head"]["kernel"].shape).astype(
        np.float32)
    dec.set_weight("lm_head", "kernel", head)
    ff.set_weight("lm_head", "kernel", head)
    after_set = eng.generate(PROMPTS)
    assert ex.weight_refreshes == n + 1
    assert after_set == _serve(ff).generate(PROMPTS) != first
    recast = ex.compute_params(dec._params)
    assert all(recast[k][w] is t for k, ws in copies.items()
               for w, t in ws.items())

    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert eng.generate(PROMPTS) == after_set
    assert ex.weight_refreshes == n + 1
    assert _serve(ff).generate(PROMPTS) != after_set
    eng.block_manager.check_invariants()


def test_engine_keeps_its_weights_through_fit_as_jax_does():
    """An engine built before `fit` serves the weights it was built with,
    and one built after serves the fitted ones, in both packages: f32
    greedy streams of the tiny LM from the same weights, equal between
    the packages before the fit, after it from the old engine and from a
    fresh one."""
    x, y = _data()
    jff = _jax_lm(jopt.SGDOptimizer(lr=0.5))
    tff = _torch_lm(topt.SGDOptimizer(lr=0.5),
                    {n: {w: np.asarray(v) for w, v in ws.items()}
                     for n, ws in jff._params.items()})
    jeng, teng = _serve(jff), _serve(tff)
    first = teng.generate(PROMPTS)
    assert first == jeng.generate(PROMPTS)
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    tff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert teng.generate(PROMPTS) == jeng.generate(PROMPTS) == first
    fresh = _serve(tff).generate(PROMPTS)
    assert fresh == _serve(jff).generate(PROMPTS) != first


def test_serving_cache_copies_are_the_per_step_cast():
    """A cached copy has the bits of the cast the step made before, and a
    rebuild writes into the same storage (a captured graph keeps reading
    it); without a compute dtype the masters are used as they are, their
    changes counted alike."""
    ff = _torch_lm(topt.SGDOptimizer(lr=0.5), dtype="bf16")
    ex = ff.executor
    got = ex.compute_params(ff._params)
    for n, ws in ff._params.items():
        for k, w in ws.items():
            assert torch.equal(got[n][k], w.to(torch.bfloat16)), f"{n}.{k}"
    copy = got["lm_head"]["kernel"]
    with torch.no_grad():
        ff._params["lm_head"]["kernel"].mul_(2.0)
    again = ex.compute_params(ff._params)["lm_head"]["kernel"]
    assert again is copy
    assert torch.equal(again, ff._params["lm_head"]["kernel"].to(
        torch.bfloat16))
    f32 = _torch_lm(topt.SGDOptimizer(lr=0.5))
    got = f32.executor.compute_params(f32._params)
    assert all(got[n][k] is w for n, ws in f32._params.items()
               for k, w in ws.items())
    seen = f32.executor.weight_refreshes
    with torch.no_grad():
        f32._params["lm_head"]["kernel"].add_(1.0)
    f32.executor.compute_params(f32._params)
    assert f32.executor.weight_refreshes == seen + 1


def test_eager_context_gives_the_default_results_on_the_cpu():
    """On the CPU the steps are plain functions, and `executor.eager()`
    (the twin of jax.disable_jit) gives the same training and serving
    results bit for bit (deterministic algorithms on: the CPU's embedding
    backward otherwise sums repeated ids in a varying order)."""
    x, y = _data()
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("default", "eager"):
            ff = _torch_lm(topt.SGDOptimizer(lr=0.05, momentum=0.9))
            with (texec.eager() if mode == "eager"
                  else contextlib.nullcontext()):
                ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False,
                       verbose=False)
                streams = _serve(ff).generate(PROMPTS)
            out[mode] = (ff, streams)
    finally:
        torch.use_deterministic_algorithms(False)
    (a, sa), (b, sb) = out["default"], out["eager"]
    assert sa == sb
    assert not isinstance(a.executor._train_step, texec.CapturedStep)
    for n, ws in a._params.items():
        for k, t in ws.items():
            assert torch.equal(t, b._params[n][k]), f"{n}.{k}"
    assert texec._EAGER_DEPTH == 0


# ------------------------------------------------------------ capture, host side

def test_signature_is_keys_shapes_and_dtypes():
    """The captured step's graph key: one signature per keys, shapes and
    dtypes of the staged inputs, as jit specialises; values do not
    count."""
    a = {"tokens": torch.zeros(4, 16, dtype=torch.int32),
         "positions": torch.ones(4, 16, dtype=torch.int32)}
    b = {"tokens": torch.full((4, 16), 7, dtype=torch.int32),
         "positions": torch.ones(4, 16, dtype=torch.int32)}
    sig = texec._signature
    assert sig((a, None)) == sig((b, None))
    assert sig((a, None)) != sig(({**a, "tokens": torch.zeros(4, 8)}, None))
    assert sig((a, None)) != sig(({**a, "tokens": a["tokens"].long()},
                                  None))
    assert sig(({"x": a["tokens"]},)) != sig(({"y": a["tokens"]},))
    assert len(sig((a, torch.zeros(3)))) == 3


def test_tree_helpers_keep_structure_and_order():
    t = {"b": (torch.zeros(1), [torch.ones(2), 3]), "a": {"c": None}}
    leaves = texec._leaves(t)
    assert leaves[2] == 3 and leaves[3] is None and len(leaves) == 4
    mapped = texec._map(lambda v: v if v is None else 0, t)
    assert mapped == {"b": (0, [0, 0]), "a": {"c": None}}
    assert isinstance(mapped["b"], tuple) and isinstance(mapped["b"][1],
                                                         list)


def test_write_back_donates_the_state():
    """The step's new state lands in the given state's tensors; a key the
    state lacks is added."""
    old = torch.zeros(3)
    state = {"n": {"s": old}}
    new = {"n": {"s": torch.ones(3), "t": torch.full((2,), 2.0)},
           "m": {"u": torch.zeros(1)}}
    out = texec._write_back(state, new)
    assert out is state and state["n"]["s"] is old
    assert torch.equal(old, torch.ones(3))
    assert state["n"]["t"] is new["n"]["t"] and "m" in state


def test_capture_error_names_the_first_error_and_its_line():
    """`_culprit` follows the chain to the first error (the capture's own
    error chains it) and names the line outside torch that raised it."""
    def host_read():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    try:
        try:
            host_read()
        except RuntimeError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as exc:
        msg = texec._culprit(exc)
    assert "test_torch_compiled.py" in msg and "in host_read" in msg
    assert "operation not permitted" in msg
    assert "capture invalidated" not in msg


def test_kernel_counter_deltas_replay_a_capture():
    """A capture's counts, taken back and added once per replay, leave the
    counter as that many eager launches would."""
    c = KernelCounter("k")
    c.launched("packed", "sm90")
    before = c.state()
    c.launched("packed", "sm90")
    c.launched("transposed", "mma")
    c.plain_calls += 1
    delta = c.since(before)
    assert delta == (2, 1, {"packed": 1, "transposed": 1},
                     {"sm90": 1, "mma": 1})
    c.restore(before)
    assert c.state() == (1, 0, {"packed": 1}, {"sm90": 1})
    for _ in range(3):
        c.add(delta)
    assert c.state() == (7, 3, {"packed": 4, "transposed": 3},
                         {"sm90": 4, "mma": 3})
    assert c.since(c.state()) == (0, 0, {}, {})


def test_steps_are_plain_functions_on_the_cpu():
    ff = _torch_lm(topt.SGDOptimizer(lr=0.05))
    ex = ff.executor
    assert ex.build_train_step() == ex.train_step
    assert not isinstance(ex.build_eval_step(), texec.CapturedStep)
    assert _serve(ff)._step_fn.captured is None


# ------------------------------------------------------------ machine model

def test_machine_model_h100_is_the_published_sxm_part(monkeypatch):
    from flexflow_tpu.search import machine_model as jmm
    from flexflow_tpu_torch.search import machine_model as tmm

    jfields = [f.name for f in jmm.ChipSpec.__dataclass_fields__.values()]
    tfields = [f.name for f in tmm.ChipSpec.__dataclass_fields__.values()]
    assert tfields == jfields
    h = tmm.CHIPS["h100"]
    assert (h.peak_flops, h.hbm_bandwidth, h.hbm_bytes) == (989e12, 3.35e12,
                                                            80e9)
    assert (h.ici_bandwidth, h.ici_links) == (25e9, 18)
    assert tmm.CHIPS["cpu"] == tmm.ChipSpec(*[
        getattr(jmm.CHIPS["cpu"], f) for f in jfields])
    assert tmm.detect_chip("cpu").name == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tmm.detect_chip("cuda") is h
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-40GB")
    with pytest.raises(ValueError, match="no chip spec"):
        tmm.detect_chip("cuda")


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA H100 SXM5 80GB",
                                  "NVIDIA H100 80GB HBM3"])
def test_detect_chip_takes_only_the_sxm_part(monkeypatch, name):
    """The "h100" entry holds the SXM part's figures: an H100 PCIe or NVL
    (lower peak and memory rate) has no entry and raises."""
    from flexflow_tpu_torch.search import machine_model as tmm

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    if "PCIe" in name or "NVL" in name:
        with pytest.raises(ValueError, match="no chip spec"):
            tmm.detect_chip("cuda")
    else:
        assert tmm.detect_chip("cuda") is tmm.CHIPS["h100"]


# ------------------------------------------------------------ bench_torch.py

def test_bench_torch_on_the_cpu_prints_the_metric_line():
    """`bench_torch.py --device cpu` (lm-smoke, batch 4) ends in bench.py's
    metric line; the line before holds the step time, MFU and the run's
    device, with no device metric for the host."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device",
         "cpu", "--steps", "2", "--warmup", "1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "transformer_lm_tokens_per_sec_per_chip"
    assert last["unit"] == "tokens/s" and last["value"] > 0
    detail = json.loads(lines[-2])
    assert detail["device"] == "cpu" and detail["tier"] == "lm-smoke"
    assert detail["device_idle_share"] is None and detail["card"] is None
    assert detail["step_ms"] > 0
    np.testing.assert_allclose(last["vs_baseline"], detail["mfu"] / 0.35)
    np.testing.assert_allclose(
        last["value"], detail["batch"] * detail["seq"] / detail["step_ms"]
        * 1e3)


# ------------------------------------------ C5: state after an abort


def test_no_collection_holds_the_collector_off_inside_a_capture():
    """`_no_collection` (around every CUDA-graph capture): no automatic
    collection inside, the collector's state restored after, also when
    the block raises, and left off where it was off."""
    import gc

    assert gc.isenabled()
    with texec._no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(ValueError):
        with texec._no_collection():
            raise ValueError("a failed capture")
    assert gc.isenabled()
    gc.disable()
    try:
        with texec._no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def _mlp_abort(tmp_path, pipeline_steps):
    """The MLP fit with a rule that fires at step 2 in --health-abort-on:
    the fit raises HealthAbort there."""
    from flexflow_tpu_torch import (
        ActiMode, FFConfig, FFModel, LossType, SGDOptimizer,
    )
    from flexflow_tpu_torch.diagnostics.health import (
        Alert, Rule, default_rules)

    class AtStep2(Rule):
        name = "at_step_2"

        def _check(self, rec):
            if rec["step"] == 2:
                return Alert(rule=self.name, level="error", step=2,
                             message="planted")
            return None

    sys.argv = ["test"]
    cfg = FFConfig(device="cpu")
    cfg.batch_size = 8
    ff = FFModel(cfg)
    x = ff.create_tensor((8, 16), name="x")
    t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
    ff.softmax(ff.dense(t, 4, name="fc2"), name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    ff.enable_diagnostics(str(tmp_path / f"t{pipeline_steps}"),
                          rules=default_rules(ff.config) + [AtStep2()],
                          abort_on=("at_step_2",))
    rs = np.random.RandomState(0)
    xs = {"x": rs.randn(48, 16).astype(np.float32)}
    ys = rs.randint(0, 4, (48, 1)).astype(np.int32)
    return ff, xs, ys


@pytest.mark.parametrize("pipeline_steps", [1, 2])
def test_aborted_fit_is_freed_only_by_a_collection(tmp_path,
                                                   pipeline_steps):
    """C5's mechanism, as far as the CPU shows it: a model whose fit
    raised HealthAbort (per step and in chunks), caught and let go, is
    cyclic garbage (the diagnostics manager and the model hold each
    other; the exception's traceback holds fit's frame): nothing frees
    it, or on the card its executor's CUDA graphs, until the collector
    runs, at whatever allocation triggers it, which on the card was
    inside the next capture. `_no_collection` keeps that collection out
    of a capture; here it frees the model afterwards, and the same
    process compiles and fits a fresh one."""
    import gc
    import weakref

    from flexflow_tpu_torch.diagnostics import HealthAbort

    ff, xs, ys = _mlp_abort(tmp_path, pipeline_steps)
    gc.collect()
    gc.disable()
    try:
        with pytest.raises(HealthAbort) as ei:
            ff.fit(xs, ys, epochs=1, batch_size=8, shuffle=False,
                   verbose=False, pipeline_steps=pipeline_steps)
        assert ei.value.alert.rule == "at_step_2"
        assert ff._py_step() == 2
        model, executor = weakref.ref(ff), weakref.ref(ff.executor)
        del ei, ff
        with texec._no_collection():
            assert [[] for _ in range(50_000)]  # no collection in here
            assert model() is not None and executor() is not None
    finally:
        gc.enable()
    gc.collect()
    assert model() is None and executor() is None
    again, xs, ys = _mlp_abort(tmp_path / "again", pipeline_steps)
    again._diagnostics.health.abort_on = frozenset()
    again.fit(xs, ys, epochs=1, batch_size=8, shuffle=False, verbose=False,
              pipeline_steps=pipeline_steps)
    assert again._py_step() == 6


def test_exception_inside_a_step_leaves_the_executor_usable(tmp_path):
    """An error raised inside the train step (a failing op) stops fit;
    the executor keeps its step and the same model fits on."""
    ff, xs, ys = _mlp_abort(tmp_path, 1)
    ff._diagnostics.health.abort_on = frozenset()
    step = ff.executor.build_train_step()
    calls = [0]

    def failing(*args):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("an op failed")
        return step(*args)

    ff.executor._train_step = failing
    with pytest.raises(RuntimeError, match="an op failed"):
        ff.fit(xs, ys, epochs=1, batch_size=8, shuffle=False, verbose=False)
    assert ff._py_step() == 2 and ff.executor._train_step is failing
    ff.executor._train_step = step
    ff.fit(xs, ys, epochs=1, batch_size=8, shuffle=False, verbose=False)
    assert ff._py_step() == 8
