"""The port's frontends (`flexflow_tpu_torch/keras/`, `.torch_frontend/`)
on the CPU: the twins of `tests/test_frontends.py` and
`tests/test_keras_callbacks.py`, plus the keras `Telemetry` and
`Diagnostics` callbacks over the port's telemetry and diagnostics.

Keras Sequential and functional models (merges, a shared layer, a CNN)
lower onto the port's FFModel and train; the callbacks change the rate
the captured step applies (a rate of 0 leaves every master bit-equal),
gate and stop early, and checkpoint through the port's resilience (one
commit an epoch, restorable into a fresh model); the datasets keep their
deterministic synthetic fallback and read only a local archive. torch.fx
modules convert onto the port's FFModel, their installed weights giving
torch's outputs (float32, rtol 1e-4, atol 1e-5), and round-trip through
the `.ff` file. The JAX package's frontends give the same layer graph.
"""

import json
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _argv(*extra):
    sys.argv = ["test", "--device", "cpu", *extra]


# ------------------------------------------------------------ keras

def test_keras_sequential_trains():
    _argv()
    from flexflow_tpu_torch.keras import Dense, Sequential
    from flexflow_tpu_torch.keras.optimizers import SGD

    model = Sequential([
        Dense(64, input_shape=(32,), activation="relu"),
        Dense(10, activation="softmax"),
    ])
    model.compile(optimizer=SGD(learning_rate=0.1),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rs = np.random.RandomState(0)
    centers = rs.randn(10, 32) * 3
    y = rs.randint(0, 10, 1024)
    x = (centers[y] + rs.randn(1024, 32)).astype(np.float32)
    model.fit(x, y.reshape(-1, 1).astype(np.int32), epochs=2)
    assert model.ffmodel.device.type == "cpu"
    assert model.ffmodel.get_perf_metrics().get_accuracy() >= 0.9


def _merge_model(pkg):
    k = __import__(f"{pkg}.keras", fromlist=["x"])
    a = k.Input(shape=(16,), batch_size=8)
    b = k.Input(shape=(16,), batch_size=8)
    x1 = k.Dense(8, activation="relu")(a)
    x2 = k.Dense(8, activation="relu")(b)
    merged = k.Concatenate(axis=1)([x1, x2])
    out = k.Dense(4, activation="softmax")(merged)
    model = k.Model(inputs=[a, b], outputs=out)
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    return model


def test_keras_functional_merge_builds_the_jax_graph_and_trains():
    layers = {}
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        _argv()
        model = _merge_model(pkg)
        layers[pkg] = [(l.op_type.name, tuple(l.outputs[0].dims))
                       for l in model.ffmodel.layers]
    assert layers["flexflow_tpu"] == layers["flexflow_tpu_torch"]
    rs = np.random.RandomState(0)
    xs = [rs.randn(8, 16).astype(np.float32) for _ in range(2)]
    ys = rs.randint(0, 4, (8, 1)).astype(np.int32)
    model.fit(xs, ys, epochs=1, batch_size=8)


def test_keras_cnn_builds():
    _argv()
    from flexflow_tpu_torch.keras import (
        Conv2D, Dense, Flatten, MaxPooling2D, Sequential,
    )

    model = Sequential([
        Conv2D(8, 3, strides=1, padding="same", activation="relu",
               input_shape=(1, 28, 28)),
        MaxPooling2D(2),
        Flatten(),
        Dense(10, activation="softmax"),
    ])
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    assert model.ffmodel.layers[-1].outputs[0].dims[-1] == 10


def test_keras_shared_layer():
    _argv()
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.keras import Add, Dense, Input, Model

    a = Input(shape=(16,), batch_size=8)
    b = Input(shape=(16,), batch_size=8)
    d = Dense(8, activation="relu", name="shared")
    out = Dense(4, activation="softmax")(Add()([d(a), d(b)]))
    model = Model(inputs=[a, b], outputs=out)
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    denses = [l for l in model.ffmodel.layers if l.op_type == OT.OP_LINEAR]
    assert len(denses) == 3  # two materialized calls + head


def _mlp_model(batch=32):
    _argv("-b", str(batch))
    from flexflow_tpu_torch.keras import Dense, Input, Model, SGD

    inp = Input(shape=(16,))
    t = Dense(32, activation="relu", name="h")(inp)
    out = Dense(4, activation="softmax", name="out")(t)
    model = Model(inp, out)
    model.compile(optimizer=SGD(learning_rate=0.1),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


def _toy_data(n=128, d=16, k=4):
    rs = np.random.RandomState(0)
    centers = rs.randn(k, d) * 3
    y = rs.randint(0, k, n)
    x = (centers[y] + rs.randn(n, d)).astype(np.float32)
    return x, y.reshape(-1, 1).astype(np.int32)


def _flat_params(ff):
    return np.concatenate([ff.get_weight(n, w).ravel()
                           for n in sorted(ff._params)
                           for w in sorted(ff._params[n])])


def test_scheduler_changes_effective_lr():
    """A schedule of 0.0 freezes every master (the captured step is
    dropped and built anew with the rate); a real rate trains."""
    from flexflow_tpu_torch.keras import LearningRateScheduler

    model = _mlp_model()
    x, y = _toy_data()
    before = _flat_params(model.ffmodel)
    model.fit(x, y, epochs=1,
              callbacks=[LearningRateScheduler(lambda e: 0.0)])
    assert model.optimizer.lr == 0.0
    after = _flat_params(model.ffmodel)
    np.testing.assert_array_equal(before, after)
    model.fit(x, y, epochs=2, callbacks=[LearningRateScheduler(
        lambda e: 0.2 if e == 0 else 0.05)])
    assert model.optimizer.lr == 0.05
    assert not np.array_equal(after, _flat_params(model.ffmodel))


def test_scheduler_rejects_non_float():
    from flexflow_tpu_torch.keras import LearningRateScheduler

    model = _mlp_model()
    x, y = _toy_data()
    with pytest.raises(ValueError, match="should be float"):
        model.fit(x, y, epochs=1,
                  callbacks=[LearningRateScheduler(lambda e: "fast")])


def test_verify_metrics_gate_and_epoch_early_stop():
    from flexflow_tpu_torch.keras import (
        Callback, EpochVerifyMetrics, VerifyMetrics,
    )

    model = _mlp_model()
    x, y = _toy_data(n=256)
    model.fit(x, y, epochs=3, callbacks=[VerifyMetrics(0.5)])
    with pytest.raises(AssertionError, match="accuracy gate"):
        model.fit(x, y, epochs=1, callbacks=[VerifyMetrics(1.01)])

    class EpochCounter(Callback):
        def __init__(self):
            super().__init__()
            self.n = 0

        def on_epoch_begin(self, epoch, logs=None):
            self.n += 1

    counter = EpochCounter()
    model.fit(x, y, epochs=10, callbacks=[counter, EpochVerifyMetrics(0.0)])
    assert counter.n == 1


def test_model_checkpoint_periodic_saves_restore(tmp_path):
    from flexflow_tpu_torch.keras import Callback, ModelCheckpoint
    from flexflow_tpu_torch.resilience import (
        latest_checkpoint,
        list_checkpoints,
    )

    class EpochCounter(Callback):
        n = 0

        def on_epoch_begin(self, epoch, logs=None):
            self.n += 1

    model = _mlp_model()
    x, y = _toy_data()
    root = str(tmp_path / "ck")
    cb, counter = ModelCheckpoint(root, keep=5), EpochCounter()
    model.fit(x, y, epochs=3, callbacks=[cb, counter])
    assert counter.n == 3  # a checkpoint never stops training
    ckpts = list_checkpoints(root)
    assert len(ckpts) == 3 and cb.last_saved is not None
    model2 = _mlp_model()
    model2.ffmodel.load_checkpoint(root)
    np.testing.assert_array_equal(_flat_params(model2.ffmodel),
                                  _flat_params(model.ffmodel))
    assert latest_checkpoint(root) == ckpts[-1]


def test_model_checkpoint_save_best_only_and_every_n(tmp_path):
    from flexflow_tpu_torch.keras import ModelCheckpoint
    from flexflow_tpu_torch.resilience import list_checkpoints

    with pytest.raises(ValueError, match="monitor"):
        ModelCheckpoint(str(tmp_path), monitor="f1")
    with pytest.raises(ValueError, match="every_n_epochs"):
        ModelCheckpoint(str(tmp_path), every_n_epochs=0)
    model = _mlp_model()
    x, y = _toy_data(n=256)
    root = str(tmp_path / "best")
    cb = ModelCheckpoint(root, monitor="accuracy", save_best_only=True)
    vals = iter([0.5, 0.3, 0.7])
    cb._metric = lambda: next(vals)
    model.fit(x, y, epochs=3, callbacks=[cb])
    assert cb.best == 0.7
    assert len(list_checkpoints(root)) == 2  # epochs 0 and 2 only
    root = str(tmp_path / "every")
    model.fit(x, y, epochs=4,
              callbacks=[ModelCheckpoint(root, every_n_epochs=2)])
    assert len(list_checkpoints(root)) == 2  # epochs 1 and 3


def test_telemetry_and_diagnostics_callbacks(tmp_path):
    """The keras callbacks over the port's telemetry (one `keras_epoch`
    record an epoch) and diagnostics (the strategy report whose per-op
    costs sum to its total, the alerts file)."""
    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.diagnostics import verify_report_total
    from flexflow_tpu_torch.keras.callbacks import Diagnostics, Telemetry

    model = _mlp_model()
    x, y = _toy_data()
    tdir = tmp_path / "tel"
    model.fit(x, y, epochs=2, callbacks=[Telemetry(str(tdir))])
    records = [json.loads(l) for l in open(tdir / "metrics.jsonl")]
    epochs = [r for r in records if r.get("kind") == "keras_epoch"]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert model.ffmodel.get_telemetry() is not None
    telemetry.deactivate()

    model = _mlp_model()
    ddir = tmp_path / "diag"
    model.fit(x, y, epochs=2, callbacks=[Diagnostics(str(ddir))])
    rep = json.load(open(ddir / "strategy_report.json"))
    assert verify_report_total(rep) == pytest.approx(
        rep["total_predicted_s"], rel=1e-9)
    assert (ddir / "alerts.jsonl").exists()
    assert model.ffmodel.get_diagnostics() is not None
    telemetry.deactivate()


def test_datasets_shapes_determinism_and_no_download(tmp_path, monkeypatch):
    from flexflow_tpu.keras.datasets import mnist as jmnist
    from flexflow_tpu_torch.keras.datasets import cifar10, mnist

    (xtr, ytr), (xte, yte) = mnist.load_data(n_train=512, n_test=64)
    assert xtr.shape == (512, 28, 28) and xtr.dtype == np.uint8
    assert ytr.shape == (512,) and ytr.dtype == np.uint8
    assert xte.shape == (64, 28, 28) and yte.shape == (64,)
    (jx, jy), _ = jmnist.load_data(n_train=512, n_test=64)
    np.testing.assert_array_equal(xtr, jx)
    np.testing.assert_array_equal(ytr, jy)
    with pytest.raises(FileNotFoundError):
        mnist.load_data(path="definitely_absent.npz", synthetic=False)
    (cx, cy), (cxe, cye) = cifar10.load_data(n_train=256, n_test=32)
    assert cx.shape == (256, 3, 32, 32) and cx.dtype == np.uint8
    assert cy.shape == (256, 1) and cxe.shape == (32, 3, 32, 32)
    # a local archive is read when present
    arr = np.arange(4 * 28 * 28, dtype=np.uint8).reshape(4, 28, 28)
    np.savez(tmp_path / "mnist.npz", x_train=arr, y_train=arr[:, 0, 0],
             x_test=arr[:2], y_test=arr[:2, 0, 0])
    monkeypatch.setenv("FLEXFLOW_DATASET_DIR", str(tmp_path))
    (lx, _), _ = mnist.load_data()
    np.testing.assert_array_equal(lx, arr)


def test_mnist_synthetic_is_learnable():
    from flexflow_tpu_torch.keras import Dense, Input, Model, SGD
    from flexflow_tpu_torch.keras import VerifyMetrics
    from flexflow_tpu_torch.keras.datasets import mnist

    _argv("-b", "64")
    (x_train, y_train), _ = mnist.load_data(n_train=2048, n_test=64)
    x = x_train.reshape(-1, 784).astype(np.float32) / 255.0
    y = y_train.reshape(-1, 1).astype(np.int32)
    inp = Input(shape=(784,))
    out = Dense(10, activation="softmax")(Dense(64, activation="relu")(inp))
    model = Model(inp, out)
    model.compile(optimizer=SGD(learning_rate=0.05),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    np.random.seed(0)
    model.fit(x, y, epochs=5, callbacks=[VerifyMetrics(0.90)])


# ------------------------------------------------------------ torch.fx

def _ff(batch):
    _argv()
    from flexflow_tpu_torch import FFConfig, FFModel

    config = FFConfig()
    config.batch_size = batch
    return FFModel(config)


def test_torch_fx_mlp_matches_torch():
    import torch
    import torch.nn as nn

    from flexflow_tpu_torch import LossType, SGDOptimizer
    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    torch.manual_seed(0)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(20, 32)
            self.act = nn.ReLU()
            self.fc2 = nn.Linear(32, 6)

        def forward(self, x):
            h = self.act(self.fc1(x))
            return self.fc2(h) + 1.0

    net = Net().eval()
    ff = _ff(4)
    x = ff.create_tensor((4, 20), name="x")
    conv = PyTorchModel(net)
    (out,) = conv.torch_to_ff(ff, [x])
    ff.softmax(out, name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.0),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    conv.install_weights(ff)
    xin = np.random.RandomState(0).randn(4, 20).astype(np.float32)
    ff.start_batch({"x": xin}, np.zeros((4, 1), np.int32))
    probs = np.asarray(ff.forward())
    with torch.no_grad():
        t_probs = torch.softmax(net(torch.from_numpy(xin)), -1).numpy()
    np.testing.assert_allclose(probs, t_probs, rtol=1e-4, atol=1e-5)


def test_torch_fx_cnn_logits_match_torch():
    import torch

    from flexflow_tpu_torch import LossType, SGDOptimizer
    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    from chip_smoke import small_cnn  # phase 24(c)'s module

    torch.manual_seed(0)
    net = small_cnn().eval()
    ff = _ff(2)
    x = ff.create_tensor((2, 1, 28, 28), name="x")
    conv = PyTorchModel(net)
    (out,) = conv.torch_to_ff(ff, [x])
    assert out.dims == (2, 10)
    ff.compile(optimizer=SGDOptimizer(lr=0.0),
               loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    conv.install_weights(ff)
    xin = np.random.RandomState(1).randn(2, 1, 28, 28).astype(np.float32)
    ff.start_batch({"x": xin}, np.zeros((2, 10), np.float32))
    with torch.no_grad():
        want = net(torch.from_numpy(xin)).numpy()
    np.testing.assert_allclose(np.asarray(ff.forward()), want, rtol=1e-4,
                               atol=1e-5)


def test_torch_ff_file_roundtrip(tmp_path):
    import torch.nn as nn

    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.torch_frontend import (
        PyTorchModel,
        torch_to_flexflow,
    )

    net = nn.Sequential(
        nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 8), nn.Softmax(dim=-1))
    path = str(tmp_path / "net.ff")
    torch_to_flexflow(net, path)
    # the JAX package's exporter writes the same file
    from flexflow_tpu.torch_frontend import torch_to_flexflow as jexport

    jexport(net, str(tmp_path / "jax.ff"))
    assert open(path).read() == open(tmp_path / "jax.ff").read()
    ff = _ff(4)
    x = ff.create_tensor((4, 16), name="x")
    (out,) = PyTorchModel(path).torch_to_ff(ff, [x])
    assert out.dims == (4, 8)
    assert [l.op_type for l in ff.layers] == [
        OT.OP_LINEAR, OT.OP_RELU, OT.OP_LINEAR, OT.OP_SOFTMAX]


def test_torch_fx_cat_and_global_mean():
    import torch
    import torch.nn as nn

    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 8)
            self.fc2 = nn.Linear(8, 8)

        def forward(self, x):
            z = torch.cat([self.fc1(x), self.fc2(x)], dim=1)
            return torch.mean(z)

    ff = _ff(4)
    x = ff.create_tensor((4, 8), name="x")
    (out,) = PyTorchModel(Net()).torch_to_ff(ff, [x])
    assert out.dims == ()


def test_new_modules_import_no_jax():
    """The frontends (the ONNX one too), the MoE ops and the zoo of the
    port import neither jax nor the JAX package (a fresh interpreter)."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, flexflow_tpu_torch.keras, "
        "flexflow_tpu_torch.keras.datasets, flexflow_tpu_torch.keras."
        "callbacks, flexflow_tpu_torch.torch_frontend, "
        "flexflow_tpu_torch.onnx_frontend, "
        "flexflow_tpu_torch.onnx_frontend.model, "
        "flexflow_tpu_torch.ops.moe, flexflow_tpu_torch.models.moe, "
        "flexflow_tpu_torch.models.alexnet, "
        "flexflow_tpu_torch.models.inception, "
        "flexflow_tpu_torch.models.dlrm, flexflow_tpu_torch.models.xdl, "
        "flexflow_tpu_torch.models.candle_uno\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flexflow_tpu', 'ml_dtypes')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]
