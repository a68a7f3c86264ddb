"""The rest of the port's model zoo (ROADMAP A12: AlexNet, Inception-v3,
DLRM, XDL, CANDLE Uno and the reference Transformer) against the JAX
package's builders, on the CPU.

Each builder runs at a small size (a small image, small embedding tables,
narrow towers, 2 layers): the same layer names, operators, output shapes
and weight specs as the JAX build; then, from the JAX model's weights
(`load_params`, DLRM's and XDL's float16 tables included), one loss and
gradient evaluation on the same batch. Float32 losses at rtol 1e-5 and
gradients within 1e-4 of each layer's largest entry (2e-3 where a float16
table's gradient is rounded at a different point). Inception-v3 needs its
published 299 x 299 (its final 8 x 8 average pool), so its whole build is
held to JAX's there and its five block kinds run chained at 9 x 9.
"""

import sys

import numpy as np
import pytest

from tests.test_torch_builders import _copy, _grads_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _ff(pkg, batch):
    sys.argv = ["test"]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = batch
    return mod, mod.FFModel(cfg)


def _alexnet(pkg, ff, m):
    m.build_alexnet(ff, batch_size=2, image_hw=67)


def _inception_blocks(pkg, ff, m):
    """The builder's five block kinds chained at a small size (9 x 9, 16
    channels in; the whole network needs 299 x 299): A (to 9 x 9), B (to
    4 x 4), C, D (to 1 x 1), E, then the builder's head."""
    inc = __import__(f"{pkg}.models.inception", fromlist=["x"])
    t = ff.create_tensor((2, 16, 9, 9), name="input")
    t = inc._inception_a(ff, t, 32, "a1_")
    t = inc._inception_b(ff, t, "b1_")
    t = inc._inception_c(ff, t, 64, "c1_")
    t = inc._inception_d(ff, t, "d1_")
    t = inc._inception_e(ff, t, "e1_")
    t = ff.flat(t, name="flat")
    ff.softmax(ff.dense(t, 10, name="fc"), name="softmax")


def _dlrm(pkg, ff, m):
    m.build_dlrm(ff, m.DLRMConfig(
        sparse_feature_size=8, embedding_size=(50, 60, 70, 80),
        mlp_bot=(4, 16, 8), mlp_top=(40, 16, 2)), batch_size=4)


def _xdl(pkg, ff, m):
    xdl = __import__(f"{pkg}.models.xdl", fromlist=["x"])
    m.build_xdl(ff, xdl.XDLConfig(
        sparse_feature_size=8, embedding_size=(50, 60, 70, 80),
        mlp_top=(32, 16, 16, 2)), batch_size=4)


def _candle(pkg, ff, m):
    uno = __import__(f"{pkg}.models.candle_uno", fromlist=["x"])
    m.build_candle_uno(ff, uno.CandleUnoConfig(
        dense_layers=(32, 32), dense_feature_layers=(24, 24),
        feature_shapes={"dose": 1, "cell.rnaseq": 20,
                        "drug.descriptors": 30, "drug.fingerprints": 16}),
        batch_size=4)


def _transformer(pkg, ff, m):
    m.build_transformer(ff, m.TransformerConfig(
        hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
        sequence_length=16), batch_size=2)


# builder, batch, loss, gradient rtol
ZOO = {
    "alexnet": (_alexnet, 2, "scce", 1e-4),
    "inception_blocks": (_inception_blocks, 2, "scce", 1e-4),
    "dlrm": (_dlrm, 4, "mse", 2e-3),
    "xdl": (_xdl, 4, "mse", 2e-3),
    "candle_uno": (_candle, 4, "mse", 1e-4),
    "transformer": (_transformer, 2, "mse", 1e-4),
}


def _batch(ff, rs):
    """Inputs for every input tensor of `ff` (ids within their table),
    and labels for its output."""
    xs = {}
    for t in ff._input_tensors:
        if "INT" in t.dtype.name:
            table = next(l for l in ff.layers if t in l.inputs)
            xs[t.name] = rs.randint(0, table.params.num_entries,
                                    t.dims).astype(np.int64)
        else:
            xs[t.name] = rs.randn(*t.dims).astype(np.float32)
    return xs


def _layers(ff):
    from importlib import import_module

    out = []
    for l in ff.layers:
        base = import_module(type(ff).__module__.rsplit(".", 1)[0]
                             + ".ops.base")
        specs = base.get_op_def(l.op_type).weights(
            l.params, [t.dims for t in l.inputs])
        out.append((l.name, l.op_type.name,
                    [tuple(t.dims) for t in l.outputs],
                    [(w.name, tuple(w.shape), w.dtype.name, w.trainable)
                     for w in specs]))
    return out


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_builder_matches_jax(name):
    build, batch, loss, rtol = ZOO[name]
    models = {}
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        mod, ff = _ff(pkg, batch)
        build(pkg, ff, __import__(f"{pkg}.models", fromlist=["x"]))
        lt = (mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
              if loss == "scce"
              else mod.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
        ff.compile(optimizer=mod.SGDOptimizer(lr=0.01), loss_type=lt)
        models[pkg] = ff
    jff, tff = models["flexflow_tpu"], models["flexflow_tpu_torch"]
    assert _layers(jff) == _layers(tff)
    _copy(jff, tff)
    rs = np.random.RandomState(3)
    xs = _batch(tff, rs)
    out = tff.layers[-1].outputs[0].dims
    y = (rs.randint(0, out[-1], (batch, 1)).astype(np.int32)
         if loss == "scce" else rs.rand(*out).astype(np.float32))
    jff.start_batch(xs, y)
    tff.start_batch(xs, y)
    jl, tl = float(jff.backward()), float(tff.backward())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grads_close(jff._grads, tff._grads, rtol, name)


def test_inception_v3_build_matches_jax():
    """The whole Inception-v3 at 299 x 299: every layer's name, operator,
    output shapes and weight specs as the JAX build (no weights made)."""
    builds = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        _, ff = _ff(pkg, 2)
        __import__(f"{pkg}.models", fromlist=["x"]).build_inception_v3(
            ff, batch_size=2)
        builds.append(_layers(ff))
    assert builds[0] == builds[1]
    assert builds[1][-3][2] == [(2, 2048)]  # flat after the 8 x 8 pool
