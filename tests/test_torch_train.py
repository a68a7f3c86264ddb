"""The port's training slice against the JAX package's.

Same numpy inputs and weights, made from a seed, go through both packages
on the CPU, where the port's kernel wrappers take their plain versions and
the JAX package runs its Pallas kernels in interpret mode:

- each op of the main path, forward and gradients (`jax.vjp` against
  torch autograd, one cotangent), in float32 at rtol = atol = 2e-5 (sums
  in another order) and in bfloat16 at 2e-2 (the frameworks round bf16 at
  different points), with the weight-gradient bound scaled by the
  gradient's size, since those sum over every row;
- the sparse CE loss, its value and its gradient in the logits' dtype;
- SGD (momentum, nesterov, weight decay) and Adam updates on the same
  arrays;
- the tiny LM (vocab 64, hidden 128, 2 heads of 64, 2 layers, seq 128,
  batch 2, `attention_impl="flash"`: JAX takes its grouped flash kernels
  and its fused LayerNorm there) trained by `fit` in both packages from
  the same weights (`load_params` on a model compiled for training); the
  same LM under `--flash-transposed` (JAX's per-head `_flash_kernel` and
  its fused single-tile backward, rows 3 and 4 of PERF.md's kernel
  table), and at head_dim 128 (hidden 256, 2 heads of 128: the packed
  one-head-per-block kernels, rows 8 and 11);
- the zoo tiers and their parameter and state arithmetic;
- the MLP of the verify flow, trained under the port to >= 90% accuracy.

The tensor-op policy (bf16 matmul inputs under fp32) applies on the
accelerator only, so it is off on both sides here.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import ops as jops
from flexflow_tpu import loss as jloss
from flexflow_tpu import optimizer as jopt
from flexflow_tpu.fftype import (
    ActiMode as JActi,
    LossType as JLoss,
    OperatorType as JOT,
)
from flexflow_tpu.ops.base import OpContext as JCtx, get_op_def as jdef
from flexflow_tpu_torch import loss as tloss
from flexflow_tpu_torch import ops as tops
from flexflow_tpu_torch.kernels import counters, reset_counters
from flexflow_tpu_torch import optimizer as topt
from flexflow_tpu_torch.fftype import (
    ActiMode as TActi,
    LossType as TLoss,
    OperatorType as TOT,
)
from flexflow_tpu_torch.ops.base import OpContext as TCtx, get_op_def as tdef

F32_TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {
    "f32": (torch.float32, jnp.float32, F32_TOL),
    "bf16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, scaled, msg=""):
    bound = dict(tol)
    if scaled:
        bound["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), **bound, err_msg=msg)


def _op_grads(op, jparams, tparams, inputs, weights, dtype, diff_inputs,
              seed=0, zero_grad=(), flash_packed=True):
    """Forward one op in both packages and pull one cotangent back through
    each. `diff_inputs` are the indices of the float inputs to
    differentiate; every weight is differentiated. Checks outputs and
    every gradient. A weight in `zero_grad` has a gradient that is exactly
    0 in exact arithmetic, so both packages return rounding noise: each is
    held below the tolerance times the op's largest weight gradient
    instead of against the other."""
    tdt, jdt, tol = DTYPES[dtype]

    def jconv(a):
        return jnp.asarray(a, jdt) if a.dtype.kind == "f" else jnp.asarray(a)

    def tconv(a):
        t = torch.tensor(a)
        return t.to(tdt) if a.dtype.kind == "f" else t

    names = sorted(weights)

    def jf(diff, ws):
        ins = [jconv(a) for a in inputs]
        for i, t in zip(diff_inputs, diff):
            ins[i] = t
        outs, _ = jdef(getattr(JOT, op)).forward(
            jparams, ins, dict(zip(names, ws)), None,
            JCtx(training=True, flash_packed=flash_packed))
        return outs[0]

    jdiff = [jconv(inputs[i]) for i in diff_inputs]
    jws = [jconv(weights[n]) for n in names]
    out_shape = jax.eval_shape(jf, jdiff, jws)
    cot = np.random.RandomState(seed).randn(*out_shape.shape).astype(
        np.float32)

    @jax.jit  # one compile of the interpret-mode kernels, not eager
    def jrun(diff, ws, ct):
        out, vjp = jax.vjp(jf, diff, ws)
        return out, vjp(ct)

    jout, (jgd, jgw) = jrun(jdiff, jws, jnp.asarray(cot, out_shape.dtype))

    tins = [tconv(a) for a in inputs]
    for i in diff_inputs:
        tins[i].requires_grad_(True)
    tws = {n: tconv(weights[n]).requires_grad_(True) for n in names}
    touts, _ = tdef(getattr(TOT, op)).forward(
        tparams, tins, tws, None,
        TCtx(training=True, flash_packed=flash_packed))
    touts[0].backward(torch.tensor(cot).to(touts[0].dtype))
    _close(touts[0], jout, tol, False, f"{op} output")
    for i, want in zip(diff_inputs, jgd):
        assert tins[i].grad.dtype == tins[i].dtype
        _close(tins[i].grad, want, tol, dtype == "bf16", f"{op} d_in{i}")
    scale = max(float(np.abs(_np(g)).max()) for g in jgw) if jgw else 1.0
    for n, want in zip(names, jgw):
        assert tws[n].grad.dtype == tws[n].dtype
        if n in zero_grad:
            for g in (tws[n].grad, want):
                assert float(np.abs(_np(g)).max()) <= tol["atol"] * scale, n
            continue
        _close(tws[n].grad, want, tol, dtype == "bf16", f"{op} d_{n}")


def _attn_weights(rs, d, e):
    w = {n: (rs.randn(d, e) / np.sqrt(d)).astype(np.float32)
         for n in ("wq", "wk", "wv")}
    w["wo"] = (rs.randn(e, e) / np.sqrt(e)).astype(np.float32)
    for n in ("bq", "bk", "bv", "bo"):
        w[n] = (rs.randn(e) * 0.1).astype(np.float32)
    return w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", ["flash", "xla", "flash_transposed"])
def test_mha_forward_and_gradients(impl, dtype):
    """Causal self-attention, (2, 128, 64) with 2 heads of 32: "flash" is
    the JAX grouped Pallas kernels against the port's flash Function,
    "xla" sdpa_xla against its twin, "flash_transposed" the op with
    `flash_packed=False` (the split heads through the per-head Pallas
    kernels, and through K5 and K8's plain versions). The key bias adds
    q.bk to a whole row of logits, which the softmax ignores: its
    gradient is 0."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 128, 64).astype(np.float32)
    w = _attn_weights(rs, 64, 64)
    kind = "flash" if impl == "flash_transposed" else impl
    _op_grads("OP_MULTIHEAD_ATTENTION",
              jops.MultiHeadAttentionParams(64, 2, causal=True, impl=kind),
              tops.MultiHeadAttentionParams(64, 2, causal=True, impl=kind),
              [x, x, x], w, dtype, diff_inputs=[0, 1, 2], zero_grad=("bk",),
              flash_packed=impl != "flash_transposed")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["layer_norm", "linear", "embedding", "gelu",
                                "add", "softmax"])
def test_op_forward_and_gradients(op, dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 8, 128) * 2 + 0.5).astype(np.float32)
    if op == "layer_norm":
        # (32 rows, 128): the JAX fused kernel's shape, the port's Function
        w = {"scale": rs.randn(128).astype(np.float32),
             "bias": rs.randn(128).astype(np.float32)}
        _op_grads("OP_LAYERNORM", jops.LayerNormParams((2,)),
                  tops.LayerNormParams((2,)), [x], w, dtype, [0])
    elif op == "linear":
        w = {"kernel": (rs.randn(128, 48) / 11).astype(np.float32),
             "bias": rs.randn(48).astype(np.float32)}
        _op_grads("OP_LINEAR",
                  jops.LinearParams(48, True, JActi.AC_MODE_GELU),
                  tops.LinearParams(48, True, TActi.AC_MODE_GELU),
                  [x], w, dtype, [0])
    elif op == "embedding":
        ids = rs.randint(0, 10, (4, 9)).astype(np.int32)
        ids[0, :3] = 3  # repeated ids: their gradients add up
        w = {"kernel": rs.randn(10, 16).astype(np.float32)}
        _op_grads("OP_EMBEDDING", jops.EmbeddingParams(10, 16),
                  tops.EmbeddingParams(10, 16), [ids], w, dtype, [])
    elif op == "gelu":
        _op_grads("OP_GELU", jops.ElementUnaryParams(JOT.OP_GELU),
                  tops.ElementUnaryParams(TOT.OP_GELU), [x], {}, dtype, [0])
    elif op == "add":
        y = rs.randn(4, 8, 128).astype(np.float32)
        _op_grads("OP_EW_ADD", jops.ElementBinaryParams(JOT.OP_EW_ADD),
                  tops.ElementBinaryParams(TOT.OP_EW_ADD), [x, y], {}, dtype,
                  [0, 1])
    else:
        _op_grads("OP_SOFTMAX", jops.SoftmaxParams(-1),
                  tops.SoftmaxParams(-1), [x], {}, dtype, [0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("softmax_last", [False, True])
def test_sparse_ce_loss_value_and_gradient(softmax_last, dtype):
    """`loss_terms` of both packages: (b, s, vocab) logits with (b, s, 1)
    labels; from logits through the fused CE Function, whose gradient
    comes back in the logits' dtype, or from probabilities."""
    tdt, jdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(2)
    logits = (rs.randn(3, 5, 40) * 3).astype(np.float32)
    if softmax_last:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rs.randint(0, 40, (3, 5, 1)).astype(np.int32)
    lt = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"

    def jf(lg):
        return jloss.loss_terms(getattr(JLoss, lt), lg, jnp.asarray(labels),
                                softmax_last)

    (jl, jce), vjp = jax.vjp(jf, jnp.asarray(logits, jdt))
    (jg,) = vjp((jnp.ones((), jl.dtype), jnp.zeros((), jce.dtype)))
    tl = torch.tensor(logits).to(tdt).requires_grad_(True)
    l, ce = tloss.loss_terms(getattr(TLoss, lt), tl, torch.tensor(labels),
                             softmax_last)
    l.backward()
    assert l.dtype == ce.dtype == torch.float32
    assert tl.grad.dtype == tdt
    np.testing.assert_allclose(_np(l), _np(jl), **tol)
    np.testing.assert_allclose(_np(ce), _np(jce), **tol)
    np.testing.assert_allclose(_np(tl.grad), _np(jg), **tol)


@pytest.mark.parametrize("loss", ["LOSS_CATEGORICAL_CROSSENTROPY",
                                  "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE",
                                  "LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE",
                                  "LOSS_IDENTITY"])
def test_other_losses_match(loss):
    rs = np.random.RandomState(3)
    logits = rs.randn(6, 7).astype(np.float32)
    labels = rs.rand(6, 7).astype(np.float32)
    want = jloss.loss_value(getattr(JLoss, loss), jnp.asarray(logits),
                            jnp.asarray(labels), False)
    got = tloss.loss_value(getattr(TLoss, loss), torch.tensor(logits),
                           torch.tensor(labels), False)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _opt_run(jo, to, steps=3):
    """`steps` updates of both optimizers on the same params and
    gradients; returns (JAX params, port params) after the last."""
    rs = np.random.RandomState(4)
    params = {"a": {"w": rs.randn(5, 3).astype(np.float32),
                    "b": rs.randn(3).astype(np.float32)},
              "c": {"w": rs.randn(7).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {n: {k: torch.tensor(v) for k, v in ws.items()}
          for n, ws in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = {n: {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in ws.items()} for n, ws in params.items()}
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), jp, js,
                           jnp.asarray(i, jnp.int32))
        tp, ts = to.update({n: {k: torch.tensor(v) for k, v in ws.items()}
                            for n, ws in g.items()}, tp, ts,
                           torch.tensor(i, dtype=torch.int32))
    return jp, tp


@pytest.mark.parametrize("kw", [dict(), dict(momentum=0.9),
                                dict(momentum=0.9, nesterov=True),
                                dict(momentum=0.5, weight_decay=0.01)])
def test_sgd_updates_match(kw):
    jp, tp = _opt_run(jopt.SGDOptimizer(lr=0.05, **kw),
                      topt.SGDOptimizer(lr=0.05, **kw))
    for n, ws in tp.items():
        for k, v in ws.items():
            np.testing.assert_allclose(_np(v), _np(jp[n][k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n}.{k}")


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.01)])
def test_adam_updates_match(kw):
    """Adam's bias-corrected step size is computed from the step in
    float32 tensors on both sides."""
    jp, tp = _opt_run(jopt.AdamOptimizer(alpha=0.01, **kw),
                      topt.AdamOptimizer(alpha=0.01, **kw))
    for n, ws in tp.items():
        for k, v in ws.items():
            np.testing.assert_allclose(_np(v), _np(jp[n][k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n}.{k}")


# ------------------------------------------------------------ tiny LM

TINY = dict(vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
            sequence_length=128, attention_impl="flash")
BATCH, STEPS = 2, 3


def _data():
    rs = np.random.RandomState(5)
    n = BATCH * STEPS
    toks = rs.randint(0, 64, (n, 128)).astype(np.int32)
    pos = np.tile(np.arange(128, dtype=np.int32), (n, 1))
    labels = rs.randint(0, 64, (n, 128, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def _jax_lm(opt, bf16=False, tiny=TINY, transposed=False):
    sys.argv = ["test"]
    from flexflow_tpu import FFConfig, FFModel, MetricsType
    from flexflow_tpu.fftype import DataType
    from flexflow_tpu.models import TransformerLMConfig, build_transformer_lm

    cfg = FFConfig()
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = BATCH
    if bf16:
        cfg.computation_dtype = DataType.DT_BFLOAT16
    cfg.flash_packed_layout = not transposed
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**tiny), batch_size=BATCH)
    ff.compile(optimizer=opt,
               loss_type=JLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY,
                        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def _torch_lm(jff, opt, bf16=False, tiny=TINY, transposed=False):
    sys.argv = ["test"]
    from flexflow_tpu_torch import FFConfig, FFModel, MetricsType, load_params
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    cfg = FFConfig(device="cpu")
    cfg.batch_size = BATCH
    if bf16:
        cfg.parse_args(["--dtype", "bf16"])
    if transposed:
        cfg.parse_args(["--flash-transposed"])
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**tiny), batch_size=BATCH)
    ff.compile(optimizer=opt,
               loss_type=TLoss.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY,
                        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    assert set(params) == set(ff._params)
    assert load_params(ff, params) == sum(len(w) for w in params.values())
    return ff


def _record_losses(ff):
    """Wrap the model's train step so each step's loss is kept; `fit`
    calls `executor._train_step` in both packages."""
    step = ff.executor.build_train_step()
    losses = []

    def wrapped(*args):
        out = step(*args)
        losses.append(float(np.asarray(_np(out[-1]))))
        return out

    ff.executor._train_step = wrapped
    return losses


def _fit_both(jopt_, topt_, bf16=False):
    x, y = _data()
    jff = _jax_lm(jopt_, bf16)
    tff = _torch_lm(jff, topt_, bf16)
    jl, tl = _record_losses(jff), _record_losses(tff)
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    tff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    assert len(jl) == len(tl) == STEPS
    return jff, tff, np.asarray(jl), np.asarray(tl)


def _param_diff(jff, tff):
    worst, name = 0.0, None
    for n, ws in jff._params.items():
        for w, v in ws.items():
            d = float(np.abs(np.asarray(v) - tff.get_weight(n, w)).max())
            if d > worst:
                worst, name = d, f"{n}.{w}"
    return worst, name


def _sgd_run(tiny=TINY, transposed=False):
    """The float32 SGD (momentum 0.9) run of both packages from the same
    weights, with one step's gradients at those weights taken first; the
    port's kernel counters are read over its `fit`."""
    x, y = _data()
    jff = _jax_lm(jopt.SGDOptimizer(lr=0.05, momentum=0.9), tiny=tiny,
                  transposed=transposed)
    tff = _torch_lm(jff, topt.SGDOptimizer(lr=0.05, momentum=0.9),
                    tiny=tiny, transposed=transposed)
    xb = {k: v[:BATCH] for k, v in x.items()}
    jxs, jy = jff._make_batch(xb, y[:BATCH])
    loss_fn = jff.executor.make_loss_fn(jff._state, jxs, jy, jff._rng)
    _, jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jff._params)
    txs, ty = tff._make_batch(xb, y[:BATCH])
    _, _, tgrads = tff.executor.value_and_grad(
        tff.executor.make_loss_fn(tff._state, txs, ty), tff._params)
    jl, tl = _record_losses(jff), _record_losses(tff)
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    reset_counters()
    tff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    plain = {n: c.plain_calls for n, c in counters().items()}
    return dict(jff=jff, tff=tff, jl=np.asarray(jl), tl=np.asarray(tl),
                jgrads=jgrads, tgrads=tgrads, plain=plain)


@pytest.fixture(scope="module")
def sgd_run():
    return _sgd_run()


def test_tiny_lm_sgd_training_matches_jax(sgd_run):
    """3 SGD (momentum 0.9) steps: per-step losses at rtol 1e-5, the final
    parameters at atol 1e-5; the metric counters agree too."""
    r = sgd_run
    assert len(r["jl"]) == len(r["tl"]) == STEPS
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    worst, name = _param_diff(r["jff"], r["tff"])
    assert worst < 1e-5, (worst, name)
    jm, tm = r["jff"].get_perf_metrics(), r["tff"].get_perf_metrics()
    assert tm.train_all == jm.train_all == BATCH * STEPS * 128
    assert tm.train_correct == jm.train_correct
    np.testing.assert_allclose(tm.get_mean_loss(), jm.get_mean_loss(),
                               rtol=1e-5)


def test_every_parameter_gets_the_jax_gradient(sgd_run):
    """One step's gradients, float32: every trainable parameter of the
    tiny LM gets a gradient equal to JAX's (rtol 1e-4, atol 1e-5), and
    every one is nonzero (the LayerNorm scales and biases, which take
    theirs from the fused LayerNorm Function's backward, included)."""
    jgrads, tgrads = sgd_run["jgrads"], sgd_run["tgrads"]
    assert set(tgrads) == set(jgrads)
    for n, ws in jgrads.items():
        assert set(tgrads[n]) == set(ws), n
        for w, want in ws.items():
            got = tgrads[n][w]
            assert float(got.abs().max()) > 0, f"{n}.{w} got no gradient"
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{n}.{w}")


# the tiny LM on the per-head paths: --flash-transposed, and head_dim 128
LAYOUT_RUNS = {"transposed": (TINY, True),
               "head_dim_128": (dict(TINY, hidden_size=256), False)}


@pytest.fixture(scope="module", params=sorted(LAYOUT_RUNS))
def layout_run(request):
    tiny, transposed = LAYOUT_RUNS[request.param]
    return _sgd_run(tiny, transposed)


def test_tiny_lm_per_head_paths_train_as_jax(layout_run):
    """3 SGD (momentum 0.9) steps on the per-head flash paths: per-step
    losses at rtol 1e-5 and the final parameters at atol 1e-5. Per step
    the port ran K5's and K8's plain versions once per layer (seq 128 is
    one JAX tile), and never K6's or K7's."""
    r = layout_run
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    worst, name = _param_diff(r["jff"], r["tff"])
    assert worst < 1e-5, (worst, name)
    layers = TINY["num_layers"]
    assert r["plain"]["flash_attention_fwd"] == STEPS * layers
    assert r["plain"]["flash_attention_bwd_fused"] == STEPS * layers
    assert r["plain"]["flash_attention_bwd_dq"] == 0
    assert r["plain"]["flash_attention_bwd_dkv"] == 0


def test_per_head_paths_give_every_parameter_the_jax_gradient(layout_run):
    """One step's float32 gradients on the per-head paths: every
    parameter's matches JAX's (rtol 1e-4, atol 1e-5) and is nonzero."""
    jgrads, tgrads = layout_run["jgrads"], layout_run["tgrads"]
    assert set(tgrads) == set(jgrads)
    for n, ws in jgrads.items():
        assert set(tgrads[n]) == set(ws), n
        for w, want in ws.items():
            got = tgrads[n][w]
            assert float(got.abs().max()) > 0, f"{n}.{w} got no gradient"
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{n}.{w}")


def test_zoo_and_its_arithmetic_are_the_jax_packages():
    """Every tier of the port's zoo has the JAX package's configuration of
    the same name, and the parameter count, FLOPs per token and training
    state bytes per chip (each update stage) agree."""
    from flexflow_tpu.models import transformer as jtr
    from flexflow_tpu_torch.models import transformer as ttr

    assert set(ttr.TRANSFORMER_LM_ZOO) == {
        "lm-smoke", "lm-smoke-draft", "lm-base", "lm-base-draft",
        "lm-xl-fsdp", "lm-xxl-fsdp"} == set(jtr.TRANSFORMER_LM_ZOO)
    fields = ("vocab_size", "hidden_size", "num_heads", "num_layers",
              "mlp_ratio", "sequence_length", "attention_impl")
    for name, tc in ttr.TRANSFORMER_LM_ZOO.items():
        jc = jtr.TRANSFORMER_LM_ZOO[name]
        assert ([getattr(tc, f) for f in fields]
                == [getattr(jc, f) for f in fields]), name
        assert (ttr.transformer_lm_param_count(tc)
                == jtr.transformer_lm_param_count(jc)), name
        assert (ttr.transformer_lm_flops_per_token(tc)
                == jtr.transformer_lm_flops_per_token(jc)), name
        for stage, shards in ((0, 1), (2, 4), (3, 4), (3, 1)):
            assert (ttr.transformer_lm_state_bytes_per_chip(
                tc, 2, stage, shards) == jtr.transformer_lm_state_bytes_per_chip(
                jc, 2, stage, shards)), (name, stage, shards)
    xxl = ttr.TRANSFORMER_LM_ZOO["lm-xxl-fsdp"]
    assert xxl.hidden_size // xxl.num_heads == 128


def test_tiny_lm_adam_training_matches_jax():
    """3 Adam steps: losses at rtol 1e-4. Parameters at atol 5e-4: Adam's
    first step moves each weight by alpha * g / (|g| + eps), about
    +-alpha (1e-3) for any gradient well above eps, so a weight whose
    gradient is tiny may land anywhere in [-alpha, alpha] from a rounding
    difference; the bound leaves room for that and is still well below
    the 3e-3 the three steps move a weight."""
    jff, tff, jl, tl = _fit_both(jopt.AdamOptimizer(alpha=1e-3),
                                 topt.AdamOptimizer(alpha=1e-3))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    worst, name = _param_diff(jff, tff)
    assert worst < 5e-4, (worst, name)


def test_tiny_lm_bf16_training_matches_jax():
    """bf16 activations over f32 masters (the main path's policy), 3 SGD
    steps: losses at rtol 2e-3 (the loss is an f32 mean over 256 tokens of
    bf16 logits rounded at other points) and parameters at atol 2e-3 (lr
    0.05 times bf16-rounded gradients)."""
    jff, tff, jl, tl = _fit_both(jopt.SGDOptimizer(lr=0.05),
                                 topt.SGDOptimizer(lr=0.05), bf16=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    worst, name = _param_diff(jff, tff)
    assert worst < 2e-3, (worst, name)


# ------------------------------------------------------------ API


def _mlp(epochs="2"):
    sys.argv = ["t", "-e", epochs, "-b", "64"]
    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )

    ff = FFModel(FFConfig(device="cpu"))
    x = ff.create_tensor((64, 32))
    # named layers: two models of this builder draw the same weights
    h = ff.dense(x, 64, ActiMode.AC_MODE_RELU, name="hidden")
    t = ff.softmax(ff.dense(h, 10, name="out"), name="probs")
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    rs = np.random.RandomState(0)
    c = rs.randn(10, 32) * 3
    y = rs.randint(0, 10, 2048)
    xs = (c[y] + rs.randn(2048, 32)).astype(np.float32)
    return ff, t, xs, y.reshape(-1, 1).astype(np.int32)


def test_verify_mlp_converges_under_the_port():
    """The verify flow's MLP (dense-relu-dense-softmax, SGD 0.1, sparse CE
    on probabilities, 2 epochs of 64): >= 90% training accuracy; eval on
    the same data agrees."""
    ff, _, xs, y = _mlp()
    assert ff.executor.last_op_is_softmax
    ff.fit(xs, y, verbose=False)
    acc = ff.get_perf_metrics().get_accuracy()
    assert acc >= 0.9, acc
    assert ff.eval(xs, y).get_accuracy() >= 0.9


def test_granular_loop_is_one_fit_step():
    """start_batch -> forward -> zero_gradients -> backward -> update makes
    the same parameters as a fit step over the same batch; the data loader
    hands out batches in order and wraps."""
    ff1, _, xs, y = _mlp("1")
    ff2, _, _, _ = _mlp("1")
    ff1.fit(xs[:64], y[:64], shuffle=False, verbose=False)
    loader = ff2.create_data_loader(ff2._input_tensors[0], xs[:128])
    assert loader.num_batches == 2
    xb = loader.next_batch()
    np.testing.assert_array_equal(xb, xs[:64])
    ff2.start_batch(xb, y[:64])
    logits = ff2.forward()
    assert tuple(logits.shape) == (64, 10)
    ff2.zero_gradients()
    lval = ff2.backward()
    ff2.update()
    assert torch.isfinite(lval)
    for n, ws in ff1._params.items():
        for w in ws:
            torch.testing.assert_close(ff2._params[n][w], ff1._params[n][w])
    assert int(ff2._step) == int(ff1._step) == 1
    np.testing.assert_array_equal(loader.next_batch(), xs[64:128])
    np.testing.assert_array_equal(loader.next_batch(), xs[:64])
    ff2.reset_metrics()
    assert ff2.get_perf_metrics().train_all == 0
    ff2.set_learning_rate(0.0)
    before = {n: {w: t.clone() for w, t in ws.items()}
              for n, ws in ff2._params.items()}
    ff2.fit(xs[:64], y[:64], verbose=False)
    for n, ws in before.items():
        for w, t in ws.items():
            torch.testing.assert_close(ff2._params[n][w], t)


def test_epoch_order_is_the_jax_packages():
    """Shuffles are keyed on (seed, absolute epoch) as in JAX, so both
    packages visit samples in the same order."""
    sys.argv = ["test"]
    from flexflow_tpu import FFConfig as JConfig, FFModel as JModel
    from flexflow_tpu_torch import FFConfig, FFModel

    jcfg = JConfig()
    jcfg.mesh_axis_sizes = (1, 1, 1, 1)
    jff = JModel(jcfg)
    tff = FFModel(FFConfig(device="cpu"))
    for epoch in range(3):
        np.testing.assert_array_equal(tff._epoch_order(50, epoch, True),
                                      jff._epoch_order(50, epoch, True))


def test_unported_paths_raise_naming_their_roadmap_item(monkeypatch,
                                                       tmp_path):
    from flexflow_tpu_torch import FFConfig

    monkeypatch.setattr(sys, "argv", ["test"])
    cfg = FFConfig(device="cpu")
    cfg.parse_args(["-e", "3", "--lr", "0.5", "--learning-rate", "0.25",
                    "--pipeline-steps", "1", "--profile-every", "0"])
    assert (cfg.epochs, cfg.learning_rate) == (3, 0.25)
    # the resilience, warm-start and engine flags run (A10's first half)
    cfg.parse_args(["--pipeline-steps", "4", "--checkpoint-dir", "c",
                    "--checkpoint-every", "2", "--checkpoint-every-seconds",
                    "30", "--checkpoint-keep", "2", "--auto-resume",
                    "--warmstart-dir", "ws"])
    assert (cfg.pipeline_steps, cfg.checkpoint_dir, cfg.checkpoint_every,
            cfg.checkpoint_every_seconds, cfg.checkpoint_keep,
            cfg.auto_resume, cfg.warmstart_dir) == (4, "c", 2, 30.0, 2,
                                                    True, "ws")
    # the observability flags run (A10b's observability half), with the
    # JAX package's values
    cfg.parse_args(["--profiling", "--xprof-dir", "t", "--diagnostics",
                    "--sanitize-numerics", "--health-abort-on",
                    "nan_loss,step_spike", "--health-sample-every", "4",
                    "--drift-threshold", "0.2", "--profile-every", "3",
                    "--watchdog-timeout", "2.5", "--watchdog-abort",
                    "--watchdog-multiplier", "5", "--flight-events", "64"])
    assert (cfg.profiling, cfg.xprof_dir, cfg.diagnostics,
            cfg.sanitize_numerics, cfg.health_abort_on,
            cfg.health_sample_every, cfg.drift_threshold,
            cfg.profile_every, cfg.watchdog_timeout, cfg.watchdog_abort,
            cfg.watchdog_multiplier, cfg.flight_events) == (
                True, "t", True, True, ("nan_loss", "step_spike"), 4, 0.2,
                3, 2.5, True, 5.0, 64)
    # the static-analysis flags run (A9), with the JAX package's fields
    assert (cfg.verify_plan, cfg.verify_rules, cfg.spmd_barrier) == (
        True, True, False)
    cfg.parse_args(["--no-verify-plan", "--no-verify-rules",
                    "--spmd-barrier"])
    assert (cfg.verify_plan, cfg.verify_rules, cfg.spmd_barrier) == (
        False, False, True)
    # the elastic flags run (A10b's migration and elastic half), with
    # the JAX package's defaults and values
    from flexflow_tpu import FFConfig as JConfig

    jcfg = JConfig()
    assert (cfg.elastic, cfg.replan_cooldown_steps, cfg.replan_horizon_steps,
            cfg.elastic_dry_run) == (
                jcfg.elastic, jcfg.replan_cooldown_steps,
                jcfg.replan_horizon_steps, jcfg.elastic_dry_run) == (
                    False, 50, 1000, False)
    elastic = ["--elastic", "--replan-cooldown-steps", "3",
               "--replan-horizon-steps", "7", "--elastic-dry-run"]
    cfg.parse_args(elastic)
    jcfg.parse_args(elastic)
    assert (cfg.elastic, cfg.replan_cooldown_steps, cfg.replan_horizon_steps,
            cfg.elastic_dry_run) == (
                jcfg.elastic, jcfg.replan_cooldown_steps,
                jcfg.replan_horizon_steps, jcfg.elastic_dry_run) == (
                    True, 3, 7, True)
    cfg.elastic = cfg.elastic_dry_run = False
    # the serving extras' flags (A11) parse to the JAX package's values
    serving = ["--serve-disaggregate", "--serve-prefill-chips", "2",
               "--serve-draft-chips", "1", "--serve-spec-k", "3"]
    fields = ("serve_disaggregate", "serve_prefill_chips",
              "serve_draft_chips", "serve_spec_k", "serve_role",
              "mesh_device_offset")
    assert tuple(getattr(cfg, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields) == (False, 0, 0, 4, "", 0)
    cfg.parse_args(serving)
    jcfg.parse_args(serving)
    assert tuple(getattr(cfg, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields) == (True, 2, 1, 3, "", 0)
    # the JAX package's inert flags are accepted, values consumed, and
    # --no-overlap-collectives stays ignored
    cfg.parse_args(["--wd", "0.1", "--dataset", "d", "--synthetic-input",
                    "--fusion", "--taskgraph", "t.dot", "--enable-propagation",
                    "--segment-size", "4", "--max-num-segments", "2",
                    "--machine-model-version", "1",
                    "--enable-inplace-optimizations", "--printFreq", "5",
                    "-ll:cpu", "2", "--simulator-workspace-size", "9",
                    "--no-overlap-collectives", "-e", "7"])
    assert cfg.epochs == 7
    # a substitution rule file given a config is verified at load: the
    # ffrules gate (A9) records its verdict for the compile report
    from flexflow_tpu_torch.analysis import rules as ffrules
    from flexflow_tpu_torch.machine import MeshShape, build_mesh
    from flexflow_tpu_torch.search.substitution import load_rule_collection

    rules = tmp_path / "rules.json"
    rules.write_text('{"rules": [{"generator": "linear_relu_merge"}]}')
    mesh = build_mesh(MeshShape((1, 1, 1, 1)))
    assert len(load_rule_collection(str(rules), mesh)) == 1
    assert str(rules) not in ffrules._LOAD_RESULTS
    assert len(load_rule_collection(str(rules), mesh, config=cfg)) == 1
    verdict = ffrules._LOAD_RESULTS[str(rules)]
    assert verdict.ok and verdict.rules_count == 1
    ff, _, xs, y = _mlp("1")
    diag = ff.enable_diagnostics(str(tmp_path))
    assert ff.get_diagnostics() is diag and diag.directory == str(tmp_path)
    from flexflow_tpu_torch.elastic import ElasticController

    ctrl = ff.enable_elastic(cooldown_steps=2)
    assert isinstance(ctrl, ElasticController) and ff._elastic is ctrl
    assert diag.elastic is ctrl and ctrl.cooldown_steps == 2


SEARCH_FLAGS = {
    "alpha": (["--alpha", "1.5"], "search_alpha", 1.5),
    "search_alpha": (["--search-alpha", "1.05"], "search_alpha", 1.05),
    "memory_search": (["--memory-search"], "perform_memory_search", True),
    "fsize": (["-ll:fsize", "12.5"], "device_mem", 12.5 * 2**20),
    "num_nodes": (["--search-num-nodes", "2"], "search_num_nodes", 2),
    "num_workers": (["--search-num-workers", "8"], "search_num_workers", 8),
    "threshold": (["--base-optimize-threshold", "3"],
                  "base_optimize_threshold", 3),
    "overlap_update": (["--search-overlap-backward-update"],
                       "search_overlap_backward_update", True),
    "sample_parallel": (["--enable-sample-parallel"],
                        "enable_sample_parallel", True),
    "compgraph": (["--compgraph", "g.dot"],
                  "export_strategy_computation_graph_file", "g.dot"),
}


@pytest.mark.parametrize("case", sorted(SEARCH_FLAGS))
def test_search_flag_parses_as_jax(case, monkeypatch):
    """Each of the search's flags (the paths C1 asked for) lands in the
    JAX package's field with the JAX package's value; the search reads
    them (tests/test_torch_search.py)."""
    from flexflow_tpu import FFConfig as JConfig
    from flexflow_tpu_torch import FFConfig

    argv, field, want = SEARCH_FLAGS[case]
    monkeypatch.setattr(sys, "argv", ["test", *argv])
    got, ref = FFConfig(device="cpu"), JConfig()
    assert getattr(got, field) == getattr(ref, field) == want
    monkeypatch.setattr(sys, "argv", ["test"])
    assert getattr(FFConfig(device="cpu"), field) == getattr(JConfig(), field)


def test_compgraph_writes_the_dot_at_compile(monkeypatch, tmp_path):
    path = tmp_path / "pcg.dot"
    ff, _, _, _ = _mlp("1")
    assert not path.exists()
    ff.config.parse_args(["--compgraph", str(path)])
    ff.compile(optimizer=ff.optimizer, loss_type=ff.loss_type)
    dot = path.read_text()
    assert dot.startswith("digraph PCG {") and dot == ff.export_dot()


# the JAX package's public names the port does not have yet, each with
# its ROADMAP item; a later slice that ports one drops it here
SURFACE_GAPS = {
    "": {},
    "ServingEngine": {},
}


def test_import_surface_matches_jax_but_for_listed_gaps():
    """The two packages' top-level names, and the public methods of
    FFModel, Optimizer (and SGD, Adam), FFConfig and ServingEngine: every
    JAX name the port lacks is listed with its ROADMAP item (FFModel's in
    `model._NOT_PORTED_METHODS`, which raise naming it)."""
    import inspect

    import flexflow_tpu as J
    import flexflow_tpu_torch as T
    from flexflow_tpu.serving import ServingEngine as JServe
    from flexflow_tpu_torch.model import _NOT_PORTED_METHODS
    from flexflow_tpu_torch.serving import ServingEngine as TServe

    def public(obj, methods=False):
        return {n for n in dir(obj) if not n.startswith("_") and (
            not methods or callable(getattr(obj, n))
            or isinstance(inspect.getattr_static(obj, n), property))}

    # subpackages count where the JAX package's __init__ imports them
    # (others appear as attributes once any test imports them)
    init = inspect.getsource(J)
    top = {n for n in public(J) if not inspect.ismodule(getattr(J, n))
           or f"from . import {n}" in init}
    missing = top - public(T)
    assert missing == set(SURFACE_GAPS[""]), missing
    for name in ("ZeroInitializer", "FFIterationConfig", "Metrics",
                 "ParameterSyncType", "build_mesh", "Strategy",
                 "ParallelDim", "ParallelTensor", "ParallelTensorShape"):
        assert hasattr(T, name), name
    pairs = {"FFModel": (J.FFModel, T.FFModel),
             "Optimizer": (J.Optimizer, T.Optimizer),
             "SGDOptimizer": (J.SGDOptimizer, T.SGDOptimizer),
             "AdamOptimizer": (J.AdamOptimizer, T.AdamOptimizer),
             "FFConfig": (J.FFConfig, T.FFConfig),
             "ServingEngine": (JServe, TServe)}
    for cls, (j, t) in pairs.items():
        gaps = public(j, methods=True) - public(t, methods=True)
        listed = (_NOT_PORTED_METHODS if cls == "FFModel"
                  else SURFACE_GAPS.get(cls, {}))
        assert gaps == set(listed), (cls, gaps ^ set(listed))
    assert (T.SGDOptimizer(momentum=0.9).num_slots,
            T.SGDOptimizer().num_slots, T.AdamOptimizer().num_slots) == (
                1, 0, 2)
    T.AdamOptimizer().next()
    it = T.FFIterationConfig()
    it.seq_length = 5
    it.reset()
    assert it.seq_length == -1
    sys.argv = ["test"]
    assert T.FFModel(T.FFConfig(device="cpu")).iter_config.seq_length == -1
    zeros = T.ZeroInitializer()(None, (2, 3), torch.float32, "cpu")
    assert zeros.shape == (2, 3) and not zeros.any()


def test_flash_transposed_flag_reaches_the_attention_op(monkeypatch):
    """--flash-transposed parses to flash_packed_layout = False, and the
    executor hands it to the MHA op in its OpContext (True without the
    flag)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    mha = tdef(TOT.OP_MULTIHEAD_ATTENTION)
    real, seen = mha.forward, []

    def spy(p, ins, w, state, ctx):
        seen.append(ctx.flash_packed)
        return real(p, ins, w, state, ctx)

    monkeypatch.setattr(mha, "forward", spy)
    rs = np.random.RandomState(0)
    x = {"tokens": rs.randint(0, 64, (1, 128)).astype(np.int32),
         "positions": np.arange(128, dtype=np.int32)[None]}
    for argv, want in (([], True), (["--flash-transposed"], False)):
        monkeypatch.setattr(sys, "argv", ["test"] + argv)
        cfg = FFConfig(device="cpu")
        assert cfg.flash_packed_layout is want
        ff = FFModel(cfg)
        build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=1)
        ff.compile()
        seen.clear()
        ff.executor.build_forward()(ff._params, ff._state,
                                    ff.executor.stage_inputs(x), False)
        assert seen == [want] * TINY["num_layers"]


def test_profile_operators_json(tmp_path, capsys, monkeypatch):
    """--profiling's per-op table (profiling.py), timed on the model's
    device through the cost model's harness: JSON rows hot ops first,
    the printed table headed by the device, the per-op counters in the
    trace, and the rows as the report's `standalone` profile section; a
    --profiling fit prints the table once per compile (JAX
    tests/test_telemetry.py:291). The harness's repetitions are cut to
    (1, 2): the table's layout is under test, not the CPU's times."""
    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.search.cost_model import CostModel

    monkeypatch.setattr(CostModel, "_REPS", (1, 2))
    from flexflow_tpu_torch.profiling import (
        print_operator_profile, profile_operators, profile_operators_json,
        profile_section_from_rows)
    from flexflow_tpu_torch.scope.attribution import verify_profile_section
    from flexflow_tpu_torch.search.cost_model import OpHarness

    ff, _, xs, y = _mlp("1")
    harness = OpHarness.of(ff.config, ff.device)
    rows = profile_operators(ff.graph, harness)
    assert [r[0] for r in rows] == ["hidden", "out", "probs"]
    recs = profile_operators_json(ff.graph, rows=rows)
    assert recs and set(recs[0]) == {
        "name", "op_type", "forward_s", "backward_s", "total_s"}
    totals = [r["total_s"] for r in recs]
    assert totals == sorted(totals, reverse=True)
    for r in recs:
        assert abs(r["total_s"] - (r["forward_s"] + r["backward_s"])) < 1e-12
    sess = telemetry.activate(
        telemetry.TelemetrySession(str(tmp_path / "prof")))
    import io

    buf = io.StringIO()
    print_operator_profile(ff.graph, file=buf, sort_by_total=True,
                           harness=harness)
    telemetry.deactivate(sess)
    assert buf.getvalue().startswith("per-operator profile on cpu")
    assert "TOTAL" in buf.getvalue()
    counters = [e for e in sess.tracer.to_dict()["traceEvents"]
                if e["ph"] == "C" and e["name"].startswith("op_profile.")]
    assert len(counters) == len(rows)
    section = profile_section_from_rows(rows)
    assert section["source"] == "standalone"
    assert verify_profile_section(section) == []
    # --profiling on a fit: the table once, into the report too
    tdir = tmp_path / "tel"
    ff.config.parse_args(["--profiling", "--telemetry-dir", str(tdir),
                          "--diagnostics"])
    capsys.readouterr()
    for _ in range(2):
        ff.fit(xs[:128], y[:128], epochs=1, verbose=False)
    out = capsys.readouterr().out
    assert out.count("per-operator profile on cpu") == 1
    telemetry.deactivate()
    import json

    rep = json.load(open(tdir / "strategy_report.json"))
    assert rep["profile"]["source"] == "standalone"
    assert {r["name"] for r in rep["profile"]["ops"]} == {
        "hidden", "out", "probs"}


def test_sgd_momentum_zero_keeps_a_scalar_slot_per_weight():
    """C3: SGD at momentum 0 keeps the JAX package's scalar zero per
    weight (its checkpoints carry them), which the update reads none of;
    num_slots stays 0."""
    from flexflow_tpu import SGDOptimizer as JSGD
    from flexflow_tpu_torch import SGDOptimizer

    params = {"fc": {"kernel": torch.ones(3, 2), "bias": torch.ones(2)}}
    slots = SGDOptimizer().init(params)
    want = JSGD().init({"fc": {"kernel": jnp.ones((3, 2)),
                               "bias": jnp.ones(2)}})
    assert set(slots) == set(want) == {"v"}
    for k in ("kernel", "bias"):
        assert slots["v"]["fc"][k].shape == () and not slots["v"]["fc"][k]
        assert np.asarray(want["v"]["fc"][k]).shape == ()
    assert SGDOptimizer().num_slots == 0
    grads = {"fc": {"kernel": torch.full((3, 2), 2.0),
                    "bias": torch.full((2,), 2.0)}}
    new, out = SGDOptimizer(lr=0.5).update(
        grads, params, slots, torch.zeros((), dtype=torch.int32))
    assert torch.equal(new["fc"]["kernel"], torch.zeros(3, 2))
    assert out is slots and not slots["v"]["fc"]["kernel"]
