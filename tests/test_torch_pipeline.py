"""The port's pipeline over the `pipe` mesh axis on gloo ranks on the CPU,
against its own sequential stack and the JAX package.

- `parallel.pipeline.pipeline_apply` against `_sequential` (the blocks
  of `tests/test_pipeline.py:24`: L 4, b 8, d 16, a tanh layer) on
  (data, model, pipe, seq) = (2, 1, 4, 1) (8 ranks, 4 microbatches) and
  (1, 1, 2, 1) (2 ranks, the default 2 P): the output, the input's
  gradient and every stacked weight's gradient within 1e-5 (float32),
  each stage given its own blocks (the executor's layout); `_sequential`
  against JAX's;
- the refusals, with JAX's messages: 3 blocks over 4 stages, a local
  batch of 4 in 3 microbatches;
- the pipelined block (`ops/pipeline_blocks.py`) against JAX's on the
  same weights, "xla" and "flash": its weights' names, shapes and
  initialisers, its FLOPs, its output; its GELU the tanh approximation,
  as `jax.nn.gelu`'s default (not the trunk's exact GELU);
- the tiny pipelined LM of `tests/test_pipeline.py:82` (vocab 64, hidden
  32, 2 heads, 4 layers, seq 16, "xla", batch 4, 2 microbatches) from
  the JAX model's weights (`load_params`) at (1, 1, 1, 1), (1, 1, 2, 1)
  and (2, 1, 2, 1): its logits at `F32_TOL` and one step's gradient of
  every parameter (rtol 1e-4, atol 1e-5) against the JAX model's; each
  stage holding only its 2 of the 4 blocks; and it trains on (2, 1, 2,
  1): 8 SGD steps, the loss falls.
"""

import sys

import numpy as np
import pytest

from test_torch_distributed import F32_TOL
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _spawn(fn, n, *args):
    from flexflow_tpu_torch.distributed import spawn

    return spawn(fn, n, *args, timeout=300)


# ------------------------------------------------------------ the schedule

L, B, D = 4, 8, 16


def stack_inputs():
    rs = np.random.RandomState(0)
    stacked = {"w": (rs.randn(L, D, D) * 0.1).astype(np.float32),
               "b": (rs.randn(L, D) * 0.1).astype(np.float32)}
    return stacked, rs.randn(B, D).astype(np.float32)


def tanh_block(w, a):
    import torch

    return torch.tanh(a @ w["w"] + w["b"])


def pipe_job(rank, mesh_axes, num_micro):
    """This rank's output rows, its input rows' gradient and its weights'
    gradients, pipelined and through the sequential stack; then (with a
    pipe axis of 4) the refusals."""
    import torch

    from flexflow_tpu_torch.machine import MeshShape, build_mesh
    from flexflow_tpu_torch.parallel.pipeline import (
        _sequential,
        pipeline_apply,
    )

    mesh = build_mesh(MeshShape(mesh_axes))
    stacked, x = stack_inputs()
    dp, di = mesh.shape["data"], mesh.coords["data"]
    P, pi = mesh.shape["pipe"], mesh.coords["pipe"]
    rows = slice(di * B // dp, (di + 1) * B // dp)
    per = slice(pi * L // P, (pi + 1) * L // P)

    def run(fn):
        xs = torch.tensor(x[rows], requires_grad=True)
        ws = {k: torch.tensor(v, requires_grad=True)
              for k, v in stacked.items()}
        y = fn(ws, xs)
        (y ** 2).sum().backward()
        return (y.detach().numpy().copy(), xs.grad.numpy().copy(),
                {k: w.grad.numpy().copy() for k, w in ws.items()})

    def local(ws, xs):
        return pipeline_apply({k: w[per] for k, w in ws.items()}, xs,
                              tanh_block, mesh=mesh,
                              num_microbatches=num_micro, num_layers=L)

    out = {"seq": run(lambda ws, xs: _sequential(ws, xs, tanh_block)),
           "local": run(local), "per": (per.start, per.stop)}
    if P == 4:
        refusals = {}
        for name, layers, m in (("layers", 3, 0), ("micro", L, 3)):
            try:
                pipeline_apply({"w": torch.tensor(stacked["w"][per])},
                               torch.zeros(B // dp, D),
                               lambda w, a: a, mesh=mesh,
                               num_microbatches=m, num_layers=layers)
                refusals[name] = None
            except ValueError as e:
                refusals[name] = str(e)
        out["refusals"] = refusals
    return out


@pytest.fixture(scope="module")
def pipe_runs():
    return {axes: _spawn(pipe_job, int(np.prod(axes)), axes, m)
            for axes, m in (((2, 1, 4, 1), 4), ((1, 1, 2, 1), 0))}


@pytest.mark.parametrize("axes", [(2, 1, 4, 1), (1, 1, 2, 1)],
                         ids=["dp2_pp4", "pp2"])
def test_pipeline_apply_matches_sequential(pipe_runs, axes):
    ranks = pipe_runs[axes]
    for r, o in enumerate(ranks):
        y, dx, dw = o["seq"]
        gy, gdx, gdw = o["local"]
        np.testing.assert_allclose(gy, y, **PIPE_TOL)
        np.testing.assert_allclose(gdx, dx, **PIPE_TOL)
        lo, hi = o["per"]
        for k in dw:
            # the stage's blocks get their gradient, the others none
            np.testing.assert_array_equal(gdw[k][:lo], 0)
            np.testing.assert_array_equal(gdw[k][hi:], 0)
            np.testing.assert_allclose(gdw[k][lo:hi], dw[k][lo:hi],
                                       **PIPE_TOL, err_msg=k)
    # every data rank's rows together are the whole batch's
    assert sum(o["seq"][0].shape[0] for o in ranks) == B * axes[2]


def test_sequential_matches_jax():
    import jax
    import jax.numpy as jnp
    import torch

    from flexflow_tpu.parallel.pipeline import _sequential as jseq
    from flexflow_tpu_torch.parallel.pipeline import _sequential as tseq

    stacked, x = stack_inputs()

    def jblock(w, a):
        return jnp.tanh(a @ w["w"] + w["b"])

    jl = jax.value_and_grad(lambda s, x: jnp.sum(jseq(s, x, jblock) ** 2),
                            argnums=(0, 1))
    jv, (jgs, jgx) = jl({k: jnp.asarray(v) for k, v in stacked.items()},
                        jnp.asarray(x))
    ws = {k: torch.tensor(v, requires_grad=True) for k, v in stacked.items()}
    xs = torch.tensor(x, requires_grad=True)
    tv = (tseq(ws, xs, tanh_block) ** 2).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(jgx), **PIPE_TOL)
    for k in ws:
        np.testing.assert_allclose(ws[k].grad.numpy(), np.asarray(jgs[k]),
                                   **PIPE_TOL)


def test_pipeline_refuses_indivisible_layers_and_microbatches(pipe_runs):
    for o in pipe_runs[(2, 1, 4, 1)]:
        ref = o["refusals"]
        assert ref["layers"] == ("pipeline: 3 blocks do not divide over 4 "
                                 "pipeline stages"), ref
        assert ref["micro"].startswith(
            "pipeline: local batch 4 does not divide into 3 microbatches"
        ), ref
    import jax.numpy as jnp

    from flexflow_tpu.machine import MeshShape, build_mesh
    from flexflow_tpu.parallel.pipeline import pipeline_apply

    mesh = build_mesh(MeshShape((1, 1, 4, 1)))
    with pytest.raises(ValueError, match=ref["layers"]):
        pipeline_apply({"w": jnp.zeros((3, 4, 4))}, jnp.zeros((4, 4)),
                       lambda w, a: a, mesh=mesh)


# ------------------------------------------------------------ the block

MB, S, E, H, LAYERS = 2, 16, 32, 2, 2


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_pipelined_block_matches_jax_and_its_gelu_is_tanh(impl):
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from flexflow_tpu import ops as jops
    from flexflow_tpu.fftype import OperatorType as JOT
    from flexflow_tpu.ops.base import OpContext as JCtx, get_op_def as jdef
    from flexflow_tpu_torch import ops as tops
    from flexflow_tpu_torch.fftype import OperatorType as TOT
    from flexflow_tpu_torch.ops.base import OpContext as TCtx
    from flexflow_tpu_torch.ops.base import get_op_def as tdef

    jp = jops.PipelineBlocksParams(LAYERS, H, attention_impl=impl)
    tp = tops.PipelineBlocksParams(LAYERS, H, attention_impl=impl)
    shape = (MB, S, E)
    jspecs = jdef(JOT.OP_PIPE_BLOCKS).weights(jp, [shape])
    tspecs = tdef(TOT.OP_PIPE_BLOCKS).weights(tp, [shape])
    assert [(w.name, tuple(w.shape), w.initializer) for w in tspecs] == [
        (w.name, tuple(w.shape), w.initializer) for w in jspecs]
    assert tdef(TOT.OP_PIPE_BLOCKS).flops(tp, [shape], [shape]) == jdef(
        JOT.OP_PIPE_BLOCKS).flops(jp, [shape], [shape])
    rs = np.random.RandomState(1)
    weights = {w.name: (rs.randn(*w.shape) * 0.2).astype(np.float32)
               for w in tspecs}
    x = rs.randn(*shape).astype(np.float32)
    (jo,), _ = jdef(JOT.OP_PIPE_BLOCKS).forward(
        jp, [jnp.asarray(x)], {k: jnp.asarray(v) for k, v in weights.items()},
        None, JCtx(training=False))
    (to,), _ = tdef(TOT.OP_PIPE_BLOCKS).forward(
        tp, [torch.tensor(x)], {k: torch.tensor(v)
                                for k, v in weights.items()},
        None, TCtx(training=False))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    # the block's GELU is the tanh approximation, as JAX's default; the
    # exact one differs by more than the tolerance on the same inputs
    z = np.linspace(-4, 4, 801).astype(np.float32)
    tanh = F.gelu(torch.tensor(z), approximate="tanh").numpy()
    np.testing.assert_allclose(tanh, np.asarray(jax.nn.gelu(z)), atol=1e-6)
    assert np.abs(F.gelu(torch.tensor(z)).numpy() - tanh).max() > 1e-4


# ------------------------------------------------------------ the LM

LM = dict(vocab_size=64, hidden_size=32, num_heads=2, num_layers=4,
          sequence_length=16, attention_impl="xla")
LM_BATCH = 4


def build_pp_lm(pkg, mesh, batch=LM_BATCH, lr=0.01):
    sys.argv = ["test", "--weight-update-sharding=off"]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    cfg.allow_tensor_op_math_conversion = False
    ff = mod.FFModel(cfg)
    models.build_transformer_lm_pipelined(
        ff, models.TransformerLMConfig(**LM), batch_size=batch,
        num_microbatches=2)
    ff.compile(optimizer=mod.SGDOptimizer(lr=lr),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def lm_batch(batch=LM_BATCH, seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, 64, (batch, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (batch, 1))
    labels = rs.randint(0, 64, (batch, 16, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def port_logits_and_grads(mesh, init):
    from flexflow_tpu_torch import load_params

    ff = build_pp_lm("flexflow_tpu_torch", mesh)
    load_params(ff, init)
    ex = ff.executor
    x, y = lm_batch()
    xs, ys = ff._make_batch(x, y)
    logits = ex.full_logits(ex.build_forward()(ff._params, ff._state, xs,
                                               False)[0])
    _, _, grads = ex.value_and_grad(ex.make_loss_fn(ff._state, xs, ys),
                                    ff._params)
    grads = ex.sync_grads(grads)
    full = {f"{n}.{k}": ex.full_weight(n, k, g).numpy().copy()
            for n, ws in grads.items() for k, g in ws.items()}
    local = {k: tuple(t.shape) for k, t in ff._params["blocks"].items()}
    return {"logits": logits.detach().numpy().copy(), "grads": full,
            "blocks": local}


def pp_lm_job(rank, mesh, init):
    out = port_logits_and_grads(mesh, init)
    if mesh == (2, 1, 2, 1):
        ff = build_pp_lm("flexflow_tpu_torch", mesh, batch=8, lr=0.1)
        x, y = lm_batch(batch=8)
        xs, ys = ff._make_batch(x, y)
        step = ff.executor.build_train_step()
        losses = []
        for _ in range(8):
            losses.append(float(step(ff._params, ff._state, ff._opt_slots,
                                     ff._step, ff._counters, (xs, ys),
                                     ff._rng)[-1]))
        out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def jax_pp_lm():
    import jax

    jff = build_pp_lm("flexflow_tpu", (1, 1, 1, 1))
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in jff._params.items()}
    x, y = lm_batch()
    xs, ys = jff._make_batch(x, y)
    logits, _ = jff.executor.build_forward()(jff._params, jff._state, xs,
                                             False)
    loss_fn = jff.executor.make_loss_fn(jff._state, xs, ys, jff._rng)
    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jff._params)
    grads = {f"{n}.{k}": np.asarray(v) for n, ws in grads.items()
             for k, v in ws.items()}
    return init, np.asarray(logits), grads


@pytest.mark.parametrize("mesh", [(1, 1, 1, 1), (1, 1, 2, 1), (2, 1, 2, 1)],
                         ids=["one", "pp2", "dp2_pp2"])
def test_pipelined_lm_logits_and_gradients_match_jax(jax_pp_lm, mesh):
    init, jlogits, jgrads = jax_pp_lm
    n = int(np.prod(mesh))
    outs = ([port_logits_and_grads(mesh, init)] if n == 1
            else _spawn(pp_lm_job, n, mesh, init))
    for o in outs:
        np.testing.assert_allclose(o["logits"], jlogits, **F32_TOL)
        assert set(o["grads"]) == set(jgrads)
        for k, want in jgrads.items():
            np.testing.assert_allclose(o["grads"][k], want, **GRAD_TOL,
                                       err_msg=k)
        # each stage stores only its layers
        assert o["blocks"]["wqkv"] == (4 // mesh[2], 32, 96)
    if mesh == (2, 1, 2, 1):
        for o in outs:
            assert o["losses"][-1] < o["losses"][0], o["losses"]
            assert o["losses"] == outs[0]["losses"]
