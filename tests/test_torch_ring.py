"""Ring attention and the sequence-parallel LM of the port on gloo ranks on
the CPU, against the JAX package on its virtual 8-device mesh.

- `parallel.ring_attention.ring_attention` on 2 and 4 ranks of a `seq`
  axis, causal and not, on the shapes of `tests/test_longcontext.py:61`
  (b 2, h 2, d 8, s 24 n: each rank a block of 24 rows): the output and
  the q, k and v gradients of sum(out^2) against JAX's `ring_attention`
  over the same axis, float32 at `F32_TOL` (rtol = atol = 2e-5). The
  port's blocks run the flash wrappers' plain versions (CPU tensors),
  JAX's its einsum fallback at these block shapes;
- `_merge_block` against JAX's, values and gradients, the first merge
  from lse = -inf included;
- the tiny LM (vocab 64, hidden 128, 2 heads of 64, 2 layers, seq 128)
  with `attention_impl="ring"` under `sequence_parallel_attention` at sp
  2 (2 ranks) and dp 2 x sp 2 (4 ranks): from the JAX model's initial
  weights (`load_params`), 2 SGD steps of a global batch of 4 end at
  JAX's weights at `F32_TOL`, each step's loss at rtol 2e-5; every
  token-wise op runs on this rank's rows of the sequence ("rows"), the
  attention as the ring, the loss over the sequence's rows (its metric
  counters the whole batch's tokens);
- `entry.dryrun_multichip(4, legs=("lm", "sp"))`: dp 1 x tp 2 x sp 2, the
  JAX dry run's factors, ring attention under Megatron, then the same
  under `sequence_parallel_attention`: one loss on every rank, the two
  legs alike;
- an MSE loss over rows split over the batch and the sequence (dp 2 x
  sp 2) is the batch mean, as on one rank.
"""

import sys

import numpy as np
import pytest

from test_torch_distributed import F32_TOL, port_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _spawn(fn, n, *args):
    from flexflow_tpu_torch.distributed import spawn

    return spawn(fn, n, *args, timeout=300)


# ------------------------------------------------------------ the ring

RING_CASES = [(n, causal) for n in (2, 4) for causal in (False, True)]


def ring_inputs(n):
    rs = np.random.RandomState(n)
    b, h, d = 2, 2, 8
    s = 24 * n
    return [rs.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def ring_job(rank, n):
    """Every case of this world size on this rank: its block of the
    output and of the q, k, v gradients."""
    import torch

    from flexflow_tpu_torch.machine import MeshShape, build_mesh
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh(MeshShape((1, 1, 1, n)))
    idx = mesh.coords["seq"]
    out = {}
    for causal in (False, True):
        full = ring_inputs(n)
        rows = full[0].shape[2] // n
        q, k, v = (torch.tensor(t[:, :, idx * rows:(idx + 1) * rows],
                                requires_grad=True) for t in full)
        o = ring_attention(q, k, v, causal=causal,
                           scale=1.0 / np.sqrt(full[0].shape[-1]), mesh=mesh)
        (o ** 2).sum().backward()
        out[causal] = [t.detach().numpy().copy()
                       for t in (o, q.grad, k.grad, v.grad)]
    return out


@pytest.fixture(scope="module")
def ring_runs():
    return {n: _spawn(ring_job, n, n) for n in (2, 4)}


def jax_ring(n, causal):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.machine import MeshShape, build_mesh
    from flexflow_tpu.parallel.ring_attention import ring_attention

    mesh = build_mesh(MeshShape((1, 1, n, 1),
                                ("data", "model", "seq", "pipe")))
    q, k, v = (jnp.asarray(t) for t in ring_inputs(n))
    scale = 1.0 / np.sqrt(q.shape[-1])

    def ring(q, k, v):
        return ring_attention(q, k, v, causal=causal, scale=scale,
                              mesh=mesh)

    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


@pytest.mark.parametrize("n,causal", RING_CASES)
def test_ring_attention_and_its_gradients_match_jax(ring_runs, n, causal):
    want = jax_ring(n, causal)
    ranks = ring_runs[n]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[causal][i] for r in ranks], axis=2)
        np.testing.assert_allclose(got, want[i], **F32_TOL,
                                   err_msg=f"{name}, n {n}, causal {causal}")


def test_merge_block_matches_jax():
    import jax
    import jax.numpy as jnp
    import torch

    from flexflow_tpu.parallel.ring_attention import _merge_block as jmerge
    from flexflow_tpu_torch.parallel.ring_attention import (
        _merge_block as tmerge,
    )

    rs = np.random.RandomState(5)
    o, ob = (rs.randn(2, 3, 8, 4).astype(np.float32) for _ in range(2))
    lse, lseb = (rs.randn(2, 3, 8).astype(np.float32) for _ in range(2))
    first = np.full_like(lse, -np.inf)
    for lse0 in (lse, first):
        args = [o, lse0, ob, lseb]

        def jloss(*a):
            on, ln = jmerge(*a)
            return jnp.sum(on ** 2) + jnp.sum(jnp.sin(ln))

        jv = jmerge(*(jnp.asarray(a) for a in args))
        jg = jax.grad(jloss, argnums=(0, 2, 3))(
            *(jnp.asarray(a) for a in args))
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        tv = tmerge(*ts)
        (torch.sum(tv[0] ** 2) + torch.sum(torch.sin(tv[1]))).backward()
        for a, b in zip(tv, jv):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **F32_TOL)
        for i, b in zip((0, 2, 3), jg):
            np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(b),
                                       **F32_TOL)
    # the first merge is the block itself
    on, ln = tmerge(torch.tensor(o), torch.tensor(first), torch.tensor(ob),
                    torch.tensor(lseb))
    np.testing.assert_array_equal(on.numpy(), ob)
    np.testing.assert_array_equal(ln.numpy(), lseb)


# ------------------------------------------------------------ the LM

BATCH, SEQ, STEPS = 4, 128, 2
TINY = dict(vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
            sequence_length=SEQ, attention_impl="ring")


def lm_data():
    rs = np.random.RandomState(0)
    n = BATCH * STEPS
    toks = rs.randint(0, 64, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    labels = rs.randint(0, 64, (n, SEQ, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def build_sp_lm(pkg, mesh):
    sys.argv = ["test", "--weight-update-sharding=off"]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    par = __import__(f"{pkg}.parallel", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = BATCH
    cfg.allow_tensor_op_math_conversion = False
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(**TINY),
                                batch_size=BATCH)
    ff.set_strategy(par.sequence_parallel_attention(ff))
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    return ff


def record_losses(ff, cast=float):
    step = ff.executor.build_train_step()
    losses = []

    def record(*args):
        out = step(*args)
        losses.append(cast(out[-1]))
        return out

    ff.executor._train_step = record
    return losses


def sp_lm_job(rank, mesh, init):
    from flexflow_tpu_torch import load_params

    ff = build_sp_lm("flexflow_tpu_torch", mesh)
    load_params(ff, init)
    losses = record_losses(ff)
    x, y = lm_data()
    ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    out = port_state(ff)
    out["losses"] = losses
    out["kinds"] = {n.name: ff.executor._rules[n.guid]["kind"]
                    for n in ff.executor.order if n.guid
                    in ff.executor._rules}
    out["loss_layout"] = ff.executor._loss_layout
    return out


@pytest.fixture(scope="module")
def jax_sp_lm():
    """The JAX package's run at sp 2 (ring attention over its virtual
    mesh), the reference of both port meshes: its initial weights, final
    weights and losses."""
    import jax

    jff = build_sp_lm("flexflow_tpu", (1, 1, 1, 2))
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in jff._params.items()}
    losses = record_losses(jff, cast=lambda v: float(np.asarray(v)))
    x, y = lm_data()
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    final = {f"{n}.{k}": np.asarray(jax.device_get(v))
             for n, ws in jff._params.items() for k, v in ws.items()}
    return init, final, losses


@pytest.mark.parametrize("mesh", [(1, 1, 1, 2), (2, 1, 1, 2)],
                         ids=["sp2", "dp2_sp2"])
def test_sequence_parallel_lm_trains_as_jax(jax_sp_lm, mesh):
    init, final, jlosses = jax_sp_lm
    outs = _spawn(sp_lm_job, int(np.prod(mesh)), mesh, init)
    for o in outs:
        np.testing.assert_allclose(o["losses"], jlosses, rtol=2e-5)
        for k, want in final.items():
            np.testing.assert_allclose(o["params"][k], want, **F32_TOL,
                                       err_msg=k)
        kinds = o["kinds"]
        for name in ("wte", "wpe", "embed_add", "l0_ln1", "l0_ffn1",
                     "l0_gelu", "l1_ffn2", "l1_res2", "ln_f", "lm_head"):
            assert kinds[name] in ("rows", "elementwise"), (name, kinds)
        assert kinds["l0_attn"] == kinds["l1_attn"] == "ring"
        data = ("data",) if mesh[0] > 1 else ()
        assert o["loss_layout"] == (data, ("seq",), ())
        assert o["counters"]["train_all"] == BATCH * STEPS * SEQ


def test_dryrun_sequence_parallel_leg_on_four_ranks():
    from flexflow_tpu_torch.entry import _factor_mesh, dryrun_multichip

    assert _factor_mesh(4, 4) == (1, 2, 2)
    assert _factor_mesh(8, 4) == (2, 2, 2)
    losses = dryrun_multichip(4, legs=("lm", "sp"), device="cpu")
    assert len(losses) == 4 and len(set(losses)) == 1
    lm, sp = losses[0]
    assert np.isfinite(lm)
    np.testing.assert_allclose(sp, lm, rtol=2e-6)


def mse_job(rank, mesh):
    """A (b, s, d) -> dense -> dense model with an MSE loss, its outputs
    split over the sequence (`sequence_parallel_attention`) on `mesh`:
    this rank's loss and the whole gradients of one step."""
    mod = __import__("flexflow_tpu_torch")
    sys.argv = ["test", "--weight-update-sharding=off"]
    cfg = mod.FFConfig(device="cpu")
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = 4
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((4, 8, 16), name="x")
    t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
    ff.dense(t, 16, name="fc2")
    par = __import__("flexflow_tpu_torch.parallel", fromlist=["x"])
    ff.set_strategy(par.sequence_parallel_attention(ff))
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.1),
               loss_type=mod.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    rs = np.random.RandomState(0)
    xs, ys = ff._make_batch({"x": rs.randn(4, 8, 16).astype(np.float32)},
                            rs.randn(4, 8, 16).astype(np.float32))
    ex = ff.executor
    lval, _, grads = ex.value_and_grad(ex.make_loss_fn(ff._state, xs, ys),
                                       ff._params)
    grads = ex.sync_grads(grads)
    return {"loss": float(ex.global_loss(lval)),
            "grads": {f"{n}.{k}": ex.full_weight(n, k, g).numpy().copy()
                      for n, ws in grads.items() for k, g in ws.items()},
            "kinds": sorted({r["kind"] for r in ex._rules.values()})
            if ex.spmd else []}


def test_sequence_split_mse_is_the_batch_mean():
    """A loss other than the sparse CE averages over the batch only: with
    the rows split over `seq` too (dp 2 x sp 2), each rank's share sums
    over its sequence rows, and loss and gradients equal one rank's."""
    one = mse_job(0, (1, 1, 1, 1))
    outs = _spawn(mse_job, 4, (2, 1, 1, 2))
    for o in outs:
        assert "rows" in o["kinds"], o["kinds"]
        np.testing.assert_allclose(o["loss"], one["loss"], rtol=2e-6)
        for k, want in one["grads"].items():
            np.testing.assert_allclose(o["grads"][k], want, **F32_TOL,
                                       err_msg=k)
