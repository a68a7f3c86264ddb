"""The tiny Transformer LM at dp 2 x tp 2 on 4 gloo ranks on the CPU,
against the JAX package on its virtual mesh and against itself.

The LM of `tests/test_torch_train.py` (vocab 64, hidden 128, 2 heads of
64, 2 layers, seq 128, `attention_impl="flash"`: the port's flash
wrappers take their plain versions on CPU tensors, JAX runs its Pallas
kernels in interpret mode) under `megatron_transformer`: each rank runs
attention on its one head, the MLP on its half of the 512 hidden
features and the embeddings on half their columns. From the JAX model's
initial weights (`load_params`) 2 SGD steps on a global batch of 4 end
at JAX's weights at `F32_TOL`; every rank holds the same weights and
the loss is the whole batch's. The same run under stage 2 and stage 3
(Adam) is bit-equal to the replicated update.
"""

import sys

import numpy as np
import pytest

from test_torch_distributed import (
    F32_TOL,
    WORLD,
    _spawn,
    assert_bit_equal,
    assert_ranks_agree,
    port_state,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESH = (2, 2, 1, 1)
BATCH, SEQ, STEPS = 4, 128, 2
TINY = dict(vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
            sequence_length=SEQ, attention_impl="flash")


def lm_data():
    rs = np.random.RandomState(0)
    n = BATCH * STEPS
    toks = rs.randint(0, 64, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    labels = rs.randint(0, 64, (n, SEQ, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def build_lm(pkg, argv=(), opt="sgd"):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    par = __import__(f"{pkg}.parallel", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = MESH
    cfg.batch_size = BATCH
    cfg.allow_tensor_op_math_conversion = False
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(**TINY),
                                batch_size=BATCH)
    ff.set_strategy(par.megatron_transformer(ff))
    optimizer = (mod.SGDOptimizer(lr=0.05) if opt == "sgd"
                 else mod.AdamOptimizer(alpha=0.01))
    ff.compile(optimizer=optimizer,
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    return ff


def lm_job(rank, jobs):
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.kernels import counters, reset_counters

    outs = []
    for job in jobs:
        ff = build_lm("flexflow_tpu_torch", job["argv"], job["opt"])
        if job.get("init") is not None:
            load_params(ff, job["init"])
        step = ff.executor.build_train_step()
        losses = []

        def record(*args):
            out = step(*args)
            losses.append(float(out[-1]))
            return out

        ff.executor._train_step = record
        x, y = lm_data()
        reset_counters()
        ff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False,
               verbose=False)
        out = port_state(ff)
        out["losses"] = losses
        out["plain"] = {n: c.plain_calls for n, c in counters().items()
                        if c.plain_calls}
        out["heads"] = next(r["params"].num_heads for g, r in
                            ff.executor._rules.items()
                            if r["kind"] == "mha")
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def jax_lm():
    jff = build_lm("flexflow_tpu")
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in jff._params.items()}
    losses = []
    step = jff.executor.build_train_step()

    def record(*args):
        out = step(*args)
        losses.append(float(np.asarray(out[-1])))
        return out

    jff.executor._train_step = record
    x, y = lm_data()
    jff.fit(x, y, epochs=1, batch_size=BATCH, shuffle=False, verbose=False)
    final = {f"{n}.{k}": np.asarray(v) for n, ws in jff._params.items()
             for k, v in ws.items()}
    return init, final, losses


def test_tiny_lm_dp2_tp2_matches_jax_and_its_stages_are_bit_equal(jax_lm):
    init, final, jlosses = jax_lm
    jobs = [dict(argv=["--weight-update-sharding=off"], opt="sgd",
                 init=init)]
    jobs += [dict(argv=[f"--weight-update-sharding={m}"], opt="adam")
             for m in ("off", "stage2", "stage3")]
    outs = _spawn(lm_job, jobs)
    sgd = [o[0] for o in outs]
    assert_ranks_agree(sgd)
    np.testing.assert_allclose(sgd[0]["losses"], jlosses, rtol=2e-5)
    for k, want in final.items():
        np.testing.assert_allclose(sgd[0]["params"][k], want, **F32_TOL,
                                   err_msg=k)
    for o in sgd:
        # each rank's attention runs its one head, through the flash
        # wrappers' plain versions (CPU tensors), and the LayerNorm's
        assert o["heads"] == 1
        for kernel in ("flash_attention_fwd", "layer_norm_fwd",
                       "layer_norm_bwd"):
            assert o["plain"].get(kernel, 0) > 0, (kernel, o["plain"])
        assert o["counters"]["train_all"] == BATCH * STEPS * SEQ
    for r in range(WORLD):
        rep, s2, s3 = outs[r][1:]
        assert_bit_equal(rep, s2, f"rank {r} stage 2")
        assert_bit_equal(rep, s3, f"rank {r} stage 3")
        assert s3["update"] == {"enabled": True, "stage": 3, "shards": 2}
        # the embedding tables: half their columns (tp) and, sharded at
        # rest, half their rows (dp)
        assert s3["local"]["wte.kernel"] == (64 * 128 // 4, 64 * 128)
        assert rep["local"]["wte.kernel"] == (64 * 128 // 2, 64 * 128)
