"""ROADMAP C9, classified: under the bf16 tensor-op input cast, serving's
greedy streams depend on the width of the call that computed a token, in
the JAX package as in the port.

The trace is lm-smoke's (f32 weights), 16 requests of 16-71 tokens, the
first four sharing a 32-token prefix, 40 new tokens each, 4 slots,
prefill chunks of 16, KV blocks of 16: the paged layout's prefix hits
skip prefill chunks, so it computes some decode tokens in calls of
another width than the contiguous layout does. With the cast (JAX:
`force_tensor_op_math=True`, the cast its TPU path applies) the JAX
package's paged and contiguous streams part (request 2 of 16 when this
was classified); without it (exact float32) every stream is equal, in
both packages. The port takes the cast on the card only; on the card at
lm-base its streams part the same way (1 of 16, `serve_bench_torch.py`'s
trace). So C9 is shared with the reference: a fix is a numerics change
(a token's arithmetic independent of its call's width) for both, not a
port divergence.
"""

import sys

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SERVE = dict(slots=4, max_new_tokens=40, prefill_chunk=16, kv_block_size=16)


def _prompts(vocab: int) -> list:
    rs = np.random.RandomState(0)
    lens = rs.randint(16, 72, size=16)
    prompts = [rs.randint(1, vocab, size=int(n)).tolist() for n in lens]
    prefix = rs.randint(1, vocab, size=32).tolist()
    for p in prompts[:4]:
        p[:32] = prefix
    return prompts


def _streams(ff, prompts) -> dict:
    return {lay: ff.serve(kv_layout=lay, **SERVE).generate(prompts)
            for lay in ("paged", "contiguous")}


def _parted(streams: dict) -> list:
    return [i for i, (a, b) in enumerate(zip(streams["paged"],
                                             streams["contiguous"]))
            if a != b]


def test_jax_streams_part_under_the_cast_as_the_ports_do():
    from flexflow_tpu import FFConfig, FFModel
    from flexflow_tpu.models import TRANSFORMER_LM_ZOO, build_transformer_lm

    import flexflow_tpu_torch as tpkg
    from flexflow_tpu_torch.models import build_transformer_lm as tbuild

    lm = TRANSFORMER_LM_ZOO["lm-smoke"]
    prompts = _prompts(lm.vocab_size)
    sys.argv = ["test"]
    out = {}
    for cast in (True, False):
        config = FFConfig()
        config.force_tensor_op_math = cast
        ff = FFModel(config)
        build_transformer_lm(ff, lm, batch_size=4)
        ff.compile()
        out[cast] = _streams(ff, prompts)
        params = {n: {k: np.asarray(v) for k, v in ws.items()}
                  for n, ws in ff._params.items()}
    assert all(len(s) == SERVE["max_new_tokens"]
               for s in out[True]["paged"] + out[True]["contiguous"])
    # the reference parts under the cast, and only under it
    assert _parted(out[True]), "the JAX package's streams did not part"
    assert _parted(out[False]) == []

    # the port in exact float32 (its CPU path): every stream equal, and
    # equal to the reference's exact streams
    config = tpkg.FFConfig(device="cpu")
    ff = tpkg.FFModel(config)
    tbuild(ff, lm, batch_size=4)
    ff.compile()
    tpkg.load_params(ff, params)
    port = _streams(ff, prompts)
    assert _parted(port) == []
    assert port["contiguous"] == out[False]["contiguous"]
