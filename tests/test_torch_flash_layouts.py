"""The port's per-head flash paths against the JAX package's.

The transposed (b, h, s, d) entry, the `(out, lse)` entry, the packed entry
at head_dim 128, and the plain versions of K5-K8 on both layouts: the same
numpy inputs, made from a seed, go through the JAX functions and the
port's on the CPU, where the port's wrappers take their plain versions.
The JAX side runs its Pallas kernels in interpret mode, jitted, as its own
tests run them:

  K5 (`flash_attention_fwd_plain`, transposed) vs `_flash_fwd`, the
    TPU `_flash_kernel` (row 3 of PERF.md's kernel table), one 512-row
    block (one-pass softmax) and 64-row blocks (online softmax, a ragged
    tail);
  K8 (`flash_attention_bwd_fused_plain`) vs `_flash_bwd` at one tile
    (`_bwd_single_tile_kernel`, row 4) and vs `_flash_bwd_packed` at
    head_dim 128, s 128 (row 11);
  K6/K7 vs `_flash_bwd` at 64-row blocks (`_bwd_dq_kernel`,
    `_bwd_dkv_kernel`, rows 5 and 6) and vs `_flash_bwd_packed` at
    head_dim 128, 64-row blocks, s 256 (rows 12 and 13);
  `flash_attention` and `flash_attention_with_lse` vs `jax.vjp` of the JAX
    entries, the lse entry under a nonzero lse cotangent;
  the backward dispatch: which plain versions run at each shape against
    which Pallas kernels the JAX package traces there.

Tolerances: float32 at rtol = atol = 2e-5 (sums in another order);
bfloat16 at 2e-2 (the frameworks round bf16 at different points). JAX
stores lse as (b*h, s, 128 lanes) copies; the port keeps (b, h, s),
compared against lane 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import counters, reset_counters
from flexflow_tpu_torch.kernels import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

DTYPES = {
    "f32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
    "bf16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}
# (batch, heads, seq, head_dim) and the JAX kernels' block rows
SHAPES = [(2, 2, 128, 64), (2, 4, 256, 64), (2, 2, 200, 32)]
BLOCKS = {128: 512, 256: 64, 200: 64}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _pairs(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.tensor(a).to(tdt) for a in arrays])


def _lane0(jlse, b, h, s):
    return _np(jlse)[..., 0].reshape(b, h, s)


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2],
                               err_msg=msg)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plain_transposed_matches_flash_fwd(shape, causal, dtype):
    b, h, s, d = shape
    (jq, jk, jv), (tq, tk, tv) = _pairs(_inputs(shape, 0, 3), dtype)
    scale = 1.0 / np.sqrt(d)
    blk = BLOCKS[s]
    jout, jlse = jax.jit(lambda q, k, v: jfa._flash_fwd(
        q, k, v, causal, scale, blk, blk))(jq, jk, jv)
    pout, plse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    assert pout.dtype == tq.dtype and tuple(pout.shape) == shape
    assert plse.dtype == torch.float32 and tuple(plse.shape) == (b, h, s)
    _close(pout, jout, dtype, "out")
    _close(plse, _lane0(jlse, b, h, s), dtype, "lse")


def _jax_bwd(q, k, v, g, causal, scale, blk, num_heads=None):
    """The JAX custom VJP's own forward and backward rules on one
    cotangent: `_flash_bwd` (transposed) or `_flash_bwd_packed`."""
    if num_heads is None:
        out, lse = jfa._flash_fwd(q, k, v, causal, scale, blk, blk)
        return jfa._flash_bwd(q, k, v, out, lse, g, causal, scale, blk, blk)
    out, lse = jfa._flash_fwd_packed(q, k, v, num_heads, causal, scale, blk,
                                     blk)
    return jfa._flash_bwd_packed(q, k, v, out, lse, g, num_heads, causal,
                                 scale, blk, blk)


def _port_bwd(kernel, tq, tk, tv, tg, causal, num_heads=None):
    kw = dict(num_heads=num_heads, causal=causal)
    out, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, **kw)
    delta = tfa.flash_delta(tg, out, num_heads)
    if kernel == "fused":
        return tfa.flash_attention_bwd_fused_plain(tq, tk, tv, tg, lse,
                                                   delta, **kw)
    dq = tfa.flash_attention_bwd_dq_plain(tq, tk, tv, tg, lse, delta, **kw)
    return (dq, *tfa.flash_attention_bwd_dkv_plain(tq, tk, tv, tg, lse,
                                                   delta, **kw))


# (kernel, layout (b, h or heads, s, d), JAX block rows): the fused K8 at
# one tile, the K6/K7 pair at 64-row tiles; transposed at head_dim 64 and a
# ragged 32, packed at head_dim 128
BWD_CASES = [
    ("fused", "transposed", (2, 2, 128, 64), 512),    # row 4
    ("fused", "transposed", (2, 2, 200, 32), 512),    # row 4, ragged
    ("fused", "packed", (2, 2, 128, 128), 512),       # row 11
    ("split", "transposed", (2, 4, 256, 64), 64),     # rows 5, 6
    ("split", "transposed", (2, 2, 200, 32), 64),     # rows 5, 6, ragged
    ("split", "packed", (2, 2, 256, 128), 64),        # rows 12, 13
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel,layout,shape,blk", BWD_CASES)
def test_backward_plain_versions_match_jax_kernels(kernel, layout, shape,
                                                   blk, causal, dtype):
    """K8's plain version where the JAX backward runs its single-tile
    kernel, K6's and K7's where it runs the dq/dkv pair."""
    b, h, s, d = shape
    arrays = _inputs(shape, 1)
    heads = None
    if layout == "packed":
        arrays = [a.transpose(0, 2, 1, 3).reshape(b, s, h * d)
                  for a in arrays]
        heads = h
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _pairs(arrays, dtype)
    scale = 1.0 / np.sqrt(d)
    jgrads = jax.jit(lambda *a: _jax_bwd(*a, causal, scale, blk, heads))(
        jq, jk, jv, jg)
    reset_counters()
    tgrads = _port_bwd(kernel, tq, tk, tv, tg, causal, heads)
    c = counters()
    ran = {n for n in ("flash_attention_bwd_fused", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv") if c[n].plain_calls}
    assert ran == ({"flash_attention_bwd_fused"} if kernel == "fused" else
                   {"flash_attention_bwd_dq", "flash_attention_bwd_dkv"})
    for name, got, want, like in zip(("dq", "dk", "dv"), tgrads, jgrads,
                                     (tq, tk, tv)):
        assert got.dtype == like.dtype and got.shape == like.shape, name
        _close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_packed_forward_plain_at_head_dim_128_matches_jax(causal, dtype):
    """K5's plain version on the packed layout against
    `_flash_fwd_packed` where a block holds one head of 128 (row 8),
    online softmax over 64-row blocks."""
    b, s, h, d = 2, 256, 2, 128
    (jq, jk, jv), (tq, tk, tv) = _pairs(_inputs((b, s, h * d), 2, 3), dtype)
    scale = 1.0 / np.sqrt(d)
    jout, jlse = jax.jit(lambda q, k, v: jfa._flash_fwd_packed(
        q, k, v, h, causal, scale, 64, 64))(jq, jk, jv)
    pout, plse = tfa.flash_attention_fwd_plain(tq, tk, tv, num_heads=h,
                                               causal=causal)
    _close(pout, jout, dtype, "out")
    _close(plse, _lane0(jlse, b, h, s), dtype, "lse")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 200])
def test_transposed_entry_matches_jax_vjp(s, causal):
    """`flash_attention` (K5, then K8: one JAX tile) against `jax.vjp` of
    the JAX `flash_attention`, float32."""
    shape = (2, 2, s, 64)
    q, k, v, g = _inputs(shape, 3)

    @jax.jit
    def jrun(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, causal=causal), q_, k_, v_)
        return out, vjp(g_)

    jout, jgrads = jrun(*(jnp.asarray(a) for a in (q, k, v, g)))
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    reset_counters()
    tout = tfa.flash_attention(*leaves, causal=causal)
    tout.backward(torch.tensor(g))
    c = counters()
    assert c["flash_attention_fwd"].plain_calls == 1
    assert c["flash_attention_bwd_fused"].plain_calls == 1
    _close(tout, jout, "f32", "out")
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        _close(leaf.grad, want, "f32", name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blk", [512, 64])
def test_lse_entry_matches_jax_vjp_with_an_lse_cotangent(blk, causal):
    """`flash_attention_with_lse` against `jax.vjp` of the JAX entry,
    with cotangents on both outputs: the lse cotangent folds into delta
    (`delta_adj`). With 64-row blocks JAX runs its dq/dkv pair; the port's
    backward is K8 at this length either way, the same function."""
    shape = (2, 2, 256, 64)
    q, k, v, g = _inputs(shape, 4)
    g_lse = np.random.RandomState(5).randn(2, 2, 256).astype(np.float32)

    @jax.jit
    def jrun(q_, k_, v_, g_, gl_):
        outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
            *a, causal=causal, block_q=blk, block_k=blk), q_, k_, v_)
        return outs, vjp((g_, gl_))

    (jout, jlse), jgrads = jrun(*(jnp.asarray(a)
                                  for a in (q, k, v, g, g_lse)))
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    tout, tlse = tfa.flash_attention_with_lse(*leaves, causal=causal)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (2, 2, 256)
    torch.autograd.backward([tout, tlse],
                            [torch.tensor(g), torch.tensor(g_lse)])
    _close(tout, jout, "f32", "out")
    _close(tlse, jlse, "f32", "lse")
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        _close(leaf.grad, want, "f32", name)
    # the lse cotangent moves the gradients: it is not dropped
    plain = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*plain, causal=causal).backward(torch.tensor(g))
    assert float((plain[0].grad - leaves[0].grad).abs().max()) > 1e-3


def _jax_kernels(entry, shapes, monkeypatch, **kw):
    """The Pallas kernels (by `pallas_call` name) the JAX package traces
    for the forward and backward of `entry` at these shapes."""
    names = []
    real = jfa.pl.pallas_call

    def recording(*args, **kwargs):
        names.append(kwargs.get("name"))
        return real(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", recording)
    jax.clear_caches()  # a cached trace would skip the recording

    def f(q, k, v, g):
        _, vjp = jax.vjp(lambda *a: entry(*a, causal=True, **kw), q, k, v)
        return vjp(g)

    jax.eval_shape(f, *(jax.ShapeDtypeStruct(s, jnp.float32)
                        for s in shapes))
    monkeypatch.setattr(jfa.pl, "pallas_call", real)
    kinds = []
    for n in names:
        for kind in ("bwd_fused", "bwd_dq", "bwd_dkv", "fwd"):
            if kind in n:
                kinds.append(kind)
                break
    return sorted(kinds)


# (layout, batch, heads, seq, head_dim)
DISPATCH = [
    ("packed", 1, 4, 256, 64),       # grouped narrow heads: the split pair
    ("packed", 1, 2, 256, 128),      # one head a block, one tile: fused
    ("packed", 1, 2, 640, 128),      # one head a block, two tiles: split
    ("transposed", 1, 2, 256, 64),   # one tile: fused
    ("transposed", 1, 2, 640, 64),   # two tiles: split
]


@pytest.mark.parametrize("layout,b,h,s,d", DISPATCH)
def test_backward_dispatch_runs_what_jax_runs(layout, b, h, s, d,
                                              monkeypatch):
    """The port's forward and backward at each shape run the plain
    versions of the kernels whose Pallas twins the JAX package traces
    there: K8 for `_bwd_single_tile_kernel`, K6 and K7 for the dq/dkv
    pair."""
    if layout == "packed":
        shapes = [(b, s, h * d)] * 4
        jentry = jfa.flash_attention_packed
        kw = dict(num_heads=h)

        def port(*a):
            return tfa.flash_attention_packed(*a, num_heads=h, causal=True)
    else:
        shapes = [(b, h, s, d)] * 4
        jentry = jfa.flash_attention
        kw = {}

        def port(*a):
            return tfa.flash_attention(*a, causal=True)
    want = _jax_kernels(jentry, shapes, monkeypatch, **kw)
    rs = np.random.RandomState(6)
    q, k, v, g = (torch.tensor(rs.randn(*sh).astype(np.float32))
                  for sh in shapes)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    reset_counters()
    port(*leaves).backward(g)
    kind = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "bwd_dq",
            "flash_attention_bwd_dkv": "bwd_dkv",
            "flash_attention_bwd_fused": "bwd_fused"}
    got = sorted(kind[n] for n, c in counters().items() if n in kind
                 for _ in range(c.plain_calls))
    assert got == want, (got, want)
    assert all(c.launches == 0 for c in counters().values())


def test_fused_dispatch_follows_the_jax_head_blocking():
    """`packed_heads_per_block` is the JAX package's: one head a block at
    head_dim % 128 == 0, or when narrow heads cannot be grouped."""
    for d, h in ((64, 16), (128, 32), (32, 4), (64, 1), (96, 3), (256, 2)):
        assert (tfa.packed_heads_per_block(d, h)
                == jfa._packed_heads_per_block(d, h)), (d, h)
