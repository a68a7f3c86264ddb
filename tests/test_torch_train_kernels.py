"""The port's training kernels' plain versions against the JAX package's.

K5 (flash forward), K6/K7 (flash backward dq, dk/dv) and K4 (LayerNorm
backward): the same numpy inputs, made from a seed, go through the JAX
function and the port's on the CPU, where the port's `autograd.Function`s
take their plain versions. The JAX side runs its Pallas kernels in
interpret mode, as its own tests run them. Its one-pass softmax (one kv
block) and its online softmax (several) are both reached: (2, 128, 2x64)
runs with the default 512-row blocks (one 128-key block, lm-base's case),
(2, 256, 4x64) with 64-row blocks (four kv blocks), and (2, 200, 2x32)
with 64-row blocks is ragged (a partial last tile, masked q rows) and
takes the grouped path at full width. Tolerances: float32 at
rtol = atol = 2e-5; bfloat16 at 2e-2, since the two frameworks round bf16
at different points (and the port's plain forward is one-pass where the
JAX kernel's online softmax rounds p against a running max).

JAX stores lse as (b*h, s, 128 lanes) copies; the port keeps (b, h, s),
compared against lane 0. Causal attention with s_q > s_k is the JAX
entries' XLA path in both packages, held to each other the same way.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.layer_norm import fused_layer_norm_or_none
from flexflow_tpu_torch.kernels import counters, reset_counters
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import layer_norm as tln
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

DTYPES = {
    "f32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
    "bf16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}
# (batch, seq, heads, head_dim) and the JAX kernels' block rows
SHAPES = [(2, 128, 2, 64), (2, 256, 4, 64), (2, 200, 2, 32)]
BLOCKS = {128: 512, 256: 64, 200: 64}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _qkvg(shape, seed):
    b, s, h, d = shape
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h * d).astype(np.float32) for _ in range(4)]


def _pair(a, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_plain_versions_match_jax_kernels(shape, causal, dtype):
    """K5's plain version (out and lse) against `_flash_fwd_packed`, and
    the port's `flash_attention_packed` Function (K5 forward, delta, then
    K6 and K7; their plain versions on the CPU) against the JAX custom
    VJP's own rules (`_flash_packed_vjp_fwd` / `_bwd`: what `jax.vjp` of
    `flash_attention_packed` runs at these shapes), one cotangent."""
    b, s, h, d = shape
    q, k, v, g = _qkvg(shape, 0)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_pair(a, dtype)
                                              for a in (q, k, v, g))
    scale = 1.0 / np.sqrt(d)
    blk = BLOCKS[s]

    @jax.jit  # one compile of the interpret-mode kernels, not eager
    def jrun(q_, k_, v_, g_):
        out, res = jfa._flash_packed_vjp_fwd(q_, k_, v_, h, causal, scale,
                                             blk, blk)
        return out, res[4], jfa._flash_packed_vjp_bwd(h, causal, scale, blk,
                                                      blk, res, g_)

    jout, jlse, jgrads = jrun(jq, jk, jv, jg)
    pout, plse = tfa.flash_attention_fwd_plain(tq, tk, tv, num_heads=h,
                                               causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tout = tfa.flash_attention_packed(*leaves, num_heads=h, causal=causal)
    tout.backward(tg)
    tol = DTYPES[dtype][2]
    assert pout.dtype == tq.dtype and tuple(plse.shape) == (b, h, s)
    torch.testing.assert_close(tout, pout, rtol=0, atol=0)
    np.testing.assert_allclose(_np(pout), _np(jout), **tol)
    np.testing.assert_allclose(
        _np(plse), _np(jlse)[..., 0].reshape(b, h, s), **tol)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **tol,
                                   err_msg=name)


def test_flash_gradients_match_jax_vjp():
    """The same through `jax.vjp` of `flash_attention_packed` itself, at
    the ragged grouped shape, causal, float32."""
    b, s, h, d = SHAPES[2]
    q, k, v, g = _qkvg(SHAPES[2], 1)

    def f(q_, k_, v_):
        return jfa.flash_attention_packed(q_, k_, v_, num_heads=h,
                                          causal=True, block_q=64,
                                          block_k=64)

    @jax.jit
    def jrun(q_, k_, v_, g_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return out, vjp(g_)

    jout, jgrads = jrun(*(jnp.asarray(a) for a in (q, k, v, g)))
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    tout = tfa.flash_attention_packed(*leaves, num_heads=h, causal=True)
    tout.backward(torch.tensor(g))
    tol = DTYPES["f32"][2]
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **tol,
                                   err_msg=name)


def test_flash_backward_kernels_match_the_fused_function():
    """K6 and K7's plain versions, fed the forward's lse and delta, give
    the Function's gradients, and the Function's backward takes delta as
    rowsum(dO * O) per head from the stored output."""
    shape = (2, 128, 2, 64)
    b, s, h, d = shape
    q, k, v, g = (torch.tensor(a) for a in _qkvg(shape, 2))
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, num_heads=h,
                                             causal=True)
    delta = tfa.flash_delta(g, out, h)
    want_delta = (g * out).reshape(b, s, h, d).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, want_delta)
    dq = tfa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta,
                                          num_heads=h, causal=True)
    dk, dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta,
                                               num_heads=h, causal=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention_packed(*leaves, num_heads=h, causal=True).backward(g)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["packed", "transposed", "lse"])
def test_flash_refuses_causal_rows_without_keys(entry):
    """Causal with s_q > s_k (the first rows see no key): the flash kernel
    functions refuse it, and the three entries compute it as the JAX
    entries do, on their XLA path (`flash_attention_packed` 1236,
    `flash_attention` 1628 through sdpa_xla, `flash_attention_with_lse` 668
    through `_attn_reference_lse`), where a row with no live key averages V
    over all keys: outputs, lse and the q/k/v gradients under one
    cotangent (and one on lse) match `jax.vjp` of the JAX entry in float32
    at rtol = atol = 2e-5, and no kernel or plain version runs."""
    b, h, d, s_q, s_k = 2, 2, 32, 192, 128
    rs = np.random.RandomState(6)
    q, g = (rs.randn(b, h, s_q, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, s_k, d).astype(np.float32) for _ in range(2))
    g_lse = rs.randn(b, h, s_q).astype(np.float32)

    def packed(a):  # (b, h, s, d) -> (b, s, h*d)
        return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)

    if entry == "packed":
        q, k, v, g = (packed(a) for a in (q, k, v, g))

        def jf(q_, k_, v_):
            return jfa.flash_attention_packed(q_, k_, v_, num_heads=h,
                                              causal=True)

        def tf(q_, k_, v_):
            return tfa.flash_attention_packed(q_, k_, v_, num_heads=h,
                                              causal=True)
    elif entry == "transposed":
        jf = functools.partial(jfa.flash_attention, causal=True)
        tf = functools.partial(tfa.flash_attention, causal=True)
    else:
        jf = functools.partial(jfa.flash_attention_with_lse, causal=True)
        tf = functools.partial(tfa.flash_attention_with_lse, causal=True)
    cot = (g, g_lse) if entry == "lse" else g

    @jax.jit
    def jrun(q_, k_, v_, cot_):
        out, vjp = jax.vjp(jf, q_, k_, v_)
        return out, vjp(cot_)

    jout, jgrads = jrun(*(jnp.asarray(a) for a in (q, k, v)),
                        jax.tree_util.tree_map(jnp.asarray, cot))
    reset_counters()
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    tout = tf(*leaves)
    outs = tout if entry == "lse" else (tout,)
    jouts = jout if entry == "lse" else (jout,)
    torch.autograd.backward(list(outs), [torch.tensor(c) for c in
                                         (cot if entry == "lse" else (cot,))])
    c = counters()
    assert all(t.launches == 0 and t.plain_calls == 0 for t in c.values()), c
    tol = DTYPES["f32"][2]
    for got, want in zip(outs, jouts):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **tol,
                                   err_msg=name)
    # the kernel functions keep refusing the shape, on every device
    kw = dict(num_heads=h) if entry == "packed" else {}
    with pytest.raises(ValueError, match="s_q <= s_k"):
        tfa.flash_attention_fwd(*leaves, causal=True, **kw)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(256, 128), (64, 256)])
def test_layer_norm_backward_plain_matches_jax_kernel(shape, dtype):
    """K4's plain version, through the port's `fused_layer_norm` Function
    (K1 forward, K4 backward), against `jax.vjp` of the JAX fused
    LayerNorm (Pallas forward and backward in interpret mode). scale and
    bias come in the activation dtype, as the compute cast hands them to
    the op; their gradients come back in that dtype."""
    tdt, jdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(3)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    scale = rs.randn(shape[-1]).astype(np.float32)
    bias = rs.randn(shape[-1]).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)

    def f(x_, s_, b_):
        y = fused_layer_norm_or_none(x_, s_, b_, (1,), 1e-5)
        assert y is not None, "shape must take the JAX fused kernel"
        return y

    @jax.jit
    def jrun(x_, s_, b_, dy_):
        y, vjp = jax.vjp(f, x_, s_, b_)
        return y, vjp(dy_)

    jy, (jdx, jds, jdb) = jrun(*(jnp.asarray(a, jdt)
                                 for a in (x, scale, bias, dy)))
    leaves = [torch.tensor(a).to(tdt).requires_grad_(True)
              for a in (x, scale, bias)]
    ty = tln.fused_layer_norm(*leaves, 1e-5)
    ty.backward(torch.tensor(dy).to(tdt))
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    for name, leaf, want in zip(("dx", "dscale", "dbias"), leaves,
                                (jdx, jds, jdb)):
        assert leaf.grad.dtype == tdt, name
        # dscale/dbias sum over every row: scale the bf16 bound with them
        bound = dict(tol)
        if dtype == "bf16" and name != "dx":
            bound["atol"] = tol["atol"] * np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(leaf.grad), _np(want), **bound,
                                   err_msg=name)


def test_layer_norm_backward_plain_sums_partials_in_f32():
    """K4 hands dscale/dbias back in f32 whatever x's dtype: the partial
    sums over rows are f32, as the TPU kernel's."""
    rs = np.random.RandomState(4)
    x = torch.tensor(rs.randn(40, 24).astype(np.float32)).bfloat16()
    s = torch.tensor(rs.randn(24).astype(np.float32)).bfloat16()
    dy = torch.tensor(rs.randn(40, 24).astype(np.float32)).bfloat16()
    dx, ds, db = tln.layer_norm_bwd(x, s, dy, 1e-5)
    assert dx.dtype == torch.bfloat16
    assert ds.dtype == db.dtype == torch.float32
    torch.testing.assert_close(db, dy.float().sum(0))


def test_cpu_functions_take_plain_versions_and_launch_nothing():
    """On CPU tensors both Functions run their plain versions, forward and
    backward, and leave every kernel launch count at 0."""
    reset_counters()
    q, k, v, g = (torch.tensor(a).requires_grad_(True)
                  for a in _qkvg((1, 32, 2, 16), 5))
    tfa.flash_attention_packed(q, k, v, num_heads=2, causal=True).backward(g)
    x = torch.randn(6, 32, requires_grad=True)
    s = torch.ones(32, requires_grad=True)
    b = torch.zeros(32, requires_grad=True)
    tln.fused_layer_norm(x, s, b, 1e-5).sum().backward()
    c = counters()
    assert all(t.launches == 0 for t in c.values()), c
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "layer_norm_fwd",
                 "layer_norm_bwd"):
        assert c[name].plain_calls == 1, (name, c[name])
    assert x.grad is not None and s.grad is not None and b.grad is not None
