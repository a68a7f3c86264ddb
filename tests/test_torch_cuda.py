"""The port's kernels on the card, each against its plain PyTorch version.

Needs an NVIDIA GPU (sm_90a) and nvcc (every kernel is CUDA C++, built
at first use); skips without a CUDA device. This file imports neither jax
nor the JAX package, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The tolerances are chip_smoke.py's. Its kernel-parity phase covers the
main paths' shapes (decode: NaN in every cache row no slot may read, a
scrambled page table with shared blocks, a float32 cache of values halfway
between bfloat16 values, which only a kernel that rounds K and V on load
matches in bfloat16; training: the flash kernels K5-K8 at lm-base's
shape on both layouts, ragged sequences, a causal offset and the other
head widths, K5-K7 in bfloat16 at lm-xxl-fsdp's shape on both layouts,
the (out, lse) entry under an lse cotangent, the LayerNorm backward at
lm-base's rows and a ragged width), in float32 and bfloat16;
the tests below add shapes off those paths, which the kernels take all
the same, strided views, the autograd Functions on the card, the
wgmma/TMA K5 and K7 (the "sm90" variant) at small versions of the
phase-2 shapes, the entries' routing of causal s_q > s_k to sdpa_xla, and
the executor's captured steps (CUDA graphs) held to their eager selves:
token streams, masters, metrics and kernel counts, and a capture that
reads the host raising with nothing run; and the chunked step (n train
steps in one graph) and an in-place restore, each with dropout drawing
from the generator the graphs hold, bit-equal to the per-step run.
"""

import contextlib
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    """chip_smoke.py's kernel-vs-plain tolerance for this dtype."""
    import chip_smoke

    return chip_smoke.TOL[str(dtype).split(".")[1]]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda):
    import chip_smoke

    errs = chip_smoke.kernel_parity(cuda)
    chip_smoke.train_kernel_parity(cuda, errs)
    assert set(errs) == {"layer_norm_fwd", "flash_decode_attention",
                         "paged_flash_decode_attention", "layer_norm_bwd",
                         "layer_norm_bwd (lm-xxl)",
                         "flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv",
                         "flash_attention_bwd_fused",
                         "flash_attention_fwd (per-head)",
                         "flash_attention_bwd_dq (per-head)",
                         "flash_attention_bwd_dkv (per-head)",
                         "flash_attention_with_lse"} | {
        f"flash_attention_{k} (per-head) @ lm-xxl {layout}"
        for k in ("fwd", "bwd_dq", "bwd_dkv")
        for layout in ("packed", "transposed")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(3, 1000), (5, 10000)])
def test_layer_norm_kernel_off_the_main_path_shapes(cuda, rows, width,
                                                   dtype):
    """A width that is no power of two (four warps a row, the last
    threads idle) and one past four warps' width (passes over the row),
    scale and bias in float32 under a bfloat16 x."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator().manual_seed(width)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(cuda, dtype)
    s = torch.randn(width, generator=g).to(cuda)
    b = torch.randn(width, generator=g).to(cuda)
    n0 = ln.LAYER_NORM_COUNTER.launches
    got = ln.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAYER_NORM_COUNTER.launches == n0 + 1
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, s, b, 1e-5).float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,block", [(32, 5), (80, 16), (128, 8),
                                            (256, 3)])
def test_decode_kernels_off_the_main_path_shapes(cuda, head_dim, block,
                                                 dtype):
    """Every head size the kernel instantiates (one to eight dims per
    lane, 80 leaving lanes idle) and block sizes that are no power of
    two, over a f32 cache with NaN in every row past the cursor."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    heads, seq = 3, 50
    lengths = [0, 1, 7, 23, 50]
    e = heads * head_dim
    n = len(lengths)
    g = torch.Generator().manual_seed(head_dim)
    q = torch.randn(n, 1, e, generator=g).to(cuda, dtype)
    k = torch.randn(n, seq, e, generator=g)
    v = torch.randn(n, seq, e, generator=g)
    for s, length in enumerate(lengths):
        k[s, length:] = float("nan")
        v[s, length:] = float("nan")
    k, v = k.to(cuda), v.to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    tol = _tol(dtype)

    got = fa.flash_decode_attention(q, k, v, lens, num_heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(),
        fa.decode_attention_plain(q, k, v, lens, num_heads=heads).float(),
        **tol)

    # the same logical caches in a pool, blocks handed out in reverse
    W = -(-seq // block)
    nb = n * W + 1
    table = torch.zeros(n, W, dtype=torch.int32)
    pool_k = torch.full((nb, block, e), float("nan"))
    pool_v = torch.full((nb, block, e), float("nan"))
    kc, vc = k.cpu(), v.cpu()
    for s, length in enumerate(lengths):
        for j in range(-(-length // block)):
            phys = nb - 1 - (s * W + j)
            table[s, j] = phys
            rows = min(block, length - j * block)
            pool_k[phys, :rows] = kc[s, j * block:j * block + rows]
            pool_v[phys, :rows] = vc[s, j * block:j * block + rows]
    pool_k, pool_v, table = pool_k.to(cuda), pool_v.to(cuda), table.to(cuda)
    paged = fa.paged_flash_decode_attention(q, pool_k, pool_v, table, lens,
                                            num_heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        paged.float(),
        fa.paged_decode_attention_plain(q, pool_k, pool_v, table, lens,
                                        num_heads=heads).float(), **tol)
    # one arithmetic over two layouts: the same keys give the same output
    torch.testing.assert_close(paged.float(), got.float(), **tol)


@pytest.mark.cuda
def test_wrappers_raise_on_what_kernels_do_not_take(cuda):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    q = torch.zeros(2, 1, 64, device=cuda, dtype=torch.float64)
    kv = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float64)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_decode_attention(q, kv, kv, lengths, num_heads=1)
    with pytest.raises(TypeError):
        ln.layer_norm(q, torch.ones(64, device=cuda, dtype=torch.float64),
                      torch.zeros(64, device=cuda, dtype=torch.float64),
                      1e-5)
    x = torch.zeros(4, 64, device=cuda)
    f64 = torch.ones(64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="bias"):
        ln.layer_norm(x, torch.ones(64, device=cuda), f64, 1e-5)
    with pytest.raises(ValueError):
        ln.layer_norm(x, torch.ones(32, device=cuda), f64[:32], 1e-5)
    q32, kv32 = q.float(), kv.float()
    with pytest.raises(TypeError):  # a half-precision cache
        fa.flash_decode_attention(q32, kv32.half(), kv32.half(), lengths,
                                  num_heads=1)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_decode_attention(q32.repeat(1, 1, 5), kv32.repeat(1, 1, 5),
                                  kv32.repeat(1, 1, 5), lengths, num_heads=1)
    with pytest.raises(ValueError, match="single-query"):
        fa.flash_decode_attention(kv32, kv32, kv32, lengths, num_heads=1)
    with pytest.raises(ValueError):  # a cache of no keys
        fa.flash_decode_attention(q32, kv32[:, :0], kv32[:, :0], lengths,
                                  num_heads=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_q,s_k,heads,head_dim,causal", [
    (3, 1, 1, 3, 16, True),        # one row, the narrowest head
    (1, 17, 65, 2, 40, True),      # causal offset, padded head columns
    (2, 65, 17, 3, 80, False),     # s_q > s_k without a mask
    (1, 100, 100, 1, 100, True),   # head width no multiple of 16
    (2, 200, 333, 2, 128, False),  # ragged both ways, the widest head
])
def test_flash_kernels_off_the_main_path_shapes(cuda, b, s_q, s_k, heads,
                                                head_dim, causal, dtype):
    """K5, K6 and K7 against their plain versions where the tiles are
    partial, the head is padded in shared memory (no 16-byte loads), or
    the causal diagonal is offset."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(s_q * 1000 + s_k)
    e = heads * head_dim
    q = torch.randn(b, s_q, e, generator=g).to(cuda, dtype)
    k = torch.randn(b, s_k, e, generator=g).to(cuda, dtype)
    v = torch.randn(b, s_k, e, generator=g).to(cuda, dtype)
    do = torch.randn(b, s_q, e, generator=g).to(cuda, dtype)
    kw = dict(num_heads=heads, causal=causal)
    tol = _tol(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), p_out.float(), **tol)
    torch.testing.assert_close(lse, p_lse, **tol)
    delta = fa.flash_delta(do, p_out, heads)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, p_lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, p_lse, delta, **kw)
    torch.cuda.synchronize()
    want = (fa.flash_attention_bwd_dq_plain(q, k, v, do, p_lse, delta, **kw),
            *fa.flash_attention_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                              **kw))
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", [(1, 64), (17, 1000), (5, 10000)])
def test_layer_norm_backward_kernel_off_the_main_path_shapes(cuda, rows,
                                                            width, dtype):
    """K4 at one row, a ragged program of rows, and a width past the
    single-block limit (the multi-pass loop)."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator().manual_seed(rows * width)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(cuda, dtype)
    s = torch.randn(width, generator=g).to(cuda, dtype)
    dy = torch.randn(rows, width, generator=g).to(cuda, dtype)
    n0 = ln.LAYER_NORM_BWD_COUNTER.launches
    got = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAYER_NORM_BWD_COUNTER.launches == n0 + 1
    for a, b in zip(got, ln.layer_norm_bwd_plain(x, s, dy, 1e-5)):
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))


@pytest.mark.cuda
def test_autograd_functions_on_card_match_their_cpu_twins(cuda):
    """The same Functions on CUDA tensors (the kernels) and on CPU copies
    (the plain versions): outputs and every gradient, float32."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator().manual_seed(7)
    ins = [torch.randn(2, 130, 128, generator=g) for _ in range(4)]
    ln_ins = [torch.randn(130, 128, generator=g), torch.randn(128,
              generator=g), torch.randn(128, generator=g)]
    results = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_(True) for t in ins[:3])
        out = fa.flash_attention_packed(q, k, v, num_heads=2, causal=True)
        out.backward(ins[3].to(dev))
        x, s, b = (t.to(dev).requires_grad_(True) for t in ln_ins)
        y = ln.fused_layer_norm(x, s, b, 1e-5)
        y.backward(out.detach()[0])
        results.append([t.detach().cpu() for t in
                        (out, q.grad, k.grad, v.grad, y, x.grad, s.grad,
                         b.grad)])
    tol = _tol(torch.float32)
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
def test_training_wrappers_raise_on_what_kernels_do_not_take(cuda):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    wide = torch.zeros(1, 4, 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(wide, wide, wide, num_heads=1)
    half = torch.zeros(1, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(half, half, half, num_heads=1)
    with pytest.raises(ValueError, match="s_q <= s_k"):
        fa.flash_attention_fwd(torch.zeros(1, 8, 64, device=cuda),
                               wide[..., :64], wide[..., :64], num_heads=1,
                               causal=True)
    x = torch.zeros(4, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        ln.layer_norm_bwd(x, torch.ones(64, device=cuda, dtype=x.dtype), x,
                          1e-5)


def _bhsd(cuda, dtype, b, h, s_q, s_k, d, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, s_q, d, generator=g).to(cuda, dtype)
    k = torch.randn(b, h, s_k, d, generator=g).to(cuda, dtype)
    v = torch.randn(b, h, s_k, d, generator=g).to(cuda, dtype)
    do = torch.randn(b, h, s_q, d, generator=g).to(cuda, dtype)
    return q, k, v, do


def _packed(t):
    """(b, h, s, d) -> the same values as a contiguous (b, s, h*d)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s_q,s_k,d,causal", [
    (1, 3, 17, 65, 40, True),      # causal offset, padded head columns
    (2, 2, 65, 17, 80, False),     # s_q > s_k without a mask
    (2, 2, 200, 333, 128, False),  # ragged both ways, the widest head
    (1, 2, 96, 96, 32, True),
])
def test_flash_kernels_transposed_layout(cuda, b, h, s_q, s_k, d, causal,
                                         dtype):
    """K5-K8 on contiguous (b, h, s, d) tensors against their plain
    versions, and against the same kernels on the packed layout of the
    same values: one arithmetic over two stride sets."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _bhsd(cuda, dtype, b, h, s_q, s_k, d, s_q * 7 + d)
    tol = _tol(dtype)
    c = fa.FLASH_FWD_COUNTER
    n0 = c.layouts.get("transposed", 0)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert c.layouts["transposed"] == n0 + 1
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), p_out.float(), **tol)
    torch.testing.assert_close(lse, p_lse, **tol)
    pk_out, pk_lse = fa.flash_attention_fwd(
        *(_packed(t) for t in (q, k, v)), num_heads=h, causal=causal)
    torch.testing.assert_close(_packed(out).float(), pk_out.float(), **tol)
    torch.testing.assert_close(lse, pk_lse, **tol)
    delta = fa.flash_delta(do, p_out)
    args = (q, k, v, do, p_lse, delta)
    kw = dict(causal=causal)
    got = (fa.flash_attention_bwd_dq(*args, **kw),
           *fa.flash_attention_bwd_dkv(*args, **kw))
    fused = fa.flash_attention_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_fused_plain(*args, **kw)
    assert want[0].shape == q.shape and want[1].shape == k.shape
    for a, f, w in zip(got, fused, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)
        torch.testing.assert_close(f.float(), w.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_kernel_packed_head_dim_128(cuda, causal, dtype):
    """K8 on the packed layout at head_dim 128 (the JAX package's packed
    single-tile backward), ragged: partial tiles, masked q rows."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = (_packed(t) for t in _bhsd(cuda, dtype, 2, 2, 190, 190,
                                             128, 11))
    kw = dict(num_heads=2, causal=causal)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.flash_delta(do, out, 2)
    c = fa.FLASH_BWD_FUSED_COUNTER
    n0 = c.layouts.get("packed", 0)
    got = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert c.layouts["packed"] == n0 + 1
    want = fa.flash_attention_bwd_fused_plain(q, k, v, do, lse, delta, **kw)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **_tol(dtype))


@pytest.mark.cuda
def test_flash_kernels_read_strided_views_in_place(cuda):
    """A (b, h, s, d) view of packed memory (strides (s*e, d, e, 1)) is
    read where it lies: the outputs come back in the same strides."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h, d = 2, 130, 4, 64
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, h * d, generator=g).to(cuda).view(
        b, s, h, d).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    tol = _tol(torch.float32)
    torch.testing.assert_close(out, p_out, **tol)
    torch.testing.assert_close(lse, p_lse, **tol)
    do = torch.randn(b, h, s, d, generator=g).to(cuda)
    delta = fa.flash_delta(do, p_out)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_bwd_dq(q, k, v, do, p_lse, delta, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 640])
def test_lse_entry_on_card_matches_its_cpu_twin(cuda, s):
    """`flash_attention_with_lse` on CUDA tensors (K5, then K8 at s <= 512
    or K6 and K7 past it) and on CPU copies (the plain versions): out,
    lse and the gradients under a nonzero lse cotangent, float32."""
    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(s)
    ins = [torch.randn(1, 2, s, 64, generator=g) for _ in range(3)]
    g_out = torch.randn(1, 2, s, 64, generator=g)
    g_lse = torch.randn(1, 2, s, generator=g)
    c = counters()
    results = []
    for dev in (cuda, torch.device("cpu")):
        n0 = {n: t.launches for n, t in c.items()}
        leaves = [t.to(dev).requires_grad_(True) for t in ins]
        out, lse = fa.flash_attention_with_lse(*leaves, causal=True)
        torch.autograd.backward([out, lse], [g_out.to(dev), g_lse.to(dev)])
        ran = {n: t.launches - n0[n] for n, t in c.items()}
        if dev.type == "cuda":
            fused = int(s <= fa.SINGLE_TILE)
            assert ran["flash_attention_fwd"] == 1
            assert ran["flash_attention_bwd_fused"] == fused
            assert ran["flash_attention_bwd_dq"] == 1 - fused
            assert ran["flash_attention_bwd_dkv"] == 1 - fused
        results.append([t.detach().cpu() for t in
                        (out, lse, *(x.grad for x in leaves))])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, **_tol(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s_q,s_k,d,causal", [
    ("packed", 2, 4, 512, 512, 64, True),        # lm-base's, batch cut
    ("transposed", 2, 4, 512, 512, 64, True),
    ("packed", 1, 4, 2048, 2048, 128, True),     # lm-xxl's, heads cut
    ("transposed", 1, 4, 2048, 2048, 128, True),
    ("packed", 2, 3, 130, 130, 128, True),       # ragged: partial tiles
    ("transposed", 2, 2, 1000, 1000, 64, True),
    ("packed", 2, 2, 130, 300, 64, True),        # causal offset
    ("transposed", 2, 2, 300, 130, 128, False),  # s_q > s_k, no mask
])
def test_sm90_kernels_match_plain_versions(cuda, layout, b, h, s_q, s_k, d,
                                           causal):
    """The wgmma/TMA K5 and K7 against their plain versions in bfloat16 at
    small versions of chip_smoke's phase-2 shapes, each launch counted as
    the sm90 variant."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _bhsd(cuda, torch.bfloat16, b, h, s_q, s_k, d,
                        s_q * 3 + s_k + d)
    heads = None
    if layout == "packed":
        q, k, v, do = (_packed(t) for t in (q, k, v, do))
        heads = h
    kw = dict(num_heads=heads, causal=causal)
    tol = _tol(torch.bfloat16)
    n5 = fa.FLASH_FWD_COUNTER.variants.get("sm90", 0)
    n7 = fa.FLASH_BWD_DKV_COUNTER.variants.get("sm90", 0)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = fa.flash_delta(do, p_out, heads)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, p_lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_COUNTER.variants["sm90"] == n5 + 1
    assert fa.FLASH_BWD_DKV_COUNTER.variants["sm90"] == n7 + 1
    torch.testing.assert_close(out.float(), p_out.float(), **tol)
    torch.testing.assert_close(lse, p_lse, **tol)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                                  **kw)
    torch.testing.assert_close(dk.float(), p_dk.float(), **tol)
    torch.testing.assert_close(dv.float(), p_dv.float(), **tol)


def _sm90_inputs(cuda, layout, b, h, s_q, s_k, d, causal):
    """bf16 q, k, v, dO on `layout` and the plain forward's lse and delta:
    the backward kernels' inputs."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _bhsd(cuda, torch.bfloat16, b, h, s_q, s_k, d,
                        s_q * 5 + s_k + d)
    heads = None
    if layout == "packed":
        q, k, v, do = (_packed(t) for t in (q, k, v, do))
        heads = h
    kw = dict(num_heads=heads, causal=causal)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    return (q, k, v, do, p_lse, fa.flash_delta(do, p_out, heads)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s_q,s_k,d,causal", [
    ("packed", 2, 4, 512, 512, 64, True),        # lm-base's, batch cut
    ("transposed", 2, 4, 512, 512, 64, True),
    ("packed", 1, 4, 2048, 2048, 128, True),     # lm-xxl's, heads cut
    ("transposed", 1, 4, 2048, 2048, 128, True),
    ("packed", 2, 3, 130, 130, 128, True),       # ragged: partial tiles
    ("transposed", 2, 2, 1000, 1000, 64, True),
    ("packed", 2, 2, 130, 300, 64, True),        # causal offset
    ("transposed", 2, 2, 300, 130, 128, False),  # s_q > s_k, no mask
])
def test_sm90_dq_kernel_matches_plain_version(cuda, layout, b, h, s_q, s_k,
                                              d, causal):
    """The wgmma/TMA K6 against its plain version in bfloat16 at small
    versions of chip_smoke's phase-2 shapes, counted as the sm90
    variant."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    args, kw = _sm90_inputs(cuda, layout, b, h, s_q, s_k, d, causal)
    n6 = fa.FLASH_BWD_DQ_COUNTER.variants.get("sm90", 0)
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_COUNTER.variants["sm90"] == n6 + 1
    torch.testing.assert_close(
        dq.float(), fa.flash_attention_bwd_dq_plain(*args, **kw).float(),
        **_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s_q,s_k,d,causal", [
    ("transposed", 2, 4, 512, 512, 64, True),  # lm-base's, batch cut
    ("packed", 2, 4, 512, 512, 128, True),     # row 11's, heads cut
    ("packed", 2, 4, 300, 300, 64, True),      # ragged: partial tiles
    ("transposed", 2, 3, 130, 300, 128, True),  # causal offset
    ("packed", 1, 2, 100, 100, 64, False),     # a cluster of one block
    ("transposed", 1, 2, 512, 200, 128, False),  # s_q > s_k, no mask
])
def test_sm90_fused_kernel_matches_plain_version_bitwise_run_to_run(
        cuda, layout, b, h, s_q, s_k, d, causal):
    """The cluster K8 against its plain version in bfloat16, counted as
    the sm90 variant; a second launch on the same inputs gives the same
    bits (dq is summed across the cluster in a fixed order)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    args, kw = _sm90_inputs(cuda, layout, b, h, s_q, s_k, d, causal)
    assert fa.fused_cluster_size(s_k) <= fa.SM90_MAX_CLUSTER
    n8 = fa.FLASH_BWD_FUSED_COUNTER.variants.get("sm90", 0)
    got = fa.flash_attention_bwd_fused(*args, **kw)
    again = fa.flash_attention_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_FUSED_COUNTER.variants["sm90"] == n8 + 2
    want = fa.flash_attention_bwd_fused_plain(*args, **kw)
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), w.float(),
                                   **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_entries_route_causal_rows_without_keys_to_sdpa_xla(cuda):
    """Causal with s_q > s_k on CUDA tensors: the entries take sdpa_xla
    (no kernel launches), as on the CPU; the kernel function refuses."""
    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, k, v, _ = _bhsd(cuda, torch.float32, 1, 2, 192, 128, 64, 5)
    c = counters()
    n0 = {n: t.launches for n, t in c.items()}
    got = fa.flash_attention_packed(*(_packed(t) for t in (q, k, v)),
                                    num_heads=2, causal=True)
    torch.cuda.synchronize()
    assert {n: t.launches for n, t in c.items()} == n0
    want = fa.flash_attention(*(t.cpu() for t in (q, k, v)), causal=True)
    torch.testing.assert_close(got.cpu(), _packed(want),
                               **_tol(torch.float32))
    with pytest.raises(ValueError, match="s_q <= s_k"):
        fa.flash_attention_fwd(q, k, v, causal=True)


_CORRUPT_TABLE = """
import torch
from flexflow_tpu_torch.kernels import flash_attention as fa
dev = torch.device("cuda")
q = torch.randn(2, 1, 64, device=dev)
pool = torch.randn(3, 4, 64, device=dev)
table = torch.tensor([[1, 2], [2, 3]], dtype=torch.int32, device=dev)
lengths = torch.tensor([8, 8], dtype=torch.int32, device=dev)
fa.paged_flash_decode_attention(q, pool, pool, table, lengths, num_heads=1)
torch.cuda.synchronize()
print("NO ERROR")
"""


@pytest.mark.cuda
def test_paged_kernel_stops_on_a_page_table_entry_outside_the_pool(cuda):
    """Block 3 of a 3-block pool: the kernel stops with a device assert
    (in a child process, whose CUDA context it ends), as the plain
    version's gather raises, rather than read another slot's block."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CORRUPT_TABLE], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "NO ERROR" not in proc.stdout, (
        proc.stdout, proc.stderr)
    assert "assert" in proc.stderr.lower(), proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_and_layer_norm_backward_give_the_same_bits_twice(
        cuda, dtype):
    """K2 and K3 merge their splits and K4 sums its partial rows in a
    fixed order: two launches on the same inputs give the same bits
    (lm-base's contiguous cache and pool at phase 8's lengths; K4 at
    lm-base's rows and lm-xxl-fsdp's width)."""
    import chip_smoke
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    args = chip_smoke.decode_inputs(cuda, dtype, 10)
    assert chip_smoke.same_bits(lambda: fa.flash_decode_attention(
        *args, num_heads=chip_smoke.HEADS))
    args = chip_smoke.paged_inputs(cuda, dtype, 11)
    assert chip_smoke.same_bits(lambda: fa.paged_flash_decode_attention(
        *args, num_heads=chip_smoke.HEADS))
    for n, d in ((4096, 1024), (1024, 4096)):
        x, s, dy = chip_smoke.ln_bwd_inputs(cuda, dtype, n, d, 12)
        assert chip_smoke.same_bits(lambda: ln.layer_norm_bwd(x, s, dy,
                                                              1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_at_lm_xxl_width(cuda, dtype):
    """K4 at lm-xxl-fsdp's (8192 tokens, 4096) rows: four warps a row."""
    import chip_smoke
    from flexflow_tpu_torch.kernels import layer_norm as ln

    x, s, dy = chip_smoke.ln_bwd_inputs(cuda, dtype, 8192, 4096, 13)
    n0 = ln.LAYER_NORM_BWD_COUNTER.launches
    got = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAYER_NORM_BWD_COUNTER.launches == n0 + 1
    for a, b in zip(got, ln.layer_norm_bwd_plain(x, s, dy, 1e-5)):
        torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_lm_base_pool(cuda, dtype):
    """K3 over lm-base's pool (8 slots of 32 pages of 16, 16 heads of 64):
    shared pages, partial last pages, an empty slot, NaN in every row no
    slot reads; against its plain version and the split model at the
    kernel's own split."""
    import chip_smoke
    from flexflow_tpu_torch.kernels import flash_attention as fa

    q, pk, pv, table, lengths = chip_smoke.paged_inputs(cuda, dtype, 14)
    h = chip_smoke.HEADS
    got = fa.paged_flash_decode_attention(q, pk, pv, table, lengths,
                                          num_heads=h)
    torch.cuda.synchronize()
    geo = fa.paged_decode_geometry(q.shape[0], h, table.shape[1],
                                   pk.shape[1], q.shape[2] // h)
    assert geo.splits == 16 and geo.keys_per_split == 32
    tol = _tol(dtype)
    for want in (fa.paged_decode_attention_plain(q, pk, pv, table, lengths,
                                                 num_heads=h),
                 fa.paged_decode_split_model(
                     q, pk, pv, table, lengths, num_heads=h,
                     keys_per_split=geo.keys_per_split)):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,block,offset", [
    (64, 128, 0),   # pages wider than a split: runs of 32 keys in a page
    (256, 16, 0),   # 8-key splits, half a page
    (62, 7, 0),     # head_dim no multiple of 4: 4-byte copies
    (64, 16, 1),    # the pool one float past a 16-byte boundary: 4-byte
])
def test_paged_split_kernel_variants(cuda, head_dim, block, offset, dtype):
    """K3's other splits and its 4-byte copies against the plain version,
    long slots (many splits, merged) beside short ones."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    heads, W = 2, 40
    lengths = [0, 1, block, 3 * block + 1, W * block - 5, W * block]
    n, e = len(lengths), heads * head_dim
    g = torch.Generator().manual_seed(head_dim * 100 + block)
    nb = n * W + 1
    flat_k = torch.randn(nb * block * e + offset, generator=g)
    flat_v = torch.randn(nb * block * e + offset, generator=g)
    pk = flat_k[offset:].view(nb, block, e)
    pv = flat_v[offset:].view(nb, block, e)
    table = torch.zeros(n, W, dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=g) + 1
    for s, length in enumerate(lengths):
        used = -(-length // block)
        table[s, :used] = perm[s * W:s * W + used].to(torch.int32)
        # rows past the cursor in the last page: stale, never read
        if length % block:
            pk[table[s, used - 1], length % block:] = float("nan")
            pv[table[s, used - 1], length % block:] = float("nan")
    q = torch.randn(n, 1, e, generator=g).to(cuda, dtype)
    flat_k, flat_v = flat_k.to(cuda), flat_v.to(cuda)
    pk = flat_k[offset:].view(nb, block, e)
    pv = flat_v[offset:].view(nb, block, e)
    table = table.to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    c = fa.PAGED_DECODE_COUNTER
    n0 = c.launches
    got = fa.paged_flash_decode_attention(q, pk, pv, table, lens,
                                          num_heads=heads)
    torch.cuda.synchronize()
    assert c.launches == n0 + 1
    want = fa.paged_decode_attention_plain(q, pk, pv, table, lens,
                                           num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scale_dtype,width,row_stride", [
    (torch.bfloat16, torch.bfloat16, 1001, 1001),  # element loads
    (torch.float16, torch.float16, 1024, 1024),
    (torch.bfloat16, torch.float32, 768, 768),     # f32 scale, bf16 rows
    (torch.float32, torch.float32, 1024, 1030),    # strided rows
    (torch.bfloat16, torch.bfloat16, 2048, 2056),  # four warps a row
    (torch.float32, torch.float32, 5000, 5000),    # passes over the row
])
def test_layer_norm_backward_kernel_variants(cuda, dtype, scale_dtype,
                                             width, row_stride):
    """K4's variants by width, type and layout against its plain version."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    rows = 300
    g = torch.Generator().manual_seed(width + row_stride)
    xs = (torch.randn(rows, row_stride, generator=g) * 3 + 1).to(cuda, dtype)
    x = xs[:, :width]
    s = torch.randn(width, generator=g).to(cuda, scale_dtype)
    dy = torch.randn(rows, width, generator=g).to(cuda, dtype)
    got = ln.layer_norm_bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    tol = _tol(torch.bfloat16 if dtype == torch.float16 else dtype)
    for a, b in zip(got, ln.layer_norm_bwd_plain(x, s, dy, 1e-5)):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim,offset,row_pad", [
    (64, 0, 0),    # 16-byte copies, 32-key splits
    (62, 0, 0),    # head_dim no multiple of 4: 4-byte copies
    (64, 1, 0),    # the cache one float past a 16-byte boundary: 4-byte
    (64, 0, 2),    # a row stride no multiple of 4 floats: 4-byte
    (256, 0, 0),   # 8-key splits
    (20, 0, 0),    # 32 keys of a head narrower than a warp
])
def test_contiguous_split_kernel_variants(cuda, head_dim, offset, row_pad,
                                          dtype):
    """K2's splits and its 4-byte copies against the plain version and the
    split model at the kernel's own split, over a strided cache of 97 keys
    (no multiple of a split) with NaN in every row past each length:
    lengths 0, 1, both sides of a split boundary, S, and one past S (the
    cursor is clamped to the cache)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    heads, seq = 2, 97
    e = heads * head_dim
    geo = fa.decode_split_geometry(1, heads, seq, head_dim)
    kps = geo.keys_per_split
    lengths = [0, 1, kps - 1, kps, kps + 1, seq, seq + 1]
    n = len(lengths)
    g = torch.Generator().manual_seed(head_dim * 10 + offset + row_pad)
    stride = e + row_pad
    flat_k = torch.randn(n * seq * stride + offset, generator=g)
    flat_v = torch.randn(n * seq * stride + offset, generator=g)
    for flat in (flat_k, flat_v):
        rows = flat[offset:].view(n, seq, stride)
        for s, length in enumerate(lengths):
            rows[s, length:] = float("nan")
    flat_k, flat_v = flat_k.to(cuda), flat_v.to(cuda)
    k = flat_k[offset:].view(n, seq, stride)[..., :e]
    v = flat_v[offset:].view(n, seq, stride)[..., :e]
    assert fa.split_copies_vectorised(k, v, head_dim) == (
        head_dim % 4 == 0 and offset == 0 and row_pad % 4 == 0)
    q = torch.randn(n, 1, e, generator=g).to(cuda, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    c = fa.DECODE_COUNTER
    n0 = c.launches
    got = fa.flash_decode_attention(q, k, v, lens, num_heads=heads)
    torch.cuda.synchronize()
    assert c.launches == n0 + 1
    tol = _tol(dtype)
    for want in (fa.decode_attention_plain(q, k, v, lens, num_heads=heads),
                 fa.decode_split_model(q, k, v, lens, num_heads=heads,
                                       keys_per_split=kps)):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width", [1, 33, 1000, 1024, 4096, 8192, 12288])
def test_layer_norm_forward_kernel_widths(cuda, width, dtype):
    """K1 against its plain version at every kind of width: one column, an
    odd one (element loads), a warp a row, four warps a row, and passes
    past four warps' width; rows cut so that the persistent grid's row
    groups end unevenly. float16 is held at the bfloat16 tolerance (its
    outputs round to 11 bits)."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    rows = 1001 if width <= 4096 else 131
    g = torch.Generator().manual_seed(width)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(cuda, dtype)
    s = torch.randn(width, generator=g).to(cuda, dtype)
    b = torch.randn(width, generator=g).to(cuda, dtype)
    n0 = ln.LAYER_NORM_COUNTER.launches
    got = ln.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAYER_NORM_COUNTER.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    tol = _tol(torch.bfloat16 if dtype == torch.float16 else dtype)
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, s, b, 1e-5).float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scale_dtype,bias_dtype,width,row_stride", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 1024, 1032),  # vectors
    (torch.bfloat16, torch.float32, torch.bfloat16, 1024, 1030),   # elements
    (torch.float32, torch.float32, torch.float16, 2048, 2052),     # 4 warps
    (torch.float16, torch.float16, torch.float32, 5000, 5008),     # passes
])
def test_layer_norm_forward_kernel_reads_strided_rows(
        cuda, dtype, scale_dtype, bias_dtype, width, row_stride):
    """K1 on a row view of wider rows (the rows read in place, y written
    contiguous), with scale and bias each in its own dtype."""
    from flexflow_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator().manual_seed(row_stride)
    xs = (torch.randn(300, row_stride, generator=g) * 3 + 1).to(cuda, dtype)
    x = xs[:, 3:3 + width] if row_stride % 8 else xs[:, :width]
    s = torch.randn(width, generator=g).to(cuda, scale_dtype)
    b = torch.randn(width, generator=g).to(cuda, bias_dtype)
    got = ln.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    tol = _tol(torch.bfloat16 if dtype == torch.float16 else dtype)
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, s, b, 1e-5).float(),
                               **tol)


# ------------------------------------------------------------ captured steps

def _smoke_lm(monkeypatch, dtype="bf16", batch=2):
    """lm-smoke's widths (vocab 512, hidden 128, 2 layers, seq 128) with 2
    heads of 64 on the flash path, compiled for training (SGD with
    momentum, accuracy and CE metrics) and for serving at chunk 4: seed
    0, so two builds draw the same weights."""
    import dataclasses

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    monkeypatch.setattr(sys, "argv", ["test"])
    cfg = FFConfig()
    cfg.parse_args(["--dtype", dtype, "--seed", "0", "-b", str(batch),
                    "--serve-slots", "4", "--serve-prefill-chunk", "4",
                    "--serve-kv-block-size", "8"])
    ff = FFModel(cfg)
    lm = dataclasses.replace(TRANSFORMER_LM_ZOO["lm-smoke"], num_heads=2,
                             attention_impl="flash")
    build_transformer_lm(ff, lm, batch_size=batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY,
                        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff, lm


def _smoke_prompts(vocab):
    import numpy as np

    rs = np.random.RandomState(1)
    # chunks of 4, then of 2 twice (26 = 6 x 4 + 2, 6 = 4 + 2), then pure
    # decode: every width is called twice or more, so each is captured
    return [rs.randint(0, vocab, size=n).tolist() for n in (3, 9, 17, 40,
                                                            6, 26)]


def _smoke_batches(lm, batch, steps):
    import numpy as np

    rs = np.random.RandomState(2)
    n, s = batch * steps, lm.sequence_length
    x = {"tokens": rs.randint(0, lm.vocab_size, (n, s)).astype(np.int32),
         "positions": np.tile(np.arange(s, dtype=np.int32), (n, 1))}
    return x, rs.randint(0, lm.vocab_size, (n, s, 1)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_decode_streams_match_eager(cuda, monkeypatch, layout,
                                             dtype, temperature):
    """The decode step replayed from its CUDA graphs (q widths 1, 2 and 4)
    gives the eager step's token streams, greedy and sampled (the
    engine's generator registered with every graph advances as eager
    calls advance it); each bf16 copy of a master is cast once."""
    from flexflow_tpu_torch import executor

    ff, lm = _smoke_lm(monkeypatch, dtype)
    prompts = _smoke_prompts(lm.vocab_size)
    eng = ff.serve(kv_layout=layout, max_new_tokens=12)
    got = eng.generate(prompts, temperature=temperature)
    with executor.eager():
        want = ff.serve(kv_layout=layout, max_new_tokens=12).generate(
            prompts, temperature=temperature)
    assert got == want
    run = eng._step_fn.captured
    assert isinstance(run, executor.CapturedStep)
    assert run.captures == 3 and len(run._graphs) == 3  # widths 1, 2, 4
    floats = sum(1 for ws in eng.decode_model._params.values()
                 for w in ws.values() if w.is_floating_point())
    ex = eng.decode_model.executor
    assert ex.weight_refreshes == floats  # cast once each (bf16)


@pytest.mark.cuda
def test_captured_train_and_eval_steps_match_eager(cuda, monkeypatch):
    """Three train steps through fit (a warm-up, a capture, a replay) and
    an eval give the eager steps' masters, slots, metrics and eval
    metrics, bit for bit; the kernel counters count the same launches,
    by layout and variant."""
    from flexflow_tpu_torch import executor
    from flexflow_tpu_torch.kernels import counters, reset_counters

    runs = {}
    for mode in ("captured", "eager"):
        ff, lm = _smoke_lm(monkeypatch)
        x, y = _smoke_batches(lm, 2, 3)
        reset_counters()
        with (executor.eager() if mode == "eager"
              else contextlib.nullcontext()):
            ff.fit(x, y, epochs=1, batch_size=2, shuffle=False,
                   verbose=False)
            counts = {n: c.state() for n, c in counters().items()}
            ev = ff.eval(x, y, batch_size=2)
        torch.cuda.synchronize()
        runs[mode] = (ff, counts, ev)
    (a, ca, ea), (b, cb, eb) = runs["captured"], runs["eager"]
    assert isinstance(a.executor._train_step, executor.CapturedStep)
    assert a.executor._train_step.captures == 1
    assert ca == cb and ca["flash_attention_fwd"][0] == 3 * 2
    assert int(a._step) == int(b._step) == 3
    for n, ws in a._params.items():
        for k, t in ws.items():
            assert torch.equal(t, b._params[n][k]), f"{n}.{k}"
            assert torch.equal(a._opt_slots["v"][n][k],
                               b._opt_slots["v"][n][k]), f"v {n}.{k}"
    for k, t in a._counters.items():
        assert torch.equal(t, b._counters[k]), k
    assert ea._c == eb._c


@pytest.mark.cuda
def test_capture_that_reads_the_host_raises_and_runs_nothing(cuda,
                                                            monkeypatch):
    """A host read inside the step (`.item()` in the GELU op) passes the
    eager warm-up, then breaks the capture: the second step raises a
    CaptureError naming the line, and no step ran in its place."""
    from flexflow_tpu_torch import executor
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.ops.base import get_op_def

    ff, lm = _smoke_lm(monkeypatch)
    x, y = _smoke_batches(lm, 2, 1)
    gelu = get_op_def(OT.OP_GELU)
    plain = gelu.forward

    def reads_the_host(params, inputs, weights, state, ctx):
        if inputs[0].sum().item() == float("inf"):  # a host read
            raise AssertionError("unreachable")
        return plain(params, inputs, weights, state, ctx)

    monkeypatch.setattr(gelu, "forward", reads_the_host)
    ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
    after_one = {n: {k: t.clone() for k, t in ws.items()}
                 for n, ws in ff._params.items()}
    with pytest.raises(executor.CaptureError,
                       match=r"train_step: .*test_torch_cuda\.py:\d+ in "
                       r"reads_the_host"):
        ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
    assert int(ff._step) == 1
    for n, ws in after_one.items():
        for k, t in ws.items():
            assert torch.equal(ff._params[n][k], t), f"{n}.{k}"
    # the step runs op by op under eager()
    with executor.eager():
        ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
    assert int(ff._step) == 2


@pytest.mark.cuda
def test_captured_train_step_follows_new_tensors_and_rates(cuda,
                                                           monkeypatch):
    """A master replaced by `set_weight` (another tensor) makes the
    captured train step capture anew; a new learning rate drops the step
    (a constant of its graph). Either way the masters stay those of the
    eager steps, bit for bit."""
    import numpy as np

    from flexflow_tpu_torch import executor

    runs = {}
    for mode in ("captured", "eager"):
        ff, lm = _smoke_lm(monkeypatch)
        x, y = _smoke_batches(lm, 2, 3)
        ctx = executor.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            ff.fit(x, y, epochs=1, batch_size=2, shuffle=False,
                   verbose=False)
            w = np.random.RandomState(3).randn(
                *ff._params["lm_head"]["kernel"].shape).astype(np.float32)
            ff.set_weight("lm_head", "kernel", w)
            step = ff.executor._train_step
            ff.fit(x, y, epochs=1, batch_size=2, shuffle=False,
                   verbose=False)
            if mode == "captured":
                assert ff.executor._train_step is step
                assert step.captures == 2  # once, then anew for the tensor
            ff.set_learning_rate(0.01)
            assert ff.executor._train_step is None
            ff.fit(x, y, epochs=1, batch_size=2, shuffle=False,
                   verbose=False)
        torch.cuda.synchronize()
        runs[mode] = ff
    a, b = runs["captured"], runs["eager"]
    assert int(a._step) == int(b._step) == 9
    for n, ws in a._params.items():
        for k, t in ws.items():
            assert torch.equal(t, b._params[n][k]), f"{n}.{k}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_captured_decode_reads_the_recast_weights(cuda, monkeypatch,
                                                  layout):
    """`set_weight` on the decode model recasts that master into its
    cached bf16 copy's own storage, and the engine's decode graphs,
    captured before, read it: its streams equal a fresh engine's on a
    model with that weight, and differ from its first. A `fit` step on
    the trained model leaves the engine's weights (`adopt_params` copied
    them): the same streams, and a fresh engine's differ. No engine
    keeps prefixes across runs (`prefix_cache=False`), so each run
    prefills the same chunks as a fresh engine's first: a prefix read
    from the cache leaves other rows to prefill, whose bf16 KV may differ
    in the last bit, and a near tie then breaks the other way."""
    import numpy as np

    ff, lm = _smoke_lm(monkeypatch)
    prompts = _smoke_prompts(lm.vocab_size)
    kw = dict(kv_layout=layout, max_new_tokens=12, prefix_cache=False)
    eng = ff.serve(**kw)
    dec = eng.decode_model
    first = eng.generate(prompts)
    copies = dec.executor.compute_params(dec._params)
    head = np.random.RandomState(4).randn(
        *ff._params["lm_head"]["kernel"].shape).astype(np.float32)
    dec.set_weight("lm_head", "kernel", head)
    ff.set_weight("lm_head", "kernel", head)
    again = eng.generate(prompts)
    assert again == ff.serve(**kw).generate(prompts)
    assert again != first
    ff.set_learning_rate(2.0)
    x, y = _smoke_batches(lm, 2, 1)
    ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
    assert eng.generate(prompts) == again
    assert ff.serve(**kw).generate(prompts) != again
    recast = dec.executor.compute_params(dec._params)
    assert all(recast[n][k] is t for n, ws in copies.items()
               for k, t in ws.items())


# ------------------------------------------------------------ layer API


def _conv_bn_dropout_model(monkeypatch, rate=0.5):
    """conv -> batch_norm -> dropout -> pool -> dense -> softmax on the
    card, f32 activations, SGD; seeded weights."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    SGDOptimizer)
    from flexflow_tpu_torch.fftype import PoolType

    monkeypatch.setattr(sys, "argv", ["test", "--seed", "3"])
    ff = FFModel(FFConfig())
    x = ff.create_tensor((8, 3, 16, 16), name="input")
    t = ff.conv2d(x, 16, 3, 3, 1, 1, 1, 1, name="conv")
    t = ff.batch_norm(t, name="bn")
    t = ff.dropout(t, rate, name="drop")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX, name="pool")
    t = ff.flat(t, name="flat")
    t = ff.softmax(ff.dense(t, 10, name="fc"), name="softmax")
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


@pytest.mark.cuda
def test_captured_conv_bn_dropout_step_matches_eager(cuda, monkeypatch):
    """Four train steps through fit (a warm-up, a capture, two replays)
    against the same steps under eager(): BatchNorm's running statistics
    advance once per step, replays included (equal after every step in
    both modes); the model's generator, registered with the graph,
    advances on every replay, so each step draws a new dropout mask, and
    the same generator state gives the same masks in both modes (masters
    within 1e-5 of each layer's largest entry: cuDNN may choose other
    convolution algorithms inside a graph; another mask moves them by
    far more)."""
    import numpy as np

    from flexflow_tpu_torch import executor

    rs = np.random.RandomState(5)
    x = rs.randn(32, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, (32, 1)).astype(np.int32)
    runs = {}
    for mode in ("captured", "eager"):
        ff = _conv_bn_dropout_model(monkeypatch)
        stats, offsets = [], []
        step = ff.executor.build_train_step()

        def watched(*args):
            out = step(*args)
            stats.append(ff._state["bn"]["running_mean"].clone())
            offsets.append(ff._rng.get_offset())
            return out

        ff.executor._train_step = watched
        with (executor.eager() if mode == "eager"
              else contextlib.nullcontext()):
            ff.fit(x, y, epochs=1, batch_size=8, shuffle=False,
                   verbose=False)
        torch.cuda.synchronize()
        runs[mode] = (ff, stats, offsets, step)
    (a, sa, oa, step_a), (b, sb, ob, _) = runs["captured"], runs["eager"]
    assert isinstance(step_a, executor.CapturedStep) and step_a.captures == 1
    assert oa == ob and all(o2 > o1 for o1, o2 in zip(oa, oa[1:]))
    for i, (u, v) in enumerate(zip(sa, sb)):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6,
                                   msg=f"running mean after step {i + 1}")
    assert all(not torch.equal(u, v) for u, v in zip(sa, sa[1:]))
    for n, ws in b._params.items():
        scale = max(float(t.abs().max()) for t in ws.values())
        for k, t in ws.items():
            err = float((a._params[n][k] - t).abs().max())
            assert err <= 1e-5 * scale, f"{n}.{k}: {err}"


@pytest.mark.cuda
def test_captured_dropout_draws_a_new_mask_per_replay(cuda):
    """The dropout op inside a CapturedStep that holds the generator:
    every call (warm-up, capture + replay, replays) draws the mask an
    eager call would draw from the same generator state, and successive
    replays draw different masks."""
    from flexflow_tpu_torch import ops
    from flexflow_tpu_torch.executor import CapturedStep
    from flexflow_tpu_torch.fftype import OperatorType as OT

    op = ops.get_op_def(OT.OP_DROPOUT)
    p = ops.DropoutParams(0.5)

    def fn(x, gen):
        (y,), _ = op.forward(p, [x], {}, None,
                             ops.OpContext(training=True, rng=gen))
        return y * 1.0

    x = torch.ones(64, 128, device=cuda)
    step = CapturedStep("dropout", fn, cuda, held=(1,))
    g = torch.Generator(cuda).manual_seed(5)
    got = [step(x, g) for _ in range(5)]
    g2 = torch.Generator(cuda).manual_seed(5)
    want = [fn(x, g2) for _ in range(5)]
    assert step.captures == 1
    for i, (u, v) in enumerate(zip(got, want)):
        assert torch.equal(u, v), f"call {i + 1}"
    assert all(not torch.equal(u, v) for u, v in zip(got, got[1:]))
    assert g.get_offset() == g2.get_offset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_ties_on_card(cuda, dtype):
    """top_k on the card breaks ties by the lower index, as
    jax.lax.top_k does (the op's stable descending sort), rows of many
    equal values included."""
    from flexflow_tpu_torch import ops
    from flexflow_tpu_torch.fftype import OperatorType as OT

    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                      [5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                      [0.0, -1.0, 0.0, 2.0, 2.0, -1.0]], dtype=dtype)
    want = [[1, 2, 4, 3], [0, 1, 2, 3], [3, 4, 0, 2]]
    op = ops.get_op_def(OT.OP_TOPK)
    (v, i), _ = op.forward(ops.TopKParams(4), [x.to(cuda)], {}, None,
                           ops.OpContext())
    assert i.tolist() == want and i.dtype == torch.int32
    assert torch.equal(v.cpu(), torch.gather(x, 1, torch.tensor(want)))
    wide = torch.zeros(4, 5000, dtype=dtype, device=cuda)
    wide[:, 4000] = 1.0
    (v, i), _ = op.forward(ops.TopKParams(5), [wide], {}, None,
                           ops.OpContext())
    assert i.tolist() == [[4000, 0, 1, 2, 3]] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["POOL_MAX", "POOL_AVG"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool2d_pad_above_half_window_on_card(cuda, pool, dtype):
    """A pad above kernel // 2 (the JAX op's reduce_window takes any pad;
    the torch pools at most half the window): the op pads explicitly with
    -inf (max) or 0 (avg, the padding counted), on the card as on the
    CPU, forward and gradient."""
    from flexflow_tpu_torch import ops
    from flexflow_tpu_torch.fftype import OperatorType as OT, PoolType

    op = ops.get_op_def(OT.OP_POOL2D)
    p = ops.Pool2DParams(3, 3, 1, 1, 2, 2, getattr(PoolType, pool))
    g = torch.Generator().manual_seed(6)
    # distinct values in each plane, exact in bf16 (quarters up to 8): a
    # tie in a window would let the CPU and CUDA max pools route its
    # gradient to different entries
    x = torch.stack([torch.randperm(63, generator=g) for _ in range(8)])
    x = ((x.float() - 31.0) / 4).reshape(2, 4, 9, 7).to(dtype)
    cot = torch.randn(2, 4, 11, 9, generator=g).to(dtype)
    res = {}
    for dev in ("cpu", cuda):
        xi = x.detach().to(dev).requires_grad_(True)
        (y,), _ = op.forward(p, [xi], {}, None, ops.OpContext())
        y.backward(cot.to(dev))
        res[str(dev)] = (y.detach().float().cpu(), xi.grad.float().cpu())
    (yc, gc), (yg, gg) = res["cpu"], res[str(cuda)]
    assert yg.shape == (2, 4, 11, 9) and torch.isfinite(yg).all()
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(
        rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(yg, yc, **tol)
    torch.testing.assert_close(gg, gc, **tol)
    if pool == "POOL_AVG":  # a corner window holds one input entry of 9
        torch.testing.assert_close(yg[:, :, 0, 0], x[:, :, 0, 0].float() / 9,
                                   **tol)


# ------------------------------------------------------------ resilience


def _dropout_mlp(argv=()):
    """dense -> relu -> dropout -> dense -> softmax on the card, f32,
    SGD with momentum; seeded weights; dropout draws from the model's
    generator, which the captured steps hold."""
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                    SGDOptimizer)

    sys.argv = ["test", *argv]
    cfg = FFConfig(device="cuda")
    cfg.batch_size = 16
    ff = FFModel(cfg)
    x = ff.create_tensor((16, 64), name="x")
    t = ff.dense(x, 256, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dropout(t, 0.5, name="drop")
    t = ff.softmax(ff.dense(t, 10, name="fc2"), name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _dropout_data():
    import numpy as np

    rs = np.random.RandomState(7)
    return (rs.randn(128, 64).astype(np.float32),
            rs.randint(0, 10, (128, 1)).astype(np.int32))


def _state(ff) -> dict:
    from flexflow_tpu_torch.resilience.checkpointer import snapshot_to_host
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    return snapshot_to_host(model_state_tree(ff))


@pytest.mark.cuda
def test_captured_generator_takes_a_restored_state(cuda):
    """A generator a CUDA graph holds, set back to a saved state
    (`set_state`, as a checkpoint restore does), makes the next replays
    draw the masks they drew after that state, as `set_offset` does."""
    from flexflow_tpu_torch import ops
    from flexflow_tpu_torch.executor import CapturedStep
    from flexflow_tpu_torch.fftype import OperatorType as OT

    op = ops.get_op_def(OT.OP_DROPOUT)
    p = ops.DropoutParams(0.5)

    def fn(x, gen):
        (y,), _ = op.forward(p, [x], {}, None,
                             ops.OpContext(training=True, rng=gen))
        return y * 1.0

    x = torch.ones(64, 128, device=cuda)
    step = CapturedStep("dropout", fn, cuda, held=(1,))
    g = torch.Generator(cuda).manual_seed(5)
    for _ in range(3):  # warm-up, capture, replay
        step(x, g)
    saved, offset = g.get_state(), g.get_offset()
    first = [step(x, g) for _ in range(2)]
    g.set_state(saved)
    assert g.get_offset() == offset
    assert all(torch.equal(u, v) for u, v in zip(first, [
        step(x, g) for _ in range(2)]))
    g.set_offset(offset)
    assert all(torch.equal(u, v) for u, v in zip(first, [
        step(x, g) for _ in range(2)]))
    assert step.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline_steps", [4, 3])
def test_captured_chunks_draw_the_per_step_masks(cuda, pipeline_steps):
    """Two shuffled epochs of 8 batches per step and in chunks (each one
    CUDA graph of n steps holding the generator once): every master, slot,
    counter and the generator's state equal bit for bit; one capture per
    chunk length."""
    x, y = _dropout_data()
    runs = {}
    for n in (1, pipeline_steps):
        ff = _dropout_mlp()
        ff.fit(x, y, epochs=2, batch_size=16, verbose=False,
               pipeline_steps=n)
        torch.cuda.synchronize()
        runs[n] = ff
    a, b = _state(runs[1]), _state(runs[pipeline_steps])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    chunks = runs[pipeline_steps].executor._chunk_steps
    assert sorted(chunks) == ([4] if pipeline_steps == 4 else [2, 3])
    assert all(s.captures == 1 for s in chunks.values())


@pytest.mark.cuda
def test_restore_in_place_keeps_the_graphs_and_the_generator(cuda,
                                                            tmp_path):
    """Killed after step 6 (checkpoints every 4), the same model restored
    in place by --auto-resume: its captured step does not capture again,
    the generator the graph holds reaches the next replay with the
    restored offset, and the run ends bit-equal to the uninterrupted one
    (masters, slots, counters, generator). The kill waits for step 4's
    write first: a write still in flight at a kill is discarded, and this
    model's steps take less than a write."""
    from flexflow_tpu_torch.resilience import (
        CheckpointPolicy, SimulatedPreemption, latest_checkpoint)

    x, y = _dropout_data()
    ref = _dropout_mlp()
    ref.fit(x, y, epochs=2, batch_size=16, verbose=False)
    ff = _dropout_mlp(["--checkpoint-dir", str(tmp_path / "ck"),
                       "--checkpoint-every", "4"])

    def kill(step):
        if step == 6:
            ff._resilience.checkpointer.wait()
            raise SimulatedPreemption(step)

    ff.set_fault_hook(kill)
    with pytest.raises(SimulatedPreemption):
        ff.fit(x, y, epochs=2, batch_size=16, verbose=False)
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("00000004")
    step = ff.executor._train_step
    assert step.captures == 1
    ff.set_fault_hook(None)
    ff._resilience.policy = CheckpointPolicy()
    ff.config.auto_resume, ff._auto_resumed = True, False
    ff.fit(x, y, epochs=2, batch_size=16, verbose=False)
    torch.cuda.synchronize()
    assert ff._resilience.last_restore_s is not None
    assert ff.executor._train_step is step and step.captures == 1
    a, b = _state(ref), _state(ff)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------ observability on the card

@pytest.mark.cuda
@pytest.mark.parametrize("pipeline_steps", [1, 4])
@pytest.mark.parametrize("phase", ["fwd", "bwd"])
def test_sanitizer_table_inside_captured_steps_and_chunks(cuda, phase,
                                                          pipeline_steps):
    """--sanitize-numerics on the card: the probes fold into the device
    table inside the captured step (a NaN planted at step 2, a replay)
    and inside a chunk's graph (at step 6, in the second chunk of 4,
    which captures and replays), which names (op, phase, step); the
    masters, slots and
    generator with probes on and no fault equal those with them off."""
    from flexflow_tpu_torch import sanitize

    x, y = _dropout_data()
    x = x[:96] if pipeline_steps == 1 else x
    y = y[:96] if pipeline_steps == 1 else y
    fault = 2 if pipeline_steps == 1 else 6
    states = []
    for on in (False, True):
        ff = _dropout_mlp(["--sanitize-numerics"] if on else [])
        ff.fit(x, y, epochs=1, batch_size=16, verbose=False,
               pipeline_steps=pipeline_steps)
        torch.cuda.synchronize()
        states.append(_state(ff))
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    ff = _dropout_mlp(["--sanitize-numerics"])
    ff.executor.set_numeric_fault("fc1", phase, fault)
    sanitize.get_monitor().reset()
    ff.fit(x, y, epochs=1, batch_size=16, verbose=False,
           pipeline_steps=pipeline_steps)
    torch.cuda.synchronize()
    info = sanitize.get_monitor().first_nonfinite()
    assert (info["op"], info["phase"], info["step"]) == ("fc1", phase,
                                                         fault)
    steps = (ff.executor._chunk_steps if pipeline_steps > 1
             else {1: ff.executor._train_step})
    assert all(s.captures == 1 for s in steps.values())


@pytest.mark.cuda
def test_profile_every_attributes_a_captured_fit_eagerly(cuda, tmp_path):
    """--profile-every 3 on a captured fit: the sampled steps run eagerly
    under torch.profiler (a replay's kernels have no host range), the
    report's profile section attributes the card's kernels to the ops
    (forward and backward) and satisfies its identity; the train step
    captured once, and the run bit-equal to the unprofiled one."""
    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.scope.attribution import verify_profile_section

    x, y = _dropout_data()
    ref = _dropout_mlp()
    ref.fit(x, y, epochs=1, batch_size=16, verbose=False)
    tdir = tmp_path / "t"
    ff = _dropout_mlp(["--telemetry-dir", str(tdir), "--diagnostics",
                       "--profile-every", "3"])
    ff.fit(x, y, epochs=1, batch_size=16, verbose=False)
    torch.cuda.synchronize()
    telemetry.deactivate()
    import json

    prof = json.load(open(tdir / "strategy_report.json"))["profile"]
    assert prof["step"] == 6 and prof["mode"] == "eager_sampled"
    assert verify_profile_section(prof) == []
    rows = {r["name"]: r for r in prof["ops"]}
    assert rows["fc1"]["fwd_s"] > 0 and rows["fc1"]["bwd_s"] > 0
    share = prof["attributed_s"] / (prof["attributed_s"]
                                    + prof["unattributed_s"])
    assert share > 0.5, share
    assert ff.executor._train_step.captures == 1
    a, b = _state(ref), _state(ff)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_recompile_alter_captures_once_more(cuda):
    """RecompileState.alter() drops the captured step with its graph: the
    next fit captures exactly one more signature, and the trajectory is
    bit-equal to a run that never recompiled."""
    from flexflow_tpu_torch.recompile import RecompileState

    x, y = _dropout_data()
    ref = _dropout_mlp()
    for _ in range(2):
        ref.fit(x, y, epochs=1, batch_size=16, verbose=False)
    ff = _dropout_mlp()
    ff.fit(x, y, epochs=1, batch_size=16, verbose=False)
    first = ff.executor._train_step
    RecompileState(lambda m: True, lambda m: None, ff).alter()
    ff.fit(x, y, epochs=1, batch_size=16, verbose=False)
    torch.cuda.synchronize()
    second = ff.executor._train_step
    assert second is not first
    assert first.captures == 1 and second.captures == 1
    a, b = _state(ref), _state(ff)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_graph_in_a_dropped_cycle_survives_a_later_capture(cuda):
    """C5: a captured step left in a reference cycle (as an aborted
    model's is) and dropped just before a second step's capture, which
    allocates enough Python objects to make the cyclic collector due:
    the capture succeeds and its replays are right (a graph reset inside
    a capture is forbidden and invalidates it); a collection after it
    frees the dropped step."""
    import gc
    import weakref

    from flexflow_tpu_torch.executor import CapturedStep

    x = torch.ones(256, device=cuda)
    old = CapturedStep("old", lambda t: t * 2.0, cuda, held=())
    for _ in range(3):
        old(x)
    assert old.captures == 1
    keep = []

    def allocating(t):
        keep.append([[] for _ in range(300_000)])  # collections due
        return t + 1.0

    new = CapturedStep("new", allocating, cuda, held=())
    first = new(x)  # the warm-up, eager
    gc.collect()
    cycle = [old]
    cycle.append(cycle)
    dropped = weakref.ref(old)
    del old, cycle
    outs = [first] + [new(x) for _ in range(2)]  # capture, then replay
    assert new.captures == 1
    assert all(torch.equal(o, x + 1.0) for o in outs)
    gc.collect()
    assert dropped() is None


def _decoding_engine(monkeypatch):
    """lm-smoke (2 heads, f32) served paged with every slot decoding."""
    ff, lm = _smoke_lm(monkeypatch, "fp32")
    eng = ff.serve(kv_layout="paged", max_new_tokens=32)
    for p in _smoke_prompts(lm.vocab_size)[:4]:
        eng.submit(p)
    while not all(s.decoding for s in eng.scheduler.slots):
        eng.step()
    return eng, lm


@pytest.mark.cuda
def test_captured_verify_step_matches_eager_at_two_widths(cuda,
                                                         monkeypatch):
    """The speculative verify step (`Executor.build_verify_step`) at q = 2
    and q = 4: warm-up, capture and replay from one KV state give the
    eager call's (slots, q) argmax and KV rows bit for bit, one graph a
    width in the decode step's pool."""
    import numpy as np

    from flexflow_tpu_torch import executor

    eng, lm = _decoding_engine(monkeypatch)
    dec = eng.decode_model
    vf = dec.executor.build_verify_step()
    lengths = np.asarray([s.length for s in eng.scheduler.slots])
    # the blocks the widest call writes, allocated as the engine does
    # before a verify (else a row lands in the shared scratch block)
    eng._prepare_writes({i: range(int(n), int(n) + 4)
                         for i, n in enumerate(lengths)})
    start = {n: {k: v.clone() for k, v in ws.items()}
             for n, ws in dec._state.items()}

    def restore():
        for n, ws in dec._state.items():
            for k, v in ws.items():
                v.copy_(start[n][k])

    rs = np.random.RandomState(3)
    for q in (2, 4):
        tokens = rs.randint(0, lm.vocab_size, (4, q)).astype(np.int32)
        positions = (lengths[:, None] + np.arange(q)).astype(np.int32)
        xs = dec.executor.host_inputs(eng._feed(tokens, positions))
        with executor.eager():
            restore()
            _, want = vf(dec._params, dec._state, xs)
            want_kv = {n: {k: v.clone() for k, v in ws.items()}
                       for n, ws in dec._state.items()}
        for _ in range(3):  # warm-up, capture + replay, replay
            restore()
            _, got = vf(dec._params, dec._state, xs)
            assert torch.equal(got.cpu(), want.cpu()) and got.shape == (4, q)
            for n, ws in dec._state.items():
                for k, v in ws.items():
                    assert torch.equal(v, want_kv[n][k]), (q, n, k)
    run = vf.captured
    assert run.captures == 2 and len(run._graphs) == 2
    assert run.pool is eng._step_fn.captured.pool


@pytest.mark.cuda
def test_kv_inject_pads_to_power_of_two_buckets(cuda, monkeypatch):
    """The handoff's landing (`_inject_rows`): 3 blocks land in a bucket
    of 4 and 5 in one of 8, the pad pairs writing zeros to the scratch
    block only; each bucket's second call is a captured replay."""
    from flexflow_tpu_torch.serving.paged import SCRATCH_BLOCK

    eng, lm = _decoding_engine(monkeypatch)
    dec = eng.decode_model
    layers = eng.kv_pool_layers()
    pool = dec._state[layers[0]]["pool_k"]
    shape = (len(layers), 0) + tuple(pool.shape[1:])
    gen = torch.Generator(device=cuda).manual_seed(4)
    free = [b for b in range(1, pool.shape[0])
            if b not in {x for s in range(4) for x in
                         eng.block_manager.table(s)}]
    for n in (3, 3, 5, 5):
        blocks = free[:n]
        rk = torch.rand(shape[:1] + (n,) + shape[2:], generator=gen,
                        device=cuda)
        rv = torch.rand(rk.shape, generator=gen, device=cuda)
        eng._inject_rows(blocks, rk, rv)
        for i, name in enumerate(layers):
            st = dec._state[name]
            assert torch.equal(st["pool_k"][blocks], rk[i])
            assert torch.equal(st["pool_v"][blocks], rv[i])
            assert not st["pool_k"][SCRATCH_BLOCK].any()
    run = eng._inject_fn.captured
    assert run.captures == 2 and len(run._graphs) == 2  # buckets 4 and 8
