"""The port's kernels on the card, each against its plain PyTorch version.

Needs an NVIDIA GPU (sm_90a for the CUDA kernels), nvcc and triton; skips
without a CUDA device. This file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

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
phase-2 shapes, and the entries' routing of causal s_q > s_k to sdpa_xla.
"""

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
    """A width that is no power of two (masked tail of the one block) and
    one past the single-block limit (the three-pass loop)."""
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
