"""The launch geometry of K2 and K3 (the split-K decode kernel, contiguous
and paged) and of K1 and K4 (the LayerNorm forward and backward kernels),
on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions); the shapes they launch are plain Python:
`decode_split_geometry` and `paged_decode_geometry` split each slot's S or
W * bs logical keys into runs that fit the kernel's shared memory, from
shapes alone (the lengths are never read on the host), and
`layer_norm_fwd_geometry` / `layer_norm_bwd_geometry` pick warps per row,
elements per thread and the persistent grid from (n, d, SM count). This
file imports no JAX.
"""

import math

import numpy as np

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import layer_norm as ln
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# csrc/decode_attention.cu: kMaxSplitKeys, kMaxSplitFloats, 128 threads
MAX_SPLIT_KEYS, MAX_SPLIT_FLOATS, SPLIT_THREADS = 64, 4096, 128


@settings(max_examples=200, deadline=None)
@given(slots=st.integers(1, 64), heads=st.integers(1, 64),
       W=st.integers(1, 12288), bs=st.integers(1, 300),
       hd=st.integers(1, 256))
def test_paged_split_geometry_fits_the_kernel(slots, heads, W, bs, hd):
    """Every key lies in exactly one split (the fewest splits that cover
    W * bs keys), a split fits the kernel's shared memory, its live pages
    fit one thread each, and whole pages make a split where a page is no
    wider than the split limit."""
    g = fa.paged_decode_geometry(slots, heads, W, bs, hd)
    kps = g.keys_per_split
    assert 1 <= kps <= MAX_SPLIT_KEYS and kps * hd <= MAX_SPLIT_FLOATS
    assert g.splits == math.ceil(W * bs / kps)
    assert (g.splits - 1) * kps < W * bs <= g.splits * kps
    rows = min(32, 2048 // hd)  # 16 KB of K and V at most
    if bs <= rows:
        assert kps % bs == 0 and kps + bs > rows
    else:
        assert kps == rows
    # pages a split touches: at most kps (bs >= 1), one thread each
    assert kps // bs + 2 <= SPLIT_THREADS
    assert g.grid == (g.splits, heads, slots)
    assert g.scratch_shape == (slots, heads, g.splits, hd + 2)
    assert g.tickets == slots * heads


def test_paged_split_geometry_at_lm_base_serving():
    """lm-base serving (8 slots, 16 heads of 64, 32 pages of 16): splits
    of 2 pages; at chip_smoke's phase-8 lengths, 42 live splits a head
    (the rest exit at once) in place of one CTA per (slot, head)."""
    import chip_smoke

    g = fa.paged_decode_geometry(8, 16, 32, 16, 64)
    assert (g.keys_per_split, g.splits, g.grid) == (32, 16, (16, 16, 8))
    live = sum(math.ceil(n / g.keys_per_split) for n in chip_smoke.LENGTHS)
    assert live == 42


@pytest.mark.parametrize("hd,bs,kps", [
    (64, 16, 32), (128, 16, 16), (256, 16, 8), (80, 16, 16),
    (64, 5, 30), (64, 128, 32), (256, 100, 8), (32, 48, 32), (32, 7, 28)])
def test_paged_split_sizes(hd, bs, kps):
    assert fa.paged_decode_geometry(2, 2, 8, bs, hd).keys_per_split == kps


def test_paged_split_geometry_refuses_what_the_kernel_does_not_take():
    for bad in ((0, 1, 1, 1, 64), (1, 1, 0, 16, 64), (1, 1, 1, 16, 257)):
        with pytest.raises(ValueError):
            fa.paged_decode_geometry(*bad)


def _split_args_ok(g: fa.DecodeSplitGeometry, extent: int, hd: int) -> bool:
    """The entries' own check (csrc/decode_attention.cu, split_args_ok)."""
    kps = g.keys_per_split
    covered = g.splits * kps
    return (1 <= hd <= 256 and 1 <= kps <= MAX_SPLIT_KEYS
            and kps * hd <= MAX_SPLIT_FLOATS
            and extent <= covered <= 2 ** 31 - 1)


@settings(max_examples=200, deadline=None)
@given(slots=st.integers(1, 64), heads=st.integers(1, 64),
       S=st.integers(1, 20000), hd=st.integers(1, 256))
def test_contiguous_split_geometry_fits_the_kernel(slots, heads, S, hd):
    """K2's splits: runs of min(32, 2048 // hd) keys (the last one short
    where S is no multiple of it), the fewest that cover the S keys, each
    key in exactly one split, and a split the kernel takes."""
    g = fa.decode_split_geometry(slots, heads, S, hd)
    kps = g.keys_per_split
    assert kps == min(32, 2048 // hd)
    assert g.splits == math.ceil(S / kps)
    starts = np.arange(g.splits) * kps
    ends = np.minimum(starts + kps, S)
    assert (ends > starts).all()  # no split without a key of the cache
    keys = np.concatenate([np.arange(a, b) for a, b in zip(starts, ends)])
    assert np.array_equal(keys, np.arange(S))
    assert g.grid == (g.splits, heads, slots)
    assert g.scratch_shape == (slots, heads, g.splits, hd + 2)
    assert g.tickets == slots * heads
    assert _split_args_ok(g, S, hd)


def test_contiguous_split_geometry_at_lm_base_serving():
    """lm-base serving's contiguous cache (8 slots of 513 keys, 16 heads
    of 64): 17 splits of 32 keys, the last one holding one key; at
    chip_smoke's phase-8 lengths, as many live splits as on the paged
    layout. Where the partials' shapes agree, the two layouts share one
    scratch (the tickets are 0 between launches)."""
    import chip_smoke

    g = fa.decode_split_geometry(8, 16, chip_smoke.MAX_SEQ + 1, 64)
    assert (g.keys_per_split, g.splits, g.grid) == (32, 17, (17, 16, 8))
    assert chip_smoke.MAX_SEQ + 1 - (g.splits - 1) * g.keys_per_split == 1
    live = sum(math.ceil(n / g.keys_per_split) for n in chip_smoke.LENGTHS)
    assert live == 42
    paged = fa.paged_decode_geometry(8, 16, 32, 16, 64)
    assert g.keys_per_split == paged.keys_per_split
    assert fa.decode_split_geometry(8, 16, 512, 64) == paged


@pytest.mark.parametrize("bad", [(0, 1, 1, 64), (1, 0, 1, 64),
                                 (1, 1, 0, 64), (1, 1, 16, 0),
                                 (1, 1, 16, 257)])
def test_contiguous_split_geometry_refuses_what_the_kernel_does_not_take(
        bad):
    with pytest.raises(ValueError):
        fa.decode_split_geometry(*bad)


def test_split_copies_vectorised():
    """16-byte copies need head_dim, the cache's strides and both bases in
    whole 4-float units, on either layout."""
    cache = torch.empty(3, 513, 128)  # contiguous (slots, S, E)
    assert fa.split_copies_vectorised(cache, cache, 64)
    assert not fa.split_copies_vectorised(cache[:, :, 1:65], cache, 64)
    assert not fa.split_copies_vectorised(
        torch.empty(3, 513, 130)[..., :128], cache, 64)
    pool = torch.empty(5, 16, 128)
    assert fa.split_copies_vectorised(pool, pool, 64)
    assert not fa.split_copies_vectorised(pool, pool, 62)
    flat = torch.empty(5 * 16 * 128 + 1)
    shifted = flat[1:].view(5, 16, 128)
    assert not fa.split_copies_vectorised(shifted, pool, 64)
    assert not fa.split_copies_vectorised(pool, shifted, 64)
    odd = torch.empty(5, 16, 130)[..., :128]
    assert not fa.split_copies_vectorised(odd, odd, 64)


def _kernel_takes(g: ln.LayerNormBwdGeometry, n: int, d: int) -> bool:
    """The entry's own check (csrc/layer_norm.cu, ff_layer_norm_bwd)."""
    if g.wide:
        return g.grid <= n
    return (d <= 32 * g.warps_per_row * g.ept
            and g.grid <= (n + 3) // 4 * g.warps_per_row)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 20000), d=st.integers(1, 20000),
       itemsize=st.sampled_from([2, 4]), sms=st.integers(1, 200),
       per_sm=st.integers(1, 8))
def test_layer_norm_bwd_geometry_fits_the_kernel(n, d, itemsize, sms,
                                                 per_sm):
    g = ln.layer_norm_bwd_geometry(n, d, itemsize, sms, per_sm)
    assert g.ept == (32 if itemsize == 2 else 16)
    assert g.warps_per_row == (1 if d <= 32 * g.ept else 4)
    assert g.wide == (d > 128 * g.ept)
    assert g.wide or d <= 32 * g.warps_per_row * g.ept  # a row in registers
    assert g.rows_in_flight * g.warps_per_row == 4  # 4 warps a CTA
    assert 1 <= g.grid <= sms * per_sm
    # no CTA without a row, and no more CTAs than the card holds at once
    assert g.grid == min(sms * per_sm, math.ceil(n / g.rows_in_flight))
    assert g.part_shape == (g.grid, 2, d)
    assert _kernel_takes(g, n, d)


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 3000), d=st.sampled_from([64, 1024, 2048, 5000]),
       sms=st.integers(1, 40), per_sm=st.integers(1, 4))
def test_layer_norm_bwd_rows_are_covered_once(n, d, sms, per_sm):
    """Row group g of CTA b takes rows b * G + g, then every grid * G
    rows on: each row exactly once."""
    g = ln.layer_norm_bwd_geometry(n, d, 2, sms, per_sm)
    G = g.rows_in_flight
    seen = []
    for b in range(g.grid):
        for grp in range(G):
            seen.extend(range(b * G + grp, n, g.grid * G))
    assert sorted(seen) == list(range(n))


def test_layer_norm_bwd_geometry_at_the_zoo_widths():
    """lm-base's (4096, 1024) and lm-xxl-fsdp's (8192, 4096) bf16 rows on
    132 SMs holding 2 CTAs each: a warp a row, then four."""
    base = ln.layer_norm_bwd_geometry(4096, 1024, 2, 132, 2)
    assert (base.warps_per_row, base.ept, base.wide, base.grid) == (
        1, 32, False, 264)
    xxl = ln.layer_norm_bwd_geometry(8192, 4096, 2, 132, 2)
    assert (xxl.warps_per_row, xxl.wide, xxl.grid) == (4, False, 264)
    f32 = ln.layer_norm_bwd_geometry(4096, 1024, 4, 132, 2)
    assert (f32.warps_per_row, f32.ept, f32.wide) == (4, 16, False)
    wide = ln.layer_norm_bwd_geometry(5, 10000, 4, 132, 2)
    assert (wide.wide, wide.warps_per_row, wide.grid) == (True, 4, 5)
    one = ln.layer_norm_bwd_geometry(1, 64, 2, 132, 2)
    assert (one.warps_per_row, one.grid) == (1, 1)


def test_layer_norm_bwd_geometry_refuses_empty_shapes():
    with pytest.raises(ValueError):
        ln.layer_norm_bwd_geometry(0, 64, 2, 132, 2)


def _fwd_instantiated(itemsize: int) -> set:
    """(warps a row, ept, wide) of K1's instantiations (csrc/layer_norm.cu,
    pick_fwd): V = one 16-byte vector, E = 4 V."""
    v = 16 // itemsize
    e = 4 * v
    return ({(1, v, False), (4, v, False), (4, 2 * v, False), (4, e, False),
             (1, e, False)} | {(4, e, True), (1, e, True)})


def _fwd_kernel_takes(g: ln.LayerNormFwdGeometry, d: int,
                      itemsize: int) -> bool:
    """The entry's own check (csrc/layer_norm.cu, ff_layer_norm_fwd)."""
    return (g.grid >= 1
            and (g.warps_per_row, g.ept, g.wide) in _fwd_instantiated(itemsize)
            and (g.wide or d <= 32 * g.warps_per_row * g.ept))


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 20000), d=st.integers(1, 20000),
       itemsize=st.sampled_from([2, 4]), sms=st.integers(1, 200),
       per_sm=st.integers(1, 16))
def test_layer_norm_fwd_geometry_fits_the_kernel(n, d, itemsize, sms,
                                                 per_sm):
    """K1: a thread holds the fewest elements, in whole 16-byte vectors,
    that four warps need for the row (at most four vectors); a warp a row
    where it alone holds the row, passes past four warps of four vectors;
    as many CTAs as the card holds at once, and none without a row."""
    g = ln.layer_norm_fwd_geometry(n, d, itemsize, sms, per_sm)
    v = 16 // itemsize
    assert g.ept in (v, 2 * v, 4 * v)
    assert g.wide == (d > 128 * 4 * v)
    if not g.wide:
        assert 128 * g.ept >= d and (g.ept == v or 64 * g.ept < d)
    assert g.warps_per_row == (1 if d <= 32 * g.ept else 4)
    assert g.rows_in_flight * g.warps_per_row == 4  # 4 warps a CTA
    assert g.grid == min(sms * per_sm, math.ceil(n / g.rows_in_flight))
    assert _fwd_kernel_takes(g, d, itemsize)


@pytest.mark.parametrize("n,d,itemsize,wpr,ept,wide", [
    (4096, 1024, 2, 4, 8, False),    # lm-base's rows: four warps of 8
    (8192, 4096, 2, 4, 32, False),   # lm-xxl-fsdp's: four warps of 32
    (8192, 4096, 4, 4, 16, True),    # f32 past four warps' width: passes
    (3000, 12288, 2, 4, 32, True),   # bf16 past four warps' width: passes
    (777, 1, 2, 1, 8, False),        # a width of one
    (50, 1500, 4, 4, 16, False),     # f32, two vectors a thread
])
@pytest.mark.parametrize("sms,per_sm", [(132, 9), (132, 1), (7, 3)])
def test_layer_norm_fwd_rows_are_covered_once(n, d, itemsize, wpr, ept,
                                              wide, sms, per_sm):
    """Row group g of CTA b takes rows b * G + g, then every grid * G rows
    on (both kernels): each row exactly once, at the zoo widths and past
    the four-warp width."""
    g = ln.layer_norm_fwd_geometry(n, d, itemsize, sms, per_sm)
    assert (g.warps_per_row, g.ept, g.wide) == (wpr, ept, wide)
    G = g.rows_in_flight
    rows = np.concatenate([np.arange(b * G + grp, n, g.grid * G)
                           for b in range(g.grid) for grp in range(G)])
    assert np.array_equal(np.sort(rows), np.arange(n))


def test_layer_norm_fwd_geometry_refuses_empty_shapes():
    for bad in ((0, 64, 2, 132, 2), (8, 0, 2, 132, 2), (8, 64, 2, 0, 2)):
        with pytest.raises(ValueError):
            ln.layer_norm_fwd_geometry(*bad)


@pytest.mark.parametrize("dtype,width,stride,offset,want", [
    (torch.bfloat16, 1024, 1024, 0, True),
    (torch.bfloat16, 1001, 1001, 0, False),   # width: no 16-byte vectors
    (torch.float32, 1024, 1030, 0, False),    # row stride
    (torch.float32, 1024, 1024, 1, False),    # base past a 16-byte line
    (torch.float16, 40, 48, 0, True),
])
def test_layer_norm_bwd_vectorised(dtype, width, stride, offset, want):
    flat = torch.empty(8 * stride + offset, dtype=dtype)
    x = flat[offset:].view(8, stride)[:, :width]
    dy = torch.empty(8, width, dtype=dtype)
    assert ln._vectorised(x.element_size(), width, x, dy) == want
