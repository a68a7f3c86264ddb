"""The launch geometry of K3 (the split-K paged decode kernel) and K4 (the
LayerNorm backward kernel), on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions); the shapes they launch are plain Python:
`paged_decode_geometry` splits each slot's W * bs logical keys into runs
that fit the kernel's shared memory, from shapes alone (the lengths are
never read on the host), and `layer_norm_bwd_geometry` picks warps per row,
elements per thread and the persistent grid from (n, d, SM count). This
file imports no JAX.
"""

import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import layer_norm as ln

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


def test_split_copies_vectorised():
    """16-byte copies need head_dim, the pool's strides and both bases in
    whole 4-float units."""
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
