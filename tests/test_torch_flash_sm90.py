"""Which kernel a CUDA launch of K5 or K7 takes, and the TMA geometry the
wgmma/TMA kernels (csrc/flash_attention_sm90.cu) are handed, on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions); what surrounds them is plain Python:
`flash_variant` picks "sm90" for bf16 at head_dim 64 or 128 whose layout
TMA takes (16-byte aligned base, outer strides positive multiples of 16
bytes in increasing order), "mma" for other bf16 shapes and "simt" for
float32; `tma_geometry` gives each operand's 4-D tensor map (dims and byte
strides innermost first, and the box), reading either layout where it
lies. This file imports no JAX.
"""

import pytest
import torch

from flexflow_tpu_torch.kernels import counters, reset_counters
from flexflow_tpu_torch.kernels import flash_attention as fa

BF16 = torch.bfloat16


def _packed(b, s, h, d, dtype=BF16):
    return torch.empty(b, s, h * d, dtype=dtype)


def _transposed(b, h, s, d, dtype=BF16):
    return torch.empty(b, h, s, d, dtype=dtype)


@pytest.mark.parametrize("name,make,heads,want", [
    # the zoo's paths: lm-base (16 heads of 64, s 512) and lm-xxl-fsdp (32
    # heads of 128, s 2048), batch cut to 1, both layouts
    ("lm-base packed", lambda: _packed(1, 512, 16, 64), 16, "sm90"),
    ("lm-base transposed", lambda: _transposed(1, 16, 512, 64), 16, "sm90"),
    ("lm-xxl packed", lambda: _packed(1, 2048, 32, 128), 32, "sm90"),
    ("lm-xxl transposed", lambda: _transposed(1, 32, 2048, 128), 32,
     "sm90"),
    ("ragged s", lambda: _packed(2, 130, 4, 64), 4, "sm90"),
    ("head_dim 32", lambda: _packed(2, 256, 4, 32), 4, "mma"),
    ("head_dim 80", lambda: _transposed(2, 3, 200, 80), 3, "mma"),
    # rows 1028 elements apart: not a multiple of 16 bytes
    ("odd row stride", lambda: torch.empty(2, 130, 1028, dtype=BF16)[
        ..., :1024], 16, "mma"),
    # the base one element past a 16-byte boundary
    ("unaligned base", lambda: torch.empty(2 * 130 * 256 + 1, dtype=BF16)[
        1:].view(2, 130, 256), 4, "mma"),
    # a (b, h, s, d) view whose head stride exceeds its batch stride
    ("heads outermost", lambda: torch.empty(4, 2, 130, 64, dtype=BF16)
     .transpose(0, 1), 4, "mma"),
    ("float32", lambda: _packed(2, 130, 4, 64, torch.float32), 4, "simt"),
    ("float32 head_dim 128", lambda: _transposed(1, 2, 256, 128,
                                                 torch.float32), 2, "simt"),
])
def test_variant_choice(name, make, heads, want):
    t = make()
    assert fa.flash_variant([t, t, t], heads) == want, name
    # K7 also loads dO: one operand TMA cannot take moves it off sm90
    if want == "sm90":
        odd = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        assert fa.flash_variant([t, t, t, odd], heads) == "mma"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [512, 130])
def test_tma_geometry_packed(s, d):
    """(b, s, h*d): dims (d, h, s, b), strides (d, h*d, s*h*d) elements
    as bytes, a box of 64 columns of `rows` rows of one head."""
    b, h = 3, 4
    t = _packed(b, s, h, d)
    for rows in (64, 128):
        dims, strides, box = fa.tma_geometry(t, h, rows)
        assert dims == (d, h, s, b)
        assert strides == (2 * d, 2 * h * d, 2 * s * h * d)
        assert box == (64, 1, rows, 1)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [512, 130])
def test_tma_geometry_transposed(s, d):
    """(b, h, s, d): dims (d, s, h, b), strides (d, s*d, h*s*d) elements
    as bytes, the box's rows on the second dim."""
    b, h = 3, 4
    t = _transposed(b, h, s, d)
    for rows in (64, 128):
        dims, strides, box = fa.tma_geometry(t, None, rows)
        assert dims == (d, s, h, b)
        assert strides == (2 * d, 2 * s * d, 2 * h * s * d)
        assert box == (64, rows, 1, 1)


def test_tma_geometry_of_a_head_view_of_packed_memory():
    """A (b, h, s, d) view of packed activations is read where it lies:
    its map is the packed one."""
    b, s, h, d = 2, 130, 4, 64
    x = _packed(b, s, h, d)
    view = x.view(b, s, h, d).transpose(1, 2)
    assert fa.tma_geometry(view, h, 128) == fa.tma_geometry(x, h, 128)
    assert fa.flash_variant([view] * 3, h) == "sm90"


def test_sm90_entry_points_box_rows():
    """The rows of each operand's box the C entry points expect: K5 loads
    q, k, v in 128-row tiles; K7 k, v in 128-key tiles and q, dO in 64-row
    stages."""
    assert fa._SM90_FNS["ff_flash_attention_fwd"] == (
        "ff_flash_attention_fwd_sm90", (128, 128, 128))
    assert fa._SM90_FNS["ff_flash_attention_bwd_dkv"] == (
        "ff_flash_attention_bwd_dkv_sm90", (64, 128, 128, 64))


def test_cpu_launches_count_no_variant():
    """On CPU tensors the wrappers take the plain versions: no launch, no
    variant counted, whatever variant the shape would take on the card."""
    reset_counters()
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 130, 128, generator=g).to(BF16)
                   for _ in range(4))
    assert fa.flash_variant([q, k, v, do], 2) == "sm90"
    out, lse = fa.flash_attention_fwd(q, k, v, num_heads=2, causal=True)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, fa.flash_delta(do, out, 2),
                               num_heads=2, causal=True)
    c = counters()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv"):
        assert c[name].launches == 0 and c[name].variants == {}, c[name]
        assert c[name].plain_calls == 1
