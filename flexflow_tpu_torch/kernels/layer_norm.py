"""Fused LayerNorm: the forward kernel K1 and the backward kernel K4 (CUDA
C++, `csrc/layer_norm.cu`), each beside its plain version, and the
`autograd.Function` that joins them.

K1 replaces `flexflow_tpu/kernels/layer_norm.py:_fwd_kernel` (48), reached
through `fused_layer_norm_or_none` (140) -> `_fused_ln` (99) -> `_call_fwd`
(80). Semantics kept: row statistics in f32 (mean, then the variance of the
centred row), `rsqrt(var + eps)`, the affine in f32, one final cast to x's
dtype.

K4 replaces `_bwd_kernel` (59), the backward of the `_fused_ln` custom VJP
(`_fused_ln_bwd`, 108; `pallas_call` at 113). It recomputes mean and rstd
from x in f32 rather than saving them, forms xhat and dyh = dy * scale,
writes dx = rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)) cast to x's
dtype, and dscale = sum dy * xhat and dbias = sum dy in f32, summed over
rows in a fixed order (per-CTA partial rows, then a column sum in CTA
order), as the TPU wrapper sums its row blocks (134). The Function hands
dscale and dbias back in scale's and bias's dtypes: under bf16 compute
those are the bf16 copies of the f32 masters, and the cast's backward
takes them up to f32 again, as in JAX.

Bound on the H100: bytes. K1 reads x once and writes y once; K4 reads x
and dy once and writes dx once (plus the small partials), ~8-20 flops per
element, far below the tensor-core line. Design (the source's header note
gives it in full): rows in registers, a warp or four a row (K4: a warp up
to 1024 bf16 / 512 f32 columns, four up to 4096 / 2048; K1: four warps of
the fewest elements a thread past 256 / 128), passes over wider rows, on
a persistent grid whose shape is `layer_norm_fwd_geometry` /
`layer_norm_bwd_geometry`; K1 keeps a thread's scale and bias in
registers across its rows. The TPU
kernels' Mosaic gates (d % 128, rows divisible by an 8-aligned row block,
`layer_norm.py:151-157`) and the 8-sublane broadcast of K4's partials
(72-77) are tiling rules of the TPU, not semantics, and are dropped: on
CUDA every last-axis affine LayerNorm launches K1 forward and K4
backward, at every width.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import KernelCounter

LAYER_NORM_COUNTER = KernelCounter("layer_norm_fwd")
LAYER_NORM_BWD_COUNTER = KernelCounter("layer_norm_bwd")

# the kernels' dtype codes (csrc/layer_norm.cu) and their threads a CTA
_LN_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 128


@dataclasses.dataclass(frozen=True)
class LayerNormFwdGeometry:
    """K1's launch shape: `warps_per_row` warps take a row, each thread
    `ept` of its elements a pass; a `wide` row takes passes of
    32 * warps_per_row * ept columns (else one, in registers); `grid` CTAs
    of 128 threads, each striding over rows `rows_in_flight` at a time."""

    warps_per_row: int
    ept: int
    wide: bool
    grid: int
    rows_in_flight: int


@dataclasses.dataclass(frozen=True)
class LayerNormBwdGeometry(LayerNormFwdGeometry):
    """K4's launch shape: K1's fields, and `part_shape`, the f32 partial
    rows of dscale and dbias, one per CTA."""

    part_shape: tuple[int, int, int]


def _grid(n: int, wpr: int, sms: int, ctas_per_sm: int) -> tuple[int, int]:
    """(CTAs, rows in flight a CTA): as many CTAs of 128 threads as the
    card holds at once, but no CTA without a row."""
    if n < 1 or sms < 1 or ctas_per_sm < 1:
        raise ValueError(f"layer_norm geometry: n={n} sms={sms} "
                         f"ctas_per_sm={ctas_per_sm}")
    in_flight = (_THREADS // 32) // wpr
    return max(1, min(sms * ctas_per_sm, -(-n // in_flight))), in_flight


@functools.lru_cache(maxsize=256)
def layer_norm_fwd_geometry(n: int, d: int, itemsize: int, sms: int,
                            ctas_per_sm: int) -> LayerNormFwdGeometry:
    """K1's geometry for n rows of width d of an `itemsize`-byte type on a
    card of `sms` SMs holding `ctas_per_sm` of its CTAs at once. A thread
    holds the fewest elements of a row, `ept`, that four warps need (one
    16-byte vector, 8 bf16 or 4 f32, at least; 32 bf16 or 16 f32 at
    most): a warp a row up to 32 ept columns, else four warps, and passes
    of 128 ept columns past 128 * 32 bf16 / 16 f32. (K4 keeps 32 / 16: at
    lm-base's width 1024 it takes a warp a row where K1 takes four warps
    of 8 bf16 a thread, which ran faster on the H100; `kernel_sweep.py`
    times both.)"""
    if d < 1:
        raise ValueError(f"layer_norm geometry: d={d}")
    ept = 16 // itemsize  # one vector
    while ept < min(-(-d // 128), 4 * (16 // itemsize)):
        ept *= 2
    wpr = 1 if d <= 32 * ept else 4
    grid, in_flight = _grid(n, wpr, sms, ctas_per_sm)
    return LayerNormFwdGeometry(wpr, ept, d > 32 * wpr * ept, grid,
                                in_flight)


@functools.lru_cache(maxsize=256)
def layer_norm_bwd_geometry(n: int, d: int, itemsize: int, sms: int,
                            ctas_per_sm: int) -> LayerNormBwdGeometry:
    """K4's geometry for n rows of width d of an `itemsize`-byte type on a
    card of `sms` SMs holding `ctas_per_sm` of its CTAs at once: a warp a
    row up to 32 ept columns, four up to 128 ept, then passes of 128 ept
    (ept: 32 for 2-byte types, 16 for f32); as many CTAs as the card holds
    at once, but no CTA without a row."""
    if d < 1:
        raise ValueError(f"layer_norm geometry: d={d}")
    ept = 32 if itemsize == 2 else 16
    wpr = 1 if d <= 32 * ept else 4
    grid, in_flight = _grid(n, wpr, sms, ctas_per_sm)
    return LayerNormBwdGeometry(wpr, ept, d > 32 * wpr * ept, grid,
                                in_flight, (grid, 2, d))


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version of K1 over the last axis: the CPU path and the
    kernel's numerics oracle on the card."""
    LAYER_NORM_COUNTER.plain_calls += 1
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         dy: torch.Tensor, eps: float):
    """Plain PyTorch version of K4 over the last axis: (dx in x's dtype,
    dscale f32, dbias f32)."""
    LAYER_NORM_BWD_COUNTER.plain_calls += 1
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dyh = dyf * scale.float()
    m1 = (dyh * xhat).mean(-1, keepdim=True)
    m2 = dyh.mean(-1, keepdim=True)
    dx = (rstd * (dyh - m2 - xhat * m1)).to(x.dtype).reshape(x.shape)
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


_SMS: dict[int, int] = {}
_OCCUPANCY: dict[tuple, int] = {}


def _library():
    from . import _build

    lib = _build.load("layer_norm")
    if lib.ff_layer_norm_bwd.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ff_layer_norm_fwd.argtypes = ([vp] * 4 + [cll, ci, cll, cll]
                                          + [ci] * 3 + [ctypes.c_float]
                                          + [ci] * 5 + [vp])
        lib.ff_layer_norm_bwd.argtypes = (
            [vp] * 7 + [cll, ci] + [cll] * 3 + [ci, ci, ctypes.c_float]
            + [ci] * 5 + [vp])
        for fn in (lib.ff_layer_norm_fwd_occupancy,
                   lib.ff_layer_norm_bwd_occupancy):
            fn.argtypes = [ci] * 5
        for fn in (lib.ff_layer_norm_fwd, lib.ff_layer_norm_bwd,
                   lib.ff_layer_norm_fwd_occupancy,
                   lib.ff_layer_norm_bwd_occupancy):
            fn.restype = ci
    return lib


def _persistent_geometry(kind: str, geometry, x2, vec: bool, lib):
    """`geometry(n, d, itemsize, sms, ctas_per_sm)` at the card's SM count
    and the CTAs of the chosen instantiation that fit on an SM, each read
    once per device (and instantiation)."""
    n, d = x2.shape
    dev = x2.device
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    geo = geometry(n, d, x2.element_size(), sms, 1)
    code = _LN_DTYPE_CODE[x2.dtype]
    key = (dev.index, kind, code, geo.warps_per_row, geo.ept, vec, geo.wide)
    per_sm = _OCCUPANCY.get(key)
    if per_sm is None:
        occupancy = getattr(lib, f"ff_layer_norm_{kind}_occupancy")
        per_sm = occupancy(code, geo.warps_per_row, geo.ept, int(vec),
                           int(geo.wide))
        if per_sm < 1:
            raise RuntimeError(f"layer_norm_{kind}: no occupancy for {key} "
                               f"(code {per_sm})")
        _OCCUPANCY[key] = per_sm
    return geometry(n, d, x2.element_size(), sms, per_sm)


def _vectorised(itemsize: int, d: int, *tensors) -> bool:
    """Whether K1 or K4 may move rows in 16-byte vectors: the width, every
    row stride and every base a multiple of 16 bytes."""
    per = 16 // itemsize
    return d % per == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % per == 0 for t in tensors)


def _launch_fwd(x2, scale, bias, eps):
    n, d = x2.shape
    dev = x2.device
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype not in _LN_DTYPE_CODE:
            raise TypeError(f"layer_norm: {name} must be float32, bfloat16 "
                            f"or float16 (got {t.dtype})")
    y2 = torch.empty_like(x2)
    lib = _library()
    # 16-byte vectors of x and y, and of scale and bias in their own types
    vec = (_vectorised(x2.element_size(), d, x2, y2)
           and scale.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        geo = _persistent_geometry("fwd", layer_norm_fwd_geometry, x2, vec,
                                   lib)
        rc = lib.ff_layer_norm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y2.data_ptr(),
            n, d, x2.stride(0), y2.stride(0), _LN_DTYPE_CODE[x2.dtype],
            _LN_DTYPE_CODE[scale.dtype], _LN_DTYPE_CODE[bias.dtype],
            float(eps), geo.warps_per_row, geo.ept, int(vec), int(geo.wide),
            geo.grid, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: code {rc}")
    LAYER_NORM_COUNTER.launches += 1
    return y2


def _launch_bwd(x2, scale, dy2, eps):
    n, d = x2.shape
    dev = x2.device
    if dy2.dtype != x2.dtype or scale.dtype not in _LN_DTYPE_CODE:
        raise TypeError(f"layer_norm_bwd: dy must be in x's dtype {x2.dtype} "
                        f"and scale float32, bfloat16 or float16 (got dy "
                        f"{dy2.dtype}, scale {scale.dtype})")
    dx2 = torch.empty_like(x2)
    lib = _library()
    code = _LN_DTYPE_CODE[x2.dtype]
    vec = _vectorised(x2.element_size(), d, x2, dy2, dx2)
    with torch.cuda.device(dev):
        geo = _persistent_geometry("bwd", layer_norm_bwd_geometry, x2, vec,
                                   lib)
        part = torch.empty(geo.part_shape, dtype=torch.float32, device=dev)
        ds, db = torch.empty((2, d), dtype=torch.float32, device=dev)
        rc = lib.ff_layer_norm_bwd(
            x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), dx2.data_ptr(),
            part.data_ptr(), ds.data_ptr(), db.data_ptr(), n, d,
            x2.stride(0), dy2.stride(0), dx2.stride(0), code,
            _LN_DTYPE_CODE[scale.dtype], float(eps), geo.warps_per_row,
            geo.ept, int(vec), int(geo.wide), geo.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: code {rc}")
    LAYER_NORM_BWD_COUNTER.launches += 1
    return dx2, ds, db


def _check_cuda(name, x, **params):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    d = x.shape[-1]
    for pname, t in params.items():
        shape = (d,) if pname in ("scale", "bias") else tuple(x.shape)
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {pname} must be {shape} on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Affine LayerNorm over the last axis of x. CPU tensors take the plain
    version; CUDA tensors launch K1. No gradient: `fused_layer_norm` is the
    differentiable entry point."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check_cuda("layer_norm", x, scale=scale, bias=bias)
    if x.numel() == 0:
        return torch.empty_like(x)
    y2 = _launch_fwd(_rows(x), scale.contiguous(), bias.contiguous(), eps)
    return y2.reshape(x.shape)


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float):
    """Gradients of the affine LayerNorm over the last axis: (dx in x's
    dtype, dscale f32, dbias f32). CPU tensors take the plain version;
    CUDA tensors launch K4."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, eps)
    _check_cuda("layer_norm_bwd", x, scale=scale, dy=dy)
    if x.numel() == 0:
        d = x.shape[-1]
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    dx2, ds, db = _launch_bwd(_rows(x), scale.contiguous(), _rows(dy), eps)
    return dx2.reshape(x.shape), ds, db


class _FusedLayerNorm(torch.autograd.Function):
    """The `_fused_ln` custom VJP: forward K1, backward K4 (their plain
    versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_bwd(x, scale, dy, ctx.eps)
        return dx, ds.to(scale.dtype), db.to(ctx.bias_dtype), None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Affine LayerNorm over the last axis, differentiable in x, scale and
    bias: K1 forward and K4 backward on CUDA, their plain versions on the
    CPU."""
    return _FusedLayerNorm.apply(x, scale, bias, float(eps))
