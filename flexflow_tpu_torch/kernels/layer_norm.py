"""Fused LayerNorm: the forward kernel K1 and the backward kernel K4
(Triton), each beside its plain version, and the `autograd.Function` that
joins them.

K1 replaces `flexflow_tpu/kernels/layer_norm.py:_fwd_kernel` (48), reached
through `fused_layer_norm_or_none` (140) -> `_fused_ln` (99) -> `_call_fwd`
(80). Semantics kept: row statistics in f32 (mean, then the variance of the
centred row), `rsqrt(var + eps)`, the affine in f32, one final cast to x's
dtype.

K4 replaces `_bwd_kernel` (59), the backward of the `_fused_ln` custom VJP
(`_fused_ln_bwd`, 108; `pallas_call` at 113). It recomputes mean and rstd
from x in f32 rather than saving them, forms xhat and dyh = dy * scale,
writes dx = rstd * (dyh - mean(dyh) - xhat * mean(dyh * xhat)) cast to x's
dtype, and per-program partial dscale = sum dy * xhat and dbias = sum dy in
f32, summed over programs outside the kernel as the TPU wrapper sums its
row blocks (134). The Function hands dscale and dbias back in scale's and
bias's dtypes: under bf16 compute those are the bf16 copies of the f32
masters, and the cast's backward takes them up to f32 again, as in JAX.

Bound on the H100: bytes. K1 reads x once and writes y once; K4 reads x
and dy once and writes dx once (plus the small partials), ~8-20 flops per
element, far below the tensor-core line. Design: K1 is one Triton program
per row; K4 one program per 16 rows, accumulating its partials in
registers. Rows up to 8192 wide stay in registers (one HBM pass); wider
rows loop over the row (three passes for K1, four for K4, re-reads served
from cache). The TPU kernels' Mosaic gates (d % 128, rows divisible by an
8-aligned row block, `layer_norm.py:151-157`) and the 8-sublane broadcast
of K4's partials (72-77) are tiling rules of the TPU, not semantics, and
are dropped: on CUDA every last-axis affine LayerNorm launches K1 forward
and K4 backward.
"""

from __future__ import annotations

import torch

from . import KernelCounter

LAYER_NORM_COUNTER = KernelCounter("layer_norm_fwd")
LAYER_NORM_BWD_COUNTER = KernelCounter("layer_norm_bwd")

# rows up to this width are normalised in one register-resident block
_SINGLE_BLOCK_MAX = 8192
# rows per K4 program: its dscale/dbias partials are (n / 16, d) f32
_BWD_ROWS = 16


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


def _launch(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    import triton

    from ._layer_norm_triton import layer_norm_fwd_kernel

    n, d = x2.shape
    y2 = torch.empty_like(x2)
    single = d <= _SINGLE_BLOCK_MAX
    block = triton.next_power_of_2(d) if single else 4096
    num_warps = 4 if block <= 1024 else 8
    layer_norm_fwd_kernel[(n,)](
        x2, scale, bias, y2, d, x2.stride(0), y2.stride(0), float(eps),
        BLOCK=block, SINGLE=single, num_warps=num_warps)
    LAYER_NORM_COUNTER.launches += 1
    return y2


def _launch_bwd(x2, scale, dy2, eps):
    import triton

    from ._layer_norm_triton import layer_norm_bwd_kernel

    n, d = x2.shape
    dx2 = torch.empty_like(x2)
    single = d <= _SINGLE_BLOCK_MAX
    block = triton.next_power_of_2(d) if single else 4096
    progs = triton.cdiv(n, _BWD_ROWS)
    alloc = torch.empty if single else torch.zeros
    ds_part = alloc((progs, d), dtype=torch.float32, device=x2.device)
    db_part = alloc((progs, d), dtype=torch.float32, device=x2.device)
    layer_norm_bwd_kernel[(progs,)](
        x2, scale, dy2, dx2, ds_part, db_part, n, d, x2.stride(0),
        dy2.stride(0), dx2.stride(0), float(eps), ROWS=_BWD_ROWS,
        BLOCK=block, SINGLE=single, num_warps=4 if block <= 1024 else 8)
    LAYER_NORM_BWD_COUNTER.launches += 1
    return dx2, ds_part.sum(0), db_part.sum(0)


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
    y2 = _launch(_rows(x), scale.contiguous(), bias.contiguous(), eps)
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
