"""Fused LayerNorm forward: kernel K1 (Triton) and its plain version.

Replaces `flexflow_tpu/kernels/layer_norm.py:_fwd_kernel` (48), reached
through `fused_layer_norm_or_none` (140) -> `_fused_ln` (99) -> `_call_fwd`
(80). Semantics kept: row statistics in f32 (mean, then the variance of the
centred row), `rsqrt(var + eps)`, the affine in f32, one final cast to x's
dtype.

Bound on the H100: bytes. Per row of d elements it reads x once and writes
y once, ~8 flops per element, far below the tensor-core line; scale and
bias (2d values) stay in cache across rows. Design: one Triton program per
row, the whole row in registers when d <= 8192 (one HBM read + one write),
a three-pass loop over the row beyond that. The TPU kernel's Mosaic gates
(d % 128, rows divisible by an 8-aligned row block, `layer_norm.py:151-157`)
are tiling rules of the TPU, not semantics, and are dropped: on CUDA every
last-axis affine LayerNorm launches the kernel.
"""

from __future__ import annotations

import torch

from . import KernelCounter

LAYER_NORM_COUNTER = KernelCounter("layer_norm_fwd")

# rows up to this width are normalised in one register-resident block
_SINGLE_BLOCK_MAX = 8192


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Affine LayerNorm over the last axis of x. CPU tensors take the plain
    version; CUDA tensors launch K1."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    d = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (d,):
            raise ValueError(
                f"layer_norm: {name} must be ({d},) on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"layer_norm: unsupported dtype {x.dtype}")
    if x.numel() == 0:
        return torch.empty_like(x)
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    y2 = _launch(x2, scale.contiguous(), bias.contiguous(), eps)
    return y2.reshape(x.shape)
