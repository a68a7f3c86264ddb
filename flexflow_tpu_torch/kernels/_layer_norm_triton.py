"""The Triton body of the fused LayerNorm forward (kernel K1); the backward
(K4) is CUDA C++, `csrc/layer_norm.cu`.

Imported only by the launchers in `layer_norm`, at their first launch: this module
imports `triton` at top level, which the CPU-only test machines do not have.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def layer_norm_fwd_kernel(x_ptr, s_ptr, b_ptr, y_ptr, n_cols, x_stride,
                          y_stride, eps, BLOCK: tl.constexpr,
                          SINGLE: tl.constexpr):
    # one program per row; f32 statistics, f32 affine, one cast at the store
    row = tl.program_id(0).to(tl.int64)
    x_row = x_ptr + row * x_stride
    y_row = y_ptr + row * y_stride
    if SINGLE:
        # the whole row in registers: one read of x, one write of y
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_row + cols, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(mask, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = xc * rstd * s + b
        tl.store(y_row + cols, y.to(y_ptr.dtype.element_ty), mask=mask)
    else:
        # rows wider than one block: three passes over the row (mean,
        # centred variance, normalise), the re-reads served from cache
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for off in range(0, n_cols, BLOCK):
            cols = off + tl.arange(0, BLOCK)
            acc += tl.load(x_row + cols, mask=cols < n_cols,
                           other=0.0).to(tl.float32)
        mean = tl.sum(acc, axis=0) / n_cols
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for off in range(0, n_cols, BLOCK):
            cols = off + tl.arange(0, BLOCK)
            mask = cols < n_cols
            x = tl.load(x_row + cols, mask=mask, other=0.0).to(tl.float32)
            xc = tl.where(mask, x - mean, 0.0)
            acc += xc * xc
        var = tl.sum(acc, axis=0) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        for off in range(0, n_cols, BLOCK):
            cols = off + tl.arange(0, BLOCK)
            mask = cols < n_cols
            x = tl.load(x_row + cols, mask=mask, other=0.0).to(tl.float32)
            s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * s + b
            tl.store(y_row + cols, y.to(y_ptr.dtype.element_ty), mask=mask)
