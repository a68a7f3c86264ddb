"""The Triton bodies of the fused LayerNorm forward (kernel K1) and
backward (kernel K4).

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


@triton.jit
def layer_norm_bwd_kernel(x_ptr, s_ptr, dy_ptr, dx_ptr, ds_ptr, db_ptr,
                          n_rows, n_cols, x_stride, dy_stride, dx_stride, eps,
                          ROWS: tl.constexpr, BLOCK: tl.constexpr,
                          SINGLE: tl.constexpr):
    # one program per group of ROWS rows: per row it recomputes mean and
    # rstd in f32, writes dx, and adds dy*xhat and dy into this program's
    # row of the dscale/dbias partials (summed over programs outside)
    pid = tl.program_id(0)
    row0 = pid * ROWS
    if SINGLE:
        # the whole row in registers: one read of x and dy, one write of dx
        cols = tl.arange(0, BLOCK)
        cmask = cols < n_cols
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        ds_acc = tl.zeros((BLOCK,), dtype=tl.float32)
        db_acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for r in range(ROWS):
            row = (row0 + r).to(tl.int64)
            mask = cmask & (row < n_rows)  # rows past n read 0, add nothing
            x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                        other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + row * dy_stride + cols, mask=mask,
                         other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / n_cols
            xc = tl.where(cmask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / n_cols
            rstd = 1.0 / tl.sqrt(var + eps)
            xhat = xc * rstd
            dyh = dy * s
            m1 = tl.sum(dyh * xhat, axis=0) / n_cols
            m2 = tl.sum(dyh, axis=0) / n_cols
            dx = rstd * (dyh - m2 - xhat * m1)
            tl.store(dx_ptr + row * dx_stride + cols,
                     dx.to(dx_ptr.dtype.element_ty), mask=mask)
            ds_acc += dy * xhat
            db_acc += dy
        tl.store(ds_ptr + pid * n_cols + cols, ds_acc, mask=cmask)
        tl.store(db_ptr + pid * n_cols + cols, db_acc, mask=cmask)
    else:
        # rows wider than one block: per row, passes over the row for the
        # statistics, then one that writes dx and adds into the partials
        # (zeroed by the caller; only this program touches its partial row)
        for r in range(ROWS):
            row = (row0 + r).to(tl.int64)
            ok = row < n_rows
            acc = tl.zeros((BLOCK,), dtype=tl.float32)
            for off in range(0, n_cols, BLOCK):
                cols = off + tl.arange(0, BLOCK)
                acc += tl.load(x_ptr + row * x_stride + cols,
                               mask=(cols < n_cols) & ok,
                               other=0.0).to(tl.float32)
            mean = tl.sum(acc, axis=0) / n_cols
            acc = tl.zeros((BLOCK,), dtype=tl.float32)
            for off in range(0, n_cols, BLOCK):
                cols = off + tl.arange(0, BLOCK)
                mask = (cols < n_cols) & ok
                x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                xc = tl.where(mask, x - mean, 0.0)
                acc += xc * xc
            rstd = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / n_cols + eps)
            a1 = tl.zeros((BLOCK,), dtype=tl.float32)
            a2 = tl.zeros((BLOCK,), dtype=tl.float32)
            for off in range(0, n_cols, BLOCK):
                cols = off + tl.arange(0, BLOCK)
                mask = (cols < n_cols) & ok
                x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + row * dy_stride + cols, mask=mask,
                             other=0.0).to(tl.float32)
                s = tl.load(s_ptr + cols, mask=cols < n_cols,
                            other=0.0).to(tl.float32)
                xhat = tl.where(mask, (x - mean) * rstd, 0.0)
                dyh = dy * s
                a1 += dyh * xhat
                a2 += dyh
            m1 = tl.sum(a1, axis=0) / n_cols
            m2 = tl.sum(a2, axis=0) / n_cols
            for off in range(0, n_cols, BLOCK):
                cols = off + tl.arange(0, BLOCK)
                cmask = cols < n_cols
                mask = cmask & ok
                x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + row * dy_stride + cols, mask=mask,
                             other=0.0).to(tl.float32)
                s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
                xhat = tl.where(mask, (x - mean) * rstd, 0.0)
                dyh = dy * s
                dx = rstd * (dyh - m2 - xhat * m1)
                tl.store(dx_ptr + row * dx_stride + cols,
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                part = pid * n_cols + cols
                ds = tl.load(ds_ptr + part, mask=cmask, other=0.0)
                db = tl.load(db_ptr + part, mask=cmask, other=0.0)
                tl.store(ds_ptr + part, ds + dy * xhat, mask=cmask)
                tl.store(db_ptr + part, db + dy, mask=cmask)
