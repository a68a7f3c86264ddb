"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in the same module.

  K1 layer_norm.layer_norm               Triton  (TPU: layer_norm.py:_fwd_kernel)
  K2 flash_attention.flash_decode_attention        CUDA (TPU: _decode_kernel)
  K3 flash_attention.paged_flash_decode_attention  CUDA (TPU: _paged_decode_kernel)
  K4 layer_norm.layer_norm_bwd           Triton  (TPU: layer_norm.py:_bwd_kernel)
  K5 flash_attention.flash_attention_fwd     CUDA (TPU: _flash_kernel_grouped,
                                                    _flash_kernel)
  K6 flash_attention.flash_attention_bwd_dq  CUDA (TPU: _bwd_dq_kernel,
                                                    _bwd_dq_kernel_grouped)
  K7 flash_attention.flash_attention_bwd_dkv CUDA (TPU: _bwd_dkv_kernel,
                                                    _bwd_dkv_kernel_grouped)
  K8 flash_attention.flash_attention_bwd_fused
                                             CUDA (TPU: _bwd_single_tile_kernel)

K1 and K4 are the forward and backward of `layer_norm.fused_layer_norm`;
K5-K8 those of `flash_attention.flash_attention_packed`,
`flash_attention` and `flash_attention_with_lse` (all
`torch.autograd.Function`s).

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. Every wrapper counts its kernel
launches, and every plain version counts its calls, in a `KernelCounter`,
so a run can show which path the main path went through; the flash
kernels also count their launches by layout ("packed", "transposed").
"""

from __future__ import annotations


class KernelCounter:
    """Plain integer counts for one kernel: `launches` is bumped where the
    wrapper launches the kernel and nowhere else; `plain_calls` where the
    plain version runs."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.layouts: dict[str, int] = {}  # launches by tensor layout

    def launched(self, layout: str):
        """One launch, on tensors of `layout`."""
        self.launches += 1
        self.layouts[layout] = self.layouts.get(layout, 0) + 1

    def reset(self):
        self.launches = 0
        self.plain_calls = 0
        self.layouts = {}

    def __repr__(self):
        return (f"KernelCounter({self.name}, launches={self.launches}, "
                f"plain_calls={self.plain_calls}, layouts={self.layouts})")


def counters() -> dict[str, KernelCounter]:
    """The counters of every kernel of the port, by kernel name."""
    from .flash_attention import (
        DECODE_COUNTER,
        FLASH_BWD_DKV_COUNTER,
        FLASH_BWD_DQ_COUNTER,
        FLASH_BWD_FUSED_COUNTER,
        FLASH_FWD_COUNTER,
        PAGED_DECODE_COUNTER,
    )
    from .layer_norm import LAYER_NORM_BWD_COUNTER, LAYER_NORM_COUNTER

    return {c.name: c for c in (
        LAYER_NORM_COUNTER, DECODE_COUNTER, PAGED_DECODE_COUNTER,
        LAYER_NORM_BWD_COUNTER, FLASH_FWD_COUNTER, FLASH_BWD_DQ_COUNTER,
        FLASH_BWD_DKV_COUNTER, FLASH_BWD_FUSED_COUNTER)}


def reset_counters():
    for c in counters().values():
        c.reset()
