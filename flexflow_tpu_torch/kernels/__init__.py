"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in the same module.

  K1 layer_norm.layer_norm               Triton  (TPU: layer_norm.py:_fwd_kernel)
  K2 flash_attention.flash_decode_attention        CUDA (TPU: _decode_kernel)
  K3 flash_attention.paged_flash_decode_attention  CUDA (TPU: _paged_decode_kernel)

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. Every wrapper counts its kernel
launches, and every plain version counts its calls, in a `KernelCounter`,
so a run can show which path the main path went through.
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

    def reset(self):
        self.launches = 0
        self.plain_calls = 0

    def __repr__(self):
        return (f"KernelCounter({self.name}, launches={self.launches}, "
                f"plain_calls={self.plain_calls})")


def counters() -> dict[str, KernelCounter]:
    """The counters of every kernel of the port, by kernel name."""
    from .flash_attention import DECODE_COUNTER, PAGED_DECODE_COUNTER
    from .layer_norm import LAYER_NORM_COUNTER

    return {c.name: c for c in (LAYER_NORM_COUNTER, DECODE_COUNTER,
                                PAGED_DECODE_COUNTER)}


def reset_counters():
    for c in counters().values():
        c.reset()
