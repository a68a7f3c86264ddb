"""FFConfig: runtime configuration + CLI flag parsing (the port's slice).

The twin of `flexflow_tpu/config.py`, cut to the flags the serving slice
reads: `-b`, `--dtype`, `--seed`, the `--serve-*` flags and the
tensor-op math policy. Unknown flags are ignored, as the reference's
tolerant argv scan does. New here: `device`, the torch device every
tensor of a model lives on. It defaults to "cuda"; a run without a CUDA
device must ask for "cpu" explicitly (see `resolve_device`).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .fftype import CompMode, DataType


@dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 0
    computation_mode: CompMode = CompMode.COMP_MODE_TRAINING
    # Mixed precision. allow_tensor_op_math_conversion is the reference's
    # cublas tensor-op flag: fp32 matmul *inputs* are cast to bf16 with
    # fp32 accumulation. It applies on CUDA, as the JAX package applies it
    # on the TPU. computation_dtype=DT_BFLOAT16 is the full policy: bf16
    # activations with fp32 master weights and fp32 KV state.
    allow_tensor_op_math_conversion: bool = True
    computation_dtype: Optional[DataType] = None  # None -> fp32 activations
    # torch device of every parameter, state and activation tensor
    device: str = "cuda"
    # serving engine defaults for model.serve()
    serve_slots: int = 4
    serve_max_seq_len: int = 0
    serve_prefill_chunk: int = 16
    serve_kv_layout: str = "paged"
    serve_kv_block_size: int = 16
    serve_kv_blocks: int = 0
    serve_prefix_cache: int = 1

    def __post_init__(self):
        self.parse_args(sys.argv[1:])

    def parse_args(self, argv: list[str]):
        i = 0
        while i < len(argv):
            a = argv[i]

            def val():
                nonlocal i
                i += 1
                return argv[i]

            if a in ("-b", "--batch-size"):
                self.batch_size = int(val())
            elif a == "--seed":
                self.seed = int(val())
            elif a == "--device":
                self.device = val()
            elif a == "--serve-slots":
                self.serve_slots = int(val())
            elif a == "--serve-max-seq":
                self.serve_max_seq_len = int(val())
            elif a == "--serve-prefill-chunk":
                self.serve_prefill_chunk = int(val())
            elif a == "--serve-kv-layout":
                v = val()
                if v not in ("contiguous", "paged"):
                    raise ValueError(
                        f"--serve-kv-layout must be 'contiguous' or "
                        f"'paged', got {v!r}")
                self.serve_kv_layout = v
            elif a == "--serve-kv-block-size":
                self.serve_kv_block_size = int(val())
            elif a == "--serve-kv-blocks":
                self.serve_kv_blocks = int(val())
            elif a == "--serve-prefix-cache":
                self.serve_prefix_cache = int(val())
            elif a == "--allow-tensor-op-math-conversion":
                self.allow_tensor_op_math_conversion = True
            elif a == "--dtype":
                d = val().lower()
                table = {
                    "bf16": DataType.DT_BFLOAT16,
                    "bfloat16": DataType.DT_BFLOAT16,
                    "fp16": DataType.DT_HALF,
                    "half": DataType.DT_HALF,
                    "fp32": None,
                    "float32": None,
                }
                if d not in table:
                    raise ValueError(
                        f"--dtype {d!r}: expected one of {sorted(table)}")
                self.computation_dtype = table[d]
            i += 1


def resolve_device(config: FFConfig) -> torch.device:
    """The model's device. A CUDA device that is not there raises: the
    port never moves to the CPU unless the caller asked for it."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device is {config.device!r} but torch sees no CUDA "
            f"device; pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
