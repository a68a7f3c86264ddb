"""FFConfig: runtime configuration + CLI flag parsing (the port's slices).

The twin of `flexflow_tpu/config.py`, cut to the flags the serving and
training slices read: `-e/--epochs`, `-b`, `--lr` (also spelled
`--learning-rate`), `--dtype`, `--seed`, `--flash-transposed`, the
`--serve-*` flags, the tensor-op math policy, and telemetry's
`--telemetry-dir`, `--metrics-interval` and `--metrics-port`. Unknown flags are
ignored, as the reference's tolerant argv scan does, except the flags of
paths the port does not have yet (`_NOT_PORTED`): asking for one raises,
naming its ROADMAP item. New
here: `device`, the torch device every tensor of a model lives on. It
defaults to "cuda"; a run without a CUDA device must ask for "cpu"
explicitly (see `resolve_device`).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .fftype import CompMode, DataType

# Flags of the JAX package whose paths are not ported: flag -> (takes a
# value, ROADMAP item). A valued flag asks for its path unless the value
# is 0 or empty.
_NOT_PORTED = {
    "--profiling": (False, "A10 (profiling)"),
    "--checkpoint-dir": (True, "A10 (resilience/ checkpoints)"),
    "--checkpoint-every": (True, "A10 (resilience/ checkpoints)"),
    "--checkpoint-every-seconds": (True, "A10 (resilience/ checkpoints)"),
    "--auto-resume": (False, "A10 (resilience/ auto-resume)"),
    "--xprof-dir": (True, "A10 (scope/ device traces)"),
    "--profile-every": (True, "A10 (scope/ op-grain profiling)"),
    "--watchdog-timeout": (True, "A10 (scope/ hang watchdog)"),
    "--diagnostics": (False, "A10 (diagnostics/)"),
    "--elastic": (False, "A10 (elastic/)"),
    "--sanitize-numerics": (False, "A10 (sanitize.py)"),
}


def _asks(value: str) -> bool:
    try:
        return float(value) != 0.0
    except ValueError:
        return value != ""


def not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to flexflow_tpu_torch yet (ROADMAP {item})")


@dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
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
    # False (--flash-transposed): impl="flash" attention splits heads into
    # (b, h, s, d) tensors and runs the transposed flash entry
    flash_packed_layout: bool = True
    # serving engine defaults for model.serve()
    serve_slots: int = 4
    serve_max_seq_len: int = 0
    serve_prefill_chunk: int = 16
    serve_kv_layout: str = "paged"
    serve_kv_block_size: int = 16
    serve_kv_blocks: int = 0
    serve_prefix_cache: int = 1
    # observability (telemetry/): telemetry_dir enables the run-wide
    # tracer + JSONL metrics log (trace.json / metrics.jsonl under the dir)
    telemetry_dir: str = ""
    # continuous export (telemetry/export.py, needs telemetry):
    # metrics_interval > 0 writes a rolling metrics_snapshot record +
    # metrics.prom every N seconds; metrics_port serves the latest
    # snapshot at /metrics and liveness at /healthz on 127.0.0.1 (port 0 =
    # off)
    metrics_interval: float = 0.0
    metrics_port: int = 0

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

            if a in _NOT_PORTED:
                takes_value, item = _NOT_PORTED[a]
                if not takes_value or _asks(val()):
                    raise not_ported(f"flag {a}", item)
            elif a in ("-e", "--epochs"):
                self.epochs = int(val())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(val())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(val())
            elif a == "--pipeline-steps":
                if int(val()) > 1:
                    raise not_ported("--pipeline-steps > 1 (the pipelined "
                                     "lax.scan engine)", "A10 (engine/)")
            elif a == "--telemetry-dir":
                self.telemetry_dir = val()
            elif a == "--metrics-interval":
                self.metrics_interval = float(val())
            elif a == "--metrics-port":
                self.metrics_port = int(val())
            elif a == "--seed":
                self.seed = int(val())
            elif a == "--device":
                self.device = val()
            elif a == "--flash-transposed":
                self.flash_packed_layout = False
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
