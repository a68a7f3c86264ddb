"""FFConfig: runtime configuration + CLI flag parsing (the port's slices).

The twin of `flexflow_tpu/config.py`, cut to the flags the port's
slices read: `-e/--epochs`, `-b`, `--lr` (also spelled
`--learning-rate`), `--dtype`, `--seed`, `--flash-transposed`, the
`--serve-*` flags, the tensor-op math policy, telemetry's
`--telemetry-dir`, `--metrics-interval` and `--metrics-port`, and the
mesh's: `--mesh data,model,pipe,seq` (or dcn first), `--nodes`,
`--only-data-parallel`, `--weight-update-sharding[=stage2|stage3|off|on]`,
`--no-weight-update-sharding`, `--import-strategy` and
`--export-strategy`. The Unity search's flags
(`--budget`, `--enable-parameter-parallel`, ...) are parsed as JAX parses
them; compile raises, naming ROADMAP A7, where the JAX package would
search (more than one device, no strategy given). Unknown flags are
ignored, as the reference's tolerant argv scan does (among them
`--no-overlap-collectives`: the port's rings have one schedule, each hop
posted before the work on the block at hand), except the flags of
paths the port does not have yet (`_NOT_PORTED`): asking for one raises,
naming its ROADMAP item. New here: `device`, the torch device every
tensor of a model lives on. It defaults to "cuda"; a run without a CUDA
device must ask for "cpu" explicitly (see `resolve_device`).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .fftype import CompMode, DataType
from .machine import DEFAULT_AXES, MULTIHOST_AXES, MeshShape

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
    # the mesh: `--mesh` sizes over mesh_axis_names (None: every rank of
    # the world on `data`); `--nodes` prepends the cross-host `dcn` axis
    mesh_axis_sizes: Optional[tuple[int, ...]] = None
    mesh_axis_names: tuple[str, ...] = DEFAULT_AXES
    num_nodes: int = 1
    workers_per_node: int = 0
    # weight-update sharding (ZeRO stage 2 / 3): None = decided by the
    # search (ROADMAP A7: raises with more than one data shard); the
    # flags force it (weight_update_stage None with sharding True: the
    # stage the search prices, also A7)
    weight_update_sharding: Optional[bool] = None
    weight_update_stage: Optional[int] = None
    only_data_parallel: bool = False
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    # the Unity search's knobs (ROADMAP A7): parsed, and compile raises
    # where the JAX package would search
    search_budget: int = 0
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_substitutions: bool = False
    substitution_json_path: Optional[str] = None
    search_calibrate: int = 0
    search_mesh_shapes: bool = False
    machine_model_file: str = ""

    def __post_init__(self):
        self.parse_args(sys.argv[1:])
        if self.workers_per_node == 0:
            from .distributed import process_count

            self.workers_per_node = max(
                1, process_count() // max(1, self.num_nodes))

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.workers_per_node

    def mesh_shape(self) -> MeshShape:
        """The mesh this config asks for (JAX `FFConfig.mesh_shape`):
        `--mesh` sizes (five of them: dcn first), `--nodes` prepending
        the dcn axis, or every device on `data`."""
        if self.mesh_axis_sizes is not None:
            sizes = tuple(self.mesh_axis_sizes)
            names = self.mesh_axis_names
            if (len(sizes) == len(MULTIHOST_AXES)
                    and names == DEFAULT_AXES):
                names = MULTIHOST_AXES
            elif self.num_nodes > 1 and len(sizes) == len(names):
                sizes = (self.num_nodes,) + sizes
                names = MULTIHOST_AXES
            return MeshShape(sizes, names)
        if self.num_nodes > 1:
            sizes = (self.num_nodes, self.workers_per_node) + (1,) * (
                len(MULTIHOST_AXES) - 2)
            return MeshShape(sizes, MULTIHOST_AXES)
        sizes = [self.num_devices] + [1] * (len(self.mesh_axis_names) - 1)
        return MeshShape(tuple(sizes), self.mesh_axis_names)

    def search_flags(self) -> list[str]:
        """The Unity-search flags this config sets (JAX `do_search`'s
        triggers)."""
        return [flag for flag, on in (
            ("--budget", self.search_budget > 0),
            ("--enable-parameter-parallel", self.enable_parameter_parallel),
            ("--enable-attribute-parallel", self.enable_attribute_parallel),
            ("--enable-substitutions", self.enable_substitutions),
            ("--substitution-json", bool(self.substitution_json_path)),
        ) if on]

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
            elif a == "--mesh":
                self.mesh_axis_sizes = tuple(int(x) for x in val().split(","))
            elif a == "--nodes":
                self.num_nodes = int(val())
            elif a in ("-ll:gpu", "--workers-per-node"):
                self.workers_per_node = int(val())
            elif a == "--only-data-parallel":
                self.only_data_parallel = True
            elif a == "--weight-update-sharding" or a.startswith(
                    "--weight-update-sharding="):
                if "=" in a:
                    v = a.split("=", 1)[1]
                elif (i + 1 < len(argv)
                      and argv[i + 1] in ("stage2", "stage3", "off", "on",
                                          "2", "3")):
                    v = val()
                else:
                    v = "on"
                table = {"stage3": (True, 3), "3": (True, 3),
                         "stage2": (True, 2), "2": (True, 2),
                         "off": (False, 0), "on": (True, None)}
                if v not in table:
                    raise ValueError(
                        f"--weight-update-sharding={v!r}: expected "
                        f"stage2|stage3|off|on")
                (self.weight_update_sharding,
                 self.weight_update_stage) = table[v]
            elif a == "--no-weight-update-sharding":
                self.weight_update_sharding = False
                self.weight_update_stage = 0
            elif a in ("--import-strategy", "--import"):
                self.import_strategy_file = val()
            elif a in ("--export-strategy", "--export"):
                self.export_strategy_file = val()
            elif a in ("--budget", "--search-budget"):
                self.search_budget = int(val())
            elif a == "--enable-parameter-parallel":
                self.enable_parameter_parallel = True
            elif a == "--enable-attribute-parallel":
                self.enable_attribute_parallel = True
            elif a == "--enable-substitutions":
                self.enable_substitutions = True
            elif a == "--substitution-json":
                self.substitution_json_path = val()
            elif a == "--calibrate":
                self.search_calibrate = int(val())
            elif a == "--search-mesh-shapes":
                self.search_mesh_shapes = True
            elif a == "--machine-model-file":
                self.machine_model_file = val()
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
    port never moves to the CPU unless the caller asked for it. Under a
    process group of more than one rank, "cuda" with no index is this
    rank's card, `LOCAL_RANK` (as torchrun sets it): a rank with no card
    of its own raises; two ranks share a card only when the caller names
    it ("cuda:0")."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device is {config.device!r} but torch sees no CUDA "
            f"device; pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        from .distributed import local_rank, process_count

        if process_count() > 1:
            lr = local_rank()
            if lr >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank with LOCAL_RANK {lr} has no card of its own "
                    f"({torch.cuda.device_count()} visible); name the "
                    f"device (FFConfig.device = 'cuda:0') to share one")
            dev = torch.device("cuda", lr)
            torch.cuda.set_device(dev)
    return dev
