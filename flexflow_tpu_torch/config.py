"""FFConfig: runtime configuration + CLI flag parsing (twin of
`flexflow_tpu/config.py`).

Every flag the JAX package's parser reads is given its path here. The
flags the JAX package parses but never reads are accepted and do nothing (`_INERT`),
and so is `--no-overlap-collectives`: the port's rings have one
schedule, each hop posted before the work on the block at hand, and the
Unity search prices the weight-update pair overlapped, as the JAX
package does by default (its runtime does not overlap it yet, ROADMAP
G1). Other unknown flags are ignored, as the reference's tolerant argv
scan does. New here: `device`, the torch device every tensor of a model
lives on. It defaults to "cuda"; a run without a CUDA device must ask
for "cpu" explicitly (see `resolve_device`).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from .fftype import CompMode, DataType
from .machine import DEFAULT_AXES, MULTIHOST_AXES, MeshShape

# Flags the JAX package parses and never reads: accepted, no effect
# (flag -> takes a value).
_INERT = {
    "--wd": True, "--printFreq": True, "-ll:cpu": True, "--dataset": True,
    "--synthetic-input": False, "--fusion": False, "--taskgraph": True,
    "--enable-propagation": False, "--segment-size": True,
    "--max-num-segments": True, "--machine-model-version": True,
    "--enable-inplace-optimizations": False,
    "--simulator-workspace-size": True, "--no-overlap-collectives": False,
}


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
    # disaggregated serving (serving/disagg.py): prefill and decode on
    # disjoint sub-meshes of the torchrun world; serve_prefill_chips sizes
    # the prefill side (0 -> half the ranks); serve_role marks which side
    # a decode compile is for and joins the warm-start plan fingerprint
    serve_disaggregate: bool = False
    serve_prefill_chips: int = 0
    serve_role: str = ""  # "" | "prefill" | "decode" | "draft"
    # speculative decoding (serving/speculative.py): serve_draft_chips
    # puts the drafter on the world's trailing ranks (0 -> colocated);
    # serve_spec_k caps the draft length the payoff gate may choose
    serve_draft_chips: int = 0
    serve_spec_k: int = 4
    # the first world rank a mesh lays its grid over: disjoint sub-meshes
    # (the sides of a split) set it per side
    mesh_device_offset: int = 0
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
    # --profiling: the per-op table (profiling.py), timed on the model's
    # device once per compile; xprof_dir: fit (and the serving loop) run
    # under torch.profiler, its Chrome trace exported there
    profiling: bool = False
    xprof_dir: str = ""
    # diagnostics (diagnostics/, needs telemetry): the strategy report
    # at compile, the cost-model drift monitor and the health rules
    # during fit. drift_threshold: the EMA of |measured - predicted| /
    # predicted step time above which a drift advisory fires;
    # health_abort_on: rules that stop fit (HealthAbort) instead of
    # warning; health_sample_every: the per-step loss fetch every K-th
    # step, the rules then seeing one K-step-averaged record a window
    diagnostics: bool = False
    drift_threshold: float = 0.5
    health_abort_on: tuple[str, ...] = ()
    health_sample_every: int = 1
    # sanitize.py: a device-side finiteness probe on every op output and
    # its cotangent, so a NaN is named by (op, fwd|bwd, step)
    sanitize_numerics: bool = False
    # scope/: --profile-every K profiles every K-th step (attributed to
    # the PCG's ops); the hang watchdog fires when no step boundary lands
    # within max(timeout, step EMA x multiplier) (0: off); the flight
    # recorder's ring (always on; 0 disables)
    profile_every: int = 0
    watchdog_timeout: float = 0.0
    watchdog_multiplier: float = 10.0
    watchdog_abort: bool = False
    flight_events: int = 256
    # resilience (resilience/): checkpoint_dir enables async checkpoints
    # during fit, every N steps / T seconds; auto_resume restores the
    # newest committed checkpoint (onto this run's mesh) before training
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    checkpoint_every_seconds: float = 0.0
    checkpoint_keep: int = 3
    auto_resume: bool = False
    # engine/: fit runs chunks of N train steps as one CUDA-graph replay
    # over batches a background thread staged (1: the per-step loop)
    pipeline_steps: int = 1
    # warmstart/: the persistent plan cache and calibration DB
    warmstart_dir: str = ""
    # the mesh: `--mesh` sizes over mesh_axis_names (None: every rank of
    # the world on `data`); `--nodes` prepends the cross-host `dcn` axis
    mesh_axis_sizes: Optional[tuple[int, ...]] = None
    mesh_axis_names: tuple[str, ...] = DEFAULT_AXES
    num_nodes: int = 1
    workers_per_node: int = 0
    # weight-update sharding (ZeRO stage 2 / 3): None = decided by the
    # Unity search's pricing (search/unity.choose_update_sharding); the
    # flags force it (weight_update_stage None with sharding True: the
    # stage priced)
    weight_update_sharding: Optional[bool] = None
    weight_update_stage: Optional[int] = None
    only_data_parallel: bool = False
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    # --compgraph: the compiled PCG's DOT export, written at compile
    export_strategy_computation_graph_file: str = ""
    # the Unity search (search/): compile searches on a mesh of more than
    # one device when a budget or a parallelism/substitution flag is set
    search_budget: int = 0
    search_alpha: float = 1.2
    search_overlap_backward_update: bool = False
    search_num_nodes: Optional[int] = None
    search_num_workers: Optional[int] = None
    base_optimize_threshold: int = 10
    perform_memory_search: bool = False
    enable_sample_parallel: bool = False
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_substitutions: bool = False
    substitution_json_path: Optional[str] = None
    # on-device calibration: measure the top-K distinct ops before
    # searching; 0 = off
    search_calibrate: int = 0
    search_mesh_shapes: bool = False
    machine_model_file: str = ""
    # -ll:fsize: bytes of device memory a device, the cap the search,
    # the update-sharding decision and the compile gate's memory pass
    # price against (0: the chip's)
    device_mem: float = 0.0
    # static plan verification (analysis/): the ffcheck pass pipeline runs
    # at compile on every plan source, before any weight is allocated;
    # errors abort the compile (PlanVerificationError) with the findings
    # in strategy_report.json's analysis section, and a restore's
    # transition is gated the same way. --no-verify-plan downgrades both
    # to logged warnings.
    verify_plan: bool = True
    # ffrules (analysis/rules.py): every --substitution-json rule is
    # verified at load (RuleVerificationError names the rule and the
    # finding class); --no-verify-rules downgrades to a logged warning,
    # the verdict still recorded in the report
    verify_rules: bool = True
    # the SPMD fingerprint barrier (analysis/spmd.py): right after the
    # compile gate every rank compares a digest of its step's ingredients
    # with rank 0's; a mismatch raises SPMDDivergenceError on every rank
    spmd_barrier: bool = False
    # elastic re-planning (elastic/): the controller consumes drift
    # advisories (with --diagnostics) and capacity deltas of the visible
    # rank set, re-plans at a step boundary and migrates in place when
    # the payoff rule says so; --replan-cooldown-steps spaces attempts,
    # --replan-horizon-steps is the payoff horizon, --elastic-dry-run
    # decides and records but never migrates
    elastic: bool = False
    replan_cooldown_steps: int = 50
    replan_horizon_steps: int = 1000
    elastic_dry_run: bool = False

    def __post_init__(self):
        self.parse_args(sys.argv[1:])
        from .distributed import (
            initialize_from_env,
            node_count,
            process_count,
            ranks_per_node,
        )

        # a script under torchrun joins its world here, once, as the JAX
        # package's one controller sees every device: the script needs no
        # call of its own (ROADMAP C8)
        initialize_from_env(self.device)
        if self.workers_per_node == 0:
            # launched over nodes (torchrun --nnodes): a node's ranks, as
            # JAX's multi-controller run takes its host's devices; else
            # the ranks divided over --nodes (a one-node emulation, JAX's
            # virtual multi-host mesh)
            self.workers_per_node = max(
                1, ranks_per_node() if node_count() > 1
                else process_count() // max(1, self.num_nodes))

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

    def parse_args(self, argv: list[str]):
        i = 0
        while i < len(argv):
            a = argv[i]

            def val():
                nonlocal i
                i += 1
                return argv[i]

            if a in _INERT:
                if _INERT[a]:
                    val()
            elif a in ("-e", "--epochs"):
                self.epochs = int(val())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(val())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(val())
            elif a == "--pipeline-steps":
                self.pipeline_steps = int(val())
            elif a == "--elastic":
                self.elastic = True
            elif a == "--replan-cooldown-steps":
                self.replan_cooldown_steps = int(val())
            elif a == "--replan-horizon-steps":
                self.replan_horizon_steps = int(val())
            elif a == "--elastic-dry-run":
                self.elastic_dry_run = True
            elif a == "--checkpoint-dir":
                self.checkpoint_dir = val()
            elif a == "--checkpoint-every":
                self.checkpoint_every = int(val())
            elif a == "--checkpoint-every-seconds":
                self.checkpoint_every_seconds = float(val())
            elif a == "--checkpoint-keep":
                self.checkpoint_keep = int(val())
            elif a == "--auto-resume":
                self.auto_resume = True
            elif a == "--warmstart-dir":
                self.warmstart_dir = val()
            elif a == "--no-verify-plan":
                self.verify_plan = False
            elif a == "--no-verify-rules":
                self.verify_rules = False
            elif a == "--spmd-barrier":
                self.spmd_barrier = True
            elif a == "--telemetry-dir":
                self.telemetry_dir = val()
            elif a == "--metrics-interval":
                self.metrics_interval = float(val())
            elif a == "--metrics-port":
                self.metrics_port = int(val())
            elif a == "--profiling":
                self.profiling = True
            elif a == "--xprof-dir":
                self.xprof_dir = val()
            elif a == "--diagnostics":
                self.diagnostics = True
            elif a == "--drift-threshold":
                self.drift_threshold = float(val())
            elif a == "--health-abort-on":
                self.health_abort_on = tuple(
                    r.strip() for r in val().split(",") if r.strip())
            elif a == "--health-sample-every":
                self.health_sample_every = int(val())
            elif a == "--sanitize-numerics":
                self.sanitize_numerics = True
            elif a == "--profile-every":
                self.profile_every = int(val())
            elif a == "--watchdog-timeout":
                self.watchdog_timeout = float(val())
            elif a == "--watchdog-multiplier":
                self.watchdog_multiplier = float(val())
            elif a == "--watchdog-abort":
                self.watchdog_abort = True
            elif a == "--flight-events":
                self.flight_events = int(val())
            elif a == "--seed":
                self.seed = int(val())
            elif a == "--mesh":
                self.mesh_axis_sizes = tuple(int(x) for x in val().split(","))
            elif a == "--nodes":
                self.num_nodes = int(val())
            elif a in ("-ll:gpu", "-ll:tpu", "--workers-per-node"):
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
            elif a in ("--alpha", "--search-alpha"):
                self.search_alpha = float(val())
            elif a == "--search-overlap-backward-update":
                self.search_overlap_backward_update = True
            elif a == "--search-num-nodes":
                self.search_num_nodes = int(val())
            elif a == "--search-num-workers":
                self.search_num_workers = int(val())
            elif a == "--base-optimize-threshold":
                self.base_optimize_threshold = int(val())
            elif a == "--memory-search":
                self.perform_memory_search = True
            elif a == "--enable-sample-parallel":
                self.enable_sample_parallel = True
            elif a == "-ll:fsize":
                self.device_mem = float(val()) * 1024 * 1024
            elif a == "--compgraph":
                self.export_strategy_computation_graph_file = val()
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
            elif a == "--serve-disaggregate":
                self.serve_disaggregate = True
            elif a == "--serve-prefill-chips":
                self.serve_prefill_chips = int(val())
            elif a == "--serve-draft-chips":
                self.serve_draft_chips = int(val())
            elif a == "--serve-spec-k":
                self.serve_spec_k = int(val())
            elif a == "--allow-tensor-op-math-conversion":
                self.allow_tensor_op_math_conversion = True
            elif a == "--no-tensor-op-math-conversion":
                # exact float32 matmuls on the card (no bf16 input cast)
                self.allow_tensor_op_math_conversion = False
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
    rank's card, `distributed.card_index`'s (`LOCAL_RANK` as torchrun
    sets it, else the global rank wrapped onto the node's cards, as
    `distributed.initialize` sets it): a LOCAL_RANK with no card of its
    own raises; two ranks share a card only when the caller names it
    ("cuda:0")."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device is {config.device!r} but torch sees no CUDA "
            f"device; pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        from .distributed import card_index, process_count

        if process_count() > 1:
            dev = torch.device("cuda",
                               card_index(torch.cuda.device_count()))
            torch.cuda.set_device(dev)
    return dev


class FFIterationConfig:
    """Per-iteration config (reference config.h:162-167): seq_length
    enables truncated-sequence batches."""

    def __init__(self):
        self.seq_length = -1

    def reset(self):
        self.seq_length = -1
