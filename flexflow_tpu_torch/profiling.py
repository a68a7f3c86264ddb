"""Per-operator profiling: the --profiling flag's output (twin of
`flexflow_tpu/profiling.py`).

Reference: every kernel wrapper prints per-op forward/backward times under
`m->profiling` (src/ops/kernels/linear_kernels.cu:95-117, enabled by
--profiling → FFConfig.profiling). The port times each PCG op's forward
and backward standalone on the model's device (the card unless the
caller asks for the CPU), through the same `OpHarness` the cost-model
calibration uses (`search/cost_model.py`: CUDA graphs timed by CUDA
events on the card), and prints one reference-style table per compile,
headed by the device it was timed on.

Caveat printed with the table: each op is timed alone, with its inputs
made for it, so the sum is not the step — the table is for finding hot
ops, exactly what the reference's per-kernel prints are for. (For
whole-step timelines, --xprof-dir runs fit under torch.profiler and
exports its Chrome trace.)
"""

from __future__ import annotations


def _harness(harness=None):
    """The harness ops are timed by: the given one, else the card's
    (float32) where there is a card, else the host's."""
    from .search.cost_model import OpHarness
    from .search.machine_model import _local_device

    return harness or OpHarness(device=_local_device())


def profile_operators(graph, harness=None
                      ) -> list[tuple[str, str, float, float]]:
    """Measure every compute op of a PCG standalone on `harness`'s device
    (`search.cost_model.OpHarness`; default the card's). Returns
    [(op name, op type, forward seconds, backward seconds), ...] in topo
    order; ops whose harness can't be built (no forward for them, a shape
    the harness cannot make) are skipped, like the reference skips
    kernels without profiling hooks. An error while an op runs raises."""
    from .search.cost_model import (
        _HARNESS_ERRORS, _NON_COMPUTE, CostModel, _op_harness)
    from .search.machine_model import TPUMachineModel, detect_chip

    harness = _harness(harness)
    cm = CostModel(TPUMachineModel(detect_chip(harness.device), {}))
    cm.harness = harness
    rows = []
    for node in graph.topo_order():
        if (node.op_type in _NON_COMPUTE or not node.outputs
                or not node.inputs):
            continue
        try:
            fn, args = _op_harness(node, harness)
        except _HARNESS_ERRORS:
            continue
        fwd_t, bwd_t = cm.calibrate(node, fn, args)
        rows.append((node.name, node.op_type.name, fwd_t, bwd_t))
    return rows


def profile_operators_json(graph, rows=None, harness=None) -> list[dict]:
    """Machine-readable per-op profile: one dict per op with forward/
    backward/total seconds, sorted by total descending (hot ops first —
    the question the table exists to answer). Pass pre-measured `rows`
    (profile_operators output) to avoid re-benchmarking."""
    rows = (profile_operators(graph, harness) if rows is None
            else rows)
    out = [
        {
            "name": name,
            "op_type": op_type,
            "forward_s": fwd,
            "backward_s": bwd,
            "total_s": fwd + bwd,
        }
        for name, op_type, fwd, bwd in rows
    ]
    out.sort(key=lambda r: r["total_s"], reverse=True)
    return out


def profile_section_from_rows(rows) -> dict:
    """Shape standalone per-op measurements into the SAME report
    `profile` section schema ffscope's xplane attribution produces
    (scope/attribution.py), so --profiling numbers land in
    strategy_report.json / the ffpulse registry / the doctor's one
    measured-vs-predicted table instead of a parallel one-off format.
    `source: "standalone"` marks that these are unfused kernels timed
    in isolation — the attribution identity (bounded by step device
    time) applies only to `source: "xplane"` sections."""
    from .scope.attribution import build_profile_section

    ops = {name: {"measured_s": fwd + bwd, "fwd_s": fwd, "bwd_s": bwd,
                  "events": 1}
           for name, _op_type, fwd, bwd in rows}
    attr = {"ops": ops, "extras": {},
            "attributed_s": sum(o["measured_s"] for o in ops.values()),
            "unattributed_s": 0.0, "parallelism": 1, "devices": 1}
    return build_profile_section(
        attr, step=-1, device_time_s=attr["attributed_s"],
        source="standalone")


def print_operator_profile(graph, file=None, sort_by_total=False,
                           harness=None):
    """Reference-format per-op table (linear_kernels.cu:95-117 prints
    '%s [Linear] forward time = %.2lfms'; this is the whole-graph sweep).
    `sort_by_total=True` orders hot ops first instead of topo order.

    Each row is also emitted as a tracer counter event ("op_profile.<name>")
    when a telemetry session is active, so the per-op table lands in the
    same Perfetto file as the run timeline."""
    import sys

    from . import telemetry

    out = file or sys.stdout
    harness = _harness(harness)
    rows = profile_operators(graph, harness)
    if sort_by_total:
        rows = sorted(rows, key=lambda r: r[2] + r[3], reverse=True)
    print(f"per-operator profile on {device_name(harness.device)} "
          f"(standalone kernels; the training step runs them with other "
          f"inputs and in another order):", file=out)
    for name, op_type, fwd, bwd in rows:
        print(f"{name} [{op_type}] forward time = {fwd * 1e3:.4f}ms, "
              f"backward time = {bwd * 1e3:.4f}ms", file=out)
        telemetry.counter(f"op_profile.{name}", {
            "forward_ms": fwd * 1e3, "backward_ms": bwd * 1e3})
        # ffpulse: the same op_time_s{op=...} series the ffscope
        # attribution feeds — one registry for both profile sources
        telemetry.observe("op_time_s", fwd + bwd, op=name)
    total_f = sum(r[2] for r in rows)
    total_b = sum(r[3] for r in rows)
    print(f"TOTAL (sum of standalone kernels) forward = "
          f"{total_f * 1e3:.4f}ms, backward = {total_b * 1e3:.4f}ms",
          file=out)
    return rows


def device_name(device) -> str:
    """The card's name and power limit (`nvidia-smi`), or "cpu"."""
    import torch

    from .search.machine_model import card_line

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return card_line(device.index or 0)
