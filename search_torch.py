#!/usr/bin/env python3
"""The port's Unity search on lm-base: the H100 machine model's predicted
step and chosen plan on four meshes, roofline-priced or calibrated on the
card.

    python3 search_torch.py --device cpu --layers 4      # roofline prices
    python3 search_torch.py --layers 12 --calibrate 4    # on the card

builds lm-base (`TRANSFORMER_LM_ZOO`: vocab 32000, hidden 1024, 16 heads
of 64, seq 512) cut to `--layers`, batch 8, bf16 over f32 masters, SGD,
on one device, as bench_torch.py does. With `--calibrate K` it measures
the graph's K most expensive distinct ops on that device
(`CostModel.calibrate_graph`: on the card, CUDA graphs of each op's
forward and of its forward and backward, replayed between CUDA events),
else the search prices the roofline at the cost model's fixed fraction of
peak. Then it runs the joint search (`search/joint.joint_graph_optimize`,
rewrites x placements, `--budget`, parameter parallelism allowed) over
the H100 model (`search/machine_model.NVSwitchMachineModel`) of one
device, dp 4, dp 2 x tp 2 and tp 4 (given as axis sizes: a search needs
only the mesh's shape), and prints one JSON line a mesh: the predicted
step of the chosen plan and of plain data parallelism, the plan's
configs by kind, the search's evaluations, segment-cache hits and wall
time; at dp 4 also the unforced weight-update decision. On the card the
card's name and power limit come before the last line. chip_smoke.py's
phase 17 runs the same functions at 12 layers.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, SEED = 8, 0
# the budget that keeps a 12-layer search within seconds a mesh (the JAX
# package's own bound for a 12-layer LM is 120 s at budget 6,
# tests/test_joint_search.py)
BUDGET = 6
MESHES = (("one device", 1, 1), ("dp 4", 4, 1), ("dp 2 x tp 2", 2, 2),
          ("tp 4", 1, 4))


def build(device: str, layers: int):
    """lm-base at `layers` layers, compiled for training on one device."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    cfg = FFConfig(device=device)
    cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                    str(BATCH)])
    ff = FFModel(cfg)
    build_transformer_lm(ff, dataclasses.replace(
        TRANSFORMER_LM_ZOO["lm-base"], num_layers=layers))
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def _mesh(data: int, model: int):
    from flexflow_tpu_torch.search.mesh_search import MeshSpec

    return MeshSpec({"data": data, "model": model, "pipe": 1, "seq": 1})


def calibrate(ff, top_k: int):
    """The cost model of one H100 with the graph's `top_k` ops measured on
    the model's device; (cost model, wall seconds)."""
    from flexflow_tpu_torch.search.cost_model import CostModel, OpHarness
    from flexflow_tpu_torch.search.machine_model import (
        CHIPS,
        machine_model_for_mesh,
    )

    cm = CostModel(machine_model_for_mesh(_mesh(1, 1), chip=CHIPS["h100"]),
                   opt_slots=ff.optimizer.num_slots)
    cm.harness = OpHarness.of(ff.config, ff.device)
    t0 = time.perf_counter()
    cm.calibrate_graph(ff.graph, top_k=top_k)
    return cm, time.perf_counter() - t0


def _configs(us, choice) -> dict:
    kinds: dict = {}
    for node in us.order:
        cfg = choice.get(node.guid)
        if cfg is not None:
            kinds[cfg.name] = kinds.get(cfg.name, 0) + 1
    return dict(sorted(kinds.items()))


def predict(ff, budget: int = BUDGET, calibration: dict | None = None
            ) -> list:
    """One row a mesh of MESHES (see the module note)."""
    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.search.joint import joint_graph_optimize
    from flexflow_tpu_torch.search.machine_model import (
        CHIPS,
        machine_model_for_mesh,
    )
    from flexflow_tpu_torch.search.mesh_search import clone_graph
    from flexflow_tpu_torch.search.unity import (
        UnitySearch,
        choose_update_sharding,
    )

    cfg = copy.copy(ff.config)
    cfg.search_budget = budget
    cfg.enable_parameter_parallel = True
    rows = []
    for name, data, model in MESHES:
        mesh = _mesh(data, model)
        cm = CostModel(machine_model_for_mesh(mesh, chip=CHIPS["h100"]),
                       opt_slots=ff.optimizer.num_slots)
        cm._calibration = dict(calibration or {})
        dp = UnitySearch(clone_graph(ff.graph), mesh, cfg, cm)
        dp_s, _ = dp.evaluate({n.guid: dp.node_configs(n)[0]
                               for n in dp.order})
        t0 = time.perf_counter()
        g, choice, us = joint_graph_optimize(clone_graph(ff.graph), mesh,
                                             cfg, cm)
        wall = time.perf_counter() - t0
        step_s, mem = us.evaluate(choice)
        strategy = us.to_strategy(choice)
        row = {"mesh": name, "axes": {"data": data, "model": model},
               "predicted_ms": step_s * 1e3, "dp_plan_ms": dp_s * 1e3,
               "memory_bytes": mem, "configs": _configs(us, choice),
               "plan_nodes": len(strategy.overrides),
               "evals": us.evals, "cache_hits": us.cache_hits,
               "search_s": wall, "calibrated": bool(calibration)}
        if (data, model) == (4, 1):
            row["update_sharding"] = choose_update_sharding(
                g, mesh, cfg, cost_model=cm,
                opt_slots=ff.optimizer.num_slots)
        rows.append(row)
    return rows


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--budget", type=int, default=BUDGET)
    parser.add_argument("--calibrate", type=int, default=0,
                        help="measure the K most expensive ops first")
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("search_torch: torch sees no CUDA device (--device cpu runs "
              "on the CPU)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    ff = build(args.device, args.layers)
    calibration = None
    if args.calibrate > 0:
        cm, wall = calibrate(ff, args.calibrate)
        calibration = cm._calibration
        print(json.dumps({"calibration": [
            {"op": k[0].name, "in_shapes": k[2], "fwd_ms": f * 1e3,
             "bwd_ms": b * 1e3} for k, (f, b) in calibration.items()],
            "stats": cm.calib_stats, "wall_s": wall}), flush=True)
    for row in predict(ff, args.budget, calibration):
        print(json.dumps(row), flush=True)
    if args.device == "cuda":
        from flexflow_tpu_torch.search.machine_model import card_line

        print(card_line(), flush=True)
    print(json.dumps({"layers": args.layers, "budget": args.budget,
                      "calibrated_ops": args.calibrate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
