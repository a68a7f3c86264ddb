"""Cost-model fidelity harness for the PyTorch port: composed prediction
vs measured step time. Twin of `scripts/cost_model_fidelity.py`.

The reference earns trust in its simulator by MEASURING every op on the
real device inside the search (Simulator::measure_operator_cost). The
port calibrates the dominant ops the same way — but a calibrated op
model still has to COMPOSE into an accurate whole-step prediction
(makespan over the task graph + collective pricing). This harness
validates exactly that: for a battery of single-device configs
(hidden/seq/batch/attention-impl/MoE/MLP), it
  1. measures the real training-step time: the captured step
     (`executor.build_train_step()`, a CUDA graph on the card) replayed n
     and 3n times between two synchronisations, three times each, and
     the slope of the medians, bench_torch.py's two-point method;
  2. predicts the step time with the analytic cost model (fixed-mfu
     roofline over the device's machine model: the H100's on the card)
     and again with on-device calibration (CostModel.calibrate_graph,
     top-4, the JAX script's),
and reports per-config errors and the Spearman rank correlation between
predicted and measured — the search needs *ranking* fidelity to pick the
right plan.

    python cost_model_fidelity_torch.py OUT.json      # the card's battery
    python cost_model_fidelity_torch.py --device cpu  # the CPU battery
    python cost_model_fidelity_torch.py --configs lm_h1024_s512_b8_flash

The card runs the JAX package's 10-config TPU battery at the same shapes
(`card_configs`), the CPU its `cpu_configs`; activations in float32 as
the JAX script's. The report goes to OUT.json when given (a partial one
to OUT.json.partial as configs finish), else only to stdout; the script
writes no other file.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def _lm(name, hidden, heads, layers, seq, batch, impl, vocab=8192):
    def make(device: str):
        import numpy as np

        from flexflow_tpu_torch import FFConfig, FFModel
        from flexflow_tpu_torch.models import (
            TransformerLMConfig,
            build_transformer_lm,
        )

        sys.argv = [sys.argv[0]]
        config = FFConfig(device=device)
        config.batch_size = batch
        ff = FFModel(config)
        c = TransformerLMConfig(vocab_size=vocab, hidden_size=hidden,
                                num_heads=heads, num_layers=layers,
                                sequence_length=seq, attention_impl=impl)
        build_transformer_lm(ff, c, batch_size=batch)
        rs = np.random.RandomState(0)
        feeds = {
            "tokens": rs.randint(0, vocab, (batch, seq)).astype(np.int32),
            "positions": np.tile(np.arange(seq, dtype=np.int32),
                                 (batch, 1)),
        }
        labels = rs.randint(0, vocab, (batch, seq, 1)).astype(np.int32)
        return ff, feeds, labels

    return {"name": name, "make": make}


def _mlp(name, batch, in_dim, hidden):
    def make(device: str):
        import numpy as np

        from flexflow_tpu_torch import FFConfig, FFModel
        from flexflow_tpu_torch.models import build_mlp_unify

        sys.argv = [sys.argv[0]]
        config = FFConfig(device=device)
        config.batch_size = batch
        ff = FFModel(config)
        build_mlp_unify(ff, batch_size=batch, in_dim=in_dim,
                        hidden_dims=(hidden,) * 4)
        rs = np.random.RandomState(0)
        feeds = {
            "input1": rs.randn(batch, in_dim).astype(np.float32),
            "input2": rs.randn(batch, in_dim).astype(np.float32),
        }
        labels = rs.randint(0, hidden, (batch, 1)).astype(np.int32)
        return ff, feeds, labels

    return {"name": name, "make": make}


def _moe(name, batch, fused=True):
    def make(device: str):
        import numpy as np

        from flexflow_tpu_torch import FFConfig, FFModel
        from flexflow_tpu_torch.models import MoeConfig, build_moe

        sys.argv = [sys.argv[0]]
        config = FFConfig(device=device)
        config.batch_size = batch
        ff = FFModel(config)
        c = MoeConfig()
        build_moe(ff, c, batch_size=batch, fused=fused)
        rs = np.random.RandomState(0)
        feeds = {"input": rs.randn(batch, c.in_dim).astype(np.float32)}
        labels = rs.randint(0, c.num_classes, (batch, 1)).astype(np.int32)
        return ff, feeds, labels

    return {"name": name, "make": make}


def card_configs():
    """The battery on the card: the JAX package's 10 single-chip configs
    (`tpu_configs()`: hidden / seq / batch / attention impl / model
    family), the same shapes; the calibration cache is shared across
    configs (same-shape ops measure once)."""
    return [
        _lm("lm_h512_s512_b8_xla", 512, 8, 6, 512, 8, "xla"),
        _lm("lm_h1024_s128_b8_xla", 1024, 16, 6, 128, 8, "xla"),
        _lm("lm_h1024_s512_b8_flash", 1024, 16, 6, 512, 8, "flash"),
        _lm("lm_h1024_s512_b4_flash", 1024, 16, 6, 512, 4, "flash"),
        _lm("lm_h1024_s512_b16_flash", 1024, 16, 6, 512, 16, "flash"),
        _lm("lm_flagship12_flash", 1024, 16, 12, 512, 8, "flash",
            vocab=32000),
        _lm("lm_h2048_s256_b8_flash", 2048, 16, 4, 256, 8, "flash"),
        _mlp("mlp_unify_b256_h8192", 256, 1024, 8192),
        _mlp("mlp_unify_b64_h4096", 64, 1024, 4096),
        _moe("moe_flat_b256_fused", 256, fused=True),
    ]


def cpu_configs():
    """Small, strongly size-separated battery for the CPU tests."""
    return [
        _lm("lm_h64_s32_b4", 64, 4, 2, 32, 4, "xla", vocab=256),
        _lm("lm_h128_s64_b4", 128, 4, 2, 64, 4, "xla", vocab=256),
        _lm("lm_h256_s64_b8", 256, 4, 4, 64, 8, "xla", vocab=256),
        _mlp("mlp_b16_h256", 16, 128, 256),
        _mlp("mlp_b64_h1024", 64, 256, 1024),
    ]


def measure_step_time(ff, feeds, labels, steps=10,
                      floor_s: float = 0.0) -> float:
    """Measured seconds/step by bench_torch.py's two-point method: the
    train step (captured on the card: call 1 warms up, call 2 captures,
    every later call replays) run n and 3n times between two
    synchronisations, three times each; the slope of the medians is the
    per-step time with every constant cost cancelled. Readings below
    `floor_s` (a roofline-derived physical bound) are retried as flukes."""
    import statistics

    import torch

    from flexflow_tpu_torch import LossType, SGDOptimizer

    if not getattr(ff, "_compiled", False):
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    step_fn = ff.executor.build_train_step()
    data = ff._make_batch(feeds, labels)
    st = (ff._params, ff._state, ff._opt_slots, ff._step, ff._counters)
    on_card = ff.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(ff.device)

    def run(n):
        nonlocal st
        for _ in range(n):
            st = step_fn(*st, data)[:5]

    run(2)  # warm-up, then the capture
    sync()

    def t_of(n):
        ts = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            run(n)
            sync()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    for _ in range(4):
        t1 = t_of(steps)
        t2 = t_of(3 * steps)
        per_step = (t2 - t1) / (2 * steps)
        if per_step >= floor_s and per_step > 0:
            return per_step
    raise RuntimeError(
        f"step-time slope repeatedly below the physical floor "
        f"{floor_s * 1e3:.3f} ms — measurement flukes")


def predict_step_time(ff, calibrate_top_k: int = 0,
                      calibration_cache: dict | None = None) -> float:
    """Predicted seconds/step: the composed makespan of the compiled PCG
    under the device's machine model (evaluate_graph — compute roofline +
    collective classification + task-graph critical path).
    calibrate_top_k > 0 first measures the K dominant distinct ops on the
    model's device (its dtype policy) and predicts from those; `calibration_cache` shares
    measurements across configs (keyed by op params + unsharded input
    shapes, so it is config-safe)."""
    from flexflow_tpu_torch.search.cost_model import CostModel, OpHarness
    from flexflow_tpu_torch.search.machine_model import (
        machine_model_for_mesh,
    )
    from flexflow_tpu_torch.search.substitution import evaluate_graph

    cm = CostModel(machine_model_for_mesh(ff.mesh))
    # the ops measured where the model runs, under its dtype policy
    cm.harness = OpHarness.of(ff.config, ff.device)
    if calibration_cache is not None:
        cm._calibration = calibration_cache
    if calibrate_top_k:
        cm.calibrate_graph(ff.graph, top_k=calibrate_top_k)
    t, _ = evaluate_graph(ff.graph, ff.mesh, cm)
    return t


def _spearman(xs, ys) -> float:
    import numpy as np

    def ranks(v):
        v = np.asarray(v, dtype=float)
        order = np.argsort(v)
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=float)
        for val in np.unique(v):  # ties share the average rank
            mask = v == val
            r[mask] = r[mask].mean()
        return r

    rx, ry = ranks(np.asarray(xs)), ranks(np.asarray(ys))
    if rx.std() == 0 or ry.std() == 0:
        return 0.0
    return float(np.corrcoef(rx, ry)[0, 1])


def run_fidelity(configs, device: str, steps=10, calibrate_top_k=6,
                 partial_path: str | None = None) -> dict:
    import torch

    from flexflow_tpu_torch import LossType, SGDOptimizer

    on_card = device.startswith("cuda")
    cal_cache: dict = {}  # shared across configs (keyed by op + shapes)
    rows = []
    for spec in configs:
        ff, feeds, labels = spec["make"](device)
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        pred_raw = predict_step_time(ff)
        # the roofline composed prediction is a (loose) physical lower
        # bound: a tenth of it floors the fluke filter on the card
        floor = 0.1 * pred_raw if on_card else 0.0
        measured = measure_step_time(ff, feeds, labels, steps=steps,
                                     floor_s=floor)
        pred_cal = predict_step_time(ff, calibrate_top_k=calibrate_top_k,
                                     calibration_cache=cal_cache)
        rows.append({
            "name": spec["name"],
            "measured_ms": round(measured * 1e3, 4),
            "predicted_ms": round(pred_raw * 1e3, 4),
            "predicted_calibrated_ms": round(pred_cal * 1e3, 4),
            "rel_err": round(pred_raw / measured - 1.0, 4),
            "rel_err_calibrated": round(pred_cal / measured - 1.0, 4),
        })
        print(f"fidelity: {rows[-1]}", flush=True)
        if partial_path:  # survive a timeout with partial evidence
            with open(partial_path, "w") as f:
                json.dump({"partial": True, "configs": rows}, f, indent=1)
        del ff
    measured = [r["measured_ms"] for r in rows]
    raw = [r["predicted_ms"] for r in rows]
    cal = [r["predicted_calibrated_ms"] for r in rows]

    def mare(pred):
        return round(sum(abs(p / m - 1.0) for p, m in zip(pred, measured))
                     / len(measured), 4)

    return {
        "device": (torch.cuda.get_device_name(torch.device(device))
                   if on_card else "cpu"),
        "n_configs": len(rows),
        "configs": rows,
        "spearman": _spearman(raw, measured),
        "spearman_calibrated": _spearman(cal, measured),
        "mean_abs_rel_err": mare(raw),
        "mean_abs_rel_err_calibrated": mare(cal),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default="",
                    help="write the report here (default: stdout only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--configs", default="",
                    help="comma-separated names of the battery to run "
                    "(default: all of the device's battery)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    sys.argv = [sys.argv[0]]  # FFConfig must not parse our flags
    on_card = args.device.startswith("cuda")
    if on_card:
        from flexflow_tpu_torch import FFConfig
        from flexflow_tpu_torch.config import resolve_device

        resolve_device(FFConfig(device=args.device))  # absent: raises
    battery = card_configs() if on_card else cpu_configs()
    if args.configs:
        want = [c.strip() for c in args.configs.split(",") if c.strip()]
        by_name = {c["name"]: c for c in card_configs() + cpu_configs()}
        unknown = [w for w in want if w not in by_name]
        if unknown:
            print(f"fidelity: unknown config(s) {unknown}; have "
                  f"{sorted(by_name)}", file=sys.stderr)
            return 2
        battery = [by_name[w] for w in want]
    report = run_fidelity(battery, args.device,
                          steps=10 if on_card else 3,
                          calibrate_top_k=4,
                          partial_path=(args.out + ".partial"
                                        if args.out else None))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        partial = args.out + ".partial"
        if os.path.exists(partial):
            os.remove(partial)
    print(json.dumps({k: v for k, v in report.items() if k != "configs"},
                     indent=1))
    for r in report["configs"]:
        print(f"  {r['name']:28s} measured {r['measured_ms']:9.3f} ms  "
              f"raw {r['predicted_ms']:9.3f} ({r['rel_err']:+.0%})  "
              f"cal {r['predicted_calibrated_ms']:9.3f} "
              f"({r['rel_err_calibrated']:+.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
