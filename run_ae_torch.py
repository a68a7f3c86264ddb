"""AE-style example runner for the PyTorch port — reference
scripts/osdi22ae/*.sh + tests/python_interface_test.sh in ONE command.
Twin of `scripts/run_ae.py`.

For each model of the OSDI'22 artifact-evaluation set (MLP, AlexNet, DLRM,
MoE, Inception-v3, XDL, candle-uno, ResNeXt-50), at the JAX script's
widths, this trains the zoo build twice — once with the Unity-style search
enabled (joint rewrite x placement search plus mesh factorization, the
dlrm.sh "strategy discovered by Unity" leg) and once with pure data
parallelism (the --only-data-parallel leg) — and prints one
machine-readable `AE_RESULT {json}` line per run and a summary last. The
MNIST MLP additionally enforces the reference's >= 90% train-accuracy
gate (python_interface_test.sh's check).

The mesh is the `torch.distributed` world: the meaningful run is

  torchrun --nproc-per-node 4 run_ae_torch.py

(one card a rank; the search may refactor the world's ranks over the
mesh axes). In one process both modes get a mesh of one rank, and the
script says so before the first run. Runs on the card by default;
`--device cpu` on the CPU (the heavy CNNs at batch 2 there).
`samples_per_sec` is the JAX script's: epochs x the batches of the data
over the fit's whole wall time, first steps (capture) included; with
`--batches N` each epoch runs N batches (default: the JAX script's data
sizes per model), so that compile and capture do not dominate.

Usage:
  python run_ae_torch.py                  # full set, on the card
  python run_ae_torch.py --models mlp,dlrm,moe --batches 64 --epochs 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

def _spec_mlp(batch, rs):
    from flexflow_tpu_torch.models import build_mnist_mlp

    def build(ff):
        build_mnist_mlp(ff, batch_size=batch)
        centers = rs.randn(10, 784) * 2.0
        n = max(2048, batch * 8)
        y = rs.randint(0, 10, n)
        x = (centers[y] + rs.randn(n, 784)).astype(np.float32)
        return {"input": x}, y.reshape(-1, 1).astype(np.int32), "scce"

    return build


def _spec_alexnet(batch, rs):
    from flexflow_tpu_torch.models import build_alexnet

    def build(ff):
        build_alexnet(ff, batch_size=batch)
        n = batch * 2
        x = rs.randn(n, 3, 229, 229).astype(np.float32)
        y = rs.randint(0, 10, (n, 1)).astype(np.int32)
        return {"input": x}, y, "scce"

    return build


def _spec_inception(batch, rs):
    from flexflow_tpu_torch.models import build_inception_v3

    def build(ff):
        build_inception_v3(ff, batch_size=batch)
        n = batch * 2
        x = rs.randn(n, 3, 299, 299).astype(np.float32)
        y = rs.randint(0, 10, (n, 1)).astype(np.int32)
        return {"input": x}, y, "scce"

    return build


def _spec_resnext(batch, rs):
    from flexflow_tpu_torch.models import build_resnext50

    def build(ff):
        build_resnext50(ff, batch_size=batch)
        n = batch * 2
        x = rs.randn(n, 3, 224, 224).astype(np.float32)
        y = rs.randint(0, 10, (n, 1)).astype(np.int32)
        return {"input": x}, y, "scce"

    return build


def _spec_dlrm(batch, rs):
    from flexflow_tpu_torch.models import DLRMConfig, build_dlrm

    def build(ff):
        c = DLRMConfig(sparse_feature_size=16,
                       embedding_size=(1000, 1000, 1000, 1000),
                       mlp_bot=(16, 64, 16), mlp_top=(80, 64, 2))
        build_dlrm(ff, c, batch_size=batch)
        n = batch * 4
        feeds = {f"sparse{i}": rs.randint(0, 1000, (n, 1)).astype(np.int64)
                 for i in range(4)}
        feeds["dense_input"] = rs.randn(n, 16).astype(np.float32)
        y = rs.rand(n, 2).astype(np.float32)
        return feeds, y, "mse"

    return build


def _spec_xdl(batch, rs):
    from flexflow_tpu_torch.models import build_xdl
    from flexflow_tpu_torch.models.xdl import XDLConfig

    def build(ff):
        c = XDLConfig(sparse_feature_size=16,
                      embedding_size=(1000,) * 4, mlp_top=(256, 64, 2))
        build_xdl(ff, c, batch_size=batch)
        n = batch * 4
        feeds = {f"sparse{i}": rs.randint(0, 1000, (n, 1)).astype(np.int64)
                 for i in range(4)}
        y = rs.rand(n, 2).astype(np.float32)
        return feeds, y, "mse"

    return build


def _spec_moe(batch, rs):
    from flexflow_tpu_torch.models import MoeConfig, build_moe

    def build(ff):
        c = MoeConfig()
        build_moe(ff, c, batch_size=batch, fused=True)
        n = max(1024, batch * 8)
        centers = rs.randn(10, c.in_dim) * 2.0
        y = rs.randint(0, 10, n)
        x = (centers[y] + rs.randn(n, c.in_dim)).astype(np.float32)
        return {"input": x}, y.reshape(-1, 1).astype(np.int32), "scce"

    return build


def _spec_candle(batch, rs):
    from flexflow_tpu_torch.models import build_candle_uno
    from flexflow_tpu_torch.models.candle_uno import CandleUnoConfig

    def build(ff):
        c = CandleUnoConfig()
        inputs, _ = build_candle_uno(ff, c, batch_size=batch)
        n = batch * 4
        feeds = {t.name: rs.randn(n, t.dims[1]).astype(np.float32)
                 for t in inputs}
        y = rs.rand(n, 1).astype(np.float32)
        return feeds, y, "mse"

    return build


SPECS = {
    "mlp": (_spec_mlp, 0.90),       # (spec factory, accuracy gate or None)
    "alexnet": (_spec_alexnet, None),
    "dlrm": (_spec_dlrm, None),
    "moe": (_spec_moe, None),
    "inception": (_spec_inception, None),
    "xdl": (_spec_xdl, None),
    "candle_uno": (_spec_candle, None),
    "resnext50": (_spec_resnext, None),
}

_MODES = {
    "unity": ["--budget", "8", "--enable-parameter-parallel",
              "--search-mesh-shapes"],
    "dp": ["--only-data-parallel"],
}


_MODES = {
    "unity": ["--budget", "8", "--enable-parameter-parallel",
              "--search-mesh-shapes"],
    "dp": ["--only-data-parallel"],
}


def _say(text: str):
    from flexflow_tpu_torch.distributed import world_rank

    if world_rank() == 0:
        print(text, flush=True)


def _resized(feeds, labels, n: int, rs):
    """The spec's data cut or tiled (rows drawn with `rs`) to `n` rows."""
    have = labels.shape[0]
    idx = (np.arange(n) if n <= have
           else rs.randint(0, have, size=n))
    return ({k: v[idx] for k, v in feeds.items()}, labels[idx])


def run_one(name: str, mode: str, batch: int, epochs: int,
            device: str = "cuda", batches: int = 0) -> dict:
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.distributed import world_size

    spec_factory, gate = SPECS[name]
    ndev = world_size()
    sys.argv = ["run_ae"] + _MODES[mode]
    config = FFConfig(device=device)
    config.batch_size = batch
    # dp: the world on `data`; unity: re-factorized by the search
    config.mesh_axis_sizes = (ndev, 1, 1, 1)
    ff = FFModel(config)
    rs = np.random.RandomState(0)
    feeds, labels, loss = spec_factory(batch, rs)(ff)
    if batches:
        feeds, labels = _resized(feeds, labels, batches * batch, rs)
    loss_type = (LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
                 if loss == "scce"
                 else LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    metrics = [MetricsType.METRICS_ACCURACY] if loss == "scce" else []
    ff.compile(optimizer=SGDOptimizer(lr=0.01 if gate is None else 0.05),
               loss_type=loss_type, metrics=metrics)
    n = labels.shape[0]
    # (no global RNG seeding: fit's shuffle is keyed on (config.seed,
    # absolute epoch) — fflint's global_rng rule keeps it out)
    t0 = time.perf_counter()
    ff.fit(feeds, labels, epochs=epochs)
    dt = time.perf_counter() - t0
    result = {
        "model": name,
        "mode": mode,
        "mesh": dict(ff.mesh.shape),
        "samples_per_sec": round(epochs * (n // batch) * batch / dt, 2),
    }
    if gate is not None:
        acc = ff.get_perf_metrics().get_accuracy()
        result["accuracy"] = round(acc, 4)
        result["gate"] = gate
        if acc < gate:
            _say(f"AE_RESULT {json.dumps(result)}")
            raise SystemExit(
                f"{name}: accuracy gate failed ({acc:.4f} < {gate})")
    _say(f"AE_RESULT {json.dumps(result)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(SPECS))
    ap.add_argument("--batches", type=int, default=0,
                    help="batches an epoch (0 = the per-model data size)")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="0 = per-model default")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--modes", default="unity,dp")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from flexflow_tpu_torch.distributed import (
        initialize_from_env,
        world_size,
    )

    initialize_from_env(args.device)
    ndev = world_size()
    if ndev == 1:
        _say("run_ae: one process — both modes run on a mesh of one rank "
             "(torchrun --nproc-per-node N run_ae_torch.py for a mesh)")
    on_card = args.device.startswith("cuda")
    heavy = {"alexnet", "inception", "resnext50"}
    results = []
    for name in args.models.split(","):
        name = name.strip()
        if name not in SPECS:
            raise SystemExit(f"unknown model {name!r}; have {sorted(SPECS)}")
        base = 2 if (name in heavy and not on_card) else 8
        batch = args.batch_size or max(base, ndev)
        for mode in args.modes.split(","):
            _say(f"Running {name} with "
                 + ("a parallelization strategy discovered by Unity"
                    if mode == "unity" else "data parallelism"))
            results.append(run_one(name, mode.strip(), batch, args.epochs,
                                   args.device, args.batches))
    _say(json.dumps({"ae_summary": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
