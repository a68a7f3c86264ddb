"""MNIST loader (reference python/flexflow/keras/datasets/mnist.py).

`load_data()` returns ((x_train, y_train), (x_test, y_test)) with the real
shapes/dtypes: x uint8 (N, 28, 28), y uint8 (N,). Resolution order:
  1. an `mnist.npz` in $FLEXFLOW_DATASET_DIR or ~/.keras/datasets (the
     standard keras cache layout: arrays x_train/y_train/x_test/y_test);
  2. with synthetic=True (default — this environment has no network
     egress), a DETERMINISTIC synthetic set: 10 fixed class-template
     images + per-sample noise, linearly separable so training gates
     (≥90% accuracy) are meaningful. Pass synthetic=False to require the
     real archive.
(Twin of `flexflow_tpu/keras/datasets/mnist.py`.)
"""

from __future__ import annotations

import os

import numpy as np


def _local_archive(name: str):
    candidates = []
    env = os.environ.get("FLEXFLOW_DATASET_DIR")
    if env:
        candidates.append(os.path.join(env, name))
    candidates.append(os.path.expanduser(f"~/.keras/datasets/{name}"))
    for p in candidates:
        if os.path.exists(p):
            return p
    return None


def _synthetic(shape, num_classes, n_train, n_test, seed):
    rs = np.random.RandomState(seed)
    templates = rs.randint(0, 256, (num_classes,) + shape).astype(np.float32)

    def split(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, num_classes, n).astype(np.uint8)
        noise = r.randn(n, *shape).astype(np.float32) * 32.0
        x = np.clip(templates[y] * 0.5 + noise + 64.0, 0, 255)
        return x.astype(np.uint8), y

    return split(n_train, seed + 1), split(n_test, seed + 2)


def load_data(path: str = "mnist.npz", synthetic: bool | None = None,
              n_train: int = 8192, n_test: int = 1024):
    local = _local_archive(path)
    if local is not None:
        with np.load(local, allow_pickle=True) as f:
            return ((f["x_train"], f["y_train"]),
                    (f["x_test"], f["y_test"]))
    if synthetic is False:
        raise FileNotFoundError(
            f"{path} not found in $FLEXFLOW_DATASET_DIR or "
            f"~/.keras/datasets and synthetic=False; this environment has "
            f"no network egress to download it")
    return _synthetic((28, 28), 10, n_train, n_test, seed=0)
