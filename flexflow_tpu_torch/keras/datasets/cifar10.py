"""CIFAR-10 loader (reference python/flexflow/keras/datasets/cifar10.py +
cifar.py's batch unpickling). `load_data()` returns ((x_train, y_train),
(x_test, y_test)): x uint8 NCHW (N, 3, 32, 32) — the reference's
channels-first convention its CNN examples consume — y uint8 (N, 1).
Resolution mirrors mnist.py: a local `cifar10.npz` archive, else a
deterministic synthetic fallback (no network egress here).
(Twin of `flexflow_tpu/keras/datasets/cifar10.py`.)
"""

from __future__ import annotations

import numpy as np

from .mnist import _local_archive, _synthetic


def load_data(path: str = "cifar10.npz", synthetic: bool | None = None,
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
    (xtr, ytr), (xte, yte) = _synthetic((3, 32, 32), 10, n_train, n_test,
                                        seed=1)
    return (xtr, ytr.reshape(-1, 1)), (xte, yte.reshape(-1, 1))
