"""Keras dataset loaders (reference python/flexflow/keras/datasets/:
mnist.py, cifar10.py). Same `load_data()` surface; this environment has no
network egress, so loaders read a local archive when present (the standard
keras cache or $FLEXFLOW_DATASET_DIR) and otherwise fall back to a
deterministic synthetic set with the real shapes/dtypes (clearly labeled —
pass synthetic=False to require real data).
(Twin of `flexflow_tpu/keras/datasets/__init__.py`.)
"""

from . import cifar10, mnist
