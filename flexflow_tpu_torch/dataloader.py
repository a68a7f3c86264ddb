"""Data loading (twin of `flexflow_tpu/dataloader.py`, host side).

The full array stays in host memory as numpy; `next_batch` slices it
round-robin with an epoch-stable order (sequential batches, `reset()` to
restart). `FFModel.start_batch` or `fit` stages a batch on the device.
"""

from __future__ import annotations

import numpy as np


class SingleDataLoader:
    def __init__(self, ffmodel, batch_tensor, full_array: np.ndarray):
        self.ffmodel = ffmodel
        self.batch_tensor = batch_tensor
        self.full_array = np.ascontiguousarray(full_array)
        self.num_samples = int(full_array.shape[0])
        self.batch_size = batch_tensor.dims[0]
        self.next_index = 0

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.next_index = 0

    def next_batch(self, ffmodel=None) -> np.ndarray:
        if self.next_index + self.batch_size > self.num_samples:
            self.next_index = 0
        sl = slice(self.next_index, self.next_index + self.batch_size)
        self.next_index += self.batch_size
        return self.full_array[sl]
