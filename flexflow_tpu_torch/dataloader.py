"""Data loading (twin of `flexflow_tpu/dataloader.py`, host side).

The full array stays in host memory as numpy; `next_batch` slices it
round-robin with an epoch-stable order (sequential batches, `reset()` to
restart). `FFModel.start_batch` or `fit` stages a batch on the device;
`next_batch_sharded` stages it here: on a mesh, this rank's block of it,
by the placement of the graph input of the loader's tensor (the whole
batch for a tensor that is no graph input). Both carry the JAX loader's
telemetry spans (`data.next_batch`, `data_wait`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import telemetry


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
        with telemetry.span("data.next_batch"):
            if self.next_index + self.batch_size > self.num_samples:
                self.next_index = 0
            sl = slice(self.next_index, self.next_index + self.batch_size)
            self.next_index += self.batch_size
            return self.full_array[sl]

    def next_batch_sharded(self) -> torch.Tensor:
        """The next batch (this rank's block of it) on the model's device.
        The data_wait span covers the slice and the copy — the host-side
        stall a training step pays before dispatch."""
        with telemetry.span("data_wait"):
            batch = self.next_batch()
            ex = self.ffmodel.executor
            name = self.batch_tensor.name
            if ex is not None and any(
                    n.name == name for n in ex.graph.sources()):
                return ex.stage_inputs({name: batch})[name]
            return torch.as_tensor(batch).to(self.ffmodel.device)
