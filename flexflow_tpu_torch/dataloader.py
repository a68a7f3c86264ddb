"""Data loading (twin of `flexflow_tpu/dataloader.py`, host side).

The full array stays in host memory as numpy; `next_batch` slices it
round-robin with an epoch-stable order (sequential batches, `reset()` to
restart; `state_dict`/`load_state_dict` save and restore the cursor).
`FFModel.start_batch` or `fit` stages a batch on the device;
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
        # whether the tensor is a graph input, resolved once on first use:
        # the graph cannot change after compile, so a scan of
        # graph.sources() per batch would be pure overhead
        self._is_input = None

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.next_index = 0

    # ---- resumable cursor (resilience/): a checkpointed run restores the
    # loader mid-epoch and the next batch is exactly the one the killed run
    # would have issued
    def state_dict(self) -> dict:
        return {"next_index": int(self.next_index)}

    def load_state_dict(self, state: dict):
        idx = int(state["next_index"])
        if idx < 0 or idx > self.num_samples:
            raise ValueError(
                f"dataloader cursor {idx} out of range for "
                f"{self.num_samples} samples")
        self.next_index = idx

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
            if self._is_input is None and ex is not None:
                self._is_input = any(n.name == name
                                     for n in ex.graph.sources())
            if self._is_input:
                return ex.stage_inputs({name: batch})[name]
            return torch.as_tensor(batch).to(self.ffmodel.device)
