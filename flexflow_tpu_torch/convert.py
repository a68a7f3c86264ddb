"""Weight transfer into the port.

The port's initializers draw from `torch.Generator`s and the JAX package's
from `jax.random`, so the two never start from the same weights. A model
holds its parameters and its non-trainable state (BatchNorm's running
statistics, the KV caches) as `{node_name: {weight_name: tensor}}` under
the same names in both packages (the builders name every layer alike), so
a dict of numpy arrays, e.g. the JAX model's `_params` and `_state`,
makes both compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def load_params(model, params: dict) -> int:
    """Set `model`'s parameters and non-trainable state from
    `{node_name: {weight_name: array}}`. Every name must exist in the
    compiled model (a parameter or a state tensor) and every shape must
    match; each array is cast to the tensor's dtype on its device. A
    parameter gets a new tensor (`set_weight`); a state tensor is written
    in place, so a captured step that holds it reads the new values.
    Tensors the dict does not name keep their values. Returns the number
    of tensors set."""
    if not model._compiled:
        raise RuntimeError("compile() the model before load_params")
    state = model._state or {}
    n = 0
    for node_name, ws in params.items():
        if node_name not in model._params and node_name not in state:
            raise KeyError(f"load_params: model has no parameters for "
                           f"node {node_name!r}")
        for wname, value in ws.items():
            value = np.asarray(value)
            if wname in model._params.get(node_name, {}):
                model.set_weight(node_name, wname, value)
            elif wname in state.get(node_name, {}):
                old = state[node_name][wname]
                if tuple(value.shape) != tuple(old.shape):
                    raise ValueError(
                        f"{node_name}.{wname}: shape {value.shape} != "
                        f"{tuple(old.shape)}")
                with torch.no_grad():
                    old.copy_(torch.tensor(value))
            else:
                raise KeyError(f"load_params: node {node_name!r} has no "
                               f"weight {wname!r}")
            n += 1
    return n
