"""Weight transfer into the port.

The port's initializers draw from `torch.Generator`s and the JAX package's
from `jax.random`, so the two never start from the same weights. A model
holds its parameters as `{node_name: {weight_name: tensor}}` under the
same names in both packages (the builders name every layer alike), so a
dict of numpy arrays, e.g. from the JAX model's `get_weight`, makes both
compute the same function.
"""

from __future__ import annotations

import numpy as np


def load_params(model, params: dict) -> int:
    """Set `model`'s parameters from `{node_name: {weight_name: array}}`.
    Every name must exist in the compiled model and every shape must
    match; each array is cast to the parameter's dtype on its device.
    Parameters the dict does not name keep their values. Returns the
    number of weights set."""
    if not model._compiled:
        raise RuntimeError("compile() the model before load_params")
    n = 0
    for node_name, ws in params.items():
        if node_name not in model._params:
            raise KeyError(f"load_params: model has no parameters for "
                           f"node {node_name!r}")
        for wname, value in ws.items():
            if wname not in model._params[node_name]:
                raise KeyError(f"load_params: node {node_name!r} has no "
                               f"weight {wname!r}")
            model.set_weight(node_name, wname, np.asarray(value))
            n += 1
    return n
