"""Serving engine of the port (twin of `flexflow_tpu/serving`).

`model.serve()` builds the decode graph of the model's own layer list
(causal attention becomes incremental attention over a paged or
contiguous KV cache) and runs Orca-style continuous batching over a fixed
slot set:

    engine = model.serve(slots=8, max_new_tokens=64)
    outputs = engine.generate(prompts)
"""

from .decode_graph import ServingSpec, adopt_params, build_decode_model
from .engine import ServingEngine
from .paged import BlockManager, CopyPlan, PagedStats
from .radix import RadixPrefixCache
from .scheduler import ContinuousBatchingScheduler, Request, Slot

__all__ = [
    "ServingEngine", "ServingSpec", "Request", "Slot",
    "ContinuousBatchingScheduler", "build_decode_model", "adopt_params",
    "BlockManager", "CopyPlan", "PagedStats", "RadixPrefixCache",
]
