"""Serving engine of the port (twin of `flexflow_tpu/serving`).

`model.serve()` builds the decode graph of the model's own layer list
(causal attention becomes incremental attention over a paged or
contiguous KV cache) and runs Orca-style continuous batching over a fixed
slot set:

    engine = model.serve(slots=8, max_new_tokens=64)
    outputs = engine.generate(prompts)

`serve(speculate=True, draft_model=...)` drafts K tokens a round with a
small LM and verifies them in one call (speculative.py);
`serve(disaggregate=True)` runs prefill and decode on disjoint windows of
the torchrun world with the KV handed over device to device (disagg.py).
"""

from .decode_graph import ServingSpec, adopt_params, build_decode_model
from .disagg import DisaggregatedServingEngine
from .engine import ServingEngine
from .paged import BlockManager, CopyPlan, PagedStats
from .radix import RadixPrefixCache
from .scheduler import ContinuousBatchingScheduler, Request, Slot
from .speculative import DrafterPlane, SpeculativeServingEngine

__all__ = [
    "ServingEngine", "DisaggregatedServingEngine",
    "SpeculativeServingEngine", "DrafterPlane", "ServingSpec",
    "Request", "Slot",
    "ContinuousBatchingScheduler", "build_decode_model", "adopt_params",
    "BlockManager", "CopyPlan", "PagedStats", "RadixPrefixCache",
]
