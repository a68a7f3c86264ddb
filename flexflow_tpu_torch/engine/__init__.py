"""Pipelined execution engine (twin of `flexflow_tpu/engine/`).

`FFModel.fit` routes through PipelinedEngine when `--pipeline-steps N`
(or `fit(..., pipeline_steps=N)`) is > 1: chunks of N train steps run as
one CUDA-graph replay over batches a background thread staged on the
device ahead of time, with per-step telemetry reconstructed at chunk
boundaries. The default stays the per-step loop (`pipeline_steps=1`),
which the chunks equal bit for bit. `plan_chunks` also cuts a serving
prompt's prefill into chunks.
"""

from .chunking import plan_chunks
from .pipelined import PipelinedEngine
from .prefetch import ChunkPrefetcher, PrefetchExhausted

__all__ = [
    "PipelinedEngine", "ChunkPrefetcher", "PrefetchExhausted",
    "plan_chunks",
]
