"""Chunk planning (a copy of `flexflow_tpu/engine/chunking.py`).

The serving engine covers a prompt's prefill with `plan_chunks` and runs
one chunk per iteration. In the JAX package the same planner also cuts an
epoch into fused multi-step training dispatches; that engine is not
ported (ROADMAP A10): the port's `fit` is the eager loop.
"""

from __future__ import annotations


def plan_chunks(b0: int, num_batches: int,
                pipeline_steps: int) -> list[tuple[int, int]]:
    """Cover batches [b0, num_batches) with chunks of up to
    `pipeline_steps` steps. Returns [(start_batch, n_steps), ...]; the
    final chunk absorbs the remainder (a shorter chunk costs one extra
    compile per distinct size, cached by the executor)."""
    if pipeline_steps < 1:
        raise ValueError(f"pipeline_steps must be >= 1, got {pipeline_steps}")
    if b0 < 0:
        raise ValueError(f"b0 must be >= 0, got {b0}")
    chunks = []
    b = b0
    while b < num_batches:
        n = min(pipeline_steps, num_batches - b)
        chunks.append((b, n))
        b += n
    return chunks
