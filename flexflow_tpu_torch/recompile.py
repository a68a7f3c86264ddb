"""RecompileState: dynamic re-optimization hooks (twin of
`flexflow_tpu/recompile.py`).

Reference: include/flexflow/recompile.h:26-41 + recompile_state.cc:22-40 —
a (trigger, alter) callback pair checked each iteration so a model can be
rewritten mid-training (the MoE expert-scaling experiment, moe.cc:180-204).
Here `alter` may change the FFModel's strategy or layer params; the
executor's built steps are then dropped, each with its CUDA graphs and
their memory pools, so the next `fit` builds and captures anew (the JAX
package's retrace).
"""

from __future__ import annotations

from typing import Callable


class RecompileState:
    def __init__(self, trigger_func: Callable[..., bool],
                 alter_func: Callable[..., None], ffmodel):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ffmodel = ffmodel
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func(self.ffmodel))

    def alter(self):
        self.alter_func(self.ffmodel)
        # drop the built steps (a CapturedStep holds its graphs and their
        # pools): the next fit() builds and captures them again
        ex = self.ffmodel.executor
        if ex is not None:
            ex.drop_steps()
        self.recompilations += 1
