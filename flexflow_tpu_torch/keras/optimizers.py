"""Keras optimizers (reference python/flexflow/keras/optimizers.py).
(Twin of `flexflow_tpu/keras/optimizers.py`.)
"""

from __future__ import annotations

from ..optimizer import AdamOptimizer, SGDOptimizer


class SGD:
    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0, **kwargs):
        self.core = SGDOptimizer(lr=learning_rate, momentum=momentum,
                                 nesterov=nesterov,
                                 weight_decay=weight_decay)


class Adam:
    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8, **kwargs):
        self.core = AdamOptimizer(alpha=learning_rate, beta1=beta_1,
                                  beta2=beta_2, epsilon=epsilon)


def get(name_or_opt):
    if isinstance(name_or_opt, (SGD, Adam)):
        return name_or_opt.core
    if isinstance(name_or_opt, str):
        return {"sgd": SGD(), "adam": Adam()}[name_or_opt.lower()].core
    return name_or_opt  # already a core Optimizer
