"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam (twin of
`flexflow_tpu/optimizer.py`, same update formulas in the same order).

`init(params)` -> slots; `update(grads, params, slots, step)` ->
(params, slots). Parameters are `{node: {weight: tensor}}` dicts of f32
masters. The masters and the optimizer slots (momentum, Adam's m and v)
are updated in place under `no_grad`, where the JAX step donates them
(`donate_argnums`): a captured train step (`executor.CapturedStep`) reads
and writes the same tensors on every replay. The updates go through
`torch._foreach_*`: one launch per op for the whole parameter list instead
of one per tensor.
`step` is the number of updates already applied, a device int32 scalar;
Adam's bias correction is computed from it in float32 tensors, as the JAX
package computes it in f32 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _flat(tree: dict):
    keys = [(n, k) for n, ws in tree.items() for k in ws]
    return keys, [tree[n][k] for n, k in keys]


def _unflat(keys, values) -> dict:
    out: dict = {}
    for (n, k), v in zip(keys, values):
        out.setdefault(n, {})[k] = v
    return out


class Optimizer:
    @property
    def num_slots(self) -> int:
        """Optimizer state entries per weight (the search's memory
        model): SGD 1 with momentum (0 without), Adam 2."""
        return 1

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, params, slots, step):
        raise NotImplementedError

    def next(self):
        """Per-iteration hook (reference Optimizer::next, where Adam folds
        its beta^t factors); nothing to do here: `step` is passed to
        `update`."""

    def set_learning_rate(self, lr: float):
        if not hasattr(self, "lr"):
            raise ValueError('Optimizer must have a "lr" attribute.')
        self.lr = float(lr)


@dataclass
class SGDOptimizer(Optimizer):
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    @property
    def num_slots(self) -> int:
        return 1 if self.momentum > 0.0 else 0

    def init(self, params):
        if self.momentum == 0.0:
            # a scalar zero per weight, as the JAX package keeps (its
            # checkpoints carry them); `update` reads none of them
            return {"v": {n: {k: torch.zeros((), dtype=t.dtype,
                                             device=t.device)
                              for k, t in ws.items()}
                          for n, ws in params.items()}}
        return {"v": {n: {k: torch.zeros_like(t) for k, t in ws.items()}
                      for n, ws in params.items()}}

    @torch.no_grad()
    def update(self, grads, params, slots, step):
        keys, ps = _flat(params)
        gs = [grads[n][k] for n, k in keys]
        if self.weight_decay != 0.0:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        if self.momentum > 0.0:
            vs = [slots["v"][n][k] for n, k in keys]
            torch._foreach_mul_(vs, self.momentum)
            torch._foreach_add_(vs, gs)  # v = momentum * v + g
            gs = (torch._foreach_add(gs, vs, alpha=self.momentum)
                  if self.nesterov else vs)
        torch._foreach_sub_(ps, torch._foreach_mul(gs, self.lr))
        return _unflat(keys, ps), slots


@dataclass
class AdamOptimizer(Optimizer):
    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    @property
    def num_slots(self) -> int:
        return 2  # m and v

    @property
    def lr(self) -> float:
        return self.alpha

    @lr.setter
    def lr(self, value: float):
        self.alpha = float(value)

    def init(self, params):
        return {m: {n: {k: torch.zeros_like(t) for k, t in ws.items()}
                    for n, ws in params.items()} for m in ("m", "v")}

    @torch.no_grad()
    def update(self, grads, params, slots, step):
        keys, ps = _flat(params)
        gs = [grads[n][k] for n, k in keys]
        ms = [slots["m"][n][k] for n, k in keys]
        vs = [slots["v"][n][k] for n, k in keys]
        # bias-corrected step size, in float32 on the step's device
        t = step.float() + 1.0
        alpha_t = (self.alpha * torch.sqrt(1.0 - torch.pow(self.beta2, t))
                   / (1.0 - torch.pow(self.beta1, t)))
        if self.weight_decay != 0.0:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - self.beta1))
        g2 = torch._foreach_mul(gs, 1.0 - self.beta2)
        torch._foreach_mul_(g2, gs)  # (1 - beta2) * g * g
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_add_(vs, g2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        num = torch._foreach_mul(ms, alpha_t)
        torch._foreach_div_(num, denom)  # alpha_t * m / (sqrt(v) + eps)
        torch._foreach_sub_(ps, num)
        return _unflat(keys, ps), slots
