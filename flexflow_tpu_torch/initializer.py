"""Weight initializers on `torch.Generator`s.

The twin of `flexflow_tpu/initializer.py`. The executor hands every weight
its own generator, seeded from the model seed and the (node, weight) name,
so a weight's values do not depend on evaluation order. The streams differ
from `jax.random`'s by design: tests that compare the two packages copy
the weights across (`convert.load_params`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape, dtype, device):
        raise NotImplementedError


def _uniform(gen, shape, dtype, device, lo, hi):
    # draw on the CPU generator, then move: one stream per weight whatever
    # the device
    t = torch.empty(tuple(shape), dtype=torch.float32)
    t.uniform_(lo, hi, generator=gen)
    return t.to(device=device, dtype=dtype)


@dataclass
class GlorotUniformInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        if len(shape) >= 2:
            fan_in, fan_out = shape[-2], shape[-1]
            receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
            fan_in *= receptive
            fan_out *= receptive
        else:
            fan_in = fan_out = shape[0] if shape else 1
        scale = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, device, -scale, scale)


@dataclass
class ConstantInitializer(Initializer):
    value: float = 0.0

    def __call__(self, gen, shape, dtype, device):
        return torch.full(tuple(shape), self.value, dtype=dtype, device=device)


@dataclass
class UniformInitializer(Initializer):
    min_val: float = 0.0
    max_val: float = 1.0

    def __call__(self, gen, shape, dtype, device):
        return _uniform(gen, shape, dtype, device, self.min_val, self.max_val)


@dataclass
class NormInitializer(Initializer):
    mean: float = 0.0
    stddev: float = 1.0

    def __call__(self, gen, shape, dtype, device):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        t.normal_(self.mean, self.stddev, generator=gen)
        return t.to(device=device, dtype=dtype)


_BY_NAME = {
    "glorot_uniform": GlorotUniformInitializer(),
    "zeros": ConstantInitializer(0.0),
    "ones": ConstantInitializer(1.0),
    "normal": NormInitializer(stddev=0.02),
    "uniform": UniformInitializer(),
}


def initializer_by_name(name: str) -> Initializer:
    return _BY_NAME[name]
