"""Weight initializers — the port of flexflow_tpu/initializers.py.

Each initializer draws from an explicit ``torch.Generator`` on the CPU
and returns a float32 tensor; the lowering moves it to the model's
device.  Drawing on the CPU keeps a seed's weights the same on every
device.  The two frameworks' generators give different numbers for
the same seed, so parity tests copy weights across instead of
re-drawing them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


class Initializer:
    def init(self, gen: torch.Generator, shape: Tuple[int, ...]
             ) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class GlorotUniformInitializer(Initializer):
    """Glorot/Xavier uniform with the reference's Keras fan convention:
    for rank >= 2 the last two dims are (fan_in, fan_out), the leading
    dims a receptive field."""

    def init(self, gen, shape):
        if len(shape) >= 2:
            receptive = math.prod(shape[:-2])
            fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-limit, limit, generator=gen)


@dataclass
class ZeroInitializer(Initializer):
    def init(self, gen, shape):
        return torch.zeros(shape)


@dataclass
class ConstantInitializer(Initializer):
    value: float = 0.0

    def init(self, gen, shape):
        return torch.full(shape, float(self.value))


@dataclass
class NormInitializer(Initializer):
    mean: float = 0.0
    stddev: float = 0.05

    def init(self, gen, shape):
        return self.mean + self.stddev * torch.randn(shape, generator=gen)


DEFAULT_WEIGHT_INIT = GlorotUniformInitializer()
DEFAULT_BIAS_INIT = ZeroInitializer()
