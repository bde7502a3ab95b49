"""LayerNorm — the port of ``LayerNormOp`` in flexflow_tpu/ops/norm.py:
statistics in float32, biased variance, ``eps`` inside the rsqrt, the
result cast back to the input dtype (norm.py:93-104)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import (
    ConstantInitializer,
    ZeroInitializer,
)
from flexflow_tpu_torch.ops.base import Operator, WeightSpec, register_op


@register_op
class LayerNormOp(Operator):
    """attrs: axes (normalized trailing axes), elementwise_affine, eps."""

    op_type = OperatorType.LAYERNORM

    def __init__(self, name, input_shapes, axes: Tuple[int, ...] = (-1,),
                 elementwise_affine: bool = True, eps: float = 1e-5):
        nd = len(input_shapes[0].sizes)
        axes = tuple(sorted(a % nd for a in axes))
        super().__init__(name, input_shapes, axes=axes,
                         elementwise_affine=elementwise_affine, eps=eps)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def _param_shape(self) -> Tuple[int, ...]:
        x = self.input_shapes[0]
        return tuple(x.sizes[a] for a in self.attrs["axes"])

    def weight_specs(self):
        if not self.attrs["elementwise_affine"]:
            return ()
        shp = self._param_shape()
        return (
            WeightSpec("gamma", shp, DataType.FLOAT32,
                       ConstantInitializer(1.0)),
            WeightSpec("beta", shp, DataType.FLOAT32, ZeroInitializer()),
        )

    def forward(self, ctx, inputs, weights):
        x = inputs[0].float()
        axes = self.attrs["axes"]
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.attrs["eps"])
        if self.attrs["elementwise_affine"]:
            bshape = [1] * x.ndim
            for a in axes:
                bshape[a] = x.shape[a]
            y = (y * weights["gamma"].reshape(bshape)
                 + weights["beta"].reshape(bshape))
        return [y.to(inputs[0].dtype)]
