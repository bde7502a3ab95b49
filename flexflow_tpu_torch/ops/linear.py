"""Linear (dense) operator — the port of ``LinearOp`` in
flexflow_tpu/ops/linear.py (linear.py:106-113): the input and kernel
cast to the compute dtype, the product accumulated in float32, a
float32 bias, then the activation.  The product is one
``torch.matmul``, as the reference left it to XLA; with a bfloat16
compute dtype the card accumulates in float32 and rounds the product
to bfloat16 before the bias add, where XLA keeps it in float32.
Gradients flow through it by autograd; ``flops`` is the reference's
(linear.py:142-144)."""

from __future__ import annotations

from typing import Sequence

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import (
    DEFAULT_BIAS_INIT,
    DEFAULT_WEIGHT_INIT,
    Initializer,
)
from flexflow_tpu_torch.ops.base import Operator, WeightSpec, register_op

_ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
}


@register_op
class LinearOp(Operator):
    op_type = OperatorType.LINEAR

    def __init__(self, name, input_shapes, out_dim: int,
                 activation: str | None = None, use_bias: bool = True,
                 kernel_initializer: Initializer | None = None,
                 bias_initializer: Initializer | None = None):
        if activation not in _ACTIVATIONS:
            raise NotImplementedError(
                f"LinearOp activation {activation!r} is not ported yet; "
                f"one of {sorted(k for k in _ACTIVATIONS if k)}")
        self._kernel_init = kernel_initializer or DEFAULT_WEIGHT_INIT
        self._bias_init = bias_initializer or DEFAULT_BIAS_INIT
        super().__init__(name, input_shapes, out_dim=out_dim,
                         activation=activation, use_bias=use_bias)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        return (ParallelTensorShape.make(
            x.sizes[:-1] + (self.attrs["out_dim"],), x.dtype),)

    @property
    def in_dim(self) -> int:
        return self.input_shapes[0].sizes[-1]

    def weight_specs(self):
        specs = [WeightSpec("kernel", (self.in_dim, self.attrs["out_dim"]),
                            DataType.FLOAT32, self._kernel_init)]
        if self.attrs["use_bias"]:
            specs.append(WeightSpec("bias", (self.attrs["out_dim"],),
                                    DataType.FLOAT32, self._bias_init))
        return specs

    def forward(self, ctx, inputs, weights):
        cd = ctx.compute_dtype
        y = torch.matmul(inputs[0].to(cd), weights["kernel"].to(cd)).float()
        if self.attrs["use_bias"]:
            y = y + weights["bias"].float()
        y = _ACTIVATIONS[self.attrs["activation"]](y)
        return [y.to(inputs[0].dtype)]

    def flops(self) -> float:
        return 2.0 * self.output_shapes[0].num_elements * self.in_dim
