"""Elementwise binary operators — the port of ``ElementBinaryOp`` in
flexflow_tpu/ops/elementwise.py, for the add the decode graph's
residuals use.  The other binary and the unary types come with the
slices whose models use them."""

from __future__ import annotations

from typing import Sequence

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import Operator, register_op

_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
}


@register_op
class ElementBinaryOp(Operator):
    """Numpy-broadcasting binary op."""

    op_type = OperatorType.EW_ADD

    def __init__(self, name, input_shapes, binary_type: OperatorType):
        if binary_type not in _BINARY_FNS:
            raise NotImplementedError(
                f"binary op {binary_type.value!r} is not ported yet")
        self.op_type = binary_type
        super().__init__(name, input_shapes, binary_type=binary_type.value)

    def infer(self) -> Sequence[ParallelTensorShape]:
        a, b = self.input_shapes
        out = torch.broadcast_shapes(a.sizes, b.sizes)
        return (ParallelTensorShape.make(tuple(out), a.dtype),)

    def forward(self, ctx, inputs, weights):
        t = OperatorType(self.attrs["binary_type"])
        return [_BINARY_FNS[t](inputs[0], inputs[1])]
