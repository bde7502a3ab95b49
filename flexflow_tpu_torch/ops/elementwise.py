"""Elementwise binary operators — the port of ``ElementBinaryOp`` in
flexflow_tpu/ops/elementwise.py, for the add the decode graph's
residuals use, with the reference's ``propagate`` (elementwise.py:
114-131: inputs aligned to the output from the right, as numpy
broadcasts).  The other binary and the unary types come with the
slices whose models use them (ROADMAP Queue A item 6)."""

from __future__ import annotations

from typing import Sequence

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import (
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)

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
                f"binary op {binary_type.value!r} is not ported yet "
                f"(ROADMAP Queue A item 6)")
        self.op_type = binary_type
        super().__init__(name, input_shapes, binary_type=binary_type.value)

    def infer(self) -> Sequence[ParallelTensorShape]:
        a, b = self.input_shapes
        out = torch.broadcast_shapes(a.sizes, b.sizes)
        return (ParallelTensorShape.make(tuple(out), a.dtype),)

    def forward(self, ctx, inputs, weights):
        t = OperatorType(self.attrs["binary_type"])
        return [_BINARY_FNS[t](inputs[0], inputs[1])]

    def propagate(self, mv: MachineView) -> OpSharding:
        out_sizes = self.output_shapes[0].sizes
        out_nd = len(out_sizes)
        ins = []
        for s in self.input_shapes:
            degs = [1] * s.ndim
            idx = [-1] * s.ndim
            # align from the right (numpy broadcasting)
            for i in range(1, s.ndim + 1):
                if s.sizes[-i] == out_sizes[-i]:
                    degs[-i] = mv.dim_degrees[-i]
                    idx[-i] = out_nd - i
            ins.append(ShardAnnot(tuple(degs), mv.replica_degree,
                                  idx=tuple(idx)))
        return OpSharding(
            inputs=tuple(ins),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self):
        return tuple(range(self.output_shapes[0].ndim))
