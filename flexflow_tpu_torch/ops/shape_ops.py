"""Shape operators — the port of ``ReshapeOp`` in
flexflow_tpu/ops/shape_ops.py (the one the decode graph uses)."""

from __future__ import annotations

from typing import Sequence, Tuple

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import Operator, register_op


@register_op
class ReshapeOp(Operator):
    op_type = OperatorType.RESHAPE

    def __init__(self, name, input_shapes, shape: Tuple[int, ...]):
        super().__init__(name, input_shapes,
                         shape=tuple(int(s) for s in shape))

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        tgt = list(self.attrs["shape"])
        if -1 in tgt:
            known = 1
            for s in tgt:
                if s != -1:
                    known *= s
            tgt[tgt.index(-1)] = x.num_elements // known
        out = ParallelTensorShape.make(tgt, x.dtype)
        if out.num_elements != x.num_elements:
            raise ValueError(f"reshape {x.sizes} -> {tuple(tgt)}")
        return (out,)

    def forward(self, ctx, inputs, weights):
        return [inputs[0].reshape(self.output_shapes[0].sizes)]
