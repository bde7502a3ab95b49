"""Input sentinel operator — the port of ``InputOp`` in
flexflow_tpu/ops/inout.py."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import Operator, register_op


@register_op
class InputOp(Operator):
    """Graph source holding a frame input.  ``tensor_guid`` links back to
    the frontend Tensor: the lowering binds feed tensors in tensor-guid
    order, as the reference does."""

    op_type = OperatorType.INPUT

    def __init__(self, name, shape: ParallelTensorShape,
                 tensor_guid: int = -1):
        self._shape = shape
        super().__init__(name, [], tensor_guid=tensor_guid)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self._shape,)

    def forward(self, ctx, inputs, weights):
        raise RuntimeError("InputOp is bound by the executor, never lowered")
