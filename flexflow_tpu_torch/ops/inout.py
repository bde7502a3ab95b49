"""Input and constant sentinel operators — the port of ``InputOp`` and
``ConstantOp`` in flexflow_tpu/ops/inout.py."""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import Operator, register_op


@register_op
class InputOp(Operator):
    """Graph source holding a frame input.  ``tensor_guid`` links back to
    the frontend Tensor: the lowering binds feed tensors in tensor-guid
    order, as the reference does."""

    op_type = OperatorType.INPUT
    is_gradient_free = True

    def __init__(self, name, shape: ParallelTensorShape,
                 tensor_guid: int = -1):
        self._shape = shape
        super().__init__(name, [], tensor_guid=tensor_guid)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self._shape,)

    def forward(self, ctx, inputs, weights):
        raise RuntimeError("InputOp is bound by the executor, never lowered")


@register_op
class ConstantOp(Operator):
    """Compile-time constant tensor (``build_gpt``'s position ids).  The
    value is kept as a numpy array; ``forward`` hands out one tensor per
    device, made at first use.  attrs keep a digest of the value, as the
    reference's do."""

    op_type = OperatorType.CONSTANT
    is_gradient_free = True

    def __init__(self, name, shape: ParallelTensorShape, value=None):
        self._shape = shape
        self._value = np.asarray(value)
        self._on_device = {}
        digest = hashlib.sha1(self._value.tobytes()).hexdigest()[:16]
        super().__init__(name, [], value_digest=digest)

    @property
    def value(self) -> np.ndarray:
        return self._value

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self._shape,)

    def forward(self, ctx, inputs, weights):
        t = self._on_device.get(ctx.device)
        if t is None:
            t = torch.from_numpy(np.array(self._value)).to(ctx.device)
            self._on_device[ctx.device] = t
        return [t]
