"""Input and constant sentinel operators and the identity — the port of
``InputOp``, ``ConstantOp`` and ``NoOp`` in flexflow_tpu/ops/inout.py,
with the reference's ``propagate``, ``signature`` and
``splittable_output_dims`` (inout.py:40-125)."""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.interop import tensor_from_numpy
from flexflow_tpu_torch.ops.base import (
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)


def _source_sharding(mv: MachineView) -> OpSharding:
    return OpSharding(inputs=(), weights=(),
                      outputs=(ShardAnnot(mv.dim_degrees,
                                          mv.replica_degree),))


@register_op
class InputOp(Operator):
    """Graph source holding a frame input.  ``tensor_guid`` links back to
    the frontend Tensor: the lowering binds feed tensors in tensor-guid
    order, as the reference does.  Under a strategy each rank is fed
    the block of the input its output annotation gives it
    (``CompiledModel.input_slices``)."""

    op_type = OperatorType.INPUT
    is_gradient_free = True

    def __init__(self, name, shape: ParallelTensorShape,
                 tensor_guid: int = -1):
        self._shape = shape.drop_parallelism()
        super().__init__(name, [], tensor_guid=tensor_guid)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self._shape,)

    def forward(self, ctx, inputs, weights):
        raise RuntimeError("InputOp is bound by the executor, never lowered")

    def signature(self) -> Tuple:
        return (self.op_type.value, self._shape.sizes,
                self._shape.dtype.value, self.attrs["tensor_guid"])

    def propagate(self, mv: MachineView) -> OpSharding:
        return _source_sharding(mv)

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0,) if self._shape.ndim else ()


@register_op
class ConstantOp(Operator):
    """Compile-time constant tensor (``build_gpt``'s position ids).  The
    value is kept as a numpy array; ``forward`` hands out one tensor per
    device, made at first use, or under a strategy the rank's block of
    it (whatever dims its annotation splits).  attrs keep a digest of
    the value, as the reference's do."""

    op_type = OperatorType.CONSTANT
    is_gradient_free = True

    def __init__(self, name, shape: ParallelTensorShape, value=None):
        self._shape = shape.drop_parallelism()
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
            t = tensor_from_numpy(self._value, ctx.device)
            self._on_device[ctx.device] = t
        if ctx.mesh is not None:
            t = t[ctx.out_placements[0].local_slices(t.shape, ctx.mesh)]
        return [t]

    def signature(self) -> Tuple:
        return (self.op_type.value, self._shape.sizes,
                self._shape.dtype.value, self.attrs["value_digest"])

    def propagate(self, mv: MachineView) -> OpSharding:
        return _source_sharding(mv)

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return ()


@register_op
class NoOp(Operator):
    """The identity (reference inout.py:114-125): its output is its
    input's shape, split as any of its dims."""

    op_type = OperatorType.NOOP

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx, inputs, weights):
        return [inputs[0]]

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))
