"""Elementwise operators — the port of ``ElementUnaryOp`` and
``ElementBinaryOp`` in flexflow_tpu/ops/elementwise.py, with the
reference's whole unary, scalar and binary tables (elementwise.py:
28-53).  GELU is the tanh form unless built with ``approximate=False``
(the exact erf form), as the reference's; ``approximate`` joins the
attributes (and so the signature) of a GELU only.  The binary ops
broadcast as numpy does, and their ``propagate`` is the reference's
(elementwise.py:114-131: inputs aligned to the output from the right);
a unary op takes the default elementwise rule."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import (
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)

_UNARY_FNS = {
    OperatorType.RELU: torch.relu,
    OperatorType.SIGMOID: torch.sigmoid,
    OperatorType.TANH: torch.tanh,
    OperatorType.ELU: F.elu,
    OperatorType.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.EXP: torch.exp,
    OperatorType.LOG: torch.log,
    OperatorType.IDENTITY: lambda x: x,
    OperatorType.RSQRT: torch.rsqrt,
}

_SCALAR_FNS = {
    OperatorType.POW: lambda x, s: torch.pow(x, s),
    OperatorType.SCALAR_ADD: lambda x, s: x + s,
    OperatorType.SCALAR_SUB: lambda x, s: x - s,
    OperatorType.SCALAR_MUL: lambda x, s: x * s,
    OperatorType.SCALAR_TRUE_DIV: lambda x, s: x / s,
}

_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
    OperatorType.EW_SUB: torch.sub,
    OperatorType.EW_MUL: torch.mul,
    OperatorType.EW_DIV: torch.div,
    OperatorType.EW_MAX: torch.maximum,
    OperatorType.EW_MIN: torch.minimum,
}


@register_op
class ElementUnaryOp(Operator):
    """attrs: unary_type, scalar (the scalar ops' operand), approximate
    (GELU only)."""

    op_type = OperatorType.IDENTITY  # the instance's own, set in __init__

    def __init__(self, name, input_shapes, unary_type: OperatorType,
                 scalar: float = 0.0, approximate: bool = True):
        if unary_type not in _UNARY_FNS and unary_type not in _SCALAR_FNS:
            raise ValueError(f"{unary_type!r} is not a unary op")
        self.op_type = unary_type
        extra = ({"approximate": approximate}
                 if unary_type is OperatorType.GELU else {})
        super().__init__(name, input_shapes, unary_type=unary_type.value,
                         scalar=scalar, **extra)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx, inputs, weights):
        t = OperatorType(self.attrs["unary_type"])
        x = inputs[0]
        if t in _SCALAR_FNS:
            return [_SCALAR_FNS[t](x, self.attrs["scalar"])]
        if t is OperatorType.GELU and not self.attrs.get("approximate",
                                                           True):
            return [F.gelu(x)]
        return [_UNARY_FNS[t](x)]

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))


@register_op
class ElementBinaryOp(Operator):
    """Numpy-broadcasting binary op."""

    op_type = OperatorType.EW_ADD

    def __init__(self, name, input_shapes, binary_type: OperatorType):
        if binary_type not in _BINARY_FNS:
            raise ValueError(f"{binary_type!r} is not a binary op")
        self.op_type = binary_type
        super().__init__(name, input_shapes, binary_type=binary_type.value)

    def infer(self) -> Sequence[ParallelTensorShape]:
        a, b = self.input_shapes
        # numpy's rule, as torch's; torch.broadcast_shapes would import
        # sympy on its first call (seconds in every new process)
        out = np.broadcast_shapes(a.sizes, b.sizes)
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
