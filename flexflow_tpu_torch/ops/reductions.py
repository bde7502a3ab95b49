"""Mean, TopK and Gather — the port of flexflow_tpu/ops/reductions.py.

``MeanOp`` reduces in float32 and casts back to the input dtype; a
reduction to a 0-d value comes out as shape [1], as the reference's
(reductions.py:47-55).  ``TopKOp`` returns the values and int32
indices of the k largest entries of the last dim, sorted (the
reference's ``lax.top_k``); ``GatherOp`` takes entries along ``axis``
by integer indices (``jnp.take``).  The ``propagate`` rules are the
reference's: the mean keeps its reduced dims whole, top-k its candidate
dim, and the gather runs on whole inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.ops.base import (
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)


@register_op
class MeanOp(Operator):
    """Reduce-mean over ``dims`` (keepdims optional)."""

    op_type = OperatorType.MEAN

    def __init__(self, name, input_shapes, dims: Tuple[int, ...],
                 keepdims: bool = False):
        nd = len(input_shapes[0].sizes)
        super().__init__(name, input_shapes,
                         dims=tuple(sorted(d % nd for d in dims)),
                         keepdims=keepdims)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        dims = self.attrs["dims"]
        if self.attrs["keepdims"]:
            sizes = tuple(1 if i in dims else s
                          for i, s in enumerate(x.sizes))
        else:
            sizes = tuple(s for i, s in enumerate(x.sizes) if i not in dims)
        return (ParallelTensorShape.make(sizes or (1,), x.dtype),)

    def forward(self, ctx, inputs, weights):
        x = inputs[0]
        y = x.float().mean(dim=self.attrs["dims"],
                           keepdim=self.attrs["keepdims"])
        if not y.dim():
            y = y.reshape(1)
        return [y.to(x.dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        x = self.input_shapes[0]
        dims = self.attrs["dims"]
        in_degs = [1] * x.ndim
        in_idx = [-1] * x.ndim
        if self.attrs["keepdims"]:
            for i in range(x.ndim):
                if i not in dims:
                    in_degs[i] = mv.dim_degrees[i]
                    in_idx[i] = i
        else:
            kept = [i for i in range(x.ndim) if i not in dims]
            for out_i, in_i in enumerate(kept):
                if out_i < len(mv.dim_degrees):
                    in_degs[in_i] = mv.dim_degrees[out_i]
                    in_idx[in_i] = out_i
        return OpSharding(
            inputs=(ShardAnnot(tuple(in_degs), mv.replica_degree,
                               idx=tuple(in_idx)),),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        if self.attrs["keepdims"]:
            return ()
        return tuple(range(self.output_shapes[0].ndim))


@register_op
class TopKOp(Operator):
    """[..., C] -> values [..., k], indices [..., k] (int32)."""

    op_type = OperatorType.TOPK

    def __init__(self, name, input_shapes, k: int, sorted: bool = True):
        super().__init__(name, input_shapes, k=int(k), sorted=bool(sorted))

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        sizes = x.sizes[:-1] + (self.attrs["k"],)
        return (ParallelTensorShape.make(sizes, x.dtype),
                ParallelTensorShape.make(sizes, DataType.INT32))

    def forward(self, ctx, inputs, weights):
        # the reference's lax.top_k returns its values sorted whatever
        # the flag says
        vals, idx = torch.topk(inputs[0], self.attrs["k"], dim=-1,
                               sorted=True)
        return [vals, idx.to(torch.int32)]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = list(mv.dim_degrees)
        degs[-1] = 1  # needs the whole candidate dim
        a = ShardAnnot(tuple(degs), mv.replica_degree)
        return OpSharding(inputs=(a,), weights=(), outputs=(a, a))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim - 1))


@register_op
class GatherOp(Operator):
    """Gather along ``axis`` with integer indices (second input)."""

    op_type = OperatorType.GATHER

    def __init__(self, name, input_shapes, axis: int = 0):
        super().__init__(name, input_shapes, axis=int(axis))

    def infer(self) -> Sequence[ParallelTensorShape]:
        data, idx = self.input_shapes
        ax = self.attrs["axis"] % data.ndim
        sizes = data.sizes[:ax] + idx.sizes + data.sizes[ax + 1:]
        return (ParallelTensorShape.make(sizes, data.dtype),)

    def forward(self, ctx, inputs, weights):
        data, idx = inputs
        ax = self.attrs["axis"] % data.dim()
        flat = idx.reshape(-1).long()
        out = data.index_select(ax, flat)
        return [out.reshape(data.shape[:ax] + idx.shape
                            + data.shape[ax + 1:])]

    def propagate(self, mv: MachineView) -> OpSharding:
        data, idx = self.input_shapes
        return OpSharding(
            inputs=(ShardAnnot.trivial(data.ndim),
                    ShardAnnot.trivial(idx.ndim)),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return ()
