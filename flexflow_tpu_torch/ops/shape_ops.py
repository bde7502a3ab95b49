"""Shape operators — the port of ``ReshapeOp``, ``FlatOp`` and
``ConcatOp`` in flexflow_tpu/ops/shape_ops.py, with the reference's
``propagate``: a reshape's split survives only on a leading dim of
unchanged extent, a flat's only on the batch dim, a concat's on every
dim but the concat axis.  On a rank's shard each reshapes or
concatenates the shard.  ``StackOp`` and ``UnstackOp`` are the search's descriptors of
the reference's branch-stacking pair (shapes, propagation, costs; no
forward yet: ROADMAP Queue A item 6)."""

from __future__ import annotations

from typing import Sequence, Tuple

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
        return [inputs[0].reshape(
            ctx.local_sizes(self.output_shapes[0].sizes))]

    def propagate(self, mv: MachineView) -> OpSharding:
        x = self.input_shapes[0]
        out = self.output_shapes[0]
        in_degs = [1] * x.ndim
        if x.ndim and out.ndim and x.sizes[0] == out.sizes[0]:
            in_degs[0] = mv.dim_degrees[0]
        return OpSharding(
            inputs=(ShardAnnot(tuple(in_degs), mv.replica_degree),),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        x, out = self.input_shapes[0], self.output_shapes[0]
        if x.ndim and out.ndim and x.sizes[0] == out.sizes[0]:
            return (0,)
        return ()


@register_op
class FlatOp(Operator):
    """[B, ...] -> [B, prod(...)] (reference: src/ops/flat.cc)."""

    op_type = OperatorType.FLAT

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        feat = 1
        for s in x.sizes[1:]:
            feat *= s
        return (ParallelTensorShape.make((x.sizes[0], feat), x.dtype),)

    def forward(self, ctx, inputs, weights):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]

    def propagate(self, mv: MachineView) -> OpSharding:
        x = self.input_shapes[0]
        in_degs = (mv.dim_degrees[0],) + (1,) * (x.ndim - 1)
        return OpSharding(
            inputs=(ShardAnnot(in_degs, mv.replica_degree),),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0,)


@register_op
class ConcatOp(Operator):
    op_type = OperatorType.CONCAT

    def __init__(self, name, input_shapes, axis: int):
        super().__init__(name, input_shapes, axis=int(axis))

    def infer(self) -> Sequence[ParallelTensorShape]:
        ax = self.attrs["axis"]
        first = self.input_shapes[0]
        total = sum(s.sizes[ax] for s in self.input_shapes)
        sizes = list(first.sizes)
        sizes[ax] = total
        return (ParallelTensorShape.make(tuple(sizes), first.dtype),)

    def forward(self, ctx, inputs, weights):
        return [torch.cat(inputs, dim=self.attrs["axis"])]

    def propagate(self, mv: MachineView) -> OpSharding:
        ax = self.attrs["axis"]
        assert mv.dim_degrees[ax] == 1, "cannot partition the concat axis"
        a = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        return OpSharding(
            inputs=(a,) * len(self.input_shapes), weights=(), outputs=(a,)
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        ax = self.attrs["axis"] % self.output_shapes[0].ndim
        return tuple(i for i in range(self.output_shapes[0].ndim) if i != ax)


@register_op
class StackOp(Operator):
    """K same-shaped inputs -> [K, ...]: the reference's ``StackOp``
    (shape_ops.py:253-295), the feed of the batched embedding its
    search builds.  Shapes, propagation and costs only; ``forward``
    raises (ROADMAP Queue A item 6)."""

    op_type = OperatorType.STACK

    def __init__(self, name, input_shapes):
        first = input_shapes[0]
        for s in input_shapes[1:]:
            assert s.sizes == first.sizes and s.dtype == first.dtype
        super().__init__(name, input_shapes)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        return (
            ParallelTensorShape.make(
                (len(self.input_shapes),) + x.sizes, x.dtype
            ),
        )

    def forward(self, ctx, inputs, weights):
        raise NotImplementedError(
            f"{self.name}: stack is not ported yet (ROADMAP Queue A item "
            f"6)")

    def propagate(self, mv: MachineView) -> OpSharding:
        # inputs unconstrained: GSPMD moves each branch's tensor to
        # wherever the sharded stack places it (like parallel ops)
        out = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        return OpSharding(
            inputs=(None,) * len(self.input_shapes),
            weights=(),
            outputs=(out,),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))

    def flops(self) -> float:
        return 0.0


@register_op
class UnstackOp(Operator):
    """[K, ...] -> K outputs [...] (inverse of StackOp): the reference's
    ``UnstackOp`` (shape_ops.py:298-332).  The view ranges over the
    OUTPUT dims; the branch dim is gathered.  Shapes, propagation and
    costs only; ``forward`` raises (ROADMAP Queue A item 6)."""

    op_type = OperatorType.UNSTACK

    def __init__(self, name, input_shapes):
        super().__init__(name, input_shapes)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        k = x.sizes[0]
        return tuple(
            ParallelTensorShape.make(x.sizes[1:], x.dtype) for _ in range(k)
        )

    def forward(self, ctx, inputs, weights):
        raise NotImplementedError(
            f"{self.name}: unstack is not ported yet (ROADMAP Queue A item "
            f"6)")

    def propagate(self, mv: MachineView) -> OpSharding:
        out = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        in_a = ShardAnnot((1,) + mv.dim_degrees, mv.replica_degree)
        return OpSharding(
            inputs=(in_a,),
            weights=(),
            outputs=(out,) * len(self.output_shapes),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))

    def flops(self) -> float:
        return 0.0
