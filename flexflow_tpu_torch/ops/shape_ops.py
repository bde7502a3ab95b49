"""Shape operators — the port of flexflow_tpu/ops/shape_ops.py:
``ReshapeOp``, ``TransposeOp``, ``FlatOp``, ``ReverseOp``, ``ConcatOp``,
``SplitOp``, ``CastOp`` and the branch-stacking pair ``StackOp`` /
``UnstackOp``, with the reference's ``propagate``: a reshape's split
survives only on a leading dim of unchanged extent, a flat's only on
the batch dim, a transpose's moves with its dims, a reverse's, a
concat's and a split's on every dim but their axis.  On a rank's shard
each computes on the shard.  A stack's inputs are unconstrained (each
arrives in its producer's layout), so under a strategy its
``forward_sharded`` lays every input out as one branch of the output
and keeps this rank's block of branches."""

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
class TransposeOp(Operator):
    op_type = OperatorType.TRANSPOSE

    def __init__(self, name, input_shapes, perm: Tuple[int, ...]):
        super().__init__(name, input_shapes,
                         perm=tuple(int(p) for p in perm))

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        perm = self.attrs["perm"]
        return (ParallelTensorShape.make(tuple(x.sizes[p] for p in perm),
                                         x.dtype),)

    def forward(self, ctx, inputs, weights):
        return [inputs[0].permute(self.attrs["perm"])]

    def propagate(self, mv: MachineView) -> OpSharding:
        perm = self.attrs["perm"]
        in_degs = [1] * len(perm)
        in_idx = [-1] * len(perm)
        for out_i, in_i in enumerate(perm):
            in_degs[in_i] = mv.dim_degrees[out_i]
            in_idx[in_i] = out_i
        return OpSharding(
            inputs=(ShardAnnot(tuple(in_degs), mv.replica_degree,
                               idx=tuple(in_idx)),),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))


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
class ReverseOp(Operator):
    op_type = OperatorType.REVERSE

    def __init__(self, name, input_shapes, axis: int):
        super().__init__(name, input_shapes, axis=int(axis))

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx, inputs, weights):
        return [torch.flip(inputs[0], (self.attrs["axis"],))]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = list(mv.dim_degrees)
        # reversing a sharded dim would permute the shards
        degs[self.attrs["axis"]] = 1
        a = ShardAnnot(tuple(degs), mv.replica_degree)
        return OpSharding(inputs=(a,), weights=(), outputs=(a,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        ax = self.attrs["axis"] % self.output_shapes[0].ndim
        return tuple(i for i in range(self.output_shapes[0].ndim) if i != ax)


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
class SplitOp(Operator):
    op_type = OperatorType.SPLIT

    def __init__(self, name, input_shapes, sizes: Tuple[int, ...],
                 axis: int):
        super().__init__(name, input_shapes,
                         sizes=tuple(int(s) for s in sizes), axis=int(axis))

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        ax = self.attrs["axis"]
        assert sum(self.attrs["sizes"]) == x.sizes[ax]
        outs = []
        for sz in self.attrs["sizes"]:
            sizes = list(x.sizes)
            sizes[ax] = sz
            outs.append(ParallelTensorShape.make(tuple(sizes), x.dtype))
        return tuple(outs)

    def forward(self, ctx, inputs, weights):
        return list(torch.split(inputs[0], list(self.attrs["sizes"]),
                                dim=self.attrs["axis"]))

    def propagate(self, mv: MachineView) -> OpSharding:
        ax = self.attrs["axis"]
        assert mv.dim_degrees[ax] == 1, "cannot partition the split axis"
        a = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        return OpSharding(
            inputs=(a,),
            weights=(),
            outputs=(a,) * len(self.output_shapes),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        ax = self.attrs["axis"] % self.output_shapes[0].ndim
        return tuple(i for i in range(self.output_shapes[0].ndim) if i != ax)


@register_op
class CastOp(Operator):
    op_type = OperatorType.CAST

    def __init__(self, name, input_shapes, dtype):
        super().__init__(name, input_shapes,
                         dtype=DataType.from_any(dtype).value)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        return (ParallelTensorShape.make(x.sizes,
                                         DataType(self.attrs["dtype"])),)

    def forward(self, ctx, inputs, weights):
        return [inputs[0].to(DataType(self.attrs["dtype"]).to_torch())]

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))


@register_op
class StackOp(Operator):
    """K same-shaped inputs -> [K, ...]: the reference's ``StackOp``
    (shape_ops.py:253-295), the feed of the batched embedding its
    search builds.  Its inputs are unconstrained, so on a mesh
    ``forward_sharded`` lays each input out as the output's branch
    layout asks (every rank reshards every input, so each collective
    has all its ranks), keeps this rank's block of branches, and sums
    each input's gradient over the branch axes: only the ranks that
    hold a branch see its gradient."""

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
        return [torch.stack(inputs, dim=0)]

    def forward_sharded(self, ctx, inputs, weights, osh):
        from flexflow_tpu_torch.parallel.mesh import (
            Placement,
            grad_all_reduce,
            reshard,
        )

        out = ctx.out_placements[0]
        inner = Placement(out.dims[1:])
        axes = out.dims[0]
        ys = [grad_all_reduce(reshard(x, pl, inner, ctx.mesh), axes,
                              ctx.mesh)
              for x, pl in zip(inputs, ctx.in_placements)]
        y = torch.stack(ys, dim=0)
        if axes:
            per = y.shape[0] // ctx.mesh.size(axes)
            y = y.narrow(0, ctx.mesh.index(axes) * per, per)
        return [y]

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
    OUTPUT dims; the branch dim is gathered."""

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
        return list(torch.unbind(inputs[0], dim=0))

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
