"""Parallel operators: Repartition / Combine / Replicate / Reduction —
the port of flexflow_tpu/parallel/parallel_ops.py (:39-150).

The four PCG operators with which FlexFlow expresses parallelism as
graph nodes.  Each computes the identity; what it does is change the
layout: its input is unconstrained (annotation None: the producer's
layout governs) and its output carries the annotation of its view.  In
the reference GSPMD turns that change into a collective; in the port
``forward_sharded`` reshards from the input's layout to the output's
(``parallel.mesh.reshard``):

    Repartition -> slice, or gather then slice  (degree change on a dim)
    Combine     -> all-gather                   (degree -> 1)
    Replicate   -> nothing to move              (replicated over axes)
    Reduction   -> all-reduce                   (partial sum -> sum)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import (
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)


class _ParallelOpBase(Operator):
    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx, inputs, weights):
        return [inputs[0]]

    def forward_sharded(self, ctx, inputs, weights, osh):
        from flexflow_tpu_torch.parallel.mesh import reshard

        return [reshard(inputs[0], ctx.in_placements[0],
                        ctx.out_placements[0], ctx.mesh)]

    def flops(self) -> float:
        return 0.0

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))


@register_op
class RepartitionOp(_ParallelOpBase):
    """Change partition degree along ``dim`` to ``degree``."""

    op_type = OperatorType.REPARTITION

    def __init__(self, name, input_shapes, dim: int, degree: int):
        super().__init__(name, input_shapes, dim=int(dim), degree=int(degree))

    def fixed_machine_view(self) -> Optional[MachineView]:
        degs = [1] * self.output_shapes[0].ndim
        degs[self.attrs["dim"]] = self.attrs["degree"]
        return MachineView(dim_degrees=tuple(degs))

    def propagate(self, mv: MachineView) -> OpSharding:
        assert mv.dim_degrees[self.attrs["dim"]] == self.attrs["degree"], (
            f"{self.name}: view {mv} disagrees with repartition degree "
            f"{self.attrs['degree']} on dim {self.attrs['dim']}"
        )
        return OpSharding(
            inputs=(None,),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )


@register_op
class CombineOp(_ParallelOpBase):
    """Gather shards along ``dim`` back to ``degree`` (usually 1)."""

    op_type = OperatorType.COMBINE

    def __init__(self, name, input_shapes, dim: int, degree: int = 1):
        super().__init__(name, input_shapes, dim=int(dim), degree=int(degree))

    def fixed_machine_view(self) -> Optional[MachineView]:
        degs = [1] * self.output_shapes[0].ndim
        degs[self.attrs["dim"]] = self.attrs["degree"]
        return MachineView(dim_degrees=tuple(degs))

    def propagate(self, mv: MachineView) -> OpSharding:
        assert mv.dim_degrees[self.attrs["dim"]] == self.attrs["degree"]
        return OpSharding(
            inputs=(None,),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )


@register_op
class ReplicateOp(_ParallelOpBase):
    """Replicate the tensor ``degree`` ways."""

    op_type = OperatorType.REPLICATE

    def __init__(self, name, input_shapes, degree: int):
        super().__init__(name, input_shapes, degree=int(degree))

    def fixed_machine_view(self) -> Optional[MachineView]:
        return MachineView(
            dim_degrees=(1,) * self.output_shapes[0].ndim,
            replica_degree=self.attrs["degree"],
        )

    def propagate(self, mv: MachineView) -> OpSharding:
        assert mv.replica_degree == self.attrs["degree"], (
            f"{self.name}: view {mv} disagrees with replicate degree "
            f"{self.attrs['degree']}"
        )
        return OpSharding(
            inputs=(None,),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, replica=mv.replica_degree),),
        )


@register_op
class ReductionOp(_ParallelOpBase):
    """Sum ``degree`` partial replicas: the producer's partial output
    becomes a sum here."""

    op_type = OperatorType.REDUCTION

    def __init__(self, name, input_shapes, degree: int):
        super().__init__(name, input_shapes, degree=int(degree))

    def propagate(self, mv: MachineView) -> OpSharding:
        return OpSharding(
            inputs=(None,),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )
