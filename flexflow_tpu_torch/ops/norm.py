"""Softmax, LayerNorm, BatchNorm and Dropout — the port of
flexflow_tpu/ops/norm.py.  Softmax: float32 over ``axis``, cast back
(norm.py:32-54; the softmax dim stays whole under a split).  Dropout
(norm.py:190-207): in training, ``x / keep`` where the mask keeps and 0
elsewhere, in x's dtype; the mask is ``LoweringContext.dropout_mask``'s
(ops/base.py: a hash of the step's seed, the op's name and each
element's index in the whole tensor, so any split draws its block of
the one-process mask); outside training the identity.  LayerNorm: statistics in
float32, biased variance, ``eps`` inside the rsqrt, the result cast
back to the input dtype (norm.py:93-104); ``propagate`` is the
reference's (norm.py:106-114): the normalised dims stay whole.
BatchNorm: the batch's statistics and running statistics in the model
state (norm.py:126-186), the op the staged pipeline refuses as
state-carrying."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import (
    ConstantInitializer,
    ZeroInitializer,
)
from flexflow_tpu_torch.ops.base import (
    LoweringContext,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)


@register_op
class SoftmaxOp(Operator):
    op_type = OperatorType.SOFTMAX

    def __init__(self, name, input_shapes, axis: int = -1):
        super().__init__(name, input_shapes, axis=int(axis))

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx, inputs, weights):
        x = inputs[0]
        return [torch.softmax(x.float(), dim=self.attrs["axis"]).to(x.dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        ax = self.attrs["axis"] % self.output_shapes[0].ndim
        degs = list(mv.dim_degrees)
        degs[ax] = 1  # the softmax dim needs the whole row
        a = ShardAnnot(tuple(degs), mv.replica_degree)
        return OpSharding(inputs=(a,), weights=(), outputs=(a,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        ax = self.attrs["axis"] % self.output_shapes[0].ndim
        return tuple(i for i in range(self.output_shapes[0].ndim)
                     if i != ax)


@register_op
class LayerNormOp(Operator):
    """attrs: axes (normalized trailing axes), elementwise_affine, eps."""

    op_type = OperatorType.LAYERNORM

    def __init__(self, name, input_shapes, axes: Tuple[int, ...] = (-1,),
                 elementwise_affine: bool = True, eps: float = 1e-5):
        nd = len(input_shapes[0].sizes)
        axes = tuple(sorted(a % nd for a in axes))
        super().__init__(name, input_shapes, axes=axes,
                         elementwise_affine=elementwise_affine, eps=eps)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def _param_shape(self) -> Tuple[int, ...]:
        x = self.input_shapes[0]
        return tuple(x.sizes[a] for a in self.attrs["axes"])

    def weight_specs(self):
        if not self.attrs["elementwise_affine"]:
            return ()
        shp = self._param_shape()
        return (
            WeightSpec("gamma", shp, DataType.FLOAT32,
                       ConstantInitializer(1.0)),
            WeightSpec("beta", shp, DataType.FLOAT32, ZeroInitializer()),
        )

    def forward(self, ctx, inputs, weights):
        x = inputs[0].float()
        axes = self.attrs["axes"]
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.attrs["eps"])
        if self.attrs["elementwise_affine"]:
            bshape = [1] * x.ndim
            for a in axes:
                bshape[a] = x.shape[a]
            y = (y * weights["gamma"].reshape(bshape)
                 + weights["beta"].reshape(bshape))
        return [y.to(inputs[0].dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = list(mv.dim_degrees)
        for a in self.attrs["axes"]:
            degs[a] = 1  # normalized dims stay whole
        a = ShardAnnot(tuple(degs), mv.replica_degree)
        w = ()
        if self.attrs["elementwise_affine"]:
            wa = ShardAnnot((1,) * len(self._param_shape()), mv.num_parts)
            w = (wa, wa)
        return OpSharding(inputs=(a,), weights=w, outputs=(a,))

    def splittable_output_dims(self):
        return tuple(i for i in range(self.output_shapes[0].ndim)
                     if i not in self.attrs["axes"])


def _sum_over(v: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``v`` over ``axes``, replicated, and differentiable:
    each rank's addend gets the gradient summed over the ranks that use
    the total (parallel/mesh.py's convention for replicated values)."""
    from flexflow_tpu_torch.parallel.mesh import _AllReduce, grad_all_reduce

    return grad_all_reduce(_AllReduce.apply(v, tuple(axes), mesh), axes,
                           mesh)


@register_op
class BatchNormOp(Operator):
    """NHWC batch norm over every dim but the last (per channel); also
    [N, C].  attrs: relu, momentum, eps (reference ``BatchNormOp``,
    norm.py:126-186, src/ops/batch_norm.cc).  The running statistics are
    model state (``state_specs``): a training pass updates them from the
    batch's statistics, an evaluation pass normalises with them.  Under
    a split of the batch (or any dim but the channels) the statistics
    are the whole batch's, summed over the ranks that split it, as the
    reference's GSPMD mean over a sharded axis is.  The running
    statistics stay whole on every rank: under a split of the channels
    a rank normalises with its block of them and updates its block,
    and the blocks are gathered back into the whole."""

    op_type = OperatorType.BATCHNORM

    def __init__(self, name, input_shapes, relu: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(name, input_shapes, relu=relu, momentum=momentum,
                         eps=eps)

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    @property
    def channels(self) -> int:
        return self.input_shapes[0].sizes[-1]

    def weight_specs(self) -> Sequence[WeightSpec]:
        c = (self.channels,)
        return (WeightSpec("scale", c, DataType.FLOAT32,
                           ConstantInitializer(1.0)),
                WeightSpec("bias", c, DataType.FLOAT32, ZeroInitializer()))

    def state_specs(self):
        c = (self.channels,)
        return (("running_mean", c, torch.float32, 0.0),
                ("running_var", c, torch.float32, 1.0))

    def forward(self, ctx, inputs, weights):
        x = inputs[0].float()
        axes = tuple(range(x.dim() - 1))
        split = ()
        if ctx.mesh is not None and ctx.in_placements:
            split = tuple(a for d in ctx.in_placements[0].dims[:-1]
                          for a in d)
        m = self.attrs["momentum"]
        rm = ctx.state_in[f"{self.name}/running_mean"]
        rv = ctx.state_in[f"{self.name}/running_var"]
        c_axes = ()
        if ctx.mesh is not None and ctx.in_placements:
            c_axes = tuple(ctx.in_placements[0].dims[-1])
        whole_rm, whole_rv = rm, rv
        if c_axes:  # this rank's channels of the whole statistics
            c = x.shape[-1]
            start = ctx.mesh.index(c_axes) * c
            rm, rv = rm[start:start + c], rv[start:start + c]
        if ctx.train:
            if split:
                n = (x.numel() // x.shape[-1]) * ctx.mesh.size(split)
                mean = _sum_over(x.sum(dim=axes), split, ctx.mesh) / n
                var = _sum_over(((x - mean) ** 2).sum(dim=axes), split,
                                ctx.mesh) / n
            else:
                mean = x.mean(dim=axes)
                var = ((x - mean) ** 2).mean(dim=axes)
            new_rm = m * rm + (1 - m) * mean.detach()
            new_rv = m * rv + (1 - m) * var.detach()
            if c_axes:
                from flexflow_tpu_torch.parallel.mesh import all_gather

                both = all_gather(torch.stack([new_rm, new_rv], dim=1), 0,
                                  c_axes, ctx.mesh)
                new_rm, new_rv = both.unbind(dim=1)
                new_rm, new_rv = new_rm.contiguous(), new_rv.contiguous()
            ctx.state_out[f"{self.name}/running_mean"] = new_rm
            ctx.state_out[f"{self.name}/running_var"] = new_rv
        else:
            mean, var = rm, rv
            ctx.state_out[f"{self.name}/running_mean"] = whole_rm
            ctx.state_out[f"{self.name}/running_var"] = whole_rv
        y = (x - mean) * torch.rsqrt(var + self.attrs["eps"])
        y = y * weights["scale"] + weights["bias"]
        if self.attrs["relu"]:
            y = torch.relu(y)
        return [y.to(inputs[0].dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        a = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        c_deg = mv.dim_degrees[-1]
        rep = mv.num_parts // max(c_deg, 1)
        wa = ShardAnnot((c_deg,), rep, idx=(len(mv.dim_degrees) - 1,))
        return OpSharding(inputs=(a,), weights=(wa, wa), outputs=(a,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))


@register_op
class DropoutOp(Operator):
    op_type = OperatorType.DROPOUT

    def __init__(self, name, input_shapes, rate: float = 0.5,
                 seed: int = 0):
        super().__init__(name, input_shapes, rate=float(rate),
                         seed=int(seed))

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def forward(self, ctx: LoweringContext, inputs, weights):
        x = inputs[0]
        rate = self.attrs["rate"]
        if not ctx.train or rate <= 0.0:
            return [x]
        keep = 1.0 - rate
        pl = ctx.in_placements[0] if ctx.in_placements else None
        shape = self.input_shapes[0].sizes
        mask = ctx.dropout_mask(self.name, keep, shape,
                                ctx.block_starts(shape, pl), x.shape)
        return [torch.where(mask, x / keep, 0.0).to(x.dtype)]

    def draws_dropout(self) -> bool:
        return self.attrs["rate"] > 0.0

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))
