"""Mixture-of-Experts ops — the port of flexflow_tpu/ops/moe.py:
GroupBy (dispatch), Aggregate (combine), AggregateSpec, Cache
(reference: src/ops/{group_by,aggregate,aggregate_spec,cache}.cc and
examples/cpp/mixture_of_experts/moe.cc).

Experts are one batched tensor [E, cap, D], so the expert dim is a real
dim a strategy may split (expert parallelism: dim 0 of the dispatch and
the expert MLP over a mesh axis).  The capacity is static, cap =
ceil(alpha * K * B / E); the dispatch is the reference's sort-based one
(kernels/moe_dispatch.py).

Gradients of the gathers (the dispatch's row gather, the combine's
[B, K] gather of expert rows) are autograd's scatter-adds, atomics on
the card.  Each slot takes one token, and a dropped token reads a slot
with weight zero, so every sum has one non-zero addend and is exact in
any order.

Under a strategy: the dispatch sees whole, replicated tokens
(``propagate``); under an expert split its ``forward_sharded`` dispatches
every token and keeps this rank's block of experts, and the lowering
sums the tokens' gradient over the expert axes.  The combine's
``expert_out`` input is replicated on dim 0 by its ``propagate``, so the
lowering gathers it; under a batch split its ``forward_sharded``
combines every token and keeps this rank's rows.  The cache keeps its
``cached`` value whole (model state is whole on every rank): under a
split its ``forward_sharded`` gathers the input whole first.

Model state: ``Aggregate`` (lambda_bal > 0) writes the balance term
``{name}/aux_loss``, which the lowering adds to the loss, and ``Cache``
its per-step ``{name}/score`` beside ``{name}/cached``; the port
declares both in ``state_specs`` (an aggregate only when it has the
term) so they exist from the start, where the reference's state gains
them at the first step: a captured step's state tensors keep their
addresses.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.ops.base import (
    LoweringContext,
    Operator,
    OpSharding,
    ShardAnnot,
    register_op,
)


def _keep_rows(ctx, y: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``y``'s ``dim`` under output 0's layout."""
    axes = ctx.out_placements[0].dims[dim]
    if not axes:
        return y
    per = y.shape[dim] // ctx.mesh.size(axes)
    return y.narrow(dim, ctx.mesh.index(axes) * per, per)


def _aux_loss_state():
    return (("aux_loss", (), torch.float32, 0.0),)


@register_op
class GroupByOp(Operator):
    """(data [B, D], assign [B, K]) -> (grouped [E, cap, D],
    expert_idx [B, K], pos [B, K], valid [B, K]).

    cap = ceil(alpha * K * B / E), alpha the reference's capacity factor
    (group_by.cc).  Tokens overflowing an expert's capacity are dropped
    (valid = 0), the reference's truncation.
    """

    op_type = OperatorType.GROUP_BY

    def __init__(self, name, input_shapes, n_experts: int,
                 alpha: float = 1.0):
        super().__init__(name, input_shapes, n_experts=int(n_experts),
                         alpha=float(alpha))

    @property
    def capacity(self) -> int:
        b = self.input_shapes[0].sizes[0]
        k = self.input_shapes[1].sizes[1]
        e = self.attrs["n_experts"]
        return max(1, math.ceil(self.attrs["alpha"] * k * b / e))

    def infer(self) -> Sequence[ParallelTensorShape]:
        data, assign = self.input_shapes
        b, d = data.sizes
        k = assign.sizes[1]
        e = self.attrs["n_experts"]
        return (
            ParallelTensorShape.make((e, self.capacity, d), data.dtype),
            ParallelTensorShape.make((b, k), DataType.INT32),
            ParallelTensorShape.make((b, k), DataType.INT32),
            ParallelTensorShape.make((b, k), data.dtype),
        )

    def forward(self, ctx: LoweringContext, inputs, weights):
        from flexflow_tpu_torch.kernels.moe_dispatch import moe_dispatch

        data, assign = inputs
        assign = assign.to(torch.int32)
        b, k = assign.shape
        e, cap = self.attrs["n_experts"], self.capacity
        flat_e = assign.reshape(-1)  # [B*K] expert ids, b major
        src = data.repeat_interleave(k, dim=0)  # token (b, k) -> row b
        grouped, pos_flat, valid_flat = moe_dispatch(src, flat_e, e, cap)
        return [
            grouped,
            assign,
            pos_flat.clamp(0, cap - 1).reshape(b, k),
            valid_flat.reshape(b, k).to(data.dtype),
        ]

    def forward_sharded(self, ctx, inputs, weights, osh):
        if not ctx.out_placements[0].dims[0]:
            return None
        outs = self.forward(ctx, inputs, weights)
        return [_keep_rows(ctx, outs[0])] + outs[1:]

    def propagate(self, mv: MachineView) -> OpSharding:
        e_deg, cap_deg, d_deg = mv.dim_degrees
        assert cap_deg == 1, "capacity dim stays whole"
        aux = ShardAnnot((1, 1), replica=mv.num_parts)
        return OpSharding(
            inputs=(
                ShardAnnot((1, d_deg), replica=e_deg * mv.replica_degree,
                           idx=(-1, 2)),
                ShardAnnot((1, 1), replica=mv.num_parts),
            ),
            weights=(),
            outputs=(
                ShardAnnot(mv.dim_degrees, mv.replica_degree),
                aux,
                aux,
                aux,
            ),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0, 2)  # expert dim (EP) and feature dim


@register_op
class AggregateOp(Operator):
    """(gates [B, K], expert_idx [B, K], pos [B, K], valid [B, K],
    expert_out [E, cap, D]) -> [B, D].

    Reference: src/ops/aggregate.cc (weighted combine with a
    load-balancing lambda; the balance loss is model state
    ``{name}/aux_loss``).
    """

    op_type = OperatorType.AGGREGATE

    def __init__(self, name, input_shapes, lambda_bal: float = 0.0):
        super().__init__(name, input_shapes, lambda_bal=float(lambda_bal))
        if self.attrs["lambda_bal"] > 0.0:
            # the balance term is model state; without it the op is
            # stateless, as the reference's
            self.state_specs = _aux_loss_state

    def infer(self) -> Sequence[ParallelTensorShape]:
        gates = self.input_shapes[0]
        expert_out = self.input_shapes[4]
        b = gates.sizes[0]
        d = expert_out.sizes[2]
        return (ParallelTensorShape.make((b, d), expert_out.dtype),)

    def _combine(self, ctx, gates, expert_idx, pos, valid, expert_out):
        e = expert_out.shape[0]
        # an out-of-range expert id (a dropped token, weight 0) reads a
        # clamped row, as the reference's gather clamps
        idx = expert_idx.long().clamp(0, e - 1)
        rows = expert_out[idx, pos.long()]  # [B, K, D]
        w = (gates * valid).to(rows.dtype)[..., None]
        out = (rows * w).sum(dim=1)
        if self.attrs["lambda_bal"] > 0.0:
            counts = torch.zeros(e, dtype=torch.float32,
                                 device=expert_out.device).index_add_(
                0, idx.reshape(-1), valid.reshape(-1).float())
            frac = counts / counts.sum().clamp_min(1.0)
            ctx.state_out[f"{self.name}/aux_loss"] = (
                self.attrs["lambda_bal"] * e * (frac * frac).sum())
        return out

    def _gates(self, gates):
        return gates

    def forward(self, ctx: LoweringContext, inputs, weights):
        gates, expert_idx, pos, valid, expert_out = inputs
        return [self._combine(ctx, self._gates(gates), expert_idx, pos,
                              valid, expert_out)]

    def forward_sharded(self, ctx, inputs, weights, osh):
        if not ctx.out_placements[0].dims[0]:
            return None
        return [_keep_rows(ctx, self.forward(ctx, inputs, weights)[0])]

    def propagate(self, mv: MachineView) -> OpSharding:
        b_deg, d_deg = mv.dim_degrees
        parts = mv.num_parts
        return OpSharding(
            inputs=(
                ShardAnnot((1, 1), replica=parts),
                ShardAnnot((1, 1), replica=parts),
                ShardAnnot((1, 1), replica=parts),
                ShardAnnot((1, 1), replica=parts),
                ShardAnnot((1, 1, d_deg), replica=parts // max(d_deg, 1),
                           idx=(-1, -1, 1)),
            ),
            weights=(),
            outputs=(ShardAnnot(mv.dim_degrees, mv.replica_degree),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0, 1)


@register_op
class AggregateSpecOp(AggregateOp):
    """Uniform-weight variant (reference: src/ops/aggregate_spec.cc)."""

    op_type = OperatorType.AGGREGATE_SPEC

    def _gates(self, gates):
        return torch.ones_like(gates) / gates.shape[1]


@register_op
class CacheOp(Operator):
    """Cache a tensor across iterations (reference: src/ops/cache.cc —
    MoE caches expert assignments; a score function drives the
    recompile trigger, moe.cc:46-92).

    attrs: use_cached — when True, forward returns the cached value
    (state) instead of the live input; the live input always refreshes
    the cache.  The per-iteration score (mean abs difference between
    live and cached) is written to state as ``{name}/score``.
    """

    op_type = OperatorType.CACHE

    def __init__(self, name, input_shapes, use_cached: bool = False):
        super().__init__(name, input_shapes, use_cached=bool(use_cached))

    def infer(self) -> Sequence[ParallelTensorShape]:
        return (self.input_shapes[0],)

    def state_specs(self):
        x = self.input_shapes[0]
        return (("cached", x.sizes, x.dtype.to_torch(), 0.0),
                ("score", (), torch.float32, 0.0))

    def _cache(self, ctx, x):
        cached = ctx.state_in[f"{self.name}/cached"]
        ctx.state_out[f"{self.name}/score"] = (
            x.detach().float() - cached.float()).abs().mean()
        ctx.state_out[f"{self.name}/cached"] = x.detach()
        if self.attrs["use_cached"]:
            return cached.to(x.dtype)
        return x

    def forward(self, ctx: LoweringContext, inputs, weights):
        return [self._cache(ctx, inputs[0])]

    def forward_sharded(self, ctx, inputs, weights, osh):
        from flexflow_tpu_torch.parallel.mesh import Placement, reshard

        pl = ctx.in_placements[0]
        if not pl.split_axes():
            return None
        x = reshard(inputs[0], pl, Placement.replicated(inputs[0].dim()),
                    ctx.mesh)
        y = self._cache(ctx, x)
        if not self.attrs["use_cached"]:
            return [inputs[0]]
        return [y[pl.local_slices(y.shape, ctx.mesh)]]

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))
