"""Embedding lookup — the port of ``EmbeddingOp`` in
flexflow_tpu/ops/embedding.py: ``aggr="none"`` (ids [..., S] ->
[..., S, D], the GPTs' token and positional tables) and the
reference's ``"sum"`` and ``"avg"`` over the ids' last dim (ids [B, S]
-> [B, D], the DLRM-style towers).  The gradient of the table is
autograd's scatter-add of the gathered rows.  ``propagate`` is the
reference's (embedding.py:156-184).  Under a batch or channel split
``forward`` runs on the rank's ids and table columns; under a replica
(vocab) split ``forward_sharded`` is the reference's explicit lowering
(embedding.py:95-150): each rank gathers the ids that fall in its
block of table rows, zeros for the rest, sums them over the aggregated
dim, and one all-reduce over the vocab axes sums the blocks (avg
divides after it), instead of a gather of the table.
``BatchedEmbeddingOp`` is the reference's batched lookup of K stacked
tables (embedding.py:196-307), which its search builds from K
same-signature embeddings: one gather over [K, V, D] for every table at
once; a branch split (dim 0) keeps whole tables on a rank, and a vocab
split runs the same explicit lowering as ``EmbeddingOp``'s."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import Initializer, NormInitializer
from flexflow_tpu_torch.ops.base import (
    REPLICA_SLOT,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)


class _TableLookup:
    """``forward`` and the vocab split's ``forward_sharded`` of a table
    lookup, for a table whose vocab dim is ``_rows`` (the embedding's 0,
    the batched embedding's 1, after its table dim) and ids with as many
    leading dims, then the looked-up dims, the last of which ``aggr``
    sums or averages when there is one."""

    _rows = 0

    def _lookup(self, table, ids):
        return table[ids]

    def _aggregate(self, y: torch.Tensor, ids: torch.Tensor,
                   mean: bool = True) -> torch.Tensor:
        """``aggr`` over the ids' last dim: sum, or (``mean``) avg."""
        aggr = self.attrs["aggr"]
        if aggr == "none" or ids.dim() <= self._rows + 1:
            return y
        if aggr == "avg" and mean:
            return y.mean(dim=-2)
        return y.sum(dim=-2)

    def forward(self, ctx, inputs, weights):
        ids = inputs[0].long()
        return [self._aggregate(self._lookup(weights["table"], ids), ids)]

    def forward_sharded(self, ctx, inputs, weights, osh):
        vocab_axes = ctx.axes(REPLICA_SLOT)
        if not vocab_axes:
            return None
        table = weights["table"]
        vshard = table.shape[self._rows]  # this rank's block of rows
        ids = inputs[0].long()
        local = ids - ctx.mesh.index(vocab_axes) * vshard
        valid = (local >= 0) & (local < vshard)
        y = self._lookup(table, torch.where(valid, local, 0))
        y = torch.where(valid[..., None], y, torch.zeros((), dtype=y.dtype,
                                                         device=y.device))
        y = ctx.reduce_partial(self._aggregate(y, ids, mean=False))
        if self.attrs["aggr"] == "avg" and ids.dim() > self._rows + 1:
            y = y / ids.shape[-1]
        return [y]


@register_op
class EmbeddingOp(_TableLookup, Operator):
    """ids [...] (int) -> [..., D].  attrs: num_entries, out_dim, aggr."""

    op_type = OperatorType.EMBEDDING

    def __init__(self, name, input_shapes, num_entries: int, out_dim: int,
                 aggr: str = "none",
                 kernel_initializer: Initializer | None = None,
                 param_dtype: str = "float32"):
        assert aggr in ("none", "sum", "avg")
        self._kernel_init = kernel_initializer or NormInitializer(
            stddev=0.05)
        super().__init__(name, input_shapes, num_entries=num_entries,
                         out_dim=out_dim, aggr=aggr, param_dtype=param_dtype)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        a = self.attrs
        if a["aggr"] == "none":
            sizes = x.sizes + (a["out_dim"],)
        else:
            sizes = (x.sizes[:-1] + (a["out_dim"],) if x.ndim > 1
                     else (x.sizes[0], a["out_dim"]))
        return (ParallelTensorShape.make(sizes, a["param_dtype"]),)

    def weight_specs(self):
        a = self.attrs
        return (WeightSpec("table", (a["num_entries"], a["out_dim"]),
                           DataType.from_any(a["param_dtype"]),
                           self._kernel_init),)

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = mv.dim_degrees
        r = mv.replica_degree  # vocab split -> partial-sum rows
        d_deg = degs[-1]  # channel split of the table
        batch_parts = 1
        for d in degs[:-1]:
            batch_parts *= d
        x = self.input_shapes[0]
        if self.attrs["aggr"] == "none":
            in_degs = degs[:-1]  # output = input dims + (D,)
        else:
            # output drops the aggregated seq dim: ids [B, S] -> out [B, D]
            in_degs = degs[:-1] + (1,) * (x.ndim - (len(degs) - 1))
        out_nd = len(degs)
        return OpSharding(
            inputs=(ShardAnnot(in_degs, replica=d_deg * r),),
            weights=(
                ShardAnnot(
                    (r, d_deg), replica=batch_parts, idx=(REPLICA_SLOT, out_nd - 1)
                ),
            ),
            outputs=(ShardAnnot(degs, replica=r, partial=r > 1),),
        )

    def splittable_output_dims(self):
        return tuple(range(self.output_shapes[0].ndim))

    def max_replica_degree(self) -> int:
        return self.attrs["num_entries"]

    def flops(self) -> float:
        return float(self.output_shapes[0].num_elements)

    def bytes_accessed(self) -> float:
        # gather traffic dominates: one row per id (reference
        # ops/embedding.py:189-193)
        x = self.input_shapes[0]
        rows = x.num_elements
        return float(rows * self.attrs["out_dim"] * 4
                     + self.output_shapes[0].num_bytes)


@register_op
class BatchedEmbeddingOp(_TableLookup, Operator):
    """K stacked lookups: ids [K, B(, S)] (int), table [K, V, D] ->
    [K, B, D] (aggr sum/avg) or [K, B, S, D] (none) — the reference's
    ``BatchedEmbeddingOp`` (embedding.py:196-307), which its strategy
    search builds from K same-signature embeddings
    (search/substitution.py ``BatchEmbeddingsXfer``).  Table k looks up
    ids k; with ids [K, B, S] the S rows are summed or averaged as
    ``EmbeddingOp``'s are."""

    op_type = OperatorType.BATCHED_EMBEDDING

    def __init__(
        self,
        name,
        input_shapes,
        num_tables: int,
        num_entries: int,
        out_dim: int,
        aggr: str = "none",
        kernel_initializer: Initializer | None = None,
        param_dtype: str = "float32",
    ):
        assert aggr in ("none", "sum", "avg")
        self._kernel_init = kernel_initializer or NormInitializer(stddev=0.05)
        super().__init__(
            name,
            input_shapes,
            num_tables=num_tables,
            num_entries=num_entries,
            out_dim=out_dim,
            aggr=aggr,
            param_dtype=param_dtype,
        )

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]  # [K, B(, S)]
        a = self.attrs
        if a["aggr"] == "none":
            sizes = x.sizes + (a["out_dim"],)
        else:
            sizes = x.sizes[:2] + (a["out_dim"],)
        return (ParallelTensorShape.make(sizes, DataType.from_any(a["param_dtype"])),)

    def weight_specs(self) -> Sequence[WeightSpec]:
        a = self.attrs
        return (
            WeightSpec(
                "table",
                (a["num_tables"], a["num_entries"], a["out_dim"]),
                DataType.from_any(a["param_dtype"]),
                self._kernel_init,
            ),
        )

    _rows = 1

    def _lookup(self, table, ids):
        """table[k][ids[k]] for every k: [K, B(, S), D]."""
        k = torch.arange(ids.shape[0], device=ids.device).view(
            (-1,) + (1,) * (ids.dim() - 1))
        return table[k, ids]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = mv.dim_degrees  # over output [K, B, D] (or [K, B, S, D])
        r = mv.replica_degree  # vocab split -> partial rows
        k_deg, d_deg = degs[0], degs[-1]
        batch_parts = 1
        for d in degs[1:-1]:
            batch_parts *= d
        x = self.input_shapes[0]
        if self.attrs["aggr"] == "none":
            in_degs = degs[:-1]
        else:
            in_degs = degs[:-1] + (1,) * (x.ndim - (len(degs) - 1))
        out_nd = len(degs)
        return OpSharding(
            inputs=(ShardAnnot(in_degs, replica=d_deg * r),),
            weights=(
                ShardAnnot(
                    (k_deg, r, d_deg),
                    replica=batch_parts,
                    idx=(0, REPLICA_SLOT, out_nd - 1),
                ),
            ),
            outputs=(ShardAnnot(degs, replica=r, partial=r > 1),),
        )

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))

    def max_replica_degree(self) -> int:
        return self.attrs["num_entries"]

    def flops(self) -> float:
        return float(self.output_shapes[0].num_elements)

    def bytes_accessed(self) -> float:
        x = self.input_shapes[0]
        rows = x.num_elements
        return float(
            rows * self.attrs["out_dim"] * 4 + self.output_shapes[0].num_bytes
        )
