"""Embedding lookup — the port of ``EmbeddingOp`` in
flexflow_tpu/ops/embedding.py, for ``aggr="none"`` (the decode path's
token and positional tables of the decode and training GPTs).  The
gradient of the table is autograd's scatter-add of the gathered rows.
The sum/avg aggregations and the vocab-split lowering come with the
slices whose models use them."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import Initializer, NormInitializer
from flexflow_tpu_torch.ops.base import Operator, WeightSpec, register_op


@register_op
class EmbeddingOp(Operator):
    """ids [...] (int) -> [..., D].  attrs: num_entries, out_dim, aggr."""

    op_type = OperatorType.EMBEDDING

    def __init__(self, name, input_shapes, num_entries: int, out_dim: int,
                 aggr: str = "none",
                 kernel_initializer: Initializer | None = None):
        if aggr != "none":
            raise NotImplementedError(
                f"embedding aggr={aggr!r}: only 'none' is ported so far")
        self._kernel_init = kernel_initializer or NormInitializer(
            stddev=0.05)
        super().__init__(name, input_shapes, num_entries=num_entries,
                         out_dim=out_dim, aggr=aggr)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        return (ParallelTensorShape.make(x.sizes + (self.attrs["out_dim"],),
                                         DataType.FLOAT32),)

    def weight_specs(self):
        a = self.attrs
        return (WeightSpec("table", (a["num_entries"], a["out_dim"]),
                           DataType.FLOAT32, self._kernel_init),)

    def forward(self, ctx, inputs, weights):
        return [weights["table"][inputs[0].long()]]

    def flops(self) -> float:
        return float(self.output_shapes[0].num_elements)
