"""Operator base machinery — the port of flexflow_tpu/ops/base.py.

An ``Operator`` is an immutable descriptor: op type + attributes +
logical input/output shapes + weight specs.  ``infer`` runs at graph
build time; ``forward(ctx, inputs, weights)`` computes the op on
PyTorch tensors.  ``flops`` is the reference's forward-FLOP estimate
(the training path's MFU counts 3x its sum).  The reference's degree
propagation and the rest of its cost hooks belong to the search slice
and are not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import Initializer


@dataclass(frozen=True)
class WeightSpec:
    """A named weight owned by an op."""

    name: str
    shape: Tuple[int, ...]
    dtype: DataType
    initializer: Initializer


class LoweringContext:
    """Carried through one forward pass of the whole graph.  ``train``
    says whether the pass is a training step's; ``device`` is where the
    model's tensors live (constants are placed there).  Ops that own
    state (the decode op's KV pools) read it from ``state_in`` and
    publish what they wrote under the same keys in ``state_out``.

    Under sequence parallelism ``sp_group`` is the process group the
    sequence dim is split over (the reference's ``mesh`` and the seq
    slot of ``slot_axes``): this rank holds shard ``sp_rank`` of
    ``sp_size``; ``seq_slice`` gives its positions."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 train: bool = False,
                 state_in: Optional[Dict[str, torch.Tensor]] = None,
                 device: torch.device | str = "cpu", sp_group=None):
        self.compute_dtype = compute_dtype
        self.train = train
        self.state_in = state_in or {}
        self.state_out: Dict[str, torch.Tensor] = {}
        self.device = torch.device(device)
        self.sp_group = sp_group
        self.sp_size, self.sp_rank = 1, 0
        if sp_group is not None:
            import torch.distributed as dist

            self.sp_size = dist.get_world_size(sp_group)
            self.sp_rank = dist.get_rank(sp_group)

    def seq_slice(self, seq_len: int) -> slice:
        """This rank's positions of a ``seq_len``-long sequence."""
        if seq_len % self.sp_size:
            raise ValueError(f"sequence length {seq_len} does not split "
                             f"into {self.sp_size} ranks")
        per = seq_len // self.sp_size
        return slice(self.sp_rank * per, (self.sp_rank + 1) * per)


class Operator:
    """Immutable operator descriptor (graph node payload)."""

    op_type: OperatorType = OperatorType.NOOP
    # True for graph sources (inputs/constants), whose outputs carry no
    # gradient in training
    is_gradient_free: bool = False

    def __init__(self, name: str,
                 input_shapes: Sequence[ParallelTensorShape], **attrs):
        self.name = name
        self.input_shapes: Tuple[ParallelTensorShape, ...] = tuple(
            input_shapes)
        self.attrs: Dict[str, Any] = dict(attrs)
        self.output_shapes: Tuple[ParallelTensorShape, ...] = tuple(
            self.infer())
        self._weight_specs: Tuple[WeightSpec, ...] = tuple(
            self.weight_specs())

    def infer(self) -> Sequence[ParallelTensorShape]:
        raise NotImplementedError(type(self).__name__)

    def weight_specs(self) -> Sequence[WeightSpec]:
        return ()

    def forward(self, ctx: LoweringContext, inputs: List[torch.Tensor],
                weights: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError(type(self).__name__)

    def flops(self) -> float:
        """Forward FLOPs estimate (reference ops/base.py:220-223)."""
        return float(sum(s.num_elements for s in self.output_shapes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


OP_REGISTRY: Dict[OperatorType, Type[Operator]] = {}


def register_op(cls: Type[Operator]) -> Type[Operator]:
    OP_REGISTRY[cls.op_type] = cls
    return cls
