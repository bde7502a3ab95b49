"""The core of the PyTorch port: operator types, tensor shapes, machine
views and specs, and the computation graph — the port of
flexflow_tpu/core/ (its ``__init__`` exports the same names)."""

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import (
    DataType,
    ParallelDim,
    ParallelTensorShape,
    Tensor,
    replica_dim,
)
from flexflow_tpu_torch.core.machine import (
    MachineSpec,
    MachineView,
)
from flexflow_tpu_torch.core.graph import (
    Edge,
    Graph,
    Node,
)

__all__ = [
    "OperatorType",
    "DataType",
    "ParallelDim",
    "ParallelTensorShape",
    "Tensor",
    "replica_dim",
    "MachineSpec",
    "MachineView",
    "Edge",
    "Graph",
    "Node",
]
