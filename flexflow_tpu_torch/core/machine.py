"""``MachineView`` — a copy of flexflow_tpu/core/machine.py:196-249.

The view of one operator: a degree per output dim, a replica degree and
a placement offset.  Each op's ``propagate(mv)`` turns it into the
sharding of its tensors and ``parallel/mesh.py`` maps its slots onto
mesh axes; the lowering (compiler/lowering.py) runs any combination
of views, one process per rank, and ignores ``start_part`` as the
reference's GSPMD lowering does.  ``MachineSpec`` comes with the
search slice (ROADMAP Queue A item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MachineView:
    """Parallelization of one operator: degree per output dim + replicas.

    ``dim_degrees[i]`` partitions output dim i into that many shards;
    ``replica_degree`` replicates the op's output.  Total parts =
    product.  ``start_part`` is the placement offset: the op's shards
    occupy the contiguous device block [start_part, start_part +
    num_parts)."""

    dim_degrees: Tuple[int, ...]
    replica_degree: int = 1
    start_part: int = 0

    @property
    def num_parts(self) -> int:
        p = self.replica_degree
        for d in self.dim_degrees:
            p *= d
        return p

    @property
    def is_trivial(self) -> bool:
        return self.num_parts == 1

    def __str__(self) -> str:
        s = "x".join(str(d) for d in self.dim_degrees)
        if self.replica_degree > 1:
            s += f"*R{self.replica_degree}"
        if self.start_part:
            s += f"@{self.start_part}"
        return f"MV[{s}]"

    @staticmethod
    def trivial(ndim: int) -> "MachineView":
        return MachineView(dim_degrees=(1,) * ndim)

    @staticmethod
    def data_parallel(ndim: int, degree: int,
                      batch_dim: int = 0) -> "MachineView":
        dims = [1] * ndim
        dims[batch_dim] = degree
        return MachineView(dim_degrees=tuple(dims))
