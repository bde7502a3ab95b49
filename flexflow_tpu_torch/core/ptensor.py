"""Parallel tensor shapes and dtypes — the port of
flexflow_tpu/core/ptensor.py.

A ``ParallelTensorShape`` is a logical tensor (sizes in NumPy order,
dtype) plus how it is laid out over the mesh of ranks: each dim
carries a partition degree and the mesh axes it is split over
(outermost first), and replica dims make replication (and partial-sum
state) first-class.  The reference lowers a shape to a JAX
``PartitionSpec``; the port's counterpart is the placement of
``parallel/mesh.py``, which maps a ``ShardAnnot`` onto the ranks'
coordinates.  ``DataType`` keeps the reference's names and adds the
map to ``torch`` dtypes.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class DataType(enum.Enum):
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    BOOL = "bool"

    def to_torch(self) -> torch.dtype:
        return _TORCH[self]

    @staticmethod
    def from_any(x: "DataType | str | np.dtype") -> "DataType":
        if isinstance(x, DataType):
            return x
        if isinstance(x, str) and x in DataType._value2member_map_:
            return DataType(x)
        return DataType(np.dtype(x).name)

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self]


_TORCH = {
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT16: torch.float16,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.BOOL: torch.bool,
}

_ITEMSIZE = {
    DataType.FLOAT32: 4,
    DataType.FLOAT16: 2,
    DataType.BFLOAT16: 2,
    DataType.INT32: 4,
    DataType.INT64: 8,
    DataType.BOOL: 1,
}


@dataclass(frozen=True)
class ParallelDim:
    """One dim of a parallel tensor: its global ``size``, its ``degree``
    (shards along it), the mesh ``axes`` it is split over (outermost
    first, their sizes multiplying to ``degree``) and ``is_replica``
    for a replica dim, which does not exist in the logical tensor and
    expresses replication (forward) or a partial-sum gradient
    (backward) over its axes."""

    size: int
    degree: int = 1
    axes: Tuple[str, ...] = ()
    is_replica: bool = False

    def __post_init__(self):
        if self.is_replica and self.size != self.degree:
            raise ValueError(f"replica dim must have size == degree, got "
                             f"{self.size} != {self.degree}")
        if self.degree > 1 and self.size % self.degree != 0:
            raise ValueError(f"dim size {self.size} not divisible by degree "
                             f"{self.degree}")

    @property
    def shard_size(self) -> int:
        return self.size // self.degree


def replica_dim(degree: int, axes: Tuple[str, ...] = ()) -> ParallelDim:
    return ParallelDim(size=degree, degree=degree, axes=axes, is_replica=True)


@dataclass(frozen=True)
class ParallelTensorShape:
    """Shape, dtype and layout of a tensor over the mesh: ``dims`` are
    the logical dims in NumPy order, ``replicas`` zero or more replica
    dims (kept apart from ``dims``, as in the reference)."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT32
    replicas: Tuple[ParallelDim, ...] = ()

    @staticmethod
    def make(sizes: Sequence[int],
             dtype: "DataType | str" = DataType.FLOAT32,
             degrees: Optional[Sequence[int]] = None,
             axes: Optional[Sequence[Tuple[str, ...]]] = None,
             ) -> "ParallelTensorShape":
        n = len(sizes)
        degrees = list(degrees) if degrees is not None else [1] * n
        axes = list(axes) if axes is not None else [()] * n
        return ParallelTensorShape(
            dims=tuple(ParallelDim(size=int(s), degree=d, axes=tuple(a))
                       for s, d, a in zip(sizes, degrees, axes)),
            dtype=DataType.from_any(dtype))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims)

    @property
    def degrees(self) -> Tuple[int, ...]:
        return tuple(d.degree for d in self.dims)

    @property
    def num_elements(self) -> int:
        return math.prod(self.sizes)

    @property
    def num_bytes(self) -> int:
        return self.num_elements * self.dtype.itemsize

    @property
    def total_degree(self) -> int:
        """Shards: the product of every dim's and replica's degree."""
        return math.prod(self.degrees) * self.replica_degree

    @property
    def replica_degree(self) -> int:
        return math.prod(r.degree for r in self.replicas)

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        return tuple(d.shard_size for d in self.dims)

    @property
    def shard_bytes(self) -> int:
        return math.prod(self.shard_sizes) * self.dtype.itemsize

    def used_axes(self) -> Tuple[str, ...]:
        out = []
        for d in self.dims + self.replicas:
            out.extend(d.axes)
        return tuple(out)

    def with_dim_degree(self, dim: int, degree: int,
                        axes: Tuple[str, ...] = ()) -> "ParallelTensorShape":
        new = list(self.dims)
        new[dim] = replace(new[dim], degree=degree, axes=tuple(axes))
        return replace(self, dims=tuple(new))

    def with_replica(self, degree: int, axes: Tuple[str, ...] = ()
                     ) -> "ParallelTensorShape":
        if degree == 1:
            return replace(self, replicas=())
        return replace(self, replicas=(replica_dim(degree, tuple(axes)),))

    def drop_parallelism(self) -> "ParallelTensorShape":
        return ParallelTensorShape(
            dims=tuple(ParallelDim(size=d.size) for d in self.dims),
            dtype=self.dtype)

    def logical_eq(self, other: "ParallelTensorShape") -> bool:
        return self.sizes == other.sizes and self.dtype == other.dtype

    def __str__(self) -> str:
        parts = [f"{d.size}/{d.degree}{list(d.axes)}" if d.degree > 1
                 else str(d.size) for d in self.dims]
        s = "x".join(parts)
        for r in self.replicas:
            s += f" *R{r.degree}{list(r.axes)}"
        return f"<{s}:{self.dtype.value}>"


class Tensor:
    """Logical frontend tensor: a symbolic value flowing between layers,
    created by FFModel layer methods before compile; carries no data."""

    _next_guid = 1000

    def __init__(self, sizes: Sequence[int],
                 dtype: "DataType | str" = DataType.FLOAT32, name: str = ""):
        self.guid = Tensor._next_guid
        Tensor._next_guid += 1
        self.sizes = tuple(int(s) for s in sizes)
        self.dtype = DataType.from_any(dtype)
        self.name = name or f"tensor_{self.guid}"

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    def __repr__(self) -> str:
        return f"Tensor({self.name}, {list(self.sizes)}, {self.dtype.value})"
