"""Tensor shapes and dtypes — the single-device subset of
flexflow_tpu/core/ptensor.py.

The reference's ``ParallelTensorShape`` carries per-dim partition
degrees and mesh axes; the port runs on one device, so a shape here is
sizes plus dtype.  ``DataType`` keeps the reference's names and adds
the map to ``torch`` dtypes.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

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
    def from_any(x: "DataType | str") -> "DataType":
        return x if isinstance(x, DataType) else DataType(x)


_TORCH = {
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT16: torch.float16,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.BOOL: torch.bool,
}


@dataclass(frozen=True)
class ParallelTensorShape:
    """Logical sizes (NumPy order) and dtype of a tensor on one device."""

    sizes: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT32

    @staticmethod
    def make(sizes: Sequence[int],
             dtype: "DataType | str" = DataType.FLOAT32
             ) -> "ParallelTensorShape":
        return ParallelTensorShape(tuple(int(s) for s in sizes),
                                   DataType.from_any(dtype))

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    @property
    def num_elements(self) -> int:
        return math.prod(self.sizes)


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
