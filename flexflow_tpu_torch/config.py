"""FFConfig — the subset of flexflow_tpu/config.py the decode path reads.

The port runs on one device.  ``device`` is explicit and defaults to
``"cuda"``: the entry points run on the card unless the caller asks for
the CPU (the tests pass ``device="cpu"``).  With the default device and
no CUDA, ``torch_device`` raises instead of continuing on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclass
class FFConfig:
    batch_size: int = 64
    num_devices: int = 1
    compute_dtype: str = "bfloat16"  # matmul dtype, as the reference
    seed: int = 0
    kv_precision: str = "off"  # KV page-pool dtype lane; only "off" here
    device: str = "cuda"

    def __post_init__(self):
        if self.num_devices != 1:
            raise NotImplementedError(
                f"num_devices={self.num_devices}: the port runs on one "
                f"device until the multi-device slice")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_DTYPES)}, got "
                f"{self.compute_dtype!r}")
        if self.kv_precision != "off":
            raise NotImplementedError(
                f"kv_precision={self.kv_precision!r}: the searched "
                f"KV-precision lane (int8 pools) comes with a later "
                f"serving slice")

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def torch_device(self) -> torch.device:
        """The device every tensor of the model lives on.  A CUDA device
        without CUDA is an error, never a silent move to the CPU."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig.device={self.device!r} but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        return dev
