"""FFConfig — the subset of flexflow_tpu/config.py the decode and
training paths read.

The port runs on one device.  ``device`` is explicit and defaults to
``"cuda"``: the entry points run on the card unless the caller asks for
the CPU (the tests pass ``device="cpu"``).  With the default device and
no CUDA, ``torch_device`` raises instead of continuing on the CPU.

Flags of the reference that the port does not run yet (``remat``,
``grad_accum_steps``, ``trace_steps``) raise when set away from their
defaults; they are never silently ignored.
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
    epochs: int = 1
    learning_rate: float = 0.01  # the default SGD's, as the reference
    weight_decay: float = 0.0001
    comp_mode: str = "training"  # set by compile(comp_mode=...)
    remat: bool = False
    grad_accum_steps: int = 1
    trace_steps: int = 1

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
        for flag, default, what in (
                ("remat", False, "activation rematerialisation"),
                ("grad_accum_steps", 1, "gradient accumulation"),
                ("trace_steps", 1, "multi-step traced train calls")):
            if getattr(self, flag) != default:
                raise NotImplementedError(
                    f"{flag}={getattr(self, flag)!r}: {what} is not ported "
                    f"yet; the port runs one optimizer step per batch "
                    f"with every activation saved")

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
