"""The hand-written CUDA kernels of the PyTorch port and their
wrappers — the port of flexflow_tpu/kernels/ (the kernels build at
first launch, never at import).  The reference's ``__init__`` exports
its wrapper ``flash_attention``; here that name is the module
kernels/flash_attention.py, which holds the wrapper of the same name
(``kernels.flash_attention.flash_attention``): the port's code reaches
the module by this name, which a re-exported function would shadow."""

from flexflow_tpu_torch.kernels import flash_attention

__all__ = [
    "flash_attention",
]
