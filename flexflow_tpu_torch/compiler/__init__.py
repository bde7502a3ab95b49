"""The compiler of the PyTorch port: the flat, pipelined, placed and
staged lowerings and the captured steps — the port of
flexflow_tpu/compiler/ (its ``__init__`` exports ``CompiledModel`` and
``data_parallel_strategy``)."""

from flexflow_tpu_torch.compiler.lowering import (
    CompiledModel,
    data_parallel_strategy,
)

__all__ = [
    "CompiledModel",
    "data_parallel_strategy",
]
