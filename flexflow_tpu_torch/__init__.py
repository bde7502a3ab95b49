"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

Built slice by slice beside the JAX package, which stays the reference
each slice is held against.  This package imports torch, numpy and the
standard library, never JAX or flexflow_tpu.  It runs on one NVIDIA
H100 two paths so far.  Serving:

    build_gpt_decode -> FFModel.compile(comp_mode="inference")
    -> compiled_decode_step -> ContinuousBatchingExecutor.run

with decode attention in a hand-written CUDA kernel for sm_90a
(``csrc/ragged_paged_attention.cu``).  Training:

    build_gpt / build_transformer -> FFModel.compile(optimizer,
    loss_type, metrics) -> FFModel.fit

with flash attention forward and backward in hand-written CUDA kernels
(``csrc/flash_attention.cu``).  Entry points run on the card unless
the config says ``device="cpu"``.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.losses import LossType
from flexflow_tpu_torch.metrics import MetricsType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer

__all__ = ["AdamOptimizer", "FFConfig", "FFModel", "LossType",
           "MetricsType", "SGDOptimizer"]
