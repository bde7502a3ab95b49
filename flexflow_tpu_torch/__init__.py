"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

Built slice by slice beside the JAX package, which stays the reference
each slice is held against.  This package imports torch, numpy and the
standard library, never JAX or flexflow_tpu.  It runs these paths on
NVIDIA H100 cards.  Serving:

    build_gpt_decode -> FFModel.compile(comp_mode="inference")
    -> compiled_decode_step -> ContinuousBatchingExecutor.run

with decode attention in hand-written CUDA kernels for sm_90a
(``csrc/ragged_paged_attention.cu``: fp32/bf16 pools, and int8 pools
under ``FFConfig(kv_precision="int8")``), prompts through the chunked
prefill lane, radix prefix sharing and SLO classes.  Training:

    build_gpt / build_transformer -> FFModel.compile(optimizer,
    loss_type, metrics) -> FFModel.fit

with flash attention forward and backward in hand-written CUDA kernels
(``csrc/flash_attention.cu``), ``FFConfig(trace_steps=n)`` running n
steps per compiled call.  Multi-rank training: the same under
``runtime.distributed`` and a strategy that splits the batch, the
sequence, out dims or heads/contractions over the job's ranks
(``compiler/lowering.py``, ``parallel/``: resharding, the ring,
Ulysses).  The decode frame, the chunk pass and the training step (one
or n) run as captured CUDA graphs over static buffers
(``compiler/graphs.py``; eagerly inside ``compiler.graphs.eager()``);
multi-rank steps stay eager.  Pipeline and inter-op placement:
``compile(pipeline=PipelineConfig(...))`` (GPipe over a ``pp`` axis of
ranks), two-block ``start_part`` strategies and the search's pipeline,
staged and placement proposals behind ``compile(strategy=None)``.
The training surface: ``build_bert`` (``models``), attention and op
dropout, ``FFConfig(remat=True)`` and ``grad_accum_steps``, and ``fit``
with keras-protocol callbacks, validation data or split,
``recompile_state``, ``checkpoint_dir`` and ``resume``
(``runtime/checkpoint.py``, ``runtime/recompile.py``,
``FFModel.recompile``).  Entry points run on the card unless the config
says ``device="cpu"``.

The exports are the reference's ``_LAZY`` names
(flexflow_tpu/__init__.py:22-53), every one of them, loaded on first
use; each subpackage's ``__init__`` exports its reference's names the
same way (``tests/test_torch_surface.py`` lists the few JAX idioms
left out, each with its reason).
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.losses import LossType
from flexflow_tpu_torch.metrics import MetricsType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer

_LAZY = {
    "IterationConfig": ("flexflow_tpu_torch.config", "IterationConfig"),
    "OperatorType": ("flexflow_tpu_torch.core.optype", "OperatorType"),
    "DataType": ("flexflow_tpu_torch.core.ptensor", "DataType"),
    "ParallelDim": ("flexflow_tpu_torch.core.ptensor", "ParallelDim"),
    "ParallelTensorShape": ("flexflow_tpu_torch.core.ptensor",
                            "ParallelTensorShape"),
    "Tensor": ("flexflow_tpu_torch.core.ptensor", "Tensor"),
    "MachineSpec": ("flexflow_tpu_torch.core.machine", "MachineSpec"),
    "Graph": ("flexflow_tpu_torch.core.graph", "Graph"),
    "UniformInitializer": ("flexflow_tpu_torch.initializers",
                           "UniformInitializer"),
    "GlorotUniformInitializer": ("flexflow_tpu_torch.initializers",
                                 "GlorotUniformInitializer"),
    "ZeroInitializer": ("flexflow_tpu_torch.initializers",
                        "ZeroInitializer"),
    "ConstantInitializer": ("flexflow_tpu_torch.initializers",
                            "ConstantInitializer"),
    "NormInitializer": ("flexflow_tpu_torch.initializers",
                        "NormInitializer"),
    "CheckpointManager": ("flexflow_tpu_torch.runtime.checkpoint",
                          "CheckpointManager"),
    "RecompileState": ("flexflow_tpu_torch.runtime.recompile",
                       "RecompileState"),
    "StepProfiler": ("flexflow_tpu_torch.runtime.profiler", "StepProfiler"),
    "device_trace": ("flexflow_tpu_torch.runtime.profiler", "device_trace"),
    "measure_operator_cost": ("flexflow_tpu_torch.runtime.profiler",
                              "measure_operator_cost"),
    "RecursiveLogger": ("flexflow_tpu_torch.utils.logging",
                        "RecursiveLogger"),
    "OBS_BUS": ("flexflow_tpu_torch.obs.events", "BUS"),
    "METRICS": ("flexflow_tpu_torch.obs.metrics", "METRICS"),
    "DriftReport": ("flexflow_tpu_torch.obs.drift", "DriftReport"),
}

__all__ = ["AdamOptimizer", "FFConfig", "FFModel", "LossType",
           "MachineView", "MetricsType", "SGDOptimizer", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
