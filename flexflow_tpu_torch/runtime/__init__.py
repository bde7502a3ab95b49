"""The runtime of the PyTorch port — the port of flexflow_tpu/runtime/:
the always-on training loop (``TrainingController``, ``shrink_config``)
and its seeded faults (``Fault``, ``FaultPlan``,
``TransientCollectiveError``), the data loader, the decode executor
and its page allocator, the compiled decode step and the fleet.  The
reference's ``__init__`` names."""

from flexflow_tpu_torch.runtime.controller import (
    TrainingController,
    shrink_config,
)
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
from flexflow_tpu_torch.runtime.faults import (
    Fault,
    FaultPlan,
    TransientCollectiveError,
)
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    PageAllocator,
    compiled_decode_step,
)
from flexflow_tpu_torch.runtime.fleet import FleetExecutor

__all__ = [
    "TrainingController",
    "shrink_config",
    "SingleDataLoader",
    "Fault",
    "FaultPlan",
    "TransientCollectiveError",
    "ContinuousBatchingExecutor",
    "DecodeRequest",
    "PageAllocator",
    "compiled_decode_step",
    "FleetExecutor",
]
