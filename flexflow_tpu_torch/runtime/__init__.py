"""runtime of the PyTorch port (flexflow_tpu/runtime/): the always-on
training loop (``TrainingController``, ``shrink_config``) and its
seeded faults (``Fault``, ``FaultPlan``, ``TransientCollectiveError``)
are exported here; the other modules are imported by path."""

from flexflow_tpu_torch.runtime.controller import (
    TrainingController,
    shrink_config,
)
from flexflow_tpu_torch.runtime.faults import (
    Fault,
    FaultPlan,
    TransientCollectiveError,
)

__all__ = [
    "Fault",
    "FaultPlan",
    "TrainingController",
    "TransientCollectiveError",
    "shrink_config",
]
