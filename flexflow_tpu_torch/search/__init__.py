"""Auto-parallelization search — the port of flexflow_tpu/search/: the
Unity algorithm (simulator + DP search + substitution engine + search
driver) over the port's graph and ops, priced for the H100 by default
(``core.machine.MachineSpec.h100_sxm``)."""

from flexflow_tpu_torch.search.machine_model import CostModel
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.views import candidate_views
from flexflow_tpu_torch.search.dp import SearchHelper
from flexflow_tpu_torch.search.driver import optimize_strategy, mcmc_optimize

__all__ = [
    "CostModel",
    "Simulator",
    "candidate_views",
    "SearchHelper",
    "optimize_strategy",
    "mcmc_optimize",
]
