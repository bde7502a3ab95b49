"""Static analysis for the graph and its strategies — the port of
flexflow_tpu/analysis/ that the strategy search calls on its default
path (``search/dp.py``, ``search/driver.py``):

1. ``invariants`` — graph well-formedness after every rewrite
   (``PCG0xx``), armed by ``FLEXFLOW_TPU_VERIFY=1`` or
   ``FFConfig.verify``.
2. ``sharding``   — strategy/``MachineView`` legality and
   search/lowering coherence (``SHD101``-``SHD110``), the always-on gate
   in ``optimize_strategy``; the gradient-sync artifacts' legality: the
   sync schedule (``SHD120``-``SHD123``), its reduction plans
   (``SHD130``-``SHD133``) and the per-group ZeRO-1 map
   (``SHD140``-``SHD141``); the serving artifacts' legality: the serve
   objective's result (``SHD160``-``SHD163``), its KV lane
   (``SHD168``-``SHD169``), the disaggregation proposal
   (``SHD164``-``SHD165``) and the fleet (``SHD166``-``SHD167``).
3. ``placement``  — pipeline stage cuts and two-block placements
   (``SHD150``-``SHD155``), the gate on every proposal the search
   returns, every imported ``__meta__.pipeline``/``placement`` block
   and every placed strategy compile lowers.
4. ``swap``       — hot-swap legality (``SHD170``-``SHD172`` and the flat
   strategy lint): the gate of ``FFModel.swap_strategy`` and the
   always-on training controller (runtime/controller.py).

``equivalence`` and ``proofgen`` (the registry's executable rewrite
proofs, ``EQV3xx``) are not imported here, as in the reference: they
run every op's forward, so callers import them by path
(``from flexflow_tpu_torch.analysis.equivalence import ...``).
"""

from flexflow_tpu_torch.analysis.findings import (
    AnalysisError,
    Finding,
    emit_findings,
    errors_only,
)
from flexflow_tpu_torch.analysis.invariants import (
    CHECK_STATS,
    GraphInvariantError,
    assert_graph_ok,
    check_graph,
    scoped_verify,
    set_verify,
    verification_enabled,
)
from flexflow_tpu_torch.analysis.placement import (
    lint_pipeline_stages,
    lint_placement,
    placement_meta,
)
from flexflow_tpu_torch.analysis.sharding import (
    lint_disaggregation,
    lint_fleet,
    lint_kv,
    lint_reduction_plan,
    lint_serving,
    lint_strategy,
    lint_sync_schedule,
    lint_zero_map,
)
from flexflow_tpu_torch.analysis.swap import lint_swap

__all__ = [
    "AnalysisError",
    "Finding",
    "emit_findings",
    "errors_only",
    "CHECK_STATS",
    "GraphInvariantError",
    "assert_graph_ok",
    "check_graph",
    "scoped_verify",
    "set_verify",
    "verification_enabled",
    "lint_strategy",
    "lint_sync_schedule",
    "lint_zero_map",
    "lint_reduction_plan",
    "lint_serving",
    "lint_kv",
    "lint_disaggregation",
    "lint_fleet",
    "lint_pipeline_stages",
    "lint_placement",
    "placement_meta",
    "lint_swap",
]
