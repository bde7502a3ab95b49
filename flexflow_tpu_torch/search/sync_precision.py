"""Per-weight-group gradient-sync precision (the search side of
comm/quantized.py) — a copy of flexflow_tpu/search/sync_precision.py.

The cost model prices compressed weight-gradient collectives
(machine_model.CostModel.sync_precision_choice); this module holds the
gradient-magnitude-safety heuristic that PRUNES the choice, and builds
the op-name → precision map the lowering executes
(compiler/lowering.py _sync_grads).

Safety heuristic — static, because the search runs before any gradient
exists:

* groups below MIN_COMPRESS_ELEMS stay fp32: their sync rides the
  latency floor, so compression saves nothing while still paying
  quantization error (and bias/scale vectors are exactly these);
* normalization ops (LayerNorm/BatchNorm) stay fp32: their per-channel
  gradients span the widest dynamic range relative to magnitude
  (the EQuARX-class failure mode for block scaling), and they are tiny
  anyway.

Under mode="search" the cost model additionally declines to compress
groups whose sync does not DOMINATE their compute
(CostModel.SYNC_DOMINANCE): a hidden-behind-compute allreduce gains
nothing from quantization, so gradient fidelity is kept for free.
"""

from __future__ import annotations

from typing import Dict, Optional

from flexflow_tpu_torch.comm.quantized import MIN_COMPRESS_ELEMS
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType

__all__ = [
    "MIN_COMPRESS_ELEMS",
    "choose_sync_precision",
    "grad_safe_to_compress",
]

# ops whose weight gradients are too magnitude-disparate for block
# scaling to be a free lunch
_SENSITIVE_OPS = frozenset({OperatorType.LAYERNORM, OperatorType.BATCHNORM})


def grad_safe_to_compress(op) -> bool:
    """May this op's weight-gradient sync be quantized at all?"""
    if not op._weight_specs:
        return False
    if op.op_type in _SENSITIVE_OPS:
        return False
    biggest = 0
    for ws in op._weight_specs:
        n = 1
        for d in ws.shape:
            n *= d
        biggest = max(biggest, n)
    return biggest >= MIN_COMPRESS_ELEMS


def choose_sync_precision(
    graph,
    strategy: Dict[int, MachineView],
    cost_model,
    mode: Optional[str] = None,
) -> Dict[str, str]:
    """op name → wire precision for every weight group the cost model
    decides to compress under ``strategy`` (entries only for bf16/int8
    — absent means fp32).  ``cost_model`` must be the same
    CostModel the search ranked with (Simulator.for_config builds it
    with config.sync_precision), so execution runs exactly what the
    simulation priced; ``mode`` overrides its sync_precision when
    given."""
    out: Dict[str, str] = {}
    old = cost_model.sync_precision
    if mode is not None:
        cost_model.sync_precision = mode
    try:
        if cost_model.sync_precision in (None, "fp32"):
            return out
        for node in graph.topo_order():
            if not node.op._weight_specs:
                continue
            mv = strategy.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            prec, _ = cost_model.sync_precision_choice(node.op, mv)
            if prec != "fp32":
                out[node.op.name] = prec
    finally:
        cost_model.sync_precision = old
    return out
