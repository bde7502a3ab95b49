"""Dynamic re-optimization — the port of
flexflow_tpu/runtime/recompile.py (reference: recompile_state.cc; user
trigger()/alter() closures checked once per training step).

``alter`` may change the graph (an op's attributes), after which the
model re-lowers (``FFModel.recompile``) with its params, optimizer
slots and state carried over by name and shape.
"""

from __future__ import annotations

from typing import Callable


class RecompileState:
    """The trigger/alter pair; ``alter`` fires at most once."""

    def __init__(self, trigger: Callable[[object], bool],
                 alter: Callable[[object], None]):
        self._trigger = trigger
        self._alter = alter
        self.altered = False

    def check(self, model) -> bool:
        """Run once per step; True when the model was altered and
        re-lowered by this call."""
        if self.altered or not self._trigger(model):
            return False
        self._alter(model)
        self.altered = True
        model.recompile()
        return True


def cache_score(model, cache_op_name: str) -> float:
    """A cache op's per-step score, ``state["<op>/score"]`` (reference
    cache.cc's score function; ops/moe.py ``CacheOp`` writes it)."""
    return float(model.state[f"{cache_op_name}/score"].float().mean())
