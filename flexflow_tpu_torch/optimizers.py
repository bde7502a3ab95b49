"""Optimizers — the port of flexflow_tpu/optimizers.py, with the
reference's update algebra: SGD with momentum, Nesterov and L2 weight
decay; Adam with the per-step bias-corrected
``alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)``, L2 decay added
to the gradient unless ``adamw``, fp32 moments.

Where the port departs from JAX: ``apply`` updates the parameters and
the optimizer state IN PLACE under ``torch.no_grad()`` (the
counterpart of the reference's buffer donation, ``donate_argnums`` in
its train step), so a step holds no second copy of the weights or the
moments.  It returns the same (params, state) objects.  The updates run
as ``torch._foreach_*`` ops over all weights, a handful of launches per
step instead of a handful per weight.  Parameters must be float32, as
every weight spec of the ported ops is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def _flat(tree: Params, like: Params) -> List[torch.Tensor]:
    """``tree``'s tensors in ``like``'s (op, weight) order."""
    return [tree[op][w] for op, ws in like.items() for w in ws]


def _zeros_like(params: Params) -> Params:
    return {op: {w: torch.zeros_like(t, dtype=torch.float32)
                 for w, t in ws.items()} for op, ws in params.items()}


def _check_fp32(ps: List[torch.Tensor]) -> None:
    bad = {t.dtype for t in ps if t.dtype != torch.float32}
    if bad:
        raise NotImplementedError(
            f"the port's optimizers update float32 parameters in place, "
            f"got {sorted(map(str, bad))}")


class Optimizer:
    def init_state(self, params: Params) -> dict:
        raise NotImplementedError

    def apply(self, params: Params, grads: Params, state: dict
              ) -> Tuple[Params, dict]:
        """Update ``params`` and ``state`` in place from ``grads`` (keyed
        like params); returns them."""
        raise NotImplementedError


@dataclass
class SGDOptimizer(Optimizer):
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params):
        if self.momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "v": _zeros_like(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        ps = _flat(params, params)
        _check_fp32(ps)
        gs = [g.float() for g in _flat(grads, params)]
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        if self.momentum > 0.0:
            vs = _flat(state["v"], params)
            torch._foreach_mul_(vs, self.momentum)
            torch._foreach_add_(vs, gs)
            gs = (torch._foreach_add(gs, vs, alpha=self.momentum)
                  if self.nesterov else vs)
        torch._foreach_add_(ps, gs, alpha=-self.lr)
        state["step"] += 1
        return params, state


@dataclass
class AdamOptimizer(Optimizer):
    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8
    adamw: bool = False

    @property
    def lr(self) -> float:
        return self.alpha

    def init_state(self, params):
        return {"step": 0, "m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        t = state["step"] + 1
        alpha_t = (self.alpha * math.sqrt(1.0 - self.beta2 ** t)
                   / (1.0 - self.beta1 ** t))
        ps = _flat(params, params)
        _check_fp32(ps)
        gs = [g.float() for g in _flat(grads, params)]
        ms, vs = _flat(state["m"], params), _flat(state["v"], params)
        if self.weight_decay and not self.adamw:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        decay = (torch._foreach_mul(ps, self.alpha * self.weight_decay)
                 if self.adamw and self.weight_decay else None)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.beta2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(ps, ms, denom, value=-alpha_t)
        if decay is not None:
            torch._foreach_sub_(ps, decay)
        state["step"] = t
        return params, state
