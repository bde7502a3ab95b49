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
step instead of a handful per weight.  A parameter of another dtype
(``LinearOp(param_dtype="bfloat16")``) is updated as the reference
updates it (optimizers.py:61-66): read in fp32, updated in fp32 and
cast back to its own dtype (round to nearest even) in place; the
optimizer slots stay fp32.

The step count is a 0-d int32 tensor on the parameters' device, as the
reference's ``opt_state["step"]`` is (optimizers.py:108), advanced in
place, and Adam's ``alpha_t`` is computed from it in fp32 on the device
and applied as a tensor scalar.  Nothing of an update is a host value
that changes from step to step, so a captured step
(compiler/graphs.py) replays it exactly, and the eager update runs the
same ops.
"""

from __future__ import annotations

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


def _fp32_view(ps: List[torch.Tensor]) -> List[torch.Tensor]:
    """The parameters as the update reads them: fp32 ones as they are
    (updated in place), others as fp32 copies that ``_cast_back``
    writes home."""
    return [p if p.dtype == torch.float32 else p.float() for p in ps]


def _cast_back(ps: List[torch.Tensor], p32: List[torch.Tensor]) -> None:
    for p, q in zip(ps, p32):
        if q is not p:
            p.copy_(q)


def _step_counter(params: Params) -> torch.Tensor:
    """A 0-d int32 zero on the parameters' device."""
    ts = [t for ws in params.values() for t in ws.values()]
    return torch.zeros((), dtype=torch.int32,
                       device=ts[0].device if ts else "cpu")


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
            return {"step": _step_counter(params)}
        return {"step": _step_counter(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        raw = _flat(params, params)
        ps = _fp32_view(raw)
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
        _cast_back(raw, ps)
        state["step"].add_(1)
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
        return {"step": _step_counter(params), "m": _zeros_like(params),
                "v": _zeros_like(params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        t = state["step"].float() + 1.0
        alpha_t = (self.alpha * torch.sqrt(1.0 - self.beta2 ** t)
                   / (1.0 - self.beta1 ** t))
        raw = _flat(params, params)
        ps = _fp32_view(raw)
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
        # p - alpha_t * m / denom, in the reference's order
        upd = torch._foreach_mul(ms, alpha_t)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)
        if decay is not None:
            torch._foreach_sub_(ps, decay)
        _cast_back(raw, ps)
        state["step"].add_(1)
        return params, state
