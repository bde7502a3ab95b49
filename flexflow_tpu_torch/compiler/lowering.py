"""Graph execution on one device — the single-device part of
flexflow_tpu/compiler/lowering.py (``CompiledModel``: ``init_params``,
``apply``, ``train_step``, ``eval_step``, ``forward_fn``).

PyTorch runs eagerly, so "lowering" is running each node's ``forward``
in topological order.  ``apply`` records autograd only when called with
``train=True``; the decode path and ``eval_step``/``forward_fn`` run it
without.  ``train_step`` is the reference's ``_raw_step``: the loss
(plus any ``*/aux_loss`` state terms), gradients by autograd, the
optimizer update (in place, see optimizers.py), then the metrics.

Weights are seeded by NAME, as the reference's ``weight_fold_key``
does: each weight draws from its own ``torch.Generator`` seeded from
the model seed and crc32 of ``"op/weight"``, so initialisation does not
depend on the order the graph enumerates its nodes.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import MetricsType, compute_metrics
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.ops.inout import InputOp
from flexflow_tpu_torch.optimizers import Optimizer


def weight_generator(seed: int, op_name: str, w_name: str) -> torch.Generator:
    """The CPU generator one weight draws from: keyed by the model seed
    and crc32 of the weight's name."""
    crc = zlib.crc32(f"{op_name}/{w_name}".encode())
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | crc)


class CompiledModel:
    """A graph bound to one device, with the loss, metrics and optimizer
    a training compile chose (all optional for inference)."""

    def __init__(self, graph: Graph, config: FFConfig,
                 loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                 metric_types: Sequence = (),
                 optimizer: Optional[Optimizer] = None):
        self.graph = graph
        self.config = config
        self.device = config.torch_device()
        self.compute_dtype = config.torch_compute_dtype
        self.loss_type = LossType.from_any(loss_type)
        self.metric_types = [MetricsType.from_any(m) for m in metric_types]
        self.optimizer = optimizer
        self._topo = graph.topo_order()
        self._input_nodes: List[Node] = sorted(
            (n for n in self._topo if isinstance(n.op, InputOp)),
            key=lambda n: n.op.attrs.get("tensor_guid", n.guid))
        sinks = graph.sinks()
        if not sinks:
            raise ValueError("empty graph")
        self._sink = sinks[-1]

    def init_params(self, seed: int = 0):
        """Fresh ``params[op_name][weight_name]`` and
        ``state["<op>/<var>"]`` tensors on the model's device."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, torch.Tensor] = {}
        for node in self._topo:
            op = node.op
            for ws in op._weight_specs:
                w = ws.initializer.init(
                    weight_generator(seed, op.name, ws.name), ws.shape)
                params.setdefault(op.name, {})[ws.name] = w.to(
                    device=self.device, dtype=ws.dtype.to_torch())
            specs = getattr(op, "state_specs", None)
            if specs is None:
                continue
            for name, shape, dtype, fill in specs():
                state[f"{op.name}/{name}"] = torch.full(
                    shape, fill, dtype=dtype, device=self.device)
        return params, state

    def apply(self, params, state, inputs: Sequence[torch.Tensor],
              train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward through the graph; returns (sink output, new state).
        ``inputs`` bind in frontend tensor-guid order.  Autograd records
        the pass only when ``train`` is set."""
        if len(inputs) != len(self._input_nodes):
            raise ValueError(f"expected {len(self._input_nodes)} inputs, "
                             f"got {len(inputs)}")
        ctx = LoweringContext(compute_dtype=self.compute_dtype, train=train,
                              state_in=state, device=self.device)
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        for node, x in zip(self._input_nodes, inputs):
            values[(node.guid, 0)] = x
        with torch.set_grad_enabled(train):
            for node in self._topo:
                if isinstance(node.op, InputOp):
                    continue
                edges = sorted(self.graph.in_edges[node.guid],
                               key=lambda e: e.dst_idx)
                ins = [values[(e.src, e.src_idx)] for e in edges]
                outs = node.op.forward(ctx, ins, params.get(node.op.name, {}))
                for i, y in enumerate(outs):
                    values[(node.guid, i)] = y
        new_state = dict(state)
        new_state.update(ctx.state_out)
        return values[(self._sink.guid, 0)], new_state

    # ---- training --------------------------------------------------------
    def _loss_from(self, logits, labels, new_state):
        loss = compute_loss(self.loss_type, logits, labels)
        for k, v in new_state.items():
            if k.endswith("/aux_loss"):
                loss = loss + v
        return loss

    def loss_and_grads(self, params, state, inputs, labels):
        """One training forward and backward without an update: (loss,
        logits, new state, grads keyed like params).  A weight the
        forward does not reach gets a zero gradient."""
        leaves = [(op, w, t) for op, ws in params.items()
                  for w, t in ws.items()]
        for _, _, t in leaves:
            t.requires_grad_(True)
        logits, new_state = self.apply(params, state, inputs, train=True)
        loss = self._loss_from(logits, labels, new_state)
        gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (op, w, t), g in zip(leaves, gs):
            grads.setdefault(op, {})[w] = (torch.zeros_like(t) if g is None
                                           else g)
        return loss.detach(), logits.detach(), new_state, grads

    def train_step(self, params, opt_state, state, inputs, labels):
        """One optimizer step: returns (params, opt_state, state, loss,
        metrics); params and opt_state are the same objects, updated in
        place.  Nothing here waits for the device."""
        if self.optimizer is None:
            raise RuntimeError("train_step needs a model compiled with "
                               "comp_mode='training'")
        loss, logits, new_state, grads = self.loss_and_grads(
            params, state, inputs, labels)
        self.optimizer.apply(params, grads, opt_state)
        m = compute_metrics(self.metric_types, self.loss_type, logits, labels)
        return params, opt_state, new_state, loss, m

    @torch.no_grad()
    def eval_step(self, params, state, inputs, labels):
        """(loss, metrics) of one batch, no gradients."""
        logits, new_state = self.apply(params, state, inputs)
        loss = self._loss_from(logits, labels, new_state)
        m = compute_metrics(self.metric_types, self.loss_type, logits, labels)
        return loss, m

    def forward_fn(self):
        """(params, state, inputs) -> logits, no gradients."""
        def fwd(params, state, inputs):
            return self.apply(params, state, inputs)[0]

        return fwd
