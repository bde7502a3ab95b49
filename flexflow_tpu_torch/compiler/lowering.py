"""Graph execution — the port of flexflow_tpu/compiler/lowering.py
(``CompiledModel``: ``init_params``, ``apply``, ``train_step``,
``eval_step``, ``forward_fn``) for one device and for pure sequence
parallelism.

PyTorch runs eagerly, so "lowering" is running each node's ``forward``
in topological order.  ``apply`` records autograd only when called with
``train=True``; the decode path and ``eval_step``/``forward_fn`` run it
without.  A training step is the reference's ``_raw_step``: the loss
(plus any ``*/aux_loss`` state terms), gradients by autograd, the
optimizer update (in place, see optimizers.py), then the metrics.

``train_steps`` runs N steps over ``[N, B, ...]`` stacks as ONE
captured CUDA graph (compiler/graphs.py): the reference's jitted
``lax.scan`` (lowering.py:697-731).  Step i reads slice i of the static
stacks; the losses and metrics come back stacked over N in static
buffers that the next call with the same N overwrites.  ``train_step``
is the N = 1 case.  The parameters, the optimizer state and the model
state are updated in place (a state value that a step returns as a new
tensor is copied into the old one), so the graph holds their
addresses.  Under sequence parallelism both stay eager: the gradient
mean's gloo host hops cannot be captured, and the reference also runs
one step per call when the job has several processes.  ``eval_step``
and ``forward_fn`` stay eager: no main path times them.

Weights are seeded by NAME, as the reference's ``weight_fold_key``
does: each weight draws from its own ``torch.Generator`` seeded from
the model seed and crc32 of ``"op/weight"``, so initialisation does not
depend on the order the graph enumerates its nodes (and every rank of a
job starts from the same weights).

Strategies.  The trivial strategy (or none) runs the graph on one
device.  The pure sequence-parallel strategy — every op whose output
has a sequence dim (ndim >= 2) at ``MachineView((1, n, 1, ...))``, n the
job's world size, and every other op trivial — runs one rank per shard
of the sequence: inputs, labels and constants are the rank's slice,
position-wise ops run on it unchanged, MHA runs the ring
(``parallel/ring_attention.py``), each rank's loss is the mean over its
tokens, the gradients are averaged over the ranks after the backward
(``all_reduce_mean_``; with equal shards the mean of the shards' mean
losses is the global mean loss) and so are the reported loss and
metrics.  Any other non-trivial view needs resharding between views
(ROADMAP Queue A item 8) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from flexflow_tpu_torch.compiler.graphs import StepGraph
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.machine import MachineView
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


# losses that are means over positions: under sequence parallelism the
# mean of the ranks' losses is the global loss
_SP_LOSSES = (LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
              LossType.CATEGORICAL_CROSSENTROPY,
              LossType.MEAN_SQUARED_ERROR, LossType.IDENTITY)


def sequence_parallel_degree(graph: Graph,
                             strategy: Optional[Dict[int, MachineView]]
                             ) -> int:
    """n when ``strategy`` is the pure sequence-parallel strategy of
    degree n, 1 when it is trivial (or None); raises
    ``NotImplementedError`` for any other strategy."""
    if not strategy:
        return 1
    views = {n.guid: strategy.get(n.guid) or MachineView.trivial(
        n.op.output_shapes[0].ndim) for n in graph.topo_order()}
    if all(v.is_trivial for v in views.values()):
        return 1
    seq_degrees = {v.dim_degrees[1] for v in views.values()
                   if len(v.dim_degrees) >= 2}
    n = max(seq_degrees, default=1)
    for guid, v in views.items():
        nd = len(v.dim_degrees)
        want = (MachineView((1, n) + (1,) * (nd - 2)) if nd >= 2
                else MachineView.trivial(nd))
        if v != want:
            raise NotImplementedError(
                f"{graph.nodes[guid].op.name}: view {v} (want {want}); the "
                f"port lowers the trivial strategy and the pure "
                f"sequence-parallel one (every op with a sequence dim at "
                f"(1, n, ...)); other views need resharding between views "
                f"(ROADMAP Queue A item 8), a later slice")
    return n


class CompiledModel:
    """A graph bound to one device, or to this rank's shard of the
    sequence under a sequence-parallel strategy, with the loss, metrics
    and optimizer a training compile chose (all optional for
    inference)."""

    def __init__(self, graph: Graph, config: FFConfig,
                 loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                 metric_types: Sequence = (),
                 optimizer: Optional[Optimizer] = None,
                 strategy: Optional[Dict[int, MachineView]] = None):
        from flexflow_tpu_torch.runtime import distributed

        self.graph = graph
        self.config = config
        self.device = config.torch_device()
        self.compute_dtype = config.torch_compute_dtype
        world = distributed.world_size()
        if config.num_devices != world:
            raise ValueError(
                f"FFConfig.num_devices={config.num_devices} but the job has "
                f"{world} rank(s) (runtime.distributed.initialize)")
        self.sp_size = sequence_parallel_degree(graph, strategy)
        if self.sp_size != world:
            raise NotImplementedError(
                f"a strategy of sequence degree {self.sp_size} on {world} "
                f"rank(s): the port splits the sequence over every rank "
                f"of the job; data-parallel and replicated execution come "
                f"with later slices")
        self.sp_group = None
        if self.sp_size > 1:
            import torch.distributed as dist

            self.sp_group = dist.group.WORLD
        self.loss_type = LossType.from_any(loss_type)
        if self.sp_size > 1 and self.loss_type not in _SP_LOSSES:
            raise NotImplementedError(
                f"loss {self.loss_type.value} under sequence parallelism: "
                f"the port takes losses that are means over positions")
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
        self.step_graph = StepGraph(self.device)

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
                              state_in=state, device=self.device,
                              sp_group=self.sp_group)
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
        forward does not reach gets a zero gradient.  Under sequence
        parallelism the loss and the gradients are the job's (means over
        the ranks) and the logits are this rank's shard.  The gradients
        are taken with respect to fresh leaves that share the weights'
        storage, so no autograd node outlives the call: a node kept from
        an earlier call would carry that call's stream into a capture."""
        leaves = [(op, w, t.detach().requires_grad_(True))
                  for op, ws in params.items() for w, t in ws.items()]
        live: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, w, t in leaves:
            live.setdefault(op, {})[w] = t
        logits, new_state = self.apply(live, state, inputs, train=True)
        loss = self._loss_from(logits, labels, new_state)
        gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (op, w, t), g in zip(leaves, gs):
            grads.setdefault(op, {})[w] = (torch.zeros_like(t) if g is None
                                           else g)
        loss = loss.detach()
        if self.sp_group is not None:
            from flexflow_tpu_torch.parallel.mesh import all_reduce_mean_

            all_reduce_mean_([g for ws in grads.values()
                              for g in ws.values()] + [loss], self.sp_group)
        return loss, logits.detach(), new_state, grads

    def _steps(self, params, opt_state, state, inputs_stacked,
               labels_stacked):
        """``labels_stacked.shape[0]`` optimizer steps in order, step i
        on slice i of the stacks; returns (losses [N], metrics stacked
        over N)."""
        losses, ms = [], []
        for i in range(labels_stacked.shape[0]):
            labels = labels_stacked[i]
            loss, logits, new_state, grads = self.loss_and_grads(
                params, state, [x[i] for x in inputs_stacked], labels)
            self.optimizer.apply(params, grads, opt_state)
            m = compute_metrics(self.metric_types, self.loss_type, logits,
                                labels)
            if self.sp_group is not None and m:
                from flexflow_tpu_torch.parallel.mesh import all_reduce_mean_

                all_reduce_mean_(list(m.values()), self.sp_group)
            with torch.no_grad():
                for k, v in new_state.items():
                    if v is not state[k]:
                        state[k].copy_(v)
            losses.append(loss)
            ms.append(m)
        return (torch.stack(losses),
                {k: torch.stack([m[k] for m in ms]) for k in ms[0]})

    def train_steps(self, params, opt_state, state, inputs_stacked,
                    labels_stacked):
        """N optimizer steps in one call (reference ``train_steps``):
        ``inputs_stacked`` a list of [N, B, ...] tensors or arrays,
        ``labels_stacked`` [N, B, ...].  Returns (params, opt_state,
        state, losses [N], metrics stacked over N); the first three are
        the same objects, updated in place, and the last two are the
        compiled step's static buffers (see the module docstring).
        Nothing here waits for the device."""
        if self.optimizer is None:
            raise RuntimeError("train_step needs a model compiled with "
                               "comp_mode='training'")
        arrays = [*inputs_stacked, labels_stacked]

        def steps(*xs):
            return self._steps(params, opt_state, state, xs[:-1], xs[-1])

        if self.sp_group is not None:
            losses, m = steps(*arrays)
        else:
            losses, m = self.step_graph(
                steps, arrays,
                bound=[t for t in pytree.tree_leaves((params, opt_state,
                                                      state))
                       if isinstance(t, torch.Tensor)])
        return params, opt_state, state, losses, m

    def train_step(self, params, opt_state, state, inputs, labels):
        """One optimizer step, ``train_steps`` with N = 1: returns
        (params, opt_state, state, loss, metrics); the loss and metrics
        are views of the static buffers the next step overwrites."""
        params, opt_state, state, losses, m = self.train_steps(
            params, opt_state, state, [x[None] for x in inputs],
            labels[None])
        return (params, opt_state, state, losses[0],
                {k: v[0] for k, v in m.items()})

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
