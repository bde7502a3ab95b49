"""Graph execution — the port of flexflow_tpu/compiler/lowering.py
(``CompiledModel``: ``init_params``, ``apply``, ``train_step``,
``eval_step``, ``forward_fn``).

PyTorch runs eagerly, so "lowering" is running each node's ``forward``
in topological order.  ``apply`` records autograd only when called with
``train=True``; the decode path and ``eval_step``/``forward_fn`` run it
without.  A training step is the reference's ``_raw_step``: the loss
(plus any ``*/aux_loss`` state terms), gradients by autograd, the
optimizer update (in place, see optimizers.py), then the metrics.

Every training step takes a seed (a 0-d int64 tensor; ``train_steps``
takes one per step, staged into the captured step like any input, so
every replay draws new dropout masks: ops/base.py).  Under
``config.remat`` each weighted op that carries no state runs inside
``torch.utils.checkpoint`` (non-reentrant, without RNG state: its masks
come from the seed, so the recompute draws the first pass's), as the
reference wraps it in ``jax.checkpoint`` (lowering.py:266-279); its
activations are recomputed in the backward.  Under
``config.grad_accum_steps`` ga > 1 a step is the reference's
``_raw_step_accum`` (lowering.py:613-693): this rank's batch runs as
ga microbatches of consecutive rows, each one forward and backward
(the model state threaded through them), the gradients summed and
divided by ga, synced once, one optimizer update; the loss is the mean
of the microbatch losses and the metrics are sums.  A microbatch's
``row_base`` places its rows in the batch, so its masks are its rows
of the one-microbatch step's.

``train_steps`` runs N steps over ``[N, B, ...]`` stacks as ONE
captured CUDA graph (compiler/graphs.py): the reference's jitted
``lax.scan`` (lowering.py:697-731).  Step i reads slice i of the static
stacks; the losses and metrics come back stacked over N in static
buffers that the next call with the same N overwrites.  ``train_step``
is the N = 1 case.  The parameters, the optimizer state and the model
state are updated in place (a state value that a step returns as a new
tensor is copied into the old one), so the graph holds their
addresses.  A job of several ranks runs its steps eagerly: the
collectives' gloo host hops cannot be captured, and the reference also
runs one step per call when the job has several processes (NCCL
capture of multi-rank steps: ROADMAP, work on ported paths, item
5.3).  ``eval_step`` and ``forward_fn`` stay eager: no main path times
them.

Weights are seeded by NAME, as the reference's ``weight_fold_key``
does: each weight draws from its own ``torch.Generator`` seeded from
the model seed and crc32 of ``"op/weight"``, so initialisation does not
depend on the order the graph enumerates its nodes, and every rank
draws the same whole weight and keeps its block of it: any strategy
starts from the one-process weights.

Strategies (explicit SPMD, one process per rank).  As in the reference
(lowering.py:140-150), each node's view (the strategy's, else its
fixed view, else trivial) goes through the op's ``propagate`` and
``view_slot_axes``; ``parallel.mesh.placement`` turns the annotations
into layouts over the job's mesh.  ``_run_node`` (reference :237-282)
reshards each edge from its producer's output layout to the layout its
consumer's input annotation asks for (the port's counterpart of the
reference's ``_constrain``: GSPMD inserts these collectives there),
puts a ``grad_all_reduce`` on an input that is replicated over axes
along which the op's work differs (its weights' or outputs' split or
partial axes: the input's gradient is a partial sum there, Megatron's
f operator), and runs the op on the local shards (or its
``forward_sharded``).  Gradients are laid out as their values are.  One
process is the same path on a one-rank mesh: every layout is whole, and
every reshard, gradient sum and job reduction is the identity; only the
capture of its steps (``capture``) sets it apart.

The loss is a global mean: the sink's output is resharded to a layout
split at most on its batch and sequence dims (the label dims) and not
partial, each rank's loss is the mean over its block divided by the
number of blocks, and autograd's gradients are then each rank's share.
``_sync_grads`` sums each weight's gradient, in fp32, over the axes the
weight is replicated on along which the op's work differs (batch,
sequence, partial-output axes); where every rank computes the same, it
does not.  The reported loss is the sum of the ranks' shares over the
sink's split axes; the metrics (per-sample sums) are summed over its
batch axes and averaged over its sequence axes.

A ``CompiledModel`` may also be given a mesh (``mesh=``): a block of
the job's ranks, each segment of the placed and staged lowerings
(placement_lowering.py, staged_pipeline_lowering.py), or the pipelined
lowering's mesh with a leading ``pp`` axis, which the views never map
onto (pipeline_lowering.py subclasses this class).  ``holds``,
``gather_weights`` and ``local_weights`` say which weights a rank
keeps and carry whole weights in and out.

Gradient sync as the reference runs it (lowering.py:357-401,
405-593), on the flat lowering over the job's mesh:

* ``sync_precision`` (op name -> bf16/int8/int8_ef, built by
  search/sync_precision.py): those weight groups sum through the
  compressed collective (comm/quantized.py) instead of the fp32
  all-reduce; ``int8_ef`` groups carry an error-feedback residual, model
  state under ``"<op>/<w>/ef_residual"`` (each rank's own entry error,
  fp32, shaped as its block of the weight), advanced once per optimizer
  step and updated in place like any state value.
* ``sync_schedule`` (search/sync_schedule.py): the buckets sum in the
  schedule's order through comm/bucketed.py.  With one microbatch, a
  hook on each weight leaf hands its gradient to ``BucketedSync`` as
  the backward produces it, so fp32 buckets run under the rest of the
  backward; with ``grad_accum_steps`` > 1 the summed gradients go in
  after the last microbatch.  Staged reduction plans run on
  ``config.machine_spec``'s link levels.  With
  ``config.device_trace_dir`` set, each bucket stamps its lane's issue
  and done points for the capture (obs/annotate.py).
* ZeRO-1 (``config.zero_dp_shard`` for every weight, or the per-group
  ``zero_groups``): each member weight's block is split further over
  the mesh axes its layout does not use, placed by
  ``parallel.mesh.place_zero_factors`` as the reference's
  ``_zero_augmented`` places them (``slot_placement``).  The rank keeps
  the optimizer slots of its shard only (``slot_views``), its gradient
  is reduce-scattered to the shard (the fp32 path; a compressed or
  scheduled sum is summed whole, then cut), the optimizer updates the
  shard, and the updated weight is all-gathered back, so every replica
  holds the same bits.

The reference sums gradients inside GSPMD's backward and runs its
compressed sync on the summed gradient; the port's ranks hold shares
of the gradient, so its compressed collective IS the sum (comm/
quantized.py says more).

Model state under a strategy (reference lowering.py:330-350): an op
with ``state_shardings`` (the decode op's page pools) keeps its block
of each state value, placed by those annotations like a weight; the
rest is whole on every rank.  A pool whose pages cannot follow the
executor's slots (``pages_follow_slots``) keeps its page dim whole, and
``whole_page_pools`` gathers a split page dim whole for a decode step
whose executor allots pages from its free list (ops/decode_attention.py
says why); the placements are the lowering's and do not change.
"""

from __future__ import annotations

import copy
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from flexflow_tpu_torch.comm import compat
from flexflow_tpu_torch.comm.bucketed import BucketedSync
from flexflow_tpu_torch.comm.quantized import (
    MIN_COMPRESS_ELEMS,
    quantized_grad_sync,
)
from flexflow_tpu_torch.compiler.graphs import StepGraph
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.losses import (
    LossType,
    compute_loss,
    job_loss,
    loss_share,
)
from flexflow_tpu_torch.metrics import (
    MetricsType,
    compute_metrics,
    job_metrics,
)
from flexflow_tpu_torch.obs.annotate import lane_stamps_armed
from flexflow_tpu_torch.ops.base import LoweringContext, OpSharding
from flexflow_tpu_torch.ops.inout import InputOp
from flexflow_tpu_torch.optimizers import Optimizer
from flexflow_tpu_torch.parallel.mesh import (
    Placement,
    all_gather,
    all_reduce_sum,
    grad_all_reduce,
    place_zero_factors,
    placement,
    reshard,
    view_slot_axes,
)


def weight_generator(seed: int, op_name: str, w_name: str) -> torch.Generator:
    """The CPU generator one weight draws from: keyed by the model seed
    and crc32 of the weight's name."""
    crc = zlib.crc32(f"{op_name}/{w_name}".encode())
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | crc)


# losses that are means over positions: a rank's share of the global
# mean is its block's mean over the number of blocks
_MEAN_LOSSES = (LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                LossType.CATEGORICAL_CROSSENTROPY,
                LossType.MEAN_SQUARED_ERROR, LossType.IDENTITY)

def step_seeds(seeds, n: int, graph: Graph) -> torch.Tensor:
    """``n`` int64 step seeds as a tensor: ``seeds`` (a tensor, array or
    sequence), or zeros when None and no op of ``graph`` draws dropout
    masks (with dropout, the same seed every step would draw the same
    masks every step, so None raises)."""
    if seeds is None:
        drawing = [node.op.name for node in graph.nodes.values()
                   if node.op.draws_dropout()]
        if drawing:
            raise ValueError(
                f"{drawing[0]} draws dropout masks in training: give each "
                f"step its own seed (train_step(seed=...), "
                f"train_steps(seeds=...)) so each draws new masks")
        return torch.zeros(n, dtype=torch.int64)
    return torch.as_tensor(seeds, dtype=torch.int64).reshape(n)


def data_parallel_strategy(graph: Graph, degree: int
                           ) -> Dict[int, MachineView]:
    """Batch-dim partitioning for every op — the reference's
    ``data_parallel_strategy`` (lowering.py:58-80, its
    --only-data-parallel path): each op takes the largest divisor of
    ``degree`` that divides its batch, pinned ops their fixed view."""
    divisors = sorted(
        (d for d in range(1, degree + 1) if degree % d == 0), reverse=True)
    strategy: Dict[int, MachineView] = {}
    for node in graph.topo_order():
        fixed = node.op.fixed_machine_view()
        if fixed is not None:
            strategy[node.guid] = fixed
            continue
        out = node.op.output_shapes[0]
        batch = out.sizes[0] if out.ndim else 1
        d = 1
        if out.ndim and 0 in node.op.splittable_output_dims():
            d = next(dd for dd in divisors if batch % dd == 0)
        strategy[node.guid] = (MachineView.data_parallel(out.ndim, d)
                               if d > 1 else MachineView.trivial(out.ndim))
    return strategy


def strategy_views(strategy) -> Dict[int, MachineView]:
    """The views by guid of a strategy, without its ``__meta__`` block
    (``FFModel.compile`` adopts that: the lowering, the sync schedule,
    the ZeRO groups)."""
    if not strategy:
        return {}
    return {k: v for k, v in strategy.items() if k != "__meta__"}


class CompiledModel:
    """A graph bound to one device, or to this rank's shards under a
    strategy over the job's ranks, with the loss, metrics and optimizer
    a training compile chose (all optional for inference)."""

    def __init__(self, graph: Graph, config: FFConfig,
                 loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                 metric_types: Sequence = (),
                 optimizer: Optional[Optimizer] = None,
                 strategy: Optional[Dict[int, MachineView]] = None,
                 mesh=None, sync_precision: Optional[Dict[str, str]] = None,
                 sync_schedule=None, zero_groups: Sequence[str] = (),
                 block: bool = False):
        from flexflow_tpu_torch.runtime import distributed

        self.graph = graph
        self.config = config
        self.device = config.torch_device()
        self.compute_dtype = config.torch_compute_dtype
        world = distributed.world_size()
        if mesh is None and config.num_devices != world:
            raise ValueError(
                f"FFConfig.num_devices={config.num_devices} but the job has "
                f"{world} rank(s) (runtime.distributed.initialize)")
        # the gradient-sync plan (module docstring): the op -> wire
        # precision map, the bucketed schedule and the ZeRO-1 groups
        # (``zero_dp_shard`` arms every op); the other lowerings, which
        # pass their own mesh, sync in fp32 and keep whole slots
        self.sync_precision: Dict[str, str] = dict(sync_precision or {})
        self.sync_schedule = sync_schedule
        self.zero_groups: Tuple[str, ...] = tuple(zero_groups or ())
        views = strategy_views(strategy)
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
        self.step_graph = StepGraph(self.device)

        # a block of the job's ranks (the placed and staged lowerings'
        # segments) or the pipelined lowering's pp-leading mesh; the
        # views map onto every axis but ``pp`` (reference lowering.py
        # :144-155)
        self.mesh = distributed.mesh() if mesh is None else mesh
        pool = [(n, s) for n, s in self.mesh.axes if n != "pp"]
        self._shardings: Dict[int, OpSharding] = {}
        self._slot_axes: Dict[int, Dict[int, Tuple[str, ...]]] = {}
        self._views: Dict[int, MachineView] = {}
        for node in self._topo:
            mv = views.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim)
            self._views[node.guid] = mv
            self._shardings[node.guid] = node.op.propagate(mv)
            self._slot_axes[node.guid] = view_slot_axes(mv, pool)
        # one process captures its steps; several run them eagerly
        self.capture = world == 1 and mesh is None
        self._layouts()
        self._zero_pl: Dict[Tuple[str, str], Placement] = {}
        # ``block``: the flat lowering of a job shrunk onto a block of
        # its ranks (``FFModel.swap_strategy``), which keeps ZeRO-1
        if (mesh is None or block) and (config.zero_dp_shard
                                        or self.zero_groups):
            self._zero_layouts()
        self._ef_keys: Dict[str, Dict[str, str]] = {}

    # ---- layouts ---------------------------------------------------------
    def _layouts(self):
        """Each node's input, output and weight layouts, the axes to sum
        each input's gradient over (``_differ``) and each weight's
        (``_grad_axes``), and the loss's layout."""
        self._in_pl, self._out_pl, self._w_pl = {}, {}, {}
        self._differ, self._grad_axes = {}, {}
        for node in self._topo:
            osh, axes = self._shardings[node.guid], self._slot_axes[node.guid]
            ins = [None if a is None else placement(a, axes)
                   for a in osh.inputs]
            outs = [placement(a, axes) for a in osh.outputs]
            ws = {spec.name: placement(a, axes)
                  for spec, a in zip(node.op._weight_specs, osh.weights)}
            used = set()
            for pl in [p for p in ins if p is not None] + list(ws.values()):
                used.update(pl.split_axes())
            for pl in outs:
                used.update(pl.split_axes() + pl.partial)
            self._in_pl[node.guid], self._out_pl[node.guid] = ins, outs
            self._w_pl[node.op.name] = ws
            self._differ[node.guid] = [
                () if p is None else self._in_order(used - set(p.split_axes()))
                for p in ins]
            self._grad_axes[node.op.name] = {
                w: self._in_order(used - set(pl.split_axes()))
                for w, pl in ws.items()}
        self._state_pl: Dict[str, Placement] = {}
        for node in self._topo:
            op = node.op
            shard = getattr(op, "state_shardings", None)
            if shard is None:
                continue
            axes = self._slot_axes[node.guid]
            for name, annot in shard(self._views[node.guid]).items():
                pl = placement(annot, axes)
                if not op.pages_follow_slots():
                    pl = Placement(((),) + pl.dims[1:])
                self._state_pl[f"{op.name}/{name}"] = pl
        sink = self._out_pl[self._sink.guid][0]
        # split at most on the label dims: batch and, for [B, S, ...]
        # outputs, the sequence
        keep = 2 if len(sink.dims) >= 3 else 1
        self._loss_pl = Placement(tuple(
            axes if d < keep else () for d, axes in enumerate(sink.dims)))
        self._loss_blocks = self.mesh.size(self._loss_pl.split_axes())
        # a rank's share of the job's loss is its block's loss over this
        # many blocks: every block for the means over positions, the
        # batch blocks for the per-sample sums averaged over the batch,
        # none for the sum
        if self.loss_type in _MEAN_LOSSES:
            self._loss_div = self._loss_blocks
        elif self.loss_type is LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
            self._loss_div = self.mesh.size(self._loss_pl.dims[0])
        else:
            self._loss_div = 1

    def _in_order(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.names if a in axes)

    def weight_placement(self, op_name: str, w_name: str) -> Placement:
        return self._w_pl[op_name][w_name]

    # ---- ZeRO-1 ----------------------------------------------------------
    def _zero_layouts(self):
        """Each member weight's ZeRO-1 placement (the reference's
        ``_zero_augmented``): its layout with the mesh axes it does not
        use appended, by ``place_zero_factors``, to the dims of its
        block they divide (largest first); a weight no axis divides
        keeps whole slots."""
        every = self.config.zero_dp_shard
        members = set(self.zero_groups)
        for node in self._topo:
            op = node.op
            if not every and op.name not in members:
                continue
            for ws in op._weight_specs:
                pl = self._w_pl[op.name][ws.name]
                used = set(pl.split_axes())
                free = [(n, size) for n, size in self.mesh.axes
                        if n not in used and size > 1 and n != "pp"]
                if not free:
                    continue
                dims = [list(a) for a in pl.dims]
                for d, fi in place_zero_factors(
                        list(pl.local_sizes(ws.shape, self.mesh)),
                        [size for _, size in free]):
                    dims[d].append(free[fi][0])
                zpl = Placement(tuple(tuple(a) for a in dims))
                if zpl != pl:
                    self._zero_pl[(op.name, ws.name)] = zpl

    def slot_placement(self, op_name: str, w_name: str) -> Placement:
        """How a weight's optimizer slots lie over the mesh."""
        return (self._zero_pl.get((op_name, w_name))
                or self._w_pl[op_name][w_name])

    def _zero_extra(self, key):
        """(dim, the axes ZeRO adds to it) of a member weight."""
        pl, zpl = self._w_pl[key[0]][key[1]], self._zero_pl[key]
        return [(d, b[len(a):]) for d, (a, b) in enumerate(zip(pl.dims,
                                                            zpl.dims))
                if len(b) > len(a)]

    def _zero_slices(self, key, shape) -> Tuple[slice, ...]:
        """This rank's shard of a member weight's block of ``shape``."""
        out = [slice(None)] * len(shape)
        for d, extra in self._zero_extra(key):
            n, i = self.mesh.size(extra), self.mesh.index(extra)
            per = shape[d] // n
            out[d] = slice(i * per, (i + 1) * per)
        return tuple(out)

    def _zero_gather(self, x, key):
        """A member weight's block from the shards (a collective over
        the ZeRO axes)."""
        for d, extra in self._zero_extra(key):
            x = all_gather(x, d, extra, self.mesh)
        return x

    def _zero_reduce(self, g, key, axes):
        """The sum of a member weight's gradient over ``axes``, cut to
        this rank's shard: a reduce-scatter along each dim over the ZeRO
        axes it sums over (a plain cut over the others), then an
        all-reduce over the summed axes ZeRO does not use."""
        done = set()
        for d, extra in self._zero_extra(key):
            run: List[str] = []
            for i, a in enumerate(extra):
                run.append(a)
                last = i + 1 == len(extra)
                if last or (extra[i + 1] in axes) != (a in axes):
                    g = self._zero_cut(g, d, tuple(run), a in axes)
                    run = []
            done.update(a for a in extra if a in axes)
        rest = tuple(a for a in axes if a not in done)
        return all_reduce_sum(g, rest, self.mesh) if rest else g

    def _zero_cut(self, g, d, axes, summed):
        n = self.mesh.size(axes)
        if not summed:
            per = g.shape[d] // n
            return g.narrow(d, self.mesh.index(axes) * per, per)
        rows = g.movedim(d, 0).contiguous()
        out = compat.reduce_scatter(rows, axes, self.mesh)
        return out.reshape((rows.shape[0] // n,) + tuple(rows.shape[1:])
                           ).movedim(0, d)

    def slot_views(self, params):
        """``params`` with each ZeRO-1 member weight cut to this rank's
        shard (views): what ``Optimizer.init_state`` sizes the slots
        by."""
        return {op: {w: (t[self._zero_slices((op, w), t.shape)]
                         if (op, w) in self._zero_pl else t)
                     for w, t in ws.items()}
                for op, ws in params.items()}

    def gather_slots(self, tree):
        """The whole optimizer slots of ``tree`` (op -> weight ->
        tensor, laid out as ``slot_placement``) on every rank: a
        collective."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, ws in tree.items():
            for w, v in ws.items():
                if (op, w) in self._zero_pl:
                    v = self._zero_gather(v, (op, w))
                out.setdefault(op, {})[w] = reshard(
                    v, self.weight_placement(op, w),
                    Placement.replicated(v.dim()), self.mesh)
        return out

    def slot_slices(self, op: str, w: str, shape):
        """Picks this rank's slot block from a whole slot value."""
        blk = self.weight_placement(op, w).local_slices(shape, self.mesh)
        if (op, w) not in self._zero_pl:
            return blk
        local = self.weight_placement(op, w).local_sizes(shape, self.mesh)
        inner = self._zero_slices((op, w), local)
        return lambda v: v[blk][inner]

    def input_slices(self, i: int, shape: Sequence[int]
                     ) -> Tuple[slice, ...]:
        """This rank's block of frontend input ``i`` of global
        ``shape`` (the reference's ``input_sharding``)."""
        pl = self._out_pl[self._input_nodes[i].guid][0]
        return pl.local_slices(shape, self.mesh)

    def label_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of labels of global ``shape``: the loss
        layout's on the label dims it shares with the output (the
        reference's ``batch_sharding``)."""
        dims = self._loss_pl.dims
        pl = Placement(tuple(dims[d] if d < len(dims) else ()
                             for d in range(len(shape))))
        return pl.local_slices(shape, self.mesh)

    # ---- initialisation --------------------------------------------------
    def init_params(self, seed: int = 0):
        """Fresh ``params[op_name][weight_name]`` and
        ``state["<op>/<var>"]`` tensors on the model's device (under a
        strategy: this rank's blocks of the weights)."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, torch.Tensor] = {}
        for node in self._topo:
            op = node.op
            if not self.holds(op.name):
                continue
            for ws in op._weight_specs:
                w = ws.initializer.init(
                    weight_generator(seed, op.name, ws.name), ws.shape)
                pl = self._w_pl[op.name][ws.name]
                w = w[pl.local_slices(ws.shape, self.mesh)].contiguous()
                params.setdefault(op.name, {})[ws.name] = w.to(
                    device=self.device, dtype=ws.dtype.to_torch())
            specs = getattr(op, "state_specs", None)
            if specs is None:
                continue
            for name, shape, dtype, fill in specs():
                key = f"{op.name}/{name}"
                pl = self._state_pl.get(key)
                if pl is not None:
                    shape = pl.local_sizes(shape, self.mesh)
                state[key] = torch.full(shape, fill, dtype=dtype,
                                        device=self.device)
        # error-feedback residuals of the int8_ef groups (reference
        # lowering.py:373-401): fp32, each rank's block, zero at first
        self._ef_keys = {}
        for op, prec in self.sync_precision.items():
            if prec != "int8_ef" or op not in params:
                continue
            for w, t in params[op].items():
                if (t.numel() < MIN_COMPRESS_ELEMS
                        or not self._grad_axes[op][w]):
                    continue
                key = f"{op}/{w}/ef_residual"
                self._ef_keys.setdefault(op, {})[w] = key
                state[key] = torch.zeros(t.shape, dtype=torch.float32,
                                         device=self.device)
        return params, state

    def page_blocks(self) -> Optional[Tuple[int, int]]:
        """(pages, slots) per block of a page pool split over the batch
        axes (each block one batch coordinate's: its slots' pages), or
        None when no pool's page dim is split."""
        for node in self._topo:
            op = node.op
            if not hasattr(op, "pages_follow_slots"):
                continue
            pl = self._state_pl.get(f"{op.name}/k_cache")
            if pl is not None and pl.dims and pl.dims[0]:
                n = self.mesh.size(pl.dims[0])
                return op.attrs["num_pages"] // n, op.max_seqs // n
        return None

    def whole_page_pools(self, state) -> Dict[str, torch.Tensor]:
        """``state`` (laid out by ``init_params``) with every page pool
        whose page dim is split over the batch axes gathered whole on
        every rank of them (a collective), for a decode step whose
        executor allots pages from its free list (runtime/decode.py's
        ``compiled_decode_step(slot_aligned=False)``, which keeps the
        layout it chose; the placements here stay the lowering's)."""
        out = dict(state)
        for key, pl in self._state_pl.items():
            if not pl.dims or not pl.dims[0] or key not in state:
                continue
            out[key] = reshard(state[key], pl,
                               Placement(((),) + pl.dims[1:]), self.mesh)
        return out

    # ---- whole weights ---------------------------------------------------
    def holds(self, op_name: str) -> bool:
        """Whether this rank keeps ``op_name``'s weights (every op here;
        a stage or segment of the other lowerings keeps its own)."""
        return True

    def weight_names(self):
        """Every (op, weight) of the graph, in topological order."""
        return [(n.op.name, ws.name) for n in self._topo
                for ws in n.op._weight_specs]

    def gather_weights(self, params, names=None):
        """The whole weights of ``names`` (default: every weight) on
        every rank, from the blocks the ranks hold: a collective, every
        rank calls it with the same names."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, w in (self.weight_names() if names is None else names):
            v = params[op][w]
            out.setdefault(op, {})[w] = reshard(
                v, self.weight_placement(op, w),
                Placement.replicated(v.dim()), self.mesh)
        return out

    def local_weights(self, whole, device):
        """This rank's blocks of the whole weights ``whole`` (numpy
        arrays by op and weight), of the ops it holds."""
        from flexflow_tpu_torch.interop import tensor_from_numpy

        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, ws in whole.items():
            if not self.holds(op):
                continue
            for w, v in ws.items():
                v = v[self.weight_placement(op, w).local_slices(
                    v.shape, self.mesh)]
                out.setdefault(op, {})[w] = tensor_from_numpy(v, device)
        return out

    # ---- forward ---------------------------------------------------------
    def apply(self, params, state, inputs: Sequence[torch.Tensor],
              train: bool = False, seed: Optional[torch.Tensor] = None,
              row_base: int = 0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward through the graph; returns (sink output, new state).
        ``inputs`` bind in frontend tensor-guid order (under a strategy:
        this rank's blocks, ``input_slices``; the sink's output is then
        this rank's block, laid out as the sink's annotation says).
        Autograd records the pass only when ``train`` is set; ``seed``
        and ``row_base`` key its dropout masks (``LoweringContext``)."""
        values, places, new_state = self.forward_values(
            params, state, inputs, train, seed, row_base)
        self._sink_pl = places[(self._sink.guid, 0)]
        return values[(self._sink.guid, 0)], new_state

    def forward_values(self, params, state, inputs, train=False, seed=None,
                       row_base: int = 0):
        """The forward pass: (every value by (guid, output index), its
        layout, the new state)."""
        if len(inputs) != len(self._input_nodes):
            raise ValueError(f"expected {len(self._input_nodes)} inputs, "
                             f"got {len(inputs)}")
        ctx = LoweringContext(compute_dtype=self.compute_dtype, train=train,
                              state_in=state, device=self.device,
                              mesh=self.mesh, seed=seed, row_base=row_base,
                              seq_length=self.config.iteration.seq_length)
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        places: Dict[Tuple[int, int], Placement] = {}
        resharded: Dict[tuple, torch.Tensor] = {}
        for node, x in zip(self._input_nodes, inputs):
            values[(node.guid, 0)] = x
            places[(node.guid, 0)] = self._out_pl[node.guid][0]
        with torch.set_grad_enabled(train):
            for node in self._topo:
                if isinstance(node.op, InputOp):
                    continue
                self._visit(node, ctx, params, values, places, resharded)
        new_state = dict(state)
        new_state.update(ctx.state_out)
        return values, places, new_state

    def _visit(self, node, ctx, params, values, places, resharded):
        """Run ``node`` into ``values`` (the pipelined lowering runs its
        block stack here instead)."""
        edges = sorted(self.graph.in_edges[node.guid],
                       key=lambda e: e.dst_idx)
        outs = self._run_node(node, ctx, edges,
                              params.get(node.op.name, {}), values,
                              places, resharded)
        for i, y in enumerate(outs):
            values[(node.guid, i)] = y

    def _run_node(self, node, ctx, edges, ws, values, places, resharded):
        """One node on this rank's shards: each edge resharded from its
        producer's layout to the input's (once per layout, whatever the
        consumers), the f operator on inputs whose gradient is partial,
        then the op."""
        guid = node.guid
        ins, in_pls = [], []
        for e in edges:
            src = (e.src, e.src_idx)
            want = self._in_pl[guid][e.dst_idx]
            if want is None:  # unconstrained: the producer's layout
                ins.append(values[src])
                in_pls.append(places[src])
                continue
            key = src + (want,)
            if key not in resharded:
                resharded[key] = reshard(values[src], places[src], want,
                                         self.mesh)
            x = resharded[key]
            differ = self._differ[guid][e.dst_idx]
            if differ and x.requires_grad:
                key = key + (differ,)
                if key not in resharded:
                    resharded[key] = grad_all_reduce(x, differ, self.mesh)
                x = resharded[key]
            ins.append(x)
            in_pls.append(want)
        osh = self._shardings[guid]
        ctx.slot_axes = self._slot_axes[guid]
        ctx.in_placements = in_pls
        ctx.out_placements = list(self._out_pl[guid])
        outs = node.op.forward_sharded(ctx, ins, ws, osh)
        if outs is None:
            if (self.config.remat and torch.is_grad_enabled()
                    and node.op._weight_specs
                    and getattr(node.op, "state_specs", None) is None):
                outs = self._remat(node.op, ctx, ins, ws)
            else:
                outs = node.op.forward(ctx, ins, ws)
        for i in range(len(outs)):
            places[(guid, i)] = ctx.out_placements[i]
        return outs

    @staticmethod
    def _remat(op, ctx, ins, ws):
        """``op.forward`` under ``torch.utils.checkpoint``: its saved
        activations are dropped and recomputed in the backward.  Each
        run takes a fresh copy of the node's context as it is now, so
        the recompute sees this node's layouts and seed, not those of
        the node the forward pass has moved on to."""
        from torch.utils.checkpoint import checkpoint

        base = copy.copy(ctx)
        in_pl, out_pl = list(ctx.in_placements), list(ctx.out_placements)
        names = list(ws)
        n_in = len(ins)
        got = {}

        def run(*flat):
            c = copy.copy(base)
            c.in_placements, c.out_placements = list(in_pl), list(out_pl)
            outs = op.forward(c, list(flat[:n_in]),
                              dict(zip(names, flat[n_in:])))
            got["placements"] = c.out_placements
            return tuple(outs)

        outs = checkpoint(run, *ins, *(ws[n] for n in names),
                          use_reentrant=False, preserve_rng_state=False)
        ctx.out_placements = got["placements"]
        return list(outs)

    # ---- training --------------------------------------------------------
    def _loss_from(self, logits, labels, new_state):
        """This rank's loss (its share of the global mean under a
        strategy) and the logits it was taken on."""
        logits = reshard(logits, self._sink_pl, self._loss_pl, self.mesh)
        loss = compute_loss(self.loss_type, logits, labels)
        for k, v in new_state.items():
            if k.endswith("/aux_loss"):
                loss = loss + v
        return loss_share(loss, self._loss_div), logits

    def _job_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return job_loss(loss, self._loss_pl.split_axes(), self.mesh)

    def _job_metrics(self, m: Dict[str, torch.Tensor]):
        dims = self._loss_pl.dims
        return job_metrics(m, dims[0], tuple(a for axes in dims[1:]
                                             for a in axes), self.mesh)

    def _residuals(self, state):
        """The error-feedback residuals in ``state``, by op and
        weight."""
        if not state or not self._ef_keys:
            return None
        return {op: {w: state[k] for w, k in ws.items() if k in state}
                for op, ws in self._ef_keys.items()}

    def ef_residual_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Each error-feedback residual's state key and the axes its
        weight's gradient sums over: the ranks' residuals add up to the
        error the summed gradient lost, which is what a checkpoint keeps
        (runtime/checkpoint.py)."""
        return {k: self._grad_axes[op][w]
                for op, ws in self._ef_keys.items() for w, k in ws.items()}

    def _bucketed(self, state) -> Optional[BucketedSync]:
        """A fresh executor of the sync schedule for one step, or None
        when the step syncs monolithically."""
        if (self.sync_schedule is None
                or not getattr(self.sync_schedule, "buckets", None)
                or self.mesh.world == 1):
            return None
        return BucketedSync(self.sync_schedule, self._grad_axes, self.mesh,
                            machine=self.config.machine_spec,
                            residuals=self._residuals(state),
                            lane_stamps=lane_stamps_armed(self.config))

    def _synced(self, grads, state=None, bucketed=None, shard=True):
        """The job's gradients from this rank's shares ``grads`` (a new
        tree) and the new error-feedback residuals by state key: the
        schedule's buckets (``bucketed``), else the compressed groups
        of ``sync_precision`` one by one and every other weight in one
        fp32 all-reduce per set of axes.  With ``shard``, a ZeRO-1
        member's gradient comes back as this rank's shard (its fp32 sum
        reduce-scattered)."""
        residuals = self._residuals(state)
        if bucketed is None:
            bucketed = self._bucketed(state)
        scattered = set()  # ZeRO members already cut to their shard
        if bucketed is not None:
            out = bucketed.finish(grads)
            new_res = bucketed.new_residuals
        else:
            out, new_res, whole = quantized_grad_sync(
                grads, self.mesh, self._grad_axes, self.sync_precision,
                residuals=residuals)
            by_axes: Dict[Tuple[str, ...], List[Tuple[str, str]]] = {}
            for op, gs in out.items():
                for w, g in gs.items():
                    axes = self._grad_axes[op][w]
                    if not axes or (op, w) in whole:
                        continue
                    if shard and (op, w) in self._zero_pl:
                        gs[w] = self._zero_reduce(g, (op, w), axes)
                        scattered.add((op, w))
                        continue
                    by_axes.setdefault(axes, []).append((op, w))
            for axes, ms in by_axes.items():
                flat = all_reduce_sum(
                    torch.cat([out[op][w].reshape(-1).float()
                               for op, w in ms]), axes, self.mesh)
                parts = flat.split([out[op][w].numel() for op, w in ms])
                for (op, w), part in zip(ms, parts):
                    g = out[op][w]
                    out[op][w] = part.view(g.shape).to(g.dtype)
        if shard:
            for key in self._zero_pl:
                op, w = key
                if key not in scattered and op in out:
                    g = out[op][w]
                    out[op][w] = g[self._zero_slices(key, g.shape)]
        updates = {self._ef_keys[op][w]: r for op, ws in new_res.items()
                   for w, r in ws.items()
                   if w in self._ef_keys.get(op, {})}
        return out, updates

    def _sync_grads(self, grads) -> None:
        """Sum each weight's gradient over its ``_grad_axes``, in place
        (the whole gradient, ZeRO members too; the placed lowering's
        segments call this)."""
        out, _ = self._synced(grads, shard=False)
        for op, gs in grads.items():
            for w, g in gs.items():
                if out[op][w] is not g:
                    g.copy_(out[op][w])

    def _update(self, params, grads, opt_state) -> None:
        """The optimizer step: ZeRO-1 members update this rank's shard
        (``grads`` holds their shards) and are all-gathered back."""
        if not self._zero_pl:
            self.optimizer.apply(params, grads, opt_state)
            return
        shards = {op: {w: (t[self._zero_slices((op, w), t.shape)].clone()
                           if (op, w) in self._zero_pl else t)
                       for w, t in ws.items()}
                  for op, ws in params.items()}
        self.optimizer.apply(shards, grads, opt_state)
        with torch.no_grad():
            for key in self._zero_pl:
                op, w = key
                if op in params:
                    params[op][w].copy_(self._zero_gather(shards[op][w],
                                                          key))

    def loss_and_grads(self, params, state, inputs, labels, seed=None,
                       row_base: int = 0, sync: bool = True,
                       bucketed: Optional[BucketedSync] = None):
        """One training forward and backward without an update: (loss,
        logits, new state, grads keyed like params).  A weight the
        forward does not reach gets a zero gradient.  Under a strategy
        the loss is the job's, the gradients are this rank's blocks of
        the job's (unsynced without ``sync``), and the logits are this
        rank's block.  The gradients
        are taken with respect to fresh leaves that share the weights'
        storage, so no autograd node outlives the call: a node kept from
        an earlier call would carry that call's stream into a capture.
        ``bucketed`` (a ``BucketedSync``) gets each synced weight's
        gradient from a hook on its leaf as the backward produces it."""
        leaves = [(op, w, t.detach().requires_grad_(True))
                  for op, ws in params.items() for w, t in ws.items()]
        live: Dict[str, Dict[str, torch.Tensor]] = {}
        synced = set(bucketed.members()) if bucketed is not None else ()
        for op, w, t in leaves:
            live.setdefault(op, {})[w] = t
            if (op, w) in synced:
                t.register_hook(
                    lambda g, op=op, w=w: bucketed.arrive(op, w, g))
        logits, new_state = self.apply(live, state, inputs, train=True,
                                       seed=seed, row_base=row_base)
        loss, logits = self._loss_from(logits, labels, new_state)
        gs = torch.autograd.grad(loss, [t for _, _, t in leaves],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (op, w, t), g in zip(leaves, gs):
            grads.setdefault(op, {})[w] = (torch.zeros_like(t) if g is None
                                           else g)
        if sync:
            grads, _ = self._synced(grads, bucketed=bucketed, shard=False)
        return (self._job_loss(loss.detach()), logits.detach(), new_state,
                grads)

    def _step(self, params, opt_state, state, inputs, labels, seed):
        """One optimizer step (``ga`` microbatches under
        ``grad_accum_steps``): (the job's loss, its metric sums)."""
        ga = self.config.grad_accum_steps
        rows = labels.shape[0]
        if rows % ga:
            raise ValueError(f"this rank's batch of {rows} must divide by "
                             f"grad_accum_steps {ga}")
        per = rows // ga
        gsum, losses, local = None, [], None
        cur = state
        # the schedule's buckets go out during the backward of a single
        # microbatch; accumulated gradients go in after the last
        bucketed = self._bucketed(state)
        for j in range(ga):
            sl = slice(j * per, (j + 1) * per)
            lab = labels[sl] if ga > 1 else labels
            loss, logits, cur, grads = self.loss_and_grads(
                params, cur, [x[sl] if ga > 1 else x for x in inputs], lab,
                seed=seed, row_base=j * per, sync=False,
                bucketed=bucketed if ga == 1 else None)
            m = compute_metrics(self.metric_types, self.loss_type, logits,
                                lab)
            losses.append(loss)
            if gsum is None:
                gsum, local = grads, m
                continue
            for op, gs in grads.items():
                for w, g in gs.items():
                    gsum[op][w].add_(g)
            local = {k: local[k] + v for k, v in m.items()}
        if ga > 1:
            for gs in gsum.values():
                for g in gs.values():
                    g.div_(ga)
        synced, ef = self._synced(gsum, state, bucketed)
        self._update(params, synced, opt_state)
        with torch.no_grad():
            for k, v in cur.items():
                if v is not state[k]:
                    state[k].copy_(v)
            for k, v in ef.items():
                state[k].copy_(v)
        loss = losses[0] if ga == 1 else torch.stack(losses).mean()
        return loss, self._job_metrics(local)

    def _steps(self, params, opt_state, state, inputs_stacked,
               labels_stacked, seeds):
        """``labels_stacked.shape[0]`` optimizer steps in order, step i
        on slice i of the stacks with seed ``seeds[i]``; returns (losses
        [N], metrics stacked over N)."""
        losses, ms = [], []
        for i in range(labels_stacked.shape[0]):
            loss, m = self._step(params, opt_state, state,
                                 [x[i] for x in inputs_stacked],
                                 labels_stacked[i], seeds[i])
            losses.append(loss)
            ms.append(m)
        return (torch.stack(losses),
                {k: torch.stack([m[k] for m in ms]) for k in ms[0]})

    def train_steps(self, params, opt_state, state, inputs_stacked,
                    labels_stacked, seeds=None):
        """N optimizer steps in one call (reference ``train_steps``):
        ``inputs_stacked`` a list of [N, B, ...] tensors or arrays,
        ``labels_stacked`` [N, B, ...], ``seeds`` N int64 step seeds
        (``step_seeds``: needed when the graph draws dropout masks).
        Returns (params, opt_state, state, losses [N], metrics stacked
        over N); the first three are the same objects,
        updated in place, and the last two are the compiled step's
        static buffers (see the module docstring).  Nothing here waits
        for the device."""
        if self.optimizer is None:
            raise RuntimeError("train_step needs a model compiled with "
                               "comp_mode='training'")
        arrays = [*inputs_stacked, labels_stacked,
                  step_seeds(seeds, labels_stacked.shape[0], self.graph)]

        def steps(*xs):
            return self._steps(params, opt_state, state, xs[:-2], xs[-2],
                               xs[-1])

        if not self.capture:
            arrays[-1] = arrays[-1].to(self.device)
            losses, m = steps(*arrays)
        else:
            losses, m = self.step_graph(
                steps, arrays,
                bound=[t for t in pytree.tree_leaves((params, opt_state,
                                                      state))
                       if isinstance(t, torch.Tensor)])
        return params, opt_state, state, losses, m

    def train_step(self, params, opt_state, state, inputs, labels,
                   seed: Optional[int] = None):
        """One optimizer step, ``train_steps`` with N = 1: returns
        (params, opt_state, state, loss, metrics); the loss and metrics
        are views of the static buffers the next step overwrites."""
        params, opt_state, state, losses, m = self.train_steps(
            params, opt_state, state, [x[None] for x in inputs],
            labels[None], None if seed is None else [seed])
        return (params, opt_state, state, losses[0],
                {k: v[0] for k, v in m.items()})

    @torch.no_grad()
    def eval_step(self, params, state, inputs, labels):
        """(loss, metrics) of one batch, no gradients: the job's."""
        logits, new_state = self.apply(params, state, inputs)
        loss, logits = self._loss_from(logits, labels, new_state)
        m = compute_metrics(self.metric_types, self.loss_type, logits, labels)
        return self._job_loss(loss), self._job_metrics(m)

    def gather_output(self, y: torch.Tensor) -> torch.Tensor:
        """The whole sink output on every rank from this rank's block
        (the last ``apply``'s layout)."""
        return reshard(y, self._sink_pl, Placement.replicated(y.dim()),
                       self.mesh)

    def forward_fn(self):
        """(params, state, inputs) -> logits, no gradients: the whole
        output on every rank."""
        def fwd(params, state, inputs):
            return self.gather_output(self.apply(params, state, inputs)[0])

        return fwd
