"""Executed inter-op (VERTICAL) placement over disjoint rank blocks —
the port of flexflow_tpu/compiler/placement_lowering.py.

A strategy whose views carry two distinct ``start_part`` blocks splits
the PCG into segment A (the block at 0) and segment B (the other).
Each segment lowers as an ordinary ``CompiledModel`` (PR 9's explicit
SPMD) over a sub-mesh of the ranks: A over ``[0, n_a)``, B over
``[start_b, start_b + n_b)`` (``runtime.distributed.mesh_over``, built
on every rank in one order).  Views keep their degrees; ``start_part``
is stripped (``_strip_start``), the sub-mesh places them.

A training step (``SegmentedModel``, shared with the staged pipeline):

    boundary    = forward_A(params_A, x_A)         on A's ranks
    loss, db    = forward and backward of B         on B's ranks
    grads_A     = backward of A with db             on A's ranks

The boundary tensors go from A's ranks to B's, and their cotangents
back, as point-to-point sends between the blocks (``parallel.mesh
.Sends``).  Each enters B as a synthetic input (``placement_boundary_i``)
laid out batch-split over B's ranks when its batch divides, else
whole.  Where the two blocks have the same axes, A lays each boundary
out as B wants it and rank i of A sends its block to rank i of B;
otherwise every A rank gathers the boundary whole and B's rank j takes
its block from A's rank j mod n_a, and the cotangents come back the
same way and are summed over A's ranks.  The reference re-runs A's
forward under ``jax.vjp`` for the backward; the port keeps A's autograd
graph from the forward to the backward (the same function).

The reference's ``placeable`` returns False under
``jax.process_count() > 1``: its host-composed step cannot place
arrays across processes.  The reference runs one process over n
devices, which the port runs as n ranks (PR 9), so "several
processes" there means several hosts here, and ``placeable`` returns
False only for a job that spans hosts (``_multi_host``).

Unsupported (loud): more than 2 blocks, more than 16 crossing tensors,
gradient accumulation, zero_dp_shard, ``train_steps`` of several steps
in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.compiler.lowering import CompiledModel
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.losses import LossType
from flexflow_tpu_torch.metrics import (
    MetricsType,
    compute_metrics,
    metric_keys,
)
from flexflow_tpu_torch.ops.inout import InputOp
from flexflow_tpu_torch.parallel.mesh import (
    Placement,
    Sends,
    all_reduce_sum,
    broadcast,
    recv,
    reshard,
)


def placement_blocks(strategy: Dict[int, MachineView]) -> List[int]:
    """Sorted distinct start_part values in ``strategy``."""
    return sorted({v.start_part for k, v in strategy.items()
                   if k != "__meta__" and v is not None})


def _cut(graph: Graph, strategy: Dict[int, MachineView]):
    """(nodes_a, nodes_b, crossing_edges, back_edges) for a 2-block
    strategy — the structural cut both placeable() and the constructor
    share."""
    in_a, in_b = [], []
    for guid, node in graph.nodes.items():
        mv = strategy.get(guid)
        block = (mv.start_part if mv is not None else 0)
        (in_a if block == 0 else in_b).append(node)
    a_guids = {n.guid for n in in_a}
    b_guids = {n.guid for n in in_b}
    crossing = [
        e for guid in a_guids for e in graph.out_edges[guid]
        if e.dst in b_guids
    ]
    back = [
        e for guid in b_guids for e in graph.out_edges[guid]
        if e.dst in a_guids
    ]
    return in_a, in_b, crossing, back


# the SAME structural cut the constructor and placeable() compute —
# shared with the placement legality lint (analysis/placement.py,
# SHD153-155) so "what the lint checks" and "what the executor runs"
# cannot drift apart
placement_cut = _cut


def placement_block_widths(in_a, in_b, strategy) -> Tuple[int, int]:
    """(block A width, block B width) — the sub-mesh size each segment
    compiles over (max view parts per side).  ONE rule shared by the
    constructor, the legality lint and the persisted ``__meta__``
    frame."""
    n_a = max((strategy[n.guid].num_parts for n in in_a
               if strategy.get(n.guid) is not None), default=1)
    n_b = max((strategy[n.guid].num_parts for n in in_b
               if strategy.get(n.guid) is not None), default=1)
    return n_a, n_b


MAX_CROSSING_TENSORS = 16


def _multi_host() -> bool:
    """Whether the job spans hosts: the port's counterpart of the
    reference's ``jax.process_count() > 1`` (module docstring)."""
    from flexflow_tpu_torch.runtime import distributed

    return distributed.num_hosts() > 1


def placeable(graph: Graph, strategy: Dict[int, MachineView], config) -> bool:
    """Can this strategy go down the placed lowering?  False keeps the
    flat lowering for multi-block strategies outside its support (>2
    blocks, grad accumulation, ZeRO, a job over several hosts)."""
    if getattr(config, "grad_accum_steps", 1) > 1:
        return False
    if getattr(config, "zero_dp_shard", False):
        return False
    if _multi_host():
        return False
    blocks = placement_blocks(strategy)
    if len(blocks) != 2:
        return False  # 1 block = flat; >2 blocks = unsupported, inert
    in_a, in_b, crossing, back = _cut(graph, strategy)
    if back or not in_a or not in_b:
        return False
    sinks = graph.sinks()
    if not sinks or sinks[-1].guid not in {n.guid for n in in_b}:
        # the loss is computed from B's sink; a cut whose second block
        # does not own the graph sink has no loss program
        return False
    return 0 < len({(e.src, e.src_idx) for e in crossing}) <= MAX_CROSSING_TENSORS


def _strip_start(mv: MachineView) -> MachineView:
    if mv.start_part == 0:
        return mv
    return MachineView(
        dim_degrees=mv.dim_degrees,
        replica_degree=mv.replica_degree,
        start_part=0,
    )


@dataclasses.dataclass
class _Segment:
    """One stage or segment: its graph's ``CompiledModel`` over the
    ranks ``[start, start + width)``, the boundary tensors it takes (its
    first inputs, in order) and the ones it produces."""

    comp: CompiledModel
    start: int
    width: int
    in_keys: List[Tuple[int, int]]
    out_keys: List[Tuple[int, int]]


class SegmentedModel:
    """Segments on disjoint blocks of ranks, run in order on M
    microbatches (the placed lowering: 2 segments, M = 1; the staged
    pipeline: S stages).  Every rank runs its own segment; the last
    segment owns the graph's sink and the loss.  Forward: for each
    microbatch, each segment receives its boundary inputs, runs, and
    sends its boundary outputs to every segment that reads them.
    Backward: the reverse, cotangents summed over a boundary's readers.
    Each segment's ranks then sync their gradients and update their
    weights.  The loss and metrics (the mean and the sums over the
    microbatches) go from the last segment to every rank."""

    def _setup(self, graph: Graph, segments: List[_Segment],
               producer: Dict[Tuple[int, int], int], config, loss_type,
               metric_types, optimizer, num_microbatches: int):
        from flexflow_tpu_torch.runtime import distributed

        self.graph = graph
        self.config = config
        self.device = config.torch_device()
        self.optimizer = optimizer
        self.loss_type = LossType.from_any(loss_type)
        self.metric_types = [MetricsType.from_any(m) for m in metric_types]
        self._metric_keys = metric_keys(self.metric_types)
        self.segments = segments
        self.num_microbatches = num_microbatches
        self._producer = producer  # boundary key -> producing segment
        self._readers = {k: [i for i, sg in enumerate(segments)
                             if k in sg.in_keys] for k in producer}
        self.rank = distributed.rank()
        self.mine = next((i for i, sg in enumerate(segments)
                          if sg.start <= self.rank < sg.start + sg.width),
                         None)
        self.mesh = distributed.mesh()
        self._op_segment = {}
        for i, sg in enumerate(segments):
            for node in sg.comp._topo:
                if not isinstance(node.op, InputOp) or node.guid in graph.nodes:
                    self._op_segment[node.op.name] = i
        # frontend input i -> (segment, its input position)
        self._input_map: List[Tuple[int, int]] = []
        inputs = sorted(
            (n for n in graph.topo_order() if isinstance(n.op, InputOp)),
            key=lambda n: n.op.attrs.get("tensor_guid", n.guid))
        for n in inputs:
            si = next(i for i, sg in enumerate(segments)
                      if any(m.guid == n.guid for m in sg.comp._input_nodes))
            local = [m.guid for m in segments[si].comp._input_nodes].index(
                n.guid)
            self._input_map.append((si, local))

    # ---- where things live ------------------------------------------------
    def holds(self, op_name: str) -> bool:
        return self._op_segment.get(op_name) == self.mine

    def weight_names(self):
        return [(n.op.name, ws.name) for n in self.graph.topo_order()
                for ws in n.op._weight_specs]

    def weight_placement(self, op_name, w_name):
        return self.segments[self._op_segment[op_name]].comp.weight_placement(
            op_name, w_name)

    def input_slices(self, i: int, shape: Sequence[int]):
        si, local = self._input_map[i]
        if si != self.mine:  # another segment's input: no rows here
            return (slice(0, 0),) + tuple(slice(None) for _ in shape[1:])
        return self._by_microbatch(
            self.segments[si].comp.input_slices(local, shape), shape[0])

    def label_slices(self, shape: Sequence[int]):
        if self.mine != len(self.segments) - 1:
            return (slice(0, 0),) + tuple(slice(None) for _ in shape[1:])
        return self._by_microbatch(
            self.segments[-1].comp.label_slices(shape), shape[0])

    def _by_microbatch(self, block, batch: int):
        """This rank's rows of a batch, microbatch by microbatch: the
        reference's microbatch m is rows [m B/M, (m+1) B/M) of the batch,
        and this rank holds its block of each, so its local rows are
        its block of microbatch 0, then of microbatch 1, ...  (``block``
        its block of the batch, one slice of rows)."""
        M = self.num_microbatches
        rows = block[0]
        if M == 1 or not isinstance(rows, slice):
            return block
        start, stop, _ = rows.indices(batch)
        per = stop - start
        if batch % (M * (batch // per)):
            raise ValueError(f"batch {batch} does not split into {M} "
                             f"microbatches of {batch // per} blocks")
        b, j = per // M, start // per
        idx = np.concatenate([np.arange(m * (batch // M) + j * b,
                                        m * (batch // M) + (j + 1) * b)
                              for m in range(M)])
        return (idx,) + tuple(block[1:])

    # ---- weights ----------------------------------------------------------
    def init_params(self, seed: int = 0):
        """This rank's segment's weights, drawn by name as the flat
        lowering's (the same weights for the same seed)."""
        if self.mine is None:
            return {}, {}
        return self.segments[self.mine].comp.init_params(seed)

    def gather_weights(self, params, names=None):
        """Whole weights on every rank, from the segment that holds
        each (gathered there, then broadcast over the job)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        specs = {(n.op.name, ws.name): ws for n in self.graph.topo_order()
                 for ws in n.op._weight_specs}
        for op, w in (self.weight_names() if names is None else names):
            si = self._op_segment[op]
            sg = self.segments[si]
            if si == self.mine:
                v = params[op][w]
                v = reshard(v, sg.comp.weight_placement(op, w),
                            Placement.replicated(v.dim()), sg.comp.mesh)
            else:
                ws = specs[(op, w)]
                v = torch.empty(ws.shape, dtype=ws.dtype.to_torch(),
                                device=self.device)
            out.setdefault(op, {})[w] = broadcast(v, sg.start)
        return out

    def local_weights(self, whole, device):
        if self.mine is None:
            return {}
        return self.segments[self.mine].comp.local_weights(
            {op: ws for op, ws in whole.items() if self.holds(op)}, device)

    # ---- boundary transfers -----------------------------------------------
    def _iso(self, a: int, b: int) -> bool:
        return self.segments[a].comp.mesh.axes == self.segments[b].comp.mesh.axes

    def _key_shape(self, key):
        src, idx = key
        sizes = list(self.graph.nodes[src].op.output_shapes[idx].sizes)
        if sizes:
            sizes[0] //= self.num_microbatches
        return tuple(sizes)

    def _in_placement(self, si: int, key) -> Placement:
        comp = self.segments[si].comp
        node = comp._input_nodes[self.segments[si].in_keys.index(key)]
        return comp._out_pl[node.guid][0]

    def _send_boundary(self, sends, key, v, pl, m, out_tensors):
        """Producer side: send boundary ``key``'s value ``v`` (laid out
        as ``pl``) to each reader; append to ``out_tensors`` the
        autograd tensors whose cotangents the backward will bring."""
        me = self.segments[self.mine]
        here = self.rank - me.start
        tag = self._tag(key, m)
        for r in self._readers[key]:
            rd = self.segments[r]
            want = self._in_placement(r, key)
            if self._iso(self.mine, r):
                t = reshard(v, pl, want, me.comp.mesh)
                sends.send(t, rd.start + here, tag)
                out_tensors.append((key, r, t))
                continue
            t = reshard(v, pl, Placement.replicated(v.dim()), me.comp.mesh)
            for j in range(here, rd.width, me.width):
                blk = want.local_slices(t.shape, rd.comp.mesh, at=j)
                sends.send(t[blk], rd.start + j, tag)
            out_tensors.append((key, r, t))

    def _recv_boundary(self, key, m):
        """Reader side: this rank's block of boundary ``key``."""
        me = self.segments[self.mine]
        p = self._producer[key]
        pd = self.segments[p]
        here = self.rank - me.start
        want = self._in_placement(self.mine, key)
        src = pd.start + (here if self._iso(p, self.mine)
                          else here % pd.width)
        src_node = self.graph.nodes[key[0]]
        dtype = src_node.op.output_shapes[key[1]].dtype.to_torch()
        like = torch.empty(want.local_sizes(self._key_shape(key),
                                            me.comp.mesh),
                           dtype=dtype, device=self.device)
        return recv(like, src, self._tag(key, m))

    def _send_cotangent(self, sends, key, g, m):
        """Reader side, backward: the cotangent of this rank's block of
        ``key`` back to the rank it came from (zeros from a rank whose
        block another rank of this segment also holds, when the
        producer sums over its ranks)."""
        me = self.segments[self.mine]
        p = self._producer[key]
        pd = self.segments[p]
        here = self.rank - me.start
        if self._iso(p, self.mine):
            sends.send(g, pd.start + here, self._tag(key, m))
            return
        want = self._in_placement(self.mine, key)
        mine = want.local_slices(self._key_shape(key), me.comp.mesh)
        first = next(j for j in range(me.width)
                     if want.local_slices(self._key_shape(key), me.comp.mesh,
                                          at=j) == mine)
        if first != here:
            g = torch.zeros_like(g)
        sends.send(g, pd.start + here % pd.width, self._tag(key, m))

    def _recv_cotangents(self, key, r, t, m):
        """Producer side, backward: the cotangent of ``t`` (what
        ``_send_boundary`` kept for reader segment ``r``)."""
        me = self.segments[self.mine]
        rd = self.segments[r]
        here = self.rank - me.start
        tag = self._tag(key, m)
        if self._iso(self.mine, r):
            return recv(t, rd.start + here, tag)
        want = self._in_placement(r, key)
        g = torch.zeros_like(t)
        for j in range(here, rd.width, me.width):
            blk = want.local_slices(t.shape, rd.comp.mesh, at=j)
            g[blk] += recv(t[blk], rd.start + j, tag)
        axes = [n for n, s in me.comp.mesh.axes if s > 1]
        return all_reduce_sum(g, axes, me.comp.mesh) if axes else g

    def _tag(self, key, m) -> int:
        return (sorted(self._producer).index(key) * self.num_microbatches
                + m)

    # ---- one pass -----------------------------------------------------------
    def _micro(self, x, m):
        M = self.num_microbatches
        if M == 1:
            return x
        per = x.shape[0] // M
        return x[m * per:(m + 1) * per]

    def _run(self, params, state, inputs, labels, train: bool,
             want_output: bool = False, seed=None):
        """One pass over the microbatches: (this rank's gradients or
        None, the job's loss and metric sums (without ``labels``: none),
        the whole output on the last segment's ranks or None)."""
        M, me_i = self.num_microbatches, self.mine
        seg_inputs = [x for (si, _), x in zip(self._input_map, inputs)
                      if si == me_i]
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        metrics = {k: torch.zeros((), dtype=torch.float32,
                                  device=self.device)
                   for k in self._metric_keys}
        grads, outputs = None, []
        if me_i is None:
            return grads, loss, metrics, None
        me = self.segments[me_i]
        last = me_i == len(self.segments) - 1
        leaves = ([(op, w, t.detach().requires_grad_(True))
                   for op, ws in params.items() for w, t in ws.items()]
                  if train else [])
        live: Dict[str, Dict[str, torch.Tensor]] = dict(params)
        if train:
            live = {}
            for op, w, t in leaves:
                live.setdefault(op, {})[w] = t
        records = []
        sends = Sends()
        with torch.set_grad_enabled(train):
            for m in range(M):
                bounds = [self._recv_boundary(k, m).requires_grad_(train)
                          for k in me.in_keys]
                real = [self._micro(x, m) for x in seg_inputs]
                rows = (real + bounds)[0].shape[0] if real + bounds else 0
                values, places, _ = me.comp.forward_values(
                    live, state, bounds + real, train, seed=seed,
                    row_base=m * rows)
                kept = []
                for k in me.out_keys:
                    self._send_boundary(sends, k, values[k], places[k], m,
                                        kept)
                share = None
                sink = (me.comp._sink.guid, 0)
                if last:
                    me.comp._sink_pl = places[sink]
                    if want_output:
                        outputs.append(me.comp.gather_output(
                            values[sink]).float())
                if last and labels is not None:
                    lab = self._micro(labels, m)
                    share, logits = me.comp._loss_from(values[sink], lab, {})
                    loss = loss + me.comp._job_loss(share.detach()) / M
                    mt = me.comp._job_metrics(compute_metrics(
                        self.metric_types, self.loss_type, logits, lab))
                    for k, v in mt.items():
                        metrics[k] = metrics[k] + v
                records.append((bounds, kept, share))
        sends.wait()
        if train:
            grads = self._backward(records, leaves)
        out = torch.cat(outputs) if outputs else None
        return grads, loss, metrics, out

    def _backward(self, records, leaves):
        M = self.num_microbatches
        me = self.segments[self.mine]
        sums: Dict[Tuple[str, str], torch.Tensor] = {}
        sends = Sends()
        for m in reversed(range(M)):
            bounds, kept, share = records[m]
            outs, gouts = [], []
            if share is not None:
                outs.append(share)
                gouts.append(torch.full_like(share, 1.0 / M))
            for key, r, t in kept:
                outs.append(t)
                gouts.append(self._recv_cotangents(key, r, t, m))
            wanted = list(bounds) + [t for _, _, t in leaves]
            got = torch.autograd.grad(outs, wanted, gouts,
                                      allow_unused=True)
            for k, b, g in zip(me.in_keys, bounds, got[:len(bounds)]):
                self._send_cotangent(sends, k,
                                     torch.zeros_like(b) if g is None else g,
                                     m)
            for (op, w, t), g in zip(leaves, got[len(bounds):]):
                if g is not None:
                    prev = sums.get((op, w))
                    sums[(op, w)] = g if prev is None else prev + g
            records[m] = None
        sends.wait()
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, w, t in leaves:
            g = sums.get((op, w))
            grads.setdefault(op, {})[w] = (torch.zeros_like(t) if g is None
                                           else g)
        me.comp._sync_grads(grads)
        return grads

    def _publish(self, loss, metrics):
        """The last segment's loss and metric sums on every rank."""
        flat = torch.stack([loss.float()] + [metrics[k].float()
                                             for k in self._metric_keys])
        flat = broadcast(flat, self.segments[-1].start)
        return flat[0], dict(zip(self._metric_keys, flat[1:].unbind()))

    # ---- the compiled model's surface ----------------------------------------
    def train_steps(self, params, opt_state, state, inputs_stacked,
                    labels_stacked, seeds=None):
        """``CompiledModel.train_steps``: N steps in order, each one
        training step of the segments (module docstring)."""
        from flexflow_tpu_torch.compiler.lowering import step_seeds

        n = labels_stacked.shape[0]
        seeds = step_seeds(seeds, n, self.graph).to(self.device)
        losses, ms = [], []
        for i in range(n):
            grads, loss, m, _ = self._run(
                params, state, [x[i] for x in inputs_stacked],
                labels_stacked[i], train=True, seed=seeds[i])
            if params:
                self.optimizer.apply(params, grads, opt_state)
            loss, m = self._publish(loss, m)
            losses.append(loss)
            ms.append(m)
        return (params, opt_state, state, torch.stack(losses),
                {k: torch.stack([m[k] for m in ms]) for k in ms[0]})

    def train_step(self, params, opt_state, state, inputs, labels,
                   seed: Optional[int] = None):
        params, opt_state, state, losses, m = self.train_steps(
            params, opt_state, state, [x[None] for x in inputs],
            labels[None], None if seed is None else [seed])
        return (params, opt_state, state, losses[0],
                {k: v[0] for k, v in m.items()})

    @torch.no_grad()
    def eval_step(self, params, state, inputs, labels):
        _, loss, m, _ = self._run(params, state, inputs, labels, train=False)
        return self._publish(loss, m)

    def forward_fn(self):
        """(params, state, inputs) -> the whole output (float32) on
        every rank."""
        sink = self.graph.sinks()[-1].op.output_shapes[0].sizes

        @torch.no_grad()
        def fwd(params, state, inputs):
            _, _, _, y = self._run(params, state, inputs, None,
                                   train=False, want_output=True)
            if y is None:
                y = torch.empty(sink, dtype=torch.float32,
                                device=self.device)
            return broadcast(y, self.segments[-1].start)

        return fwd


def _segment_graph(graph: Graph, members: Sequence[Node],
                   in_keys: Sequence[Tuple[int, int]], name: str,
                   next_guid: int, micro: int = 1) -> Graph:
    """The sub-graph of ``members``, each boundary input a synthetic
    ``InputOp`` (negative tensor guids in boundary order sort them
    first, and in order, in ``CompiledModel``'s input order)."""
    from flexflow_tpu_torch.core.ptensor import ParallelTensorShape

    member = {n.guid for n in members}
    sg = Graph()
    K = len(in_keys)
    bmap: Dict[Tuple[int, int], Node] = {}
    for bi, (src, idx) in enumerate(in_keys):
        shp = graph.nodes[src].op.output_shapes[idx]
        sizes = list(shp.sizes)
        if sizes:
            sizes[0] //= micro
        node = Node(next_guid + bi, InputOp(
            f"{name}_{bi}", ParallelTensorShape.make(tuple(sizes), shp.dtype),
            tensor_guid=bi - K))
        bmap[(src, idx)] = node
        sg.add_node(node)
    for n in members:
        sg.add_node(n)
    for n in members:
        for e in graph.in_edges[n.guid]:
            if e.src in member:
                sg.add_edge(graph.nodes[e.src], n, e.src_idx, e.dst_idx)
            else:
                sg.add_edge(bmap[(e.src, e.src_idx)], n, 0, e.dst_idx)
    return sg


class PlacedCompiledModel(SegmentedModel):
    """Two-segment vertical placement over disjoint rank blocks."""

    def __init__(self, graph: Graph, strategy: Dict[int, MachineView],
                 config, loss_type, metric_types, optimizer):
        from flexflow_tpu_torch.runtime import distributed

        self.strategy = strategy
        if getattr(config, "grad_accum_steps", 1) > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not supported with inter-op "
                "placement")
        if getattr(config, "zero_dp_shard", False):
            raise NotImplementedError(
                "zero_dp_shard is not supported with inter-op placement")
        views = {k: v for k, v in strategy.items() if k != "__meta__"}
        blocks = placement_blocks(views)
        if len(blocks) != 2:
            raise NotImplementedError(
                f"inter-op placement supports exactly 2 device blocks, "
                f"strategy has start_parts {blocks}")
        start_b = blocks[1]
        in_a, in_b, crossing, back = _cut(graph, views)
        if back:
            raise NotImplementedError(
                "inter-op placement requires a forward-only cut (edges "
                "from the second block back into the first exist)")
        boundary_srcs = sorted({(e.src, e.src_idx) for e in crossing})
        if not 0 < len(boundary_srcs) <= MAX_CROSSING_TENSORS:
            raise NotImplementedError(
                f"inter-op placement supports 1..{MAX_CROSSING_TENSORS} "
                f"tensors crossing the blocks, found {len(boundary_srcs)}")
        self._boundary_srcs = boundary_srcs
        self._n_boundaries = len(boundary_srcs)
        n = distributed.world_size()
        if config.num_devices != n:
            raise ValueError(
                f"FFConfig.num_devices={config.num_devices} but the job has "
                f"{n} rank(s) (runtime.distributed.initialize)")
        n_a, n_b = placement_block_widths(in_a, in_b, views)
        if start_b < n_a or start_b + n_b > n:
            raise ValueError(
                f"device blocks overlap or overflow: A needs {n_a} from 0, "
                f"B needs {n_b} from {start_b}, have {n}")
        topo_pos = {nd.guid: i for i, nd in enumerate(graph.topo_order())}
        in_a = sorted(in_a, key=lambda nd: topo_pos[nd.guid])
        in_b = sorted(in_b, key=lambda nd: topo_pos[nd.guid])
        next_guid = max(graph.nodes) + 1
        graph_a = _segment_graph(graph, in_a, [], "placement_boundary",
                                 next_guid)
        graph_b = _segment_graph(graph, in_b, boundary_srcs,
                                 "placement_boundary", next_guid)
        strat_a = {nd.guid: _strip_start(views[nd.guid])
                   for nd in in_a if views.get(nd.guid) is not None}
        strat_b = {nd.guid: _strip_start(views[nd.guid])
                   for nd in in_b if views.get(nd.guid) is not None}
        # each boundary enters B under B's own geometry: batch-split
        # over B's ranks when divisible, whole otherwise
        for node in graph_b.topo_order():
            if node.guid in graph.nodes:
                continue
            shp = node.op.output_shapes[0]
            if shp.ndim and shp.sizes[0] % n_b == 0:
                strat_b[node.guid] = MachineView.data_parallel(shp.ndim, n_b)
            else:
                strat_b[node.guid] = MachineView.trivial(shp.ndim)
        mesh_a = distributed.mesh_over(start=0, width=n_a)
        mesh_b = distributed.mesh_over(start=start_b, width=n_b)
        comp_a = CompiledModel(
            graph_a, dataclasses.replace(config, num_devices=n_a),
            LossType.IDENTITY, [], optimizer, strategy=strat_a, mesh=mesh_a)
        comp_b = CompiledModel(
            graph_b, dataclasses.replace(config, num_devices=n_b),
            loss_type, metric_types, optimizer, strategy=strat_b,
            mesh=mesh_b)
        self._comp_a, self._comp_b = comp_a, comp_b
        segments = [_Segment(comp_a, 0, n_a, [], list(boundary_srcs)),
                    _Segment(comp_b, start_b, n_b, list(boundary_srcs), [])]
        self._setup(graph, segments, {k: 0 for k in boundary_srcs}, config,
                    loss_type, metric_types, optimizer, 1)
