"""Pipeline-parallel lowering — the port of
flexflow_tpu/compiler/pipeline_lowering.py: PCG -> prologue + pipelined
block stack + epilogue, ``FFModel.compile(pipeline=PipelineConfig(...))``.

How the PCG is pipelined (as the reference's):

1. The graph is partitioned into *blocks* — repeated isomorphic
   subgraphs found by op name (``layer<i>_...``) or given by
   ``block_of`` (``detect_blocks``).  Nodes before the first block form
   the prologue, nodes after it the epilogue.
2. The ranks form a mesh whose leading axis is ``pp`` (S stages) and
   whose other axes factor the rest as ``mesh_axis_sizes`` does
   (``build_pipeline_mesh``); stage s holds blocks [s L/S, (s+1) L/S).
3. A step runs the prologue, splits the stream tensor into M
   microbatches, runs the stack through ``parallel.pipeline
   .pipeline_gpipe`` (GPipe over point-to-point sends), merges, and
   runs the epilogue and the loss.

The views of every op (the strategy's, by default data parallelism
over the ranks of one stage) map onto the non-``pp`` axes, so each
stage's ranks split its microbatches as the view says and sync its
weights' gradients among themselves.  The prologue and the epilogue
run on every pp rank alike, as in the reference, whose full-mesh
prologue and epilogue are replicated over ``pp``; the pipeline hands
every pp rank the same output and stage 0's input cotangent, so every
replica of a prologue or epilogue weight gets the same gradient and
stays bit-equal to the others.

Where the port departs: block weights keep their own op names and are
initialised from them (``weight_generator``) as the flat lowering's
are, so a pipelined model and a flat one start from the same weights;
the reference stacks them under block 0's names with ``fold_in(k, b)``
(``interop.stacked_to_blocks`` carries weights between the two).  A
rank holds only the weights of its stage's blocks, besides the
prologue's and the epilogue's (``holds``); ``gather_weights`` brings
every weight to every rank.

Constraints (checked at compile, with the reference's messages): the
blocks are isomorphic, each has a single streaming input and a single
consumed output, they chain linearly, and no block op carries state.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.compiler.lowering import CompiledModel
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.parallel.mesh import (
    Placement,
    broadcast,
    mesh_axis_sizes,
    reshard,
)
from flexflow_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    merge_microbatches,
    pipeline_gpipe,
    split_microbatches,
)

_BLOCK_RE = re.compile(r"^layer(\d+)_")


def pipeline_mesh_axes(num_devices: int, num_stages: int,
                       axis_name: str = "pp"):
    """The axes of ``build_pipeline_mesh``: a leading pipeline axis of
    size num_stages, the remaining ranks in prime-sized axes."""
    if num_devices % num_stages:
        raise ValueError(f"{num_devices} devices not divisible into "
                         f"{num_stages} stages")
    return [(axis_name, num_stages)] + mesh_axis_sizes(
        num_devices // num_stages)


def build_pipeline_mesh(num_devices: int, num_stages: int,
                        axis_name: str = "pp"):
    """The job's ranks over ``pipeline_mesh_axes`` (reference
    ``build_pipeline_mesh``, pipeline_lowering.py:54-64)."""
    from flexflow_tpu_torch.runtime import distributed

    return distributed.mesh_over(
        pipeline_mesh_axes(num_devices, num_stages, axis_name))


def detect_blocks(
    graph: Graph, block_of: Optional[Dict[int, int]] = None
) -> Tuple[List[List[Node]], List[Node], List[Node]]:
    """Partition nodes into (blocks, prologue, epilogue) in topo order."""
    topo = graph.topo_order()
    if block_of is None:
        block_of = {}
        for node in topo:
            m = _BLOCK_RE.match(node.op.name)
            if m:
                block_of[node.guid] = int(m.group(1))
    if not block_of:
        raise ValueError(
            "pipeline compile found no repeated blocks: name block ops "
            "'layer<i>_...' or pass block_of={node_guid: block_idx}"
        )
    n_blocks = max(block_of.values()) + 1
    blocks: List[List[Node]] = [[] for _ in range(n_blocks)]
    prologue: List[Node] = []
    epilogue: List[Node] = []
    seen_block = False
    for node in topo:
        b = block_of.get(node.guid)
        if b is not None:
            seen_block = True
            blocks[b].append(node)
        elif not seen_block:
            prologue.append(node)
        else:
            epilogue.append(node)
    for i, blk in enumerate(blocks):
        if not blk:
            raise ValueError(f"pipeline block {i} is empty")
    return blocks, prologue, epilogue


def _block_signature(block: List[Node], graph: Graph, member: set) -> Tuple:
    sig = []
    for node in block:
        in_edges = sorted(graph.in_edges[node.guid], key=lambda e: e.dst_idx)
        wiring = tuple(
            ("ext",) if e.src not in member
            else ("int", block_pos(block, e.src), e.src_idx)
            for e in in_edges)
        sig.append((node.op.signature(), wiring))
    return tuple(sig)


def block_pos(block: List[Node], guid: int) -> int:
    for i, n in enumerate(block):
        if n.guid == guid:
            return i
    return -1


class PipelinedCompiledModel(CompiledModel):
    """A ``CompiledModel`` whose repeated-block stack runs as an S-stage
    GPipe pipeline over the ``pp`` axis of the ranks."""

    def __init__(self, graph: Graph, config, loss_type, metric_types,
                 optimizer, strategy=None, *, pipeline: PipelineConfig,
                 block_of: Optional[Dict[int, int]] = None):
        from flexflow_tpu_torch.runtime import distributed

        self.pipeline = pipeline
        self._blocks, self._prologue, self._epilogue = detect_blocks(
            graph, block_of)
        L, S = len(self._blocks), pipeline.num_stages
        if L % S:
            raise ValueError(f"{L} blocks not divisible into {S} stages")

        member0 = {n.guid for n in self._blocks[0]}
        sig0 = _block_signature(self._blocks[0], graph, member0)
        for i, blk in enumerate(self._blocks[1:], 1):
            member = {n.guid for n in blk}
            if _block_signature(blk, graph, member) != sig0:
                raise ValueError(
                    f"pipeline block {i} is not isomorphic to block 0")

        # streaming tensor: the unique external value entering each block
        self._block_entry: List[Tuple[int, int]] = []
        for blk in self._blocks:
            member = {n.guid for n in blk}
            ext = set()
            for node in blk:
                for e in graph.in_edges[node.guid]:
                    if e.src not in member:
                        ext.add((e.src, e.src_idx))
            if len(ext) != 1:
                raise ValueError(
                    f"pipeline block has {len(ext)} external inputs; need "
                    f"exactly 1")
            self._block_entry.append(next(iter(ext)))
        # block exit = the (unique) block value consumed outside the block
        self._block_exit: List[Tuple[int, int]] = []
        all_members = [{n.guid for n in blk} for blk in self._blocks]
        topo = graph.topo_order()
        for bi, blk in enumerate(self._blocks):
            member = all_members[bi]
            exits = set()
            for node in topo:
                if node.guid in member:
                    continue
                for e in graph.in_edges[node.guid]:
                    if e.src in member:
                        exits.add((e.src, e.src_idx))
            if len(exits) != 1:
                raise ValueError(
                    f"pipeline block {bi} has {len(exits)} external "
                    f"consumers; need 1")
            self._block_exit.append(next(iter(exits)))
        for bi in range(1, L):
            if self._block_entry[bi] != self._block_exit[bi - 1]:
                raise ValueError("pipeline blocks must chain linearly")

        for node in [n for b in self._blocks for n in b]:
            if getattr(node.op, "state_specs", None) is not None:
                raise ValueError(
                    f"stateful op {node.op.name} not supported inside a "
                    f"pipeline block")

        world = distributed.world_size()
        if config.num_devices != world:
            raise ValueError(
                f"FFConfig.num_devices={config.num_devices} but the job has "
                f"{world} rank(s) (runtime.distributed.initialize)")
        mesh = build_pipeline_mesh(world, pipeline.num_stages,
                                   pipeline.axis_name)
        super().__init__(graph, config, loss_type, metric_types, optimizer,
                         strategy, mesh=mesh)

        self._block_guids = {g for m in all_members for g in m}
        self._first_block = next(n.guid for n in topo
                                 if n.guid in self._block_guids)
        self._stage = mesh.coord(pipeline.axis_name)
        per = L // S
        self._stage_blocks = list(range(self._stage * per,
                                        (self._stage + 1) * per))
        self._owner = {n.op.name: b // per
                       for b, blk in enumerate(self._blocks) for n in blk}

    # ---- weights ---------------------------------------------------------
    def holds(self, op_name: str) -> bool:
        owner = self._owner.get(op_name)
        return owner is None or owner == self._stage

    def gather_weights(self, params, names=None):
        """Whole weights on every rank: a block weight from its stage's
        ranks (gathered there, then broadcast over the pp group)."""
        axis = self.pipeline.axis_name
        S = self.pipeline.num_stages
        specs = {(n.op.name, ws.name): ws for n in self._topo
                 for ws in n.op._weight_specs}
        pp_ranks = (self.mesh.members((axis,)) if S > 1
                    else [self.mesh.rank])
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for op, w in (self.weight_names() if names is None else names):
            owner = self._owner.get(op)
            if owner is None or owner == self._stage:
                v = params[op][w]
                v = reshard(v, self.weight_placement(op, w),
                            Placement.replicated(v.dim()), self.mesh)
            else:
                ws = specs[(op, w)]
                v = torch.empty(ws.shape, dtype=ws.dtype.to_torch(),
                                device=self.device)
            if owner is not None and S > 1:
                v = broadcast(v, pp_ranks[owner],
                              self.mesh.group((axis,)))
            out.setdefault(op, {})[w] = v
        return out

    # ---- forward ---------------------------------------------------------
    def _visit(self, node, ctx, params, values, places, resharded):
        if node.guid not in self._block_guids:
            return super()._visit(node, ctx, params, values, places,
                                  resharded)
        if node.guid != self._first_block:
            return  # the pipeline ran the whole stack
        entry, exit_ = self._block_entry[0], self._block_exit[-1]
        values[exit_] = self._run_pipeline(values[entry], places[entry],
                                           ctx, params)
        places[exit_] = places[entry]

    def _run_pipeline(self, stream, pl, ctx, params):
        M = self.pipeline.num_microbatches
        if stream.shape[0] % M:
            raise ValueError(
                f"this rank's batch block of {stream.shape[0]} does not "
                f"split into {M} microbatches")
        mine = [n for b in self._stage_blocks for n in self._blocks[b]]
        keys = [(n.op.name, ws.name) for n in mine
                for ws in n.op._weight_specs]
        leaves = [params[op][w] for op, w in keys]
        first = self._block_entry[self._stage_blocks[0]]
        last = self._block_exit[self._stage_blocks[-1]]

        def stage_fn(ts, x, m):
            p: Dict[str, Dict[str, torch.Tensor]] = {}
            for (op, w), t in zip(keys, ts):
                p.setdefault(op, {})[w] = t
            # microbatch m holds rows [m * rows, (m + 1) * rows) of this
            # pass's block: its dropout masks are those rows'
            sctx = LoweringContext(compute_dtype=ctx.compute_dtype,
                                   train=ctx.train, device=ctx.device,
                                   mesh=self.mesh, seed=ctx.seed,
                                   row_base=ctx.row_base + m * x.shape[0],
                                   seq_length=ctx.seq_length)
            values = {first: x}
            places = {first: pl}
            resharded: Dict[tuple, torch.Tensor] = {}
            for node in mine:
                edges = sorted(self.graph.in_edges[node.guid],
                               key=lambda e: e.dst_idx)
                outs = self._run_node(node, sctx, edges,
                                      p.get(node.op.name, {}), values,
                                      places, resharded)
                for i, y in enumerate(outs):
                    values[(node.guid, i)] = y
            if sctx.state_out:
                raise AssertionError("stateful ops inside pipeline blocks")
            y = values[last]
            if places[last] != pl:
                y = reshard(y, places[last], pl, self.mesh)
            return y

        ym = pipeline_gpipe(stage_fn, leaves, split_microbatches(stream, M),
                            self.mesh, self.pipeline.axis_name)
        return merge_microbatches(ym)
