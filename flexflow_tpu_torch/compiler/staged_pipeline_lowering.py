"""General staged pipeline: GPipe over arbitrary graph cuts — the port
of flexflow_tpu/compiler/staged_pipeline_lowering.py.

The stacked-block pipelined lowering (pipeline_lowering.py) needs S
isomorphic blocks.  This one runs the general shape the search proposes
(``search/pipeline_search.py::propose_pipeline_general``): a
topological interval partition of the PCG into S heterogeneous stages,
each lowered as an ordinary ``CompiledModel`` with data parallelism
over its own contiguous block of ``n / S`` ranks, with the microbatches
driven as a wavefront (``placement_lowering.SegmentedModel``, shared
with the placed lowering):

  forward:  for each microbatch m, stage s receives its boundary
            inputs, runs, and sends its boundary outputs on;
  backward: the microbatches in reverse, each stage differentiating its
            microbatch with the cotangents its readers sent back;
  update:   each stage's ranks sync and apply their gradients, taken
            of the mean of the microbatch losses.

Cross-stage tensors (skip edges included) enter their consumer stage as
synthetic boundary inputs, batch-split over the consumer's ranks when
the microbatch divides; the stages have the same axes, so stage s lays
each one out as its reader wants it and its rank i sends its block to
the reader's rank i.  The reference re-runs each stage's forward under
``jax.vjp`` (activation rematerialisation); the port keeps each
microbatch's autograd graph until its backward (the same function).

Unsupported (loud, with the reference's messages): state-carrying ops
(the microbatch wavefront would race their updates), grad
accumulation, ZeRO, and a job over several hosts (the reference's
"multi-process" refusal: it runs one process over its devices, the
port one rank per device, placement_lowering.py's docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from flexflow_tpu_torch.compiler.lowering import (
    CompiledModel,
    data_parallel_strategy,
)
from flexflow_tpu_torch.compiler.placement_lowering import (
    SegmentedModel,
    _multi_host,
    _Segment,
    _segment_graph,
)
from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.losses import LossType


class StagedPipelinedModel(SegmentedModel):
    """S heterogeneous stages over contiguous rank blocks, microbatched."""

    def __init__(self, graph: Graph, stage_guids: List[List[int]],
                 num_microbatches: int, config, loss_type, metric_types,
                 optimizer):
        from flexflow_tpu_torch.runtime import distributed

        if getattr(config, "grad_accum_steps", 1) > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not supported with the staged "
                "pipeline (microbatching already plays that role)")
        if getattr(config, "zero_dp_shard", False):
            raise NotImplementedError(
                "zero_dp_shard is not supported with the staged pipeline")
        if _multi_host():
            raise NotImplementedError(
                "multi-process staged pipelining is not supported (the "
                "wavefront is host-composed)")
        self.num_stages = S = len(stage_guids)
        self.num_microbatches = M = int(num_microbatches)
        if S < 2 or M < 1:
            raise ValueError(f"a staged pipeline needs >= 2 stages and >= 1 "
                             f"microbatch, got {S} and {M}")
        if config.batch_size % M:
            raise ValueError(
                f"batch {config.batch_size} must divide into "
                f"{M} microbatches")
        n = config.num_devices
        if n != distributed.world_size():
            raise ValueError(
                f"FFConfig.num_devices={n} but the job has "
                f"{distributed.world_size()} rank(s) "
                f"(runtime.distributed.initialize)")
        if n % S:
            raise ValueError(f"{n} devices do not split into {S} stages")
        d = n // S

        stage_of: Dict[int, int] = {}
        for si, guids in enumerate(stage_guids):
            for g in guids:
                if g not in graph.nodes:
                    raise ValueError(f"stage {si} names unknown node {g}")
                stage_of[g] = si
        if set(stage_of) != set(graph.nodes):
            raise ValueError("stages must partition the graph")
        for guid in graph.nodes:
            for e in graph.out_edges[guid]:
                if stage_of[e.src] > stage_of[e.dst]:
                    raise ValueError(
                        "stage partition has a backward edge — stages "
                        "must follow a topological interval order")
            if getattr(graph.nodes[guid].op, "writes_state", False) or \
                    getattr(graph.nodes[guid].op, "state_specs", None):
                raise NotImplementedError(
                    f"op {graph.nodes[guid].op.name!r} carries state — "
                    "the microbatch wavefront would race its updates")
        self.stage_guids = [list(g) for g in stage_guids]

        # cross-stage boundary tensors, by producer (src, src_idx)
        crossing = sorted({(e.src, e.src_idx)
                           for guid in graph.nodes
                           for e in graph.out_edges[guid]
                           if stage_of[e.src] != stage_of[e.dst]})
        producer = {k: stage_of[k[0]] for k in crossing}
        topo_pos = {nd.guid: i for i, nd in enumerate(graph.topo_order())}
        next_guid = max(graph.nodes) + 1
        micro_b = config.batch_size // M
        segments = []
        for si, guids in enumerate(stage_guids):
            member = set(guids)
            in_keys = sorted({(e.src, e.src_idx) for g in member
                              for e in graph.in_edges[g]
                              if e.src not in member})
            nodes = sorted((graph.nodes[g] for g in guids),
                           key=lambda nd: topo_pos[nd.guid])
            sg = _segment_graph(graph, nodes, in_keys,
                                f"stage{si}_boundary", next_guid, micro=M)
            next_guid += len(in_keys)
            is_last = si == S - 1
            comp = CompiledModel(
                sg, dataclasses.replace(config, num_devices=d,
                                        batch_size=micro_b),
                loss_type if is_last else LossType.IDENTITY,
                metric_types if is_last else [], optimizer,
                strategy=data_parallel_strategy(sg, d),
                mesh=distributed.mesh_over(start=si * d, width=d))
            segments.append(_Segment(
                comp, si * d, d, in_keys,
                [k for k in crossing if producer[k] == si]))
        self._setup(graph, segments, producer, config, loss_type,
                    metric_types, optimizer, M)

