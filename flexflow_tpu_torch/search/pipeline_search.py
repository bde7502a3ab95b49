"""Search-integrated pipeline parallelism — a copy of
flexflow_tpu/search/pipeline_search.py, priced by the port's
``Simulator`` and cost model (the same ``coherent_calibration`` as the
flat search), its proposals lowered by the port's
``compiler/pipeline_lowering.py`` and ``staged_pipeline_lowering.py``.
The text below is the reference's.

The reference only *declares* OP_PIPELINE (ffconst.h:148) and its Unity
search approximates inter-op parallelism with disjoint device splits
(reference: src/runtime/graph.cc:161-295); the pipelined executor here
(parallel/pipeline.py) was previously reachable only by the user
passing ``compile(pipeline=PipelineConfig(...))``.  This module closes
the loop: for stacked-block graphs the compile-time search also costs
``pp ∈ {2, 4, 8}`` pipelined candidates in the SAME simulator currency
as dp/tp/sp strategies and compile() lowers the winner automatically.

Pipeline cost model (collective/looped GPipe over a pp × dp mesh):

  T = (M + S − 1)/M · Σ_block fwd+bwd(dp d)      compute incl. bubble
    + 2(M + S − 1) · t_hop                        per-tick ppermute (fwd
                                                  + reversed bwd pass)
    + T_prologue/epilogue(dp n)                   unpipelined ends
    + max_stage weight allreduce + update         dp-d groups, parallel
                                                  across stages

where d = n/S is the data-parallel width inside each stage.  The pp
axis is OUTERMOST in build_pipeline_mesh, so on a multi-host machine
stage boundaries cross DCN while each stage's dp sync group stays
inside one ICI domain — exactly the PipeDream/GPipe reason pipelining
wins at scale: DP's weight allreduce over DCN is replaced by one
activation hop per tick.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView


@dataclasses.dataclass
class StagedPipelineProposal:
    """A costed S-stage partition of an ARBITRARY PCG (reference: the
    inter-op device splits of graph.cc:161-295 are general over any
    graph cut).  ``executable`` is True when the stacked-block scan
    lowering can run it; the general heterogeneous shape executes via
    the staged wavefront executor
    (compiler/staged_pipeline_lowering.StagedPipelinedModel), which
    compile() adopts when every flat strategy is infeasible."""

    num_stages: int
    num_microbatches: int
    stage_guids: List[List[int]]  # topo-interval partition, stage order
    cost: float                   # modeled seconds/iteration
    executable: bool


def _pick_microbatches(batch: int, stages: int, dp: int = 1) -> Optional[int]:
    """Largest M <= 4*stages with M >= stages, batch % M == 0, and each
    microbatch still divisible by the stage's dp width — enough
    microbatches to amortize the (S-1)/(M+S-1) bubble without shrinking
    per-microbatch shards to nothing."""
    best = None
    for m in range(stages, 4 * stages + 1):
        if batch % m == 0 and (batch // m) % max(dp, 1) == 0:
            best = m
    return best


def _applicable(graph: Graph, stages: int):
    """Replicate PipelinedCompiledModel's gates (pipeline_lowering.py):
    stacked isomorphic blocks, single entry/exit, linear chain, equal
    entry/exit shapes, stateless block ops.  Returns (blocks, prologue,
    epilogue) or None."""
    from flexflow_tpu_torch.compiler.pipeline_lowering import (
        _block_signature,
        detect_blocks,
    )

    try:
        blocks, prologue, epilogue = detect_blocks(graph)
    except ValueError:
        return None
    if len(blocks) % stages or len(blocks) < stages:
        return None
    members = [{n.guid for n in blk} for blk in blocks]
    sig0 = _block_signature(blocks[0], graph, members[0])
    for blk, member in zip(blocks[1:], members[1:]):
        if _block_signature(blk, graph, member) != sig0:
            return None
    entries, exits = [], []
    topo = graph.topo_order()
    for blk, member in zip(blocks, members):
        ext_in = set()
        for node in blk:
            for e in graph.in_edges[node.guid]:
                if e.src not in member:
                    ext_in.add((e.src, e.src_idx))
        ext_out = set()
        for node in topo:
            if node.guid in member:
                continue
            for e in graph.in_edges[node.guid]:
                if e.src in member:
                    ext_out.add((e.src, e.src_idx))
        if len(ext_in) != 1 or len(ext_out) != 1:
            return None
        entries.append(next(iter(ext_in)))
        exits.append(next(iter(ext_out)))
        for node in blk:
            if getattr(node.op, "state_specs", None) is not None:
                return None
    for i in range(1, len(blocks)):
        if entries[i] != exits[i - 1]:
            return None
    # the streamed activation must keep one shape across stages
    src, idx = entries[0]
    entry_shape = graph.nodes[src].op.output_shapes[idx]
    src, idx = exits[-1]
    exit_shape = graph.nodes[src].op.output_shapes[idx]
    if tuple(entry_shape.sizes) != tuple(exit_shape.sizes):
        return None
    return blocks, prologue, epilogue, entry_shape


def propose_pipeline(graph: Graph, config, sim, baseline_cost: float):
    """Best PipelineConfig whose simulated step time beats
    ``baseline_cost`` by more than the search uncertainty margin, or
    None.  ``sim`` is the same Simulator that scored the flat search."""
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

    n = config.search_devices
    batch = config.batch_size
    cost = sim.cost
    machine = cost.machine
    best: Optional[Tuple[PipelineConfig, float]] = None

    for stages in (2, 4, 8):
        if stages <= 1 or stages > n or n % stages:
            continue
        got = _applicable(graph, stages)
        if got is None:
            continue
        blocks, prologue, epilogue, entry_shape = got
        d = n // stages  # dp width inside each stage
        m = _pick_microbatches(batch, stages, d)
        if m is None:
            continue

        def dp_view(op, deg):
            ndim = op.output_shapes[0].ndim
            batch_dim = op.output_shapes[0].sizes[0]
            if deg > 1 and batch_dim % deg:
                return None
            return MachineView.data_parallel(ndim, deg)

        # compute: all block ops fwd+bwd at dp-d shards, scaled by the
        # bubble; update term excluded here (charged once, below)
        comp = 0.0
        sync_one_stage = 0.0
        upd_one_stage = 0.0
        mem_one_stage = 0.0
        per_stage = len(blocks) // stages
        feasible = True
        for bi, blk in enumerate(blocks):
            for node in blk:
                v = dp_view(node.op, d)
                if v is None:
                    feasible = False
                    break
                if bi < per_stage:
                    mem_one_stage += cost.op_memory(node.op, v)
                full = cost.op_cost(node.op, v, backward=True)
                upd = cost.update_cost(node.op, v)
                comp += full - upd
                if bi < per_stage:  # one representative stage
                    upd_one_stage += upd
                    # stage grads allreduce over the d-wide dp group;
                    # pp is the OUTER mesh axis so this group sits
                    # inside one ICI domain whenever d <= domain size
                    for ws, annot in zip(
                        node.op._weight_specs,
                        node.op.propagate(v).weights,
                    ):
                        if annot is None or annot.replica <= 1:
                            continue
                        nbytes = ws.dtype.itemsize
                        for s in ws.shape:
                            nbytes *= s
                        sync_one_stage += cost.allreduce(
                            nbytes, d,
                            spans_dcn=d > machine.devices_per_host,
                        )
            if not feasible:
                break
        if not feasible:
            continue
        # a stage device holds its own stage's weights/opt state only —
        # the memory win that makes pipelining viable where replication
        # is not — but that stage must still fit
        if mem_one_stage > machine.hbm_capacity:
            continue
        bubble = (m + stages - 1) / m
        t_compute = bubble * comp

        # per-tick activation hop: microbatch shard over the dp group,
        # one ICI/DCN hop; both the forward scan and its differentiated
        # reverse pay it every tick
        hop_bytes = entry_shape.num_bytes / m / max(d, 1)
        spans_dcn = n > machine.devices_per_host  # pp crosses hosts
        if spans_dcn:
            t_hop = hop_bytes / machine.dcn_bandwidth + machine.dcn_latency
        else:
            t_hop = hop_bytes / machine.ici_bandwidth + machine.ici_latency
        t_comm = 2.0 * (m + stages - 1) * t_hop

        # unpipelined prologue/epilogue at full-dp width
        t_ends = 0.0
        for node in prologue + epilogue:
            v = dp_view(node.op, d)
            if v is None:
                v = MachineView.trivial(node.op.output_shapes[0].ndim)
            t_ends += cost.op_cost(node.op, v, backward=True)
            t_ends += cost.weight_sync_cost(node.op, v)

        total = t_compute + t_comm + t_ends + sync_one_stage + upd_one_stage
        if best is None or total < best[1]:
            from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

            best = (PipelineConfig(num_stages=stages, num_microbatches=m),
                    total)

    if best is None:
        return None
    margin = max(0.0, config.search_improvement_margin)
    if not math.isfinite(baseline_cost) or (
            best[1] < baseline_cost * (1.0 - margin)):
        _gate_pipeline_proposal(
            graph, config, best[0].num_stages, best[0].num_microbatches)
        from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

        log.log(
            f"pipeline search: pp={best[0].num_stages} M="
            f"{best[0].num_microbatches} simulated "
            f"{best[1] * 1e3:.3f} ms/iter beats flat "
            f"{baseline_cost * 1e3:.3f} ms/iter"
        )
        return best[0]
    return None


def stacked_stage_guids(graph: Graph, stages: int) -> Optional[List[List[int]]]:
    """The explicit stage partition a stacked-block PipelineConfig
    implies: blocks grouped ``len(blocks)/S`` per stage, prologue in
    stage 0, epilogue in the last — the cut the scan lowering will run,
    materialized so the legality lint (SHD150-152) can check it."""
    got = _applicable(graph, stages)
    if got is None:
        return None
    blocks, prologue, epilogue, _entry = got
    per = len(blocks) // stages
    out: List[List[int]] = []
    for si in range(stages):
        stage = [n.guid for n in prologue] if si == 0 else []
        for blk in blocks[si * per:(si + 1) * per]:
            stage += [n.guid for n in blk]
        if si == stages - 1:
            stage += [n.guid for n in epilogue]
        out.append(stage)
    return out


def _gate_pipeline_proposal(graph: Graph, config, stages: int,
                            microbatches: int,
                            stage_guids: Optional[List[List[int]]] = None,
                            ) -> None:
    """Always-on legality gate on every pipeline proposal the search
    returns (analysis/placement.py SHD150-152) — the same discipline
    optimize_strategy applies to flat strategies.  A failure is a
    SEARCH bug: fail loudly at the proposal, not in the lowering."""
    from flexflow_tpu_torch.analysis import (
        AnalysisError,
        emit_findings,
        errors_only,
        lint_pipeline_stages,
    )

    if stage_guids is None:
        stage_guids = stacked_stage_guids(graph, stages)
    bad = errors_only(lint_pipeline_stages(
        graph, stage_guids, stages, microbatches, config))
    if bad:
        emit_findings(bad)
        raise AnalysisError(
            "pipeline search produced an illegal stage partition", bad)


def _balanced_intervals(costs: List[float], stages: int) -> List[int]:
    """Split ``costs`` into ``stages`` contiguous intervals minimizing
    the max interval sum (classic linear-partition DP) — stage balance
    decides the pipeline tick.  Returns the end index (exclusive) of
    each interval."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    INF = math.inf
    # dp[s][i]: min over partitions of costs[:i] into s intervals of the
    # max interval sum; cut[s][i]: position of the last cut
    dp = [[INF] * (n + 1) for _ in range(stages + 1)]
    cut = [[0] * (n + 1) for _ in range(stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(dp[s - 1][j], prefix[i] - prefix[j])
                if v < dp[s][i]:
                    dp[s][i] = v
                    cut[s][i] = j
    ends = []
    i = n
    for s in range(stages, 0, -1):
        ends.append(i)
        i = cut[s][i]
    return ends[::-1]


def propose_pipeline_general(graph: Graph, config, sim,
                             baseline_cost: float
                             ) -> Optional[StagedPipelineProposal]:
    """Costed S-stage pipeline candidate for an ARBITRARY graph
    (reference: inter-op splits are general over any cut,
    graph.cc:161-295; the enum-stub OP_PIPELINE has no such limit).

    The topo order is partitioned into S contiguous intervals balancing
    full-step compute (every edge then crosses forward); cost model
    mirrors propose_pipeline's collective-GPipe formula with the tick
    set by the SLOWEST stage and the per-tick hop priced on the widest
    adjacent-cut crossing:

      T = (M + S - 1)/M · max_s C_s · S̄ …  — see inline terms

    Returns the best finite-cost proposal (marked ``executable`` when
    the graph also passes the stacked-block gates), or None."""
    n = config.search_devices
    batch = config.batch_size
    cost = sim.cost
    machine = cost.machine
    topo = [node for node in graph.topo_order()]
    best: Optional[StagedPipelineProposal] = None

    for stages in (2, 4, 8):
        if stages <= 1 or stages > n or n % stages:
            continue
        if len(topo) < stages:
            continue
        d = n // stages
        m = _pick_microbatches(batch, stages, d)
        if m is None:
            continue

        def dp_view(op, deg):
            ndim = op.output_shapes[0].ndim
            if ndim == 0:
                return MachineView.trivial(0)
            batch_dim = op.output_shapes[0].sizes[0]
            if deg > 1 and batch_dim % deg:
                return None
            return MachineView.data_parallel(ndim, deg)

        node_cost = {}
        feasible = True
        for node in topo:
            v = dp_view(node.op, d)
            if v is None:
                feasible = False
                break
            node_cost[node.guid] = (
                cost.op_cost(node.op, v, backward=True), v)
        if not feasible:
            continue
        ends = _balanced_intervals(
            [node_cost[nd.guid][0] for nd in topo], stages)
        stage_of = {}
        stage_guids: List[List[int]] = []
        startp = 0
        for si, e in enumerate(ends):
            stage_guids.append([nd.guid for nd in topo[startp:e]])
            for nd in topo[startp:e]:
                stage_of[nd.guid] = si
            startp = e
        if any(not s for s in stage_guids):
            continue

        # per-stage compute/sync/update/memory
        stage_comp = [0.0] * stages
        stage_sync = [0.0] * stages
        stage_upd = [0.0] * stages
        stage_mem = [0.0] * stages
        for node in topo:
            si = stage_of[node.guid]
            full, v = node_cost[node.guid]
            upd = cost.update_cost(node.op, v)
            stage_comp[si] += full - upd
            stage_upd[si] += upd
            stage_mem[si] += cost.op_memory(node.op, v)
            for ws, annot in zip(node.op._weight_specs,
                                 node.op.propagate(v).weights):
                if annot is None or annot.replica <= 1:
                    continue
                nbytes = ws.dtype.itemsize
                for s_ in ws.shape:
                    nbytes *= s_
                stage_sync[si] += cost.allreduce(
                    nbytes, d, spans_dcn=d > machine.devices_per_host)
        if max(stage_mem) > machine.hbm_capacity:
            continue

        # per-tick hop: widest adjacent-cut crossing (edges may skip
        # stages; a k-stage skip pays k hops — charged as k unit hops)
        hop_bytes = 0.0
        for guid in graph.nodes:
            for e in graph.out_edges[guid]:
                span = stage_of[e.dst] - stage_of[e.src]
                if span > 0:
                    shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
                    hop_bytes = max(
                        hop_bytes,
                        span * shape.num_bytes / m / max(d, 1))
        spans_dcn = n > machine.devices_per_host
        if spans_dcn:
            t_hop = hop_bytes / machine.dcn_bandwidth + machine.dcn_latency
        else:
            t_hop = hop_bytes / machine.ici_bandwidth + machine.ici_latency

        # collective-GPipe: every tick runs all stages on one microbatch
        # each; tick = slowest stage's per-microbatch time + hop; fwd
        # and reversed bwd both pay the hop every tick
        tick = max(stage_comp) / m
        t_compute = (m + stages - 1) * tick
        t_comm = 2.0 * (m + stages - 1) * t_hop
        total = t_compute + t_comm + max(
            s + u for s, u in zip(stage_sync, stage_upd))

        if math.isfinite(total) and (best is None or total < best.cost):
            executable = _applicable(graph, stages) is not None
            best = StagedPipelineProposal(
                num_stages=stages, num_microbatches=m,
                stage_guids=stage_guids, cost=total,
                executable=executable)

    if best is None:
        return None
    margin = max(0.0, config.search_improvement_margin)
    if math.isfinite(baseline_cost) and (
            best.cost >= baseline_cost * (1.0 - margin)):
        return None
    _gate_pipeline_proposal(
        graph, config, best.num_stages, best.num_microbatches,
        stage_guids=best.stage_guids)
    return best
