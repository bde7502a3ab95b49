"""Search-proposed inter-op placement over two disjoint device blocks —
a copy of flexflow_tpu/search/placement_search.py on the port's
``search/dp.py::SearchHelper`` and simulator.  The reference's
``jax.process_count() > 1`` refusal is the port's job over several
hosts (``compiler/placement_lowering.py::_multi_host``).  The text
below is the reference's.

The Unity search's VERTICAL resource splits assign subgraphs to
disjoint device boxes and the mapper executes that placement
(reference: src/runtime/graph.cc:161-295 execute_nonsequence_split;
src/mapper/mapper.cc:371-475).  This framework's flat search costs
every strategy with ``placement_overlap=False`` because its default
execution is ONE SPMD program (small-degree views replicate, offsets
are inert).  This pass closes the loop the other way: it enumerates
2-block cut candidates of the PCG, intra-op-searches each side on its
own device block with the overlap-aware simulator, prices the placed
executor's actual schedule (compiler/placement_lowering.py):

    T_placed = T_A(full step on block A) + T_B(full step on block B)
             + 2 x sum(crossing-tensor moves)        (fwd + cotangent)

and returns the best start_part-carrying strategy that passes
``placeable()`` and beats the flat strategy by the search margin.

The honest win regime is a DCN-spanning machine: each block's weight
syncs stay inside one ICI domain and only the crossing activations pay
DCN — the same mechanism that makes the pipeline proposal win
(search/pipeline_search.py).  On a single ICI domain the flat SPMD
program can spread every op over all devices, so placement rarely wins
there and this pass returns None.
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView

Strategy = Dict[int, MachineView]


def _ancestors(graph: Graph, guid: int) -> Set[int]:
    out: Set[int] = set()
    stack = [e.src for e in graph.in_edges[guid]]
    while stack:
        g = stack.pop()
        if g in out:
            continue
        out.add(g)
        stack.extend(e.src for e in graph.in_edges[g])
    return out


def _cut_candidates(graph: Graph, max_candidates: int = 6,
                    max_crossing: int = 16) -> List[FrozenSet[int]]:
    """Predecessor-closed node sets A (block-0 side of a cut), ranked by
    forward-FLOP balance.  Closure under predecessors guarantees no
    back edges; candidates come from ``A = ancestors(x)`` and
    ``A = ancestors(x) + {x}`` for every interior node x — this covers
    both sequence cuts (x a bottleneck) and join cuts (x a concat whose
    towers land in A), the two shapes the reference's VERTICAL splits
    produce."""
    sinks = graph.sinks()
    if not sinks:
        return []
    sink_guid = sinks[-1].guid
    flops = {g: n.op.flops() for g, n in graph.nodes.items()}
    total = sum(flops.values()) or 1.0
    seen: Set[FrozenSet[int]] = set()
    scored: List[Tuple[float, FrozenSet[int]]] = []
    for guid in graph.nodes:
        if guid == sink_guid:
            continue
        anc = _ancestors(graph, guid)
        for a_set in (frozenset(anc), frozenset(anc | {guid})):
            if not a_set or sink_guid in a_set:
                continue
            if len(a_set) >= graph.num_nodes:
                continue
            if a_set in seen:
                continue
            seen.add(a_set)
            crossing = {
                (e.src, e.src_idx)
                for g in a_set
                for e in graph.out_edges[g]
                if e.dst not in a_set
            }
            if not 0 < len(crossing) <= max_crossing:
                continue
            frac = sum(flops[g] for g in a_set) / total
            # prefer balanced cuts with few crossing tensors
            scored.append((abs(frac - 0.5) + 0.02 * len(crossing), a_set))
    scored.sort(key=lambda t: t[0])
    return [a for _, a in scored[:max_candidates]]


def _budget_pairs(n: int) -> List[Tuple[int, int]]:
    cands = {n // 2, n // 4, n - n // 4}
    return sorted(
        (a, n - a) for a in cands if 0 < a < n
    )


def propose_placement(graph: Graph, config, flat_cost: float,
                      calibration=None) -> Optional[Strategy]:
    """Best 2-block placed strategy whose modeled step time beats
    ``flat_cost`` by more than the search margin, or None."""
    from flexflow_tpu_torch.compiler.placement_lowering import (
        MAX_CROSSING_TENSORS,
        _multi_host,
        placeable,
    )
    from flexflow_tpu_torch.search.dp import SearchHelper
    from flexflow_tpu_torch.search.simulator import Simulator

    n = config.search_devices
    if n < 2 or _multi_host():
        return None
    if getattr(config, "grad_accum_steps", 1) > 1:
        return None
    if getattr(config, "zero_dp_shard", False):
        return None
    if graph.num_nodes > config.placement_search_max_nodes:
        return None

    sim = Simulator.for_config(
        config, calibration=calibration, placement_overlap=True
    )
    helper = SearchHelper(sim, n)
    best: Optional[Tuple[float, Strategy]] = None
    for a_set in _cut_candidates(
            graph, max_crossing=MAX_CROSSING_TENSORS):
        b_set = set(graph.nodes) - a_set
        graph_a = graph._subgraph(set(a_set))
        graph_b = graph._subgraph(b_set)
        # distinct crossing TENSORS: the placed executor transfers each
        # (src, src_idx) exactly once however many B-side consumers it
        # has (placement_lowering boundary_srcs is the same set)
        crossing = sorted({
            (e.src, e.src_idx)
            for g in a_set
            for e in graph.out_edges[g]
            if e.dst not in a_set
        })
        dph = getattr(sim.machine, "devices_per_host", 0) or n
        for a, b in _budget_pairs(n):
            ca, sa = helper.graph_cost(graph_a, budget=a, start=0)
            if not math.isfinite(ca):
                continue
            cb, sb = helper.graph_cost(graph_b, budget=b, start=a)
            if not math.isfinite(cb):
                continue
            # the boundary crosses DCN when block B extends beyond block
            # A's hosts — exactly the regime this pass targets, so the
            # move must be priced at DCN speed there, not ICI
            spans_dcn = (a + b - 1) // dph > (a - 1) // dph
            moves = 0.0
            for src, idx in crossing:
                node = graph.nodes[src]
                mv = sa.get(src)
                osh = sim._propagate(node, mv) if mv is not None else None
                annot = (
                    osh.outputs[idx]
                    if osh is not None and idx < len(osh.outputs)
                    else None
                )
                shape = node.op.output_shapes[idx]
                # activation forward + cotangent back, each one
                # cross-block move
                moves += 2.0 * sim.cost.placement_move_cost(
                    shape, annot, spans_dcn=spans_dcn)
            total = ca + cb + moves
            if best is None or total < best[0]:
                merged = dict(sa)
                merged.update(sb)
                best = (total, merged)

    if best is None:
        return None
    margin = max(0.0, config.search_improvement_margin)
    # flat_cost == inf (flat strategy HBM-infeasible): any finite placed
    # candidate wins outright
    if math.isfinite(flat_cost) and best[0] >= flat_cost * (1.0 - margin):
        return None
    strategy = best[1]
    if not placeable(graph, strategy, config):
        return None
    # always-on legality gate (analysis/placement.py, SHD153-155 +
    # per-segment SHD101-110) — the same discipline optimize_strategy
    # applies to flat results: a proposal that fails is a SEARCH bug
    # and must fail loudly here, not inside XLA or, worse, never
    from flexflow_tpu_torch.analysis import (
        AnalysisError,
        emit_findings,
        errors_only,
        lint_placement,
    )

    bad = errors_only(lint_placement(graph, strategy, config))
    if bad:
        emit_findings(bad)
        raise AnalysisError(
            "placement search produced an illegal 2-block placed "
            "strategy", bad)
    from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

    log.log(
        f"placement search: 2-block placed strategy modeled "
        f"{best[0] * 1e3:.3f} ms/iter beats flat "
        f"{flat_cost * 1e3:.3f} ms/iter"
    )
    return strategy
