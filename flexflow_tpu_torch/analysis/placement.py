"""Pipeline/placement proposal legality — SHD150-155: a copy of
flexflow_tpu/analysis/placement.py, on the port's lowerings
(``compiler/placement_lowering.py``'s cut and widths).  The text below
is the reference's.

PR 4 gated every FLAT strategy the search emits (SHD101-110, always-on
in ``optimize_strategy``), but the two proposal classes compile() can
adopt on top of the flat search — pipeline stage cuts
(``search/pipeline_search.py``) and 2-block ``start_part`` placements
(``search/placement_search.py``) — bypassed that gate entirely.  Unity
(OSDI'22) ships its joint parallelization proposals only through a
legality checker; this pass closes the gap with the same always-on
discipline: every proposal is linted before it is returned, persisted
(strategy ``__meta__``) or imported.

Pipeline stage cuts (``lint_pipeline_stages``):

* **SHD150** structure: stage count matches the partition, >= 2
  stages, the device count splits into the stages, microbatch count
  amortizes the bubble (M >= S) and divides the batch, no empty stage,
  no unknown guid
* **SHD151** exact-once node coverage: every graph node in exactly one
  stage (a duplicated node would train twice per tick; an uncovered
  one would never run)
* **SHD152** contiguity / boundary-edge coherence: every edge crosses
  stages FORWARD (stage(src) <= stage(dst)) — equivalently the stage
  prefixes are predecessor-closed topo intervals, the shape both the
  scan lowering and the staged wavefront executor require

``start_part`` placement blocks (``lint_placement``):

* **SHD153** block structure: exactly 2 distinct ``start_part`` blocks
  and the first starts at device 0 (the placed executor's fixed frame)
* **SHD154** device capacity / disjointness: block B starts at or
  after block A's width and fits inside the machine — the EXACT
  overlap/overflow rule ``PlacedCompiledModel.__init__`` enforces
* **SHD155** lowering-schedule agreement: the cut is the one the
  placed executor can actually run — both blocks non-empty, no edge
  from block B back into block A (the fwd_A/step_B/grad_A composition
  is forward-only), the graph sink owned by block B (the loss program
  lives there), and 1..MAX_CROSSING_TENSORS distinct crossing tensors

``lint_placement`` also re-runs the flat SHD101-110 lint PER SEGMENT
against each block's own submesh size — the same per-block device
count the placed lowering compiles each ``CompiledModel`` with — so a
placed proposal passes exactly the gate every flat strategy passes,
in the geometry it will actually execute under.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from flexflow_tpu_torch.analysis.findings import Finding


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="placement", message=message, **kw)


def lint_pipeline_stages(graph, stage_guids: Optional[List[List[int]]],
                         num_stages: int, num_microbatches: int,
                         config) -> List[Finding]:
    """Legality findings for an S-stage pipeline partition of ``graph``
    ([] = legal).  ``stage_guids=None`` checks the scalar structure
    only (a persisted stacked-block proposal records no explicit cut —
    the scan lowering re-derives it from the block names)."""
    findings: List[Finding] = []
    # the device frame the proposal was costed under (search_devices
    # == num_devices except in search-for-a-bigger-machine mode)
    n = getattr(config, "search_devices", 0) or config.num_devices
    if num_stages < 2:
        findings.append(_f(
            "SHD150", f"pipeline proposal has {num_stages} stage(s) — "
            f"inter-op pipelining needs at least 2"))
    elif n % num_stages:
        findings.append(_f(
            "SHD150", f"{n} devices do not split into {num_stages} "
            f"stages"))
    if num_microbatches < max(num_stages, 1):
        findings.append(_f(
            "SHD150",
            f"{num_microbatches} microbatch(es) < {num_stages} stages — "
            f"the (M + S - 1)/M bubble would exceed the pipelining win "
            f"by construction"))
    if num_microbatches >= 1 and config.batch_size % num_microbatches:
        findings.append(_f(
            "SHD150",
            f"batch {config.batch_size} does not divide into "
            f"{num_microbatches} microbatches"))
    if stage_guids is None:
        return findings
    if len(stage_guids) != num_stages:
        findings.append(_f(
            "SHD150",
            f"proposal declares {num_stages} stages but carries "
            f"{len(stage_guids)} stage node lists"))
    stage_of: Dict[int, int] = {}
    dup = False
    for si, stage in enumerate(stage_guids):
        if not stage:
            findings.append(_f("SHD150", f"stage {si} is empty"))
        for guid in stage:
            if guid not in graph.nodes:
                findings.append(_f(
                    "SHD150",
                    f"stage {si} names node {guid} the graph does not "
                    f"have", node=guid))
                continue
            if guid in stage_of:
                dup = True
                findings.append(_f(
                    "SHD151",
                    f"node {guid} ({graph.nodes[guid].op.name!r}) is in "
                    f"stages {stage_of[guid]} and {si} — it would run "
                    f"twice per tick", node=guid,
                    op=graph.nodes[guid].op.name))
            else:
                stage_of[guid] = si
    uncovered = sorted(g for g in graph.nodes if g not in stage_of)
    if uncovered:
        findings.append(_f(
            "SHD151",
            f"{len(uncovered)} graph node(s) in no stage (e.g. "
            f"{[graph.nodes[g].op.name for g in uncovered[:4]]}) — they "
            f"would never execute"))
    if dup or uncovered:
        return findings  # span checks below need a well-defined map
    for guid in graph.nodes:
        for e in graph.out_edges.get(guid, ()):
            if e.dst not in stage_of:
                continue
            if stage_of[e.dst] < stage_of[guid]:
                findings.append(_f(
                    "SHD152",
                    f"edge {graph.nodes[e.src].op.name!r} -> "
                    f"{graph.nodes[e.dst].op.name!r} crosses BACKWARD "
                    f"from stage {stage_of[e.src]} to stage "
                    f"{stage_of[e.dst]} — the stages are not a "
                    f"predecessor-closed topo-interval partition, so no "
                    f"forward wavefront can honor the cut",
                    node=e.src, op=graph.nodes[e.src].op.name))
    return findings


def placement_meta(graph, strategy, config) -> Optional[dict]:
    """The jsonable ``__meta__.placement`` block for a 2-block placed
    strategy: the device-block frame the cut executes under (what
    ``fflint strategy`` can re-check stdlib-only, STR208).  None when
    the strategy is not a 2-block placement."""
    from flexflow_tpu_torch.compiler.placement_lowering import (
        placement_block_widths,
        placement_blocks,
        placement_cut,
    )

    blocks = placement_blocks(strategy)
    if len(blocks) != 2:
        return None
    in_a, in_b, _crossing, _back = placement_cut(graph, strategy)
    n_a, n_b = placement_block_widths(in_a, in_b, strategy)
    return {
        "num_devices": config.num_devices,
        "blocks": [[0, n_a], [blocks[1], n_b]],
    }


def lint_placement(graph, strategy, config) -> List[Finding]:
    """Legality findings for a ``start_part``-carrying placed strategy
    against the placed executor's actual schedule
    (``compiler/placement_lowering.py``) — SHD153-155 plus the flat
    SHD101-110 lint per segment ([] = legal)."""
    from flexflow_tpu_torch.analysis.sharding import lint_strategy
    from flexflow_tpu_torch.compiler.placement_lowering import (
        MAX_CROSSING_TENSORS,
        placement_block_widths,
        placement_blocks,
        placement_cut,
    )

    findings: List[Finding] = []
    blocks = placement_blocks(strategy)
    if len(blocks) != 2:
        return [_f(
            "SHD153",
            f"placed strategy must carry exactly 2 start_part device "
            f"blocks, found start_parts {blocks}")]
    if blocks[0] != 0:
        findings.append(_f(
            "SHD153",
            f"first device block starts at {blocks[0]}, not 0 — the "
            f"placed executor's frame pins block A to device 0"))
    start_b = blocks[1]
    in_a, in_b, crossing, back = placement_cut(graph, strategy)

    # SHD154: the constructor's overlap/overflow rule, via the SHARED
    # width helper (same anti-drift discipline as placement_cut)
    n_a, n_b = placement_block_widths(in_a, in_b, strategy)
    if start_b < n_a:
        findings.append(_f(
            "SHD154",
            f"device blocks overlap: block A needs {n_a} devices from "
            f"0 but block B starts at {start_b}"))
    if start_b + n_b > config.num_devices:
        findings.append(_f(
            "SHD154",
            f"device blocks overflow: block B needs {n_b} devices from "
            f"{start_b} but the machine has {config.num_devices}"))

    # SHD155: the structural cut placeable()/the constructor require
    if not in_a or not in_b:
        findings.append(_f(
            "SHD155", "a placement block is empty — there is no cut to "
            "execute"))
    for e in back:
        findings.append(_f(
            "SHD155",
            f"edge {graph.nodes[e.src].op.name!r} -> "
            f"{graph.nodes[e.dst].op.name!r} flows from block B back "
            f"into block A — the fwd_A/step_B/grad_A composition is "
            f"forward-only", node=e.src, op=graph.nodes[e.src].op.name))
    sinks = graph.sinks()
    b_guids = {n.guid for n in in_b}
    if sinks and sinks[-1].guid not in b_guids:
        findings.append(_f(
            "SHD155",
            f"graph sink {sinks[-1].op.name!r} is not in block B — the "
            f"loss program lives on block B, so a cut whose second "
            f"block does not own the sink has no training step",
            node=sinks[-1].guid, op=sinks[-1].op.name))
    n_crossing = len({(e.src, e.src_idx) for e in crossing})
    if not 0 < n_crossing <= MAX_CROSSING_TENSORS:
        findings.append(_f(
            "SHD155",
            f"{n_crossing} distinct tensors cross the blocks — the "
            f"placed executor supports 1..{MAX_CROSSING_TENSORS}"))
    if findings:
        return findings  # segment lint below needs a coherent frame

    # per-segment flat lint: each block compiles as an ordinary
    # CompiledModel over ITS OWN submesh, so its views must pass the
    # same SHD101-110 gate flat strategies pass — against the block's
    # device count, which is the mesh the lowering will build
    from flexflow_tpu_torch.compiler.placement_lowering import _strip_start

    for members, n_block in ((in_a, n_a), (in_b, n_b)):
        sub = graph._subgraph({n.guid for n in members})
        sub_strategy = {
            n.guid: _strip_start(strategy[n.guid])
            for n in members if strategy.get(n.guid) is not None
        }
        findings += lint_strategy(sub, sub_strategy, n_block)
    return findings
