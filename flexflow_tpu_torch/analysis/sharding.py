"""Strategy/sharding legality linter — pass 3 of the static-analysis
stack; the ``lint_strategy``, ``lint_sync_schedule``, ``lint_zero_map``
and ``lint_reduction_plan`` part of flexflow_tpu/analysis/sharding.py,
copied (GSPMD-style, arXiv:2105.04663: sharding consistency is a
decidable static check; arXiv:2110.10548: placement legality as a
constraint system).

For a (graph, ``{guid: MachineView}``) pair this proves what the
lowering (``compiler/lowering.py``) will otherwise discover when it
runs — or worse, not discover at all:

* **SHD101** view rank matches the op's output rank
* **SHD102** every partitioned dim is divisible by its degree
* **SHD103** mesh-capacity fit: total parts divide the device count
  (the divisor rule ``views.boundary_views``/``candidate_views``
  generate under; an imported or cache-served strategy may not)
* **SHD104** ops with a pinned view (``fixed_machine_view``) get it
* **SHD105** the op's own degree propagation accepts the view
* **SHD106** only splittable dims are partitioned; replica degree
  within ``max_replica_degree``
* **SHD107** propagation/lowering coherence: every sharded dim of every
  propagated annotation maps to a view slot of EXACTLY its degree, and
  no slot is consumed twice by one tensor — the condition under which
  ``parallel.mesh.placement`` lays the tensor out with the annotated
  degrees (search/lowering drift check)
* **SHD108** the view's degrees factor onto the mesh's prime-factor
  axis pool (``view_slot_axes`` succeeds — what the lowering will run)
* **SHD109** strategy coverage: every node has a view
* **SHD110** per-edge compatibility: a consumer's input constraint has
  the rank of the producer's output (boundary-view handoff, the
  invariant split-boundary enumeration relies on —
  ``views.boundary_views`` pins one view to both segments)

Gradient-sync SCHEDULE legality (``lint_sync_schedule`` — the
searched, persisted comm plan of search/sync_schedule.py, gated
always-on wherever a schedule is produced or imported):

* **SHD120** structural sanity: bucket precision is a known wire
  precision; every named op exists in the graph and carries weights
* **SHD121** coverage: every weight group that actually syncs under the
  strategy is covered EXACTLY once (no duplicates, no holes — an
  uncovered group silently falls back to the exposed post-backward
  monolithic path)
* **SHD122** issue order respects grad readiness: buckets are ordered
  by non-increasing earliest-member topo position — the backward
  produces grads in reverse topo order, so a bucket issued before its
  grads exist is a plan the executed step cannot honor
* **SHD123** precision coherence: a compressed bucket's ops must be
  gradient-safe to compress and agree with the sync-precision map
  (search/sync_precision.py) — the two artifacts are built together
  and must not contradict

Per-group optimizer-state sharding legality (``lint_zero_map`` — the
co-searched ZeRO-1 dimension of search/comm_plan.py, gated always-on
wherever the map is produced or imported):

* **SHD140** membership: every named op exists in the graph, carries
  weights, and actually SYNCS under the strategy (some propagated
  weight annot is replicated — optimizer state only shards over
  replication axes, so a non-synced entry is incoherent)
* **SHD141** shardability: the op's achieved ZeRO shard factor under
  the shared placement rule (``comm_plan.zero_update_factor`` — the
  same evenly-divisible ``place_zero_factors`` rule the lowering's
  ``_zero_augmented`` and ``CostModel.op_memory`` apply) must exceed
  1 — a map entry whose optimizer state cannot shard was credited a
  win execution will never realize

Staged REDUCTION-PLAN legality (``lint_reduction_plan`` — the
per-bucket hierarchical reduction strategies of
search/reduction_plan.py, gated always-on with the schedule):

* **SHD130** structural sanity: stages form the canonical RS..AR..AG
  bracketing, kinds/precisions known, levels within the machine's
  link hierarchy
* **SHD131** level coverage: the plan's cross level equals the deepest
  link level the bucket's replication groups actually span — too
  shallow leaves the coarse links mispriced, too deep prices stages
  the wire never runs
* **SHD132** group/slice coherence: a staged bucket must contain at
  least one group whose replication provably decomposes across the
  slice boundary (a plan on a within-slice bucket is incoherent)
* **SHD133** precision-per-level validity: only the cross-level
  allreduce stage may compress, and its wire precision must be fp32 or
  the bucket's own (sync-precision-map-coherent) precision — per-level
  precision composes with the map, never contradicts it

The serving gates are the reference's too (sharding.py:584-1170):
``lint_serving`` (SHD160-163) and ``lint_kv`` (SHD168-169) on every
serve-objective result, fresh, cache-served or imported;
``lint_disaggregation`` (SHD164-165) on a two-block prefill/decode
proposal; ``lint_fleet`` (SHD166-167) on an N-replica fleet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from flexflow_tpu_torch.analysis.findings import Finding, errors_only


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="sharding", message=message, **kw)


def _annot_findings(annot, slot_sizes, what: str, guid, name) -> List[Finding]:
    """SHD107 for one propagated ShardAnnot."""
    out: List[Finding] = []
    used = set()
    idx = annot.parallel_idx()
    for i, (deg, slot) in enumerate(zip(annot.degrees, idx)):
        if deg <= 1:
            continue
        if slot == -1 or slot not in slot_sizes:
            out.append(_f(
                "SHD107",
                f"{what} dim {i} sharded {deg}-way but maps to no view "
                f"slot", node=guid, op=name))
        elif slot_sizes[slot] != deg:
            out.append(_f(
                "SHD107",
                f"{what} dim {i} annotated degree {deg} but its view "
                f"slot {slot} has degree {slot_sizes[slot]} — the "
                f"lowered PartitionSpec would realize a different "
                f"sharding", node=guid, op=name))
        elif slot in used:
            out.append(_f(
                "SHD107",
                f"{what} maps two dims onto view slot {slot} — the "
                f"PartitionSpec would reuse mesh axes", node=guid, op=name))
        else:
            used.add(slot)
    return out


def lint_strategy(graph, strategy: Dict[int, object],
                  num_devices: int) -> List[Finding]:
    """All legality findings for a (graph, MachineView map) pair on a
    ``num_devices`` mesh ([] = legal).  ``start_part`` offsets are
    placement hints the GSPMD lowering ignores and are not linted."""
    from flexflow_tpu_torch.ops.base import REPLICA_SLOT
    from flexflow_tpu_torch.parallel.mesh import mesh_axis_sizes, view_slot_axes

    findings: List[Finding] = []
    axis_pool = mesh_axis_sizes(num_devices)

    for node in graph.topo_order():
        guid, op = node.guid, node.op
        name = getattr(op, "name", None)
        out_shapes = getattr(op, "output_shapes", None)
        if not out_shapes:
            continue
        out = out_shapes[0]
        mv = strategy.get(guid)
        if mv is None:
            findings.append(_f(
                "SHD109", "node has no view in the strategy",
                node=guid, op=name))
            continue
        if len(mv.dim_degrees) != out.ndim:
            findings.append(_f(
                "SHD101",
                f"view {mv} has {len(mv.dim_degrees)} dim degrees but "
                f"the op output has rank {out.ndim}", node=guid, op=name))
            continue  # every later check indexes dims by rank
        for d, deg in enumerate(mv.dim_degrees):
            if deg < 1:
                findings.append(_f(
                    "SHD102", f"dim {d} degree {deg} < 1",
                    node=guid, op=name))
            elif deg > 1 and out.sizes[d] % deg != 0:
                findings.append(_f(
                    "SHD102",
                    f"dim {d} (size {out.sizes[d]}) not divisible by "
                    f"degree {deg}", node=guid, op=name))
        parts = mv.num_parts
        if parts > num_devices or num_devices % max(1, parts) != 0:
            findings.append(_f(
                "SHD103",
                f"view {mv} needs {parts} parts on a {num_devices}-device "
                f"mesh (must divide)", node=guid, op=name))
        fixed = op.fixed_machine_view() if hasattr(
            op, "fixed_machine_view") else None
        if fixed is not None:
            if (mv.dim_degrees != fixed.dim_degrees
                    or mv.replica_degree != fixed.replica_degree):
                findings.append(_f(
                    "SHD104",
                    f"op pins view {fixed} but the strategy assigns {mv}",
                    node=guid, op=name))
                continue  # propagate would assert; already reported
        elif hasattr(op, "splittable_output_dims"):
            splittable = set(op.splittable_output_dims())
            for d, deg in enumerate(mv.dim_degrees):
                if deg > 1 and d not in splittable:
                    findings.append(_f(
                        "SHD106",
                        f"dim {d} partitioned {deg}-way but the op only "
                        f"splits dims {sorted(splittable)}",
                        node=guid, op=name))
            max_r = op.max_replica_degree()
            r = mv.replica_degree
            if r > 1 and (r > max_r or max_r % r != 0):
                findings.append(_f(
                    "SHD106",
                    f"replica degree {r} outside the op's contraction "
                    f"capacity {max_r}", node=guid, op=name))
        osh = None
        try:
            osh = op.propagate(mv)
        except AssertionError as e:
            findings.append(_f(
                "SHD105", f"degree propagation rejected {mv}: {e}",
                node=guid, op=name))
        except Exception as e:  # malformed views can out-of-range index
            findings.append(_f(
                "SHD105",
                f"degree propagation failed on {mv}: "
                f"{type(e).__name__}: {e}", node=guid, op=name))
        slot_axes: Optional[dict] = None
        if parts <= num_devices and num_devices % max(1, parts) == 0:
            try:
                slot_axes = view_slot_axes(mv, axis_pool)
            except ValueError as e:
                findings.append(_f(
                    "SHD108",
                    f"view {mv} does not factor onto the mesh axis pool "
                    f"{axis_pool}: {e}", node=guid, op=name))
        if osh is not None and slot_axes is not None:
            slot_sizes = {i: d for i, d in enumerate(mv.dim_degrees)}
            slot_sizes[REPLICA_SLOT] = mv.replica_degree
            for i, annot in enumerate(osh.outputs):
                findings += _annot_findings(
                    annot, slot_sizes, f"output {i}", guid, name)
            for i, annot in enumerate(osh.weights):
                findings += _annot_findings(
                    annot, slot_sizes, f"weight {i}", guid, name)
            for i, annot in enumerate(osh.inputs):
                if annot is not None:
                    findings += _annot_findings(
                        annot, slot_sizes, f"input {i}", guid, name)
            # SHD110: consumer input constraints must have the rank of
            # the tensor the edge actually carries
            for e in graph.in_edges.get(guid, ()):
                producer = graph.nodes.get(e.src)
                if producer is None:
                    continue
                p_outs = getattr(producer.op, "output_shapes", None)
                if p_outs is None or e.src_idx >= len(p_outs):
                    continue  # invariants pass owns that failure
                if e.dst_idx < len(osh.inputs):
                    annot = osh.inputs[e.dst_idx]
                    if (annot is not None
                            and len(annot.degrees) != p_outs[e.src_idx].ndim):
                        findings.append(_f(
                            "SHD110",
                            f"input {e.dst_idx} constraint has rank "
                            f"{len(annot.degrees)} but the producing edge "
                            f"carries a rank-{p_outs[e.src_idx].ndim} "
                            f"tensor", node=guid, op=name))
    return findings


def _s(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="sync_schedule", message=message,
                   **kw)


def lint_sync_schedule(graph, strategy: Dict[int, object], schedule,
                       precision_map: Optional[Dict[str, str]] = None,
                       ) -> List[Finding]:
    """Legality findings for a gradient-sync schedule against its
    (graph, strategy) — SHD120-123 ([] = legal).  ``schedule`` is a
    ``search.sync_schedule.SyncSchedule`` or any duck-typed bucket list
    (objects with ``.name``/``.ops``/``.precision``)."""
    # one source of truth for legal wire precisions: the schedule
    # module is deliberately torch-free, so this stays pure host-side
    from flexflow_tpu_torch.search.sync_schedule import (
        BUCKET_PRECISIONS as _BUCKET_PRECISIONS,
    )

    findings: List[Finding] = []
    buckets = list(getattr(schedule, "buckets", schedule) or [])
    if not buckets:
        return [_s("SHD121", "schedule has no buckets")]

    # which ops actually sync under this strategy (some propagated
    # weight annot is replicated) — the coverage universe
    pos: Dict[str, int] = {}
    synced: Dict[str, bool] = {}
    weighted: Dict[str, object] = {}
    for i, node in enumerate(graph.topo_order()):
        name = getattr(node.op, "name", None)
        if name is None:
            continue
        pos[name] = i
        if not getattr(node.op, "_weight_specs", ()):
            continue
        weighted[name] = node.op
        mv = strategy.get(node.guid)
        if mv is None and hasattr(node.op, "fixed_machine_view"):
            mv = node.op.fixed_machine_view()
        if mv is None:
            continue
        try:
            osh = node.op.propagate(mv)
        except Exception:
            continue  # SHD105 owns that failure
        synced[name] = any(
            a is not None and a.replica > 1 for a in osh.weights)

    seen: Dict[str, str] = {}  # op name -> bucket that claimed it
    prev_min_pos: Optional[int] = None
    prev_name: Optional[str] = None
    pmap = precision_map or {}
    for bucket in buckets:
        bname = getattr(bucket, "name", "?")
        prec = getattr(bucket, "precision", "fp32")
        if prec not in _BUCKET_PRECISIONS:
            findings.append(_s(
                "SHD120",
                f"bucket {bname!r} carries unknown precision {prec!r} "
                f"(known: {list(_BUCKET_PRECISIONS)})"))
        min_pos: Optional[int] = None
        for op_name in getattr(bucket, "ops", ()):
            if op_name not in pos:
                findings.append(_s(
                    "SHD120",
                    f"bucket {bname!r} names op {op_name!r} the graph "
                    f"does not have", op=op_name))
                continue
            if op_name not in weighted:
                findings.append(_s(
                    "SHD120",
                    f"bucket {bname!r} names op {op_name!r}, which "
                    f"carries no weights to sync", op=op_name))
                continue
            if op_name in seen:
                findings.append(_s(
                    "SHD121",
                    f"op {op_name!r} is covered twice (buckets "
                    f"{seen[op_name]!r} and {bname!r}) — its gradient "
                    f"would sync twice", op=op_name))
            seen[op_name] = bname
            p = pos[op_name]
            min_pos = p if min_pos is None else min(min_pos, p)
            if prec != "fp32":
                from flexflow_tpu_torch.search.sync_precision import (
                    grad_safe_to_compress,
                )

                mapped = pmap.get(op_name, "fp32")
                if mapped != prec:
                    findings.append(_s(
                        "SHD123",
                        f"bucket {bname!r} compresses {op_name!r} at "
                        f"{prec} but the sync-precision map says "
                        f"{mapped!r} — the two artifacts contradict",
                        op=op_name))
                elif not grad_safe_to_compress(weighted[op_name]):
                    findings.append(_s(
                        "SHD123",
                        f"bucket {bname!r} compresses {op_name!r}, which "
                        f"the gradient-safety heuristic excludes",
                        op=op_name))
        if min_pos is None:
            continue
        if prev_min_pos is not None and min_pos > prev_min_pos:
            findings.append(_s(
                "SHD122",
                f"issue order violates grad readiness: bucket "
                f"{prev_name!r} (earliest member at topo position "
                f"{prev_min_pos}) issues BEFORE bucket {bname!r} "
                f"(earliest member at {min_pos}), but the backward "
                f"produces {bname!r}'s grads first — the serialized "
                f"collective chain would stall a ready bucket behind "
                f"one whose grads do not exist yet"))
        prev_min_pos, prev_name = min_pos, bname
    uncovered = sorted(
        n for n, is_synced in synced.items() if is_synced and n not in seen)
    if uncovered:
        findings.append(_s(
            "SHD121",
            f"{len(uncovered)} synced weight group(s) uncovered (e.g. "
            f"{uncovered[:4]}) — they would fall back to the exposed "
            f"post-backward monolithic sync"))
    return findings


def _z(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="zero_map", message=message, **kw)


def lint_zero_map(graph, strategy: Dict[int, object], zero_map,
                  cost_model) -> List[Finding]:
    """Legality findings for a per-group optimizer-state sharding map
    (op names whose ZeRO-1 state/update shards — search/comm_plan.py
    ``choose_zero_groups``) against its (graph, strategy) — SHD140/141
    ([] = legal, and an empty map trivially is).  ``cost_model``
    supplies the device count for the shared placement rule, so a map
    that lints clean is credited and executed coherently."""
    from flexflow_tpu_torch.search.comm_plan import zero_update_factor

    names = list(zero_map or ())
    if not names:
        return []
    findings: List[Finding] = []
    by_name: Dict[str, object] = {}
    mv_of: Dict[str, object] = {}
    for node in graph.topo_order():
        n = getattr(node.op, "name", None)
        if n is None:
            continue
        by_name[n] = node.op
        mv = strategy.get(node.guid)
        if mv is None and hasattr(node.op, "fixed_machine_view"):
            mv = node.op.fixed_machine_view()
        mv_of[n] = mv
    seen = set()
    for name in names:
        if name in seen:
            findings.append(_z(
                "SHD140", f"op {name!r} appears twice in the "
                f"optimizer-sharding map", op=name))
            continue
        seen.add(name)
        op = by_name.get(name)
        if op is None:
            findings.append(_z(
                "SHD140", f"optimizer-sharding map names op {name!r} "
                f"the graph does not have", op=name))
            continue
        if not getattr(op, "_weight_specs", ()):
            findings.append(_z(
                "SHD140", f"op {name!r} carries no weights — nothing "
                f"to shard optimizer state for", op=name))
            continue
        mv = mv_of.get(name)
        if mv is None:
            from flexflow_tpu_torch.core.machine import MachineView

            mv = MachineView.trivial(op.output_shapes[0].ndim)
        synced = False
        try:
            osh = op.propagate(mv)
            synced = any(
                a is not None and a.replica > 1 for a in osh.weights)
        except Exception:
            pass  # SHD105 owns propagation failures
        if not synced:
            findings.append(_z(
                "SHD140", f"op {name!r} has no replicated weight under "
                f"this strategy — optimizer state only shards over "
                f"replication axes, so the entry is incoherent",
                op=name))
            continue
        f = zero_update_factor(cost_model, op, mv)
        if f <= 1.0:
            findings.append(_z(
                "SHD141", f"op {name!r} achieves no ZeRO shard factor "
                f"under the shared placement rule (achieved {f:g}) — "
                f"the credited update win would never be realized",
                op=name))
    return findings


def _p(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="reduction_plan", message=message,
                   **kw)


def lint_reduction_plan(graph, strategy: Dict[int, object], schedule,
                        cost_model) -> List[Finding]:
    """Legality findings for the staged reduction plans a schedule's
    buckets carry, against (graph, strategy, machine) — SHD130-133
    ([] = legal; a plan-free schedule is trivially legal).
    ``cost_model`` supplies the link hierarchy and the slot→axis
    replica decomposition — the SAME classifier the pricing used, so a
    plan that lints clean is priced and executed coherently."""
    from flexflow_tpu_torch.search.reduction_plan import validate_stages_split
    from flexflow_tpu_torch.search.sync_schedule import synced_weight_groups

    buckets = list(getattr(schedule, "buckets", schedule) or [])
    if not any(getattr(b, "plan", None) is not None for b in buckets):
        return []
    findings: List[Finding] = []
    levels = cost_model.levels()
    num_levels = len(levels)
    parts_by_op: Dict[str, list] = {}
    for node, _mv, parts in synced_weight_groups(graph, strategy,
                                                 cost_model):
        parts_by_op[node.op.name] = parts
    for bucket in buckets:
        plan = getattr(bucket, "plan", None)
        if plan is None:
            continue
        bname = getattr(bucket, "name", "?")
        structural, prec_errs = validate_stages_split(
            plan.stages, num_levels)
        for e in structural:
            findings.append(_p(
                "SHD130", f"bucket {bname!r} plan {plan.name!r}: {e}"))
        for e in prec_errs:
            findings.append(_p(
                "SHD133", f"bucket {bname!r} plan {plan.name!r}: {e}"))
        if structural:
            continue
        # group/slice coherence + level coverage
        deepest = 0
        spanning = 0
        for op in getattr(bucket, "ops", ()):
            for part in parts_by_op.get(op, ()):
                _nbytes, replica, _spans, _n, key = part
                if replica <= 1:
                    continue
                factors = cost_model.replica_level_split(key, replica)
                if factors is None:
                    continue
                d = max((i for i, f in enumerate(factors) if f > 1),
                        default=0)
                deepest = max(deepest, d)
                if d > 0:
                    spanning += 1
        if spanning == 0:
            findings.append(_p(
                "SHD132",
                f"bucket {bname!r} carries staged plan {plan.name!r} but "
                f"none of its replication groups provably spans a slice "
                f"boundary — the staged stages have no cross-level wire "
                f"to ride"))
        elif plan.cross_level != deepest:
            findings.append(_p(
                "SHD131",
                f"bucket {bname!r} plan {plan.name!r} reaches link level "
                f"{plan.cross_level} but the bucket's groups span level "
                f"{deepest} — the plan's level coverage does not match "
                f"the topology the groups actually cross"))
        # SHD133: cross precision composes with the bucket precision
        # (int8_ef buckets stage at the plain int8 wire — wire_base)
        from flexflow_tpu_torch.search.sync_schedule import wire_base

        bprec = getattr(bucket, "precision", "fp32")
        for s in plan.stages:
            if s.kind == "allreduce" and s.precision not in (
                    "fp32", wire_base(bprec)):
                findings.append(_p(
                    "SHD133",
                    f"bucket {bname!r} plan {plan.name!r} compresses the "
                    f"cross-level allreduce at {s.precision} but the "
                    f"bucket's (sync-precision-map-coherent) precision "
                    f"is {bprec!r} — per-level precision must compose "
                    f"with the map, not contradict it"))
    return findings


# ---------------------------------------------------------------------------
# serving-objective legality (SHD160-163)
# ---------------------------------------------------------------------------
def _srv(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="serving", message=message, **kw)


def lint_serving(graph, strategy: Dict[int, object], serving,
                 cost_model, predicted_p99_s: Optional[float] = None,
                 ) -> List[Finding]:
    """Legality of a serve-objective result against its ServingSpec
    (search/serving.py) — the always-on gate ``optimize_strategy`` runs
    under ``FFConfig.objective="serve"`` before the strategy is
    returned, persisted or imported:

    * **SHD160** spec/graph coherence: the spec's frame geometry
      (max_seqs, page_size, pages_per_seq) is positive and matches
      every decode op's own attrs; the graph HAS decode ops (a serve
      artifact for a graph with nothing ragged is a provenance bug);
      the arrival quantile lies in (0, 1).
    * **SHD161** KV residency fits: per-device memory under the
      strategy — weights + activations + every decode op's page pool
      at FULL occupancy — must fit the machine's HBM capacity (the
      "rejected during search, not at OOM" budget, checked again here
      so imported/cached artifacts cannot smuggle an over-budget map).
    * **SHD162** decode view legality: each decode op's replica (head
      split) degree must divide its head count and the batch degree
      must divide the frame's sequence slots — frames shard evenly or
      the executor's fixed frame composition breaks.
    * **SHD163** SLO coherence (warn): a declared p99 budget that the
      PREDICTED p99 already exceeds is reported — the deployment is
      mis-sized, but prediction is not proof, so this warns rather
      than gates.
    """
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.search.serving import decode_nodes

    findings: List[Finding] = []
    nodes = decode_nodes(graph)
    if serving is None:
        return [_srv("SHD160", "serve artifact carries no serving spec")]
    if not nodes:
        return [_srv(
            "SHD160",
            "serve objective on a graph with no decode-attention ops — "
            "nothing here is ragged; the artifact's objective is "
            "mislabeled")]
    if (serving.max_seqs < 1 or serving.page_size < 1
            or serving.pages_per_seq < 1):
        findings.append(_srv(
            "SHD160",
            f"serving spec has non-positive frame geometry "
            f"(max_seqs={serving.max_seqs}, "
            f"page_size={serving.page_size}, "
            f"pages_per_seq={serving.pages_per_seq})"))
    if not (0.0 < serving.quantile < 1.0):
        findings.append(_srv(
            "SHD160",
            f"arrival quantile {serving.quantile} outside (0, 1)"))
    if serving.p99_budget_ms < 0:
        findings.append(_srv(
            "SHD163",
            f"declared p99 budget is negative "
            f"({serving.p99_budget_ms} ms)"))
    mem = 0.0
    for node in graph.topo_order():
        mv = strategy.get(node.guid)
        if mv is None:
            mv = node.op.fixed_machine_view() or MachineView.trivial(
                node.op.output_shapes[0].ndim)
        if node in nodes:
            geo = (node.op.max_seqs, node.op.attrs["page_size"],
                   node.op.attrs["pages_per_seq"])
            if geo != (serving.max_seqs, serving.page_size,
                       serving.pages_per_seq):
                findings.append(_srv(
                    "SHD160",
                    f"decode op frame geometry {geo} disagrees with the "
                    f"serving spec "
                    f"({serving.max_seqs}, {serving.page_size}, "
                    f"{serving.pages_per_seq})",
                    node=node.guid, op=node.op.name))
            r = max(mv.replica_degree, 1)
            heads = node.op.attrs["num_heads"]
            if heads % r != 0:
                findings.append(_srv(
                    "SHD162",
                    f"head-split degree {r} does not divide the op's "
                    f"{heads} heads", node=node.guid, op=node.op.name))
            b = max(mv.dim_degrees[0], 1) if mv.dim_degrees else 1
            if node.op.max_seqs % b != 0:
                findings.append(_srv(
                    "SHD162",
                    f"batch degree {b} does not divide the frame's "
                    f"{node.op.max_seqs} sequence slots — frames cannot "
                    f"shard evenly", node=node.guid, op=node.op.name))
        m = cost_model.op_memory(node.op, mv)
        if math.isfinite(m):  # NaN/inf views: SHD105's propagation
            mem += m  # findings own those failures
    cap = cost_model.machine.hbm_capacity
    if mem > cap:
        findings.append(_srv(
            "SHD161",
            f"per-device memory under this strategy "
            f"({mem / 1e9:.2f} GB incl. full-occupancy KV residency) "
            f"exceeds the HBM capacity ({cap / 1e9:.2f} GB) — the "
            f"decode deployment cannot hold its page pool"))
    if (predicted_p99_s is not None and serving.p99_budget_ms > 0
            and predicted_p99_s * 1e3 > serving.p99_budget_ms):
        findings.append(_srv(
            "SHD163",
            f"predicted p99 decode latency "
            f"({predicted_p99_s * 1e3:.3f} ms) exceeds the declared "
            f"SLO budget ({serving.p99_budget_ms:.3f} ms)",
            severity="warn"))
    return findings


# ---------------------------------------------------------------------------
# KV-lane legality (SHD168/169)
# ---------------------------------------------------------------------------
def lint_kv(graph, strategy: Dict[int, object], kv_meta,
            serving=None) -> List[Finding]:
    """Legality of a KV-lane result (``__meta__.kv``,
    FFConfig.kv_precision / serve_shared_prefix_pages) against the
    decode graph it targets — the always-on gate the driver runs on
    fresh AND cache-served serve results, re-run at import before the
    dtype is adopted onto the graph's decode ops:

    * **SHD168** sharing/refcount accounting coherence (see module
      docstring): shared_prefix_pages in [0, pages_per_seq), coherent
      with the armed ServingSpec, and the recorded
      shared_residency_factor equal to the refcount arithmetic
      ``(max_seqs*(pps-s)+s) / (max_seqs*pps)``.
    * **SHD169** pool-dtype legality: dtype in fp32/bf16/int8; decode
      ops' own ``kv_dtype`` attrs (pre-adoption these are absent —
      vacuously coherent) agree with the meta and each other; int8
      carries "page_slot" scales, fp32/bf16 carry none.
    """
    from flexflow_tpu_torch.search.serving import decode_nodes

    findings: List[Finding] = []
    if not isinstance(kv_meta, dict):
        return [_srv("SHD169",
                     f"__meta__.kv is not a mapping: {type(kv_meta).__name__}")]
    nodes = decode_nodes(graph)
    if not nodes:
        return [_srv(
            "SHD169",
            "kv lane armed on a graph with no decode-attention ops — "
            "there is no page pool to retype or share")]
    # ---- SHD169: pool dtype discipline ----------------------------------
    dtype = kv_meta.get("dtype")
    if dtype not in ("fp32", "bf16", "int8"):
        findings.append(_srv(
            "SHD169",
            f"__meta__.kv pool dtype {dtype!r} is not one of "
            f"fp32|bf16|int8"))
    layout = kv_meta.get("scale_layout", "none")
    if dtype == "int8" and layout != "page_slot":
        findings.append(_srv(
            "SHD169",
            f"int8 pool requires per-(page, slot) scales "
            f"(scale_layout='page_slot'), got {layout!r} — dequant "
            f"inside the page loop has no scales to read"))
    if dtype in ("fp32", "bf16") and layout not in ("none", None):
        findings.append(_srv(
            "SHD169",
            f"{dtype} pool must not carry scales "
            f"(scale_layout={layout!r}) — a scale tensor nothing "
            f"dequants is residency the pricing never saw"))
    op_dtypes = {n.op.attrs.get("kv_dtype", None) for n in nodes}
    declared = {d for d in op_dtypes if d is not None}
    if len(declared) > 1:
        findings.append(_srv(
            "SHD169",
            f"decode ops disagree on kv_dtype ({sorted(declared)}) — "
            f"one page pool cannot hold two dtypes"))
    elif declared and dtype in ("fp32", "bf16", "int8") \
            and declared != {dtype}:
        findings.append(_srv(
            "SHD169",
            f"decode ops carry kv_dtype={next(iter(declared))!r} but "
            f"__meta__.kv persists {dtype!r} — the artifact does not "
            f"describe the graph it rides"))
    # ---- SHD168: sharing accounting coherence ---------------------------
    pps = nodes[0].op.attrs["pages_per_seq"]
    max_seqs = nodes[0].op.max_seqs
    shared = kv_meta.get("shared_prefix_pages", 0)
    if not isinstance(shared, int) or shared < 0 or shared >= pps:
        findings.append(_srv(
            "SHD168",
            f"shared_prefix_pages={shared!r} outside [0, "
            f"pages_per_seq={pps}) — a sequence cannot share its whole "
            f"allotment (the last token's scatter needs a private "
            f"page)"))
        shared = 0
    if serving is not None:
        sv = int(getattr(serving, "shared_prefix_pages", 0) or 0)
        if sv != shared:
            findings.append(_srv(
                "SHD168",
                f"__meta__.kv declares shared_prefix_pages={shared} "
                f"but the serving spec prices {sv} — residency was "
                f"ranked under sharing the artifact does not record"))
    factor = kv_meta.get("shared_residency_factor", 1.0)
    expect = 1.0
    if shared and max_seqs > 0 and pps > 0:
        expect = (max_seqs * (pps - shared) + shared) / float(
            max_seqs * pps)
    try:
        ok = abs(float(factor) - expect) <= 1e-9
    except (TypeError, ValueError):
        ok = False
    if not ok:
        findings.append(_srv(
            "SHD168",
            f"shared_residency_factor={factor!r} does not match the "
            f"refcount arithmetic for shared_prefix_pages={shared} "
            f"over a {max_seqs}x{pps}-page frame (expected "
            f"{expect:.9f}) — the residency discount is not the one "
            f"the allocator's refcounts deliver"))
    return findings


# ---------------------------------------------------------------------------
# prefill/decode disaggregation legality (SHD164/165)
# ---------------------------------------------------------------------------
def lint_disaggregation(decode_graph, meta, config, prefill_graph=None,
                        prefill_strategy=None, decode_strategy=None,
                        ) -> List[Finding]:
    """Legality of a disaggregation proposal/artifact
    (``__meta__.disaggregation``, search/disaggregation.py) against the
    decode graph it targets — the always-on gate at proposal time and
    the re-lint at import:

    * **SHD164** two-block structure: positive prefill/decode block
      widths that are disjoint and fit the machine; a chunk size >= 1;
      the decode graph actually HAS decode-attention ops (and the
      prefill graph, when available, has none — a decode op on the
      prefill block would drag the page pool across the cut).
    * **SHD165** handoff coherence: the persisted pool geometry
      (max_seqs, page_size, pages_per_seq) matches every decode op's
      own attrs — ONE allocator's pages cross the boundary, so the
      writer and the reader must agree on the frame; the prefill graph
      shares one parameter set with the decode graph
      (``prefill_weight_bridge``); the SLO-class table is structurally
      sound (unique names, non-negative deadlines, quantiles in
      (0, 1)).

    When per-phase strategies are supplied (proposal time), each block
    additionally passes the flat SHD101-110 lint under ITS OWN submesh
    width — the same per-segment discipline as ``lint_placement``."""
    from flexflow_tpu_torch.search.serving import decode_nodes

    def _d(code, message, **kw):
        return Finding(code=code, pass_name="disaggregation",
                       message=message, **kw)

    findings: List[Finding] = []
    if not isinstance(meta, dict):
        return [_d("SHD164", "disaggregation meta is not an object")]
    nodes = decode_nodes(decode_graph)
    if not nodes:
        findings.append(_d(
            "SHD164",
            "disaggregation artifact targets a graph with no "
            "decode-attention ops — there is no decode phase to "
            "disaggregate"))
    try:
        a = int(meta.get("prefill_devices", 0))
        b = int(meta.get("decode_devices", 0))
        chunk = int(meta.get("chunk", 0))
    except (TypeError, ValueError):
        return findings + [_d(
            "SHD164",
            f"disaggregation meta has non-integer block/chunk fields "
            f"({meta.get('prefill_devices')!r}, "
            f"{meta.get('decode_devices')!r}, {meta.get('chunk')!r})")]
    n = getattr(config, "search_devices", 0) or config.num_devices
    if a < 1 or b < 1:
        findings.append(_d(
            "SHD164",
            f"disaggregation blocks must both be non-empty "
            f"(prefill={a}, decode={b})"))
    elif a + b > n:
        findings.append(_d(
            "SHD164",
            f"disaggregation blocks overflow the machine: prefill {a} "
            f"+ decode {b} devices on a {n}-device mesh"))
    if chunk < 1:
        findings.append(_d(
            "SHD164",
            f"prefill chunk must be >= 1, got {chunk!r}"))
    if prefill_graph is not None and decode_nodes(prefill_graph):
        findings.append(_d(
            "SHD164",
            "prefill graph carries decode-attention ops — the page "
            "pool would live on BOTH sides of the cut"))

    # SHD165: pool geometry must agree across the handoff
    geo = (meta.get("max_seqs"), meta.get("page_size"),
           meta.get("pages_per_seq"))
    for node in nodes:
        got = (node.op.max_seqs, node.op.attrs["page_size"],
               node.op.attrs["pages_per_seq"])
        if got != geo:
            findings.append(_d(
                "SHD165",
                f"decode op {node.op.name!r} frame geometry {got} "
                f"disagrees with the persisted handoff geometry {geo} "
                f"— the prefill writer and the decode reader would "
                f"index different pools",
                node=node.guid, op=node.op.name))
    # shared-parameter-set bridge: proven on the META-ONLY path (import
    # re-lint — derive the prompt twin from the decode graph itself).
    # At proposal time the bridge was already proven on the ORIGINAL
    # graph pair before any block search ran; the block solves may
    # rewrite op names, so re-bridging rewritten block graphs here
    # would manufacture false mismatches.
    if (prefill_strategy is None and decode_strategy is None and nodes
            and prefill_graph is None):
        try:
            from flexflow_tpu_torch.models.decode import derive_prefill_model
            from flexflow_tpu_torch.runtime.prefill import (
                prefill_weight_bridge,
            )

            twin = derive_prefill_model(
                decode_graph, config,
                seq_len=int(meta.get("prefill_seq_len") or 1),
            )[0].graph
            prefill_weight_bridge(twin, decode_graph)
        except ValueError as e:
            findings.append(_d(
                "SHD165",
                f"prefill and decode graphs do not share one parameter "
                f"set: {e}"))
        except Exception as e:
            findings.append(_d(
                "SHD165",
                f"cannot derive the prefill twin of this decode graph "
                f"({e}) — the shared-parameter-set contract is "
                f"unprovable"))
    classes = meta.get("slo_classes", [])
    if not isinstance(classes, list):
        findings.append(_d(
            "SHD165", f"slo_classes is not a list: {classes!r}"))
    else:
        seen = set()
        for i, c in enumerate(classes):
            if not isinstance(c, dict) or not c.get("name") \
                    or not isinstance(c.get("name"), str):
                findings.append(_d(
                    "SHD165",
                    f"slo_classes[{i}] is not a named class object"))
                continue
            if c["name"] in seen:
                findings.append(_d(
                    "SHD165",
                    f"slo_classes[{i}] duplicates {c['name']!r}"))
            seen.add(c["name"])
            if not isinstance(c.get("priority", 0), int) \
                    or isinstance(c.get("priority", 0), bool):
                findings.append(_d(
                    "SHD165",
                    f"slo class {c['name']!r} priority is not an int"))
            df = c.get("deadline_frames", 0)
            if not isinstance(df, int) or isinstance(df, bool) or df < 0:
                findings.append(_d(
                    "SHD165",
                    f"slo class {c['name']!r} deadline_frames {df!r} "
                    f"is not a non-negative int"))
            q = c.get("quantile", 0.99)
            if not isinstance(q, (int, float)) or isinstance(q, bool) \
                    or not (0.0 < float(q) < 1.0):
                findings.append(_d(
                    "SHD165",
                    f"slo class {c['name']!r} quantile {q!r} outside "
                    f"(0, 1)"))

    # per-block flat lint (proposal time only — imports carry no
    # per-phase strategies): each phase compiles over its OWN submesh,
    # so its views must pass the gate in that geometry
    if not errors_only(findings):
        from flexflow_tpu_torch.compiler.placement_lowering import _strip_start

        for graph, strategy, width in (
                (prefill_graph, prefill_strategy, a),
                (decode_graph, decode_strategy, b)):
            if graph is None or strategy is None:
                continue
            stripped = {g: _strip_start(mv)
                        for g, mv in strategy.items() if mv is not None}
            findings += lint_strategy(graph, stripped, width)
    return findings


# ---------------------------------------------------------------------------
# serving-fleet legality (SHD166/167)
# ---------------------------------------------------------------------------
def lint_fleet(decode_graph, meta, config,
               replica_blocks=None) -> List[Finding]:
    """Legality of a serving-fleet proposal/artifact (``__meta__.fleet``,
    search/fleet.py) against the decode graph it targets — the
    always-on gate at proposal time and the re-lint at import:

    * **SHD166** N-block frame structure: a non-empty replica list with
      positive integer widths, non-negative starts, blocks pairwise
      DISJOINT and inside the machine; each replica's intra split
      (prefill_devices/decode_devices) fits its own width; the decode
      graph actually HAS decode-attention ops.
    * **SHD167** routing + pool coherence: every SLO class the table
      names is covered by a routing row whose per-replica fractions
      are in [0, 1] and sum to 1; routing rows name no unknown class
      and are sized to the replica list; the persisted pool geometry
      (max_seqs, page_size, pages_per_seq) matches every decode op's
      own attrs — every replica runs the SAME deployment frame, one
      request must be servable anywhere its class routes; the
      SLO-class table is structurally sound.

    When per-replica ``replica_blocks`` — (graph, strategy, width)
    triples — are supplied (proposal time), each block additionally
    passes the flat SHD101-110 lint under ITS OWN submesh width, the
    same per-segment discipline as ``lint_disaggregation``."""
    from flexflow_tpu_torch.search.serving import decode_nodes

    def _f(code, message, **kw):
        return Finding(code=code, pass_name="fleet", message=message,
                       **kw)

    findings: List[Finding] = []
    if not isinstance(meta, dict):
        return [_f("SHD166", "fleet meta is not an object")]
    nodes = decode_nodes(decode_graph)
    if not nodes:
        findings.append(_f(
            "SHD166",
            "fleet artifact targets a graph with no decode-attention "
            "ops — there is nothing to replicate"))
    reps = meta.get("replicas")
    if not isinstance(reps, list) or not reps:
        return findings + [_f(
            "SHD166",
            f"fleet meta carries no replica list: {reps!r}")]
    n = getattr(config, "search_devices", 0) or config.num_devices
    spans = []
    for i, r in enumerate(reps):
        if not isinstance(r, dict):
            findings.append(_f(
                "SHD166", f"replicas[{i}] is not an object: {r!r}"))
            continue
        try:
            w = int(r.get("devices", 0))
            s = int(r.get("start", -1))
            a = int(r.get("prefill_devices", 0))
            b = int(r.get("decode_devices", 0))
        except (TypeError, ValueError):
            findings.append(_f(
                "SHD166",
                f"replicas[{i}] has non-integer block fields "
                f"({r.get('devices')!r}, {r.get('start')!r}, "
                f"{r.get('prefill_devices')!r}, "
                f"{r.get('decode_devices')!r})"))
            continue
        if w < 1 or s < 0:
            findings.append(_f(
                "SHD166",
                f"replicas[{i}] block [{s}, {s + w}) is not a "
                f"non-empty in-range device block"))
            continue
        if s + w > n:
            findings.append(_f(
                "SHD166",
                f"replicas[{i}] block [{s}, {s + w}) overflows the "
                f"{n}-device mesh"))
        if a < 0 or b < 1 or a + b > w:
            findings.append(_f(
                "SHD166",
                f"replicas[{i}] intra split prefill={a} + decode={b} "
                f"does not fit its {w}-device block"))
        spans.append((s, s + w, i))
    spans.sort()
    for (s0, e0, i0), (s1, e1, i1) in zip(spans, spans[1:]):
        if s1 < e0:
            findings.append(_f(
                "SHD166",
                f"replica blocks overlap: replicas[{i0}] "
                f"[{s0}, {e0}) and replicas[{i1}] [{s1}, {e1}) share "
                f"devices — two page pools cannot own one HBM"))

    # SHD167: pool geometry must agree across every replica
    geo = (meta.get("max_seqs"), meta.get("page_size"),
           meta.get("pages_per_seq"))
    for node in nodes:
        got = (node.op.max_seqs, node.op.attrs["page_size"],
               node.op.attrs["pages_per_seq"])
        if got != geo:
            findings.append(_f(
                "SHD167",
                f"decode op {node.op.name!r} frame geometry {got} "
                f"disagrees with the persisted fleet geometry {geo} — "
                f"a request routed across replicas would land in a "
                f"different pool shape",
                node=node.guid, op=node.op.name))
    classes = meta.get("slo_classes", [])
    names = set()
    if not isinstance(classes, list):
        findings.append(_f(
            "SHD167", f"slo_classes is not a list: {classes!r}"))
        classes = []
    for i, c in enumerate(classes):
        if not isinstance(c, dict) or not c.get("name") \
                or not isinstance(c.get("name"), str):
            findings.append(_f(
                "SHD167",
                f"slo_classes[{i}] is not a named class object"))
            continue
        if c["name"] in names:
            findings.append(_f(
                "SHD167",
                f"slo_classes[{i}] duplicates {c['name']!r}"))
        names.add(c["name"])
        df = c.get("deadline_frames", 0)
        if not isinstance(df, int) or isinstance(df, bool) or df < 0:
            findings.append(_f(
                "SHD167",
                f"slo class {c['name']!r} deadline_frames {df!r} is "
                f"not a non-negative int"))
        q = c.get("quantile", 0.99)
        if not isinstance(q, (int, float)) or isinstance(q, bool) \
                or not (0.0 < float(q) < 1.0):
            findings.append(_f(
                "SHD167",
                f"slo class {c['name']!r} quantile {q!r} outside "
                f"(0, 1)"))
    routing = meta.get("routing")
    if not isinstance(routing, dict) or not routing:
        findings.append(_f(
            "SHD167", f"fleet meta carries no routing table: "
                      f"{routing!r}"))
        routing = {}
    for cname, fr in sorted(routing.items()):
        if names and cname not in names:
            findings.append(_f(
                "SHD167",
                f"routing row {cname!r} names an unknown SLO class "
                f"(table: {sorted(names)})"))
        if (not isinstance(fr, list) or len(fr) != len(reps)
                or not all(isinstance(v, (int, float))
                           and not isinstance(v, bool) for v in fr)):
            findings.append(_f(
                "SHD167",
                f"routing row {cname!r} is not a list of "
                f"{len(reps)} fractions: {fr!r}"))
            continue
        if any(v < 0.0 or v > 1.0 for v in fr):
            findings.append(_f(
                "SHD167",
                f"routing row {cname!r} has fractions outside "
                f"[0, 1]: {fr}"))
        elif abs(sum(fr) - 1.0) > 1e-3:
            findings.append(_f(
                "SHD167",
                f"routing row {cname!r} fractions sum to "
                f"{sum(fr):.6f}, not 1 — traffic would be dropped or "
                f"duplicated"))
    for cname in sorted(names - set(routing)):
        findings.append(_f(
            "SHD167",
            f"SLO class {cname!r} has no routing row — its requests "
            f"have nowhere to go"))

    # per-replica flat lint (proposal time only — imports carry no
    # per-replica strategies): every replica compiles over its OWN
    # submesh, so its views must pass the gate in that geometry
    if replica_blocks and not errors_only(findings):
        from flexflow_tpu_torch.compiler.placement_lowering import _strip_start

        for graph, strategy, width in replica_blocks:
            if graph is None or strategy is None:
                continue
            stripped = {g: _strip_start(mv)
                        for g, mv in strategy.items() if mv is not None}
            findings += lint_strategy(graph, stripped, width)
    return findings
