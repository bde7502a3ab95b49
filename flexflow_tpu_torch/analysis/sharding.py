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

The reference's other gates in this file (``lint_serving``,
``lint_kv``, ``lint_disaggregation``, ``lint_fleet``) guard artifacts
of modules the port has not ported (ROADMAP Queue A item 9); they come
with those modules.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from flexflow_tpu_torch.analysis.findings import Finding


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
