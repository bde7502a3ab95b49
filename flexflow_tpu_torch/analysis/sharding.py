"""Strategy/sharding legality linter — pass 3 of the static-analysis
stack; the ``lint_strategy`` part of flexflow_tpu/analysis/sharding.py,
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

The reference's other gates in this file (``lint_sync_schedule``,
``lint_zero_map``, ``lint_reduction_plan``, ``lint_serving``,
``lint_kv``, ``lint_disaggregation``, ``lint_fleet``) guard artifacts
of modules the port has not ported (ROADMAP Queue A items 5, 8 and 9);
they come with those modules.
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
