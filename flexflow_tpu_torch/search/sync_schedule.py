"""Gradient-sync schedule: bucketed, issue-ordered, searched — a copy
of flexflow_tpu/search/sync_schedule.py.

The simulator has always CREDITED async-collective overlap — a weight
group's allreduce rides the comm timeline and hides under later compute
— but the executed step fires ONE monolithic post-backward sync
(compiler/lowering.py ``_sync_grads``), so the predicted and real
timelines systematically disagreed on exactly the term the
sync-precision search made searchable.  GSPMD (arXiv:2105.04663) hides
reduction latency by issuing collectives asynchronously under the
remaining backward; the cross-replica weight-update sharding work
(arXiv:2004.13336) shows the sync/update tail is where data-parallel
steps lose their time.  This module closes the loop: the sync becomes a
first-class, searched, persisted, linted ARTIFACT —

* a ``SyncSchedule`` partitions the strategy's synced weight groups
  into issue-ordered buckets, reverse-topological so a bucket's fused
  collective issues as soon as the backward has produced its members'
  grads, overlapping the rest of the backward;
* small groups coalesce to amortize per-collective latency (the cost
  model prices one latency term per fused bucket,
  ``CostModel.bucket_sync_cost``); per-bucket precision composes with
  the sync-precision map (search/sync_precision.py);
* ``choose_sync_schedule`` sweeps coalescing thresholds under
  ``FFConfig.sync_schedule="search"``, prices every candidate with the
  simulator's exposed-comm semantics (``simulate(sync_schedule=...)``)
  and returns a schedule only when it beats the monolithic baseline;
* the result embeds in the strategy file's ``__meta__`` (strategy_io)
  behind the existing graph-digest gate, is linted always-on
  (``analysis.lint_sync_schedule``, SHD12x) wherever it is produced or
  imported, and is executed for real by ``comm/bucketed.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCHEDULE_SCHEMA = 1

# wire precisions a bucket may carry — mirrors comm.quantized
# SYNC_PRECISIONS without importing torch (this module must stay loadable
# by the stdlib-only lint path).  "int8_ef" is the error-feedback
# variant of int8 (comm.quantized_allreduce_ef): identical wire format,
# the device re-injects its local quantization error next step via a
# residual carried as training-loop state (FFConfig.sync_ef)
BUCKET_PRECISIONS = ("fp32", "bf16", "int8", "int8_ef")


def wire_base(precision: Optional[str]) -> Optional[str]:
    """The on-wire format of a bucket precision: ``int8_ef`` rides the
    plain int8 wire (EF changes WHAT is quantized, not the payload) —
    the normalization every consumer of the raw collective applies
    (staged cross-slice stages, the execution dispatch, SHD133)."""
    return "int8" if precision == "int8_ef" else precision

# default coalescing floors swept by the search when FFConfig does not
# pin one (sync_bucket_bytes): fused-bucket fp32 payload bytes below
# which the next group keeps joining the open bucket.  Small floors
# maximize overlap (more, earlier issue points), large floors maximize
# latency amortization — the simulator arbitrates.
DEFAULT_BUCKET_BYTES = (1 << 20, 4 << 20, 16 << 20)


@dataclass(frozen=True)
class SyncBucket:
    """One fused gradient-sync collective: the named weight groups'
    grads flatten into a single wire payload at ``precision``.
    ``plan`` — an optional staged reduction plan for hierarchical
    topologies (search/reduction_plan.py): the bucket's cross-slice
    traffic then rides the staged RS/AR/AG shape at per-level wire
    precision instead of one flat ring; None keeps the flat collective
    (always the case on single-level machines)."""

    name: str
    ops: Tuple[str, ...]
    precision: str = "fp32"
    plan: Optional[object] = None  # reduction_plan.ReductionPlan


@dataclass
class SyncSchedule:
    """Issue-ordered bucket list (bucket 0 = the deepest layers, whose
    grads the backward produces FIRST) plus provenance metadata."""

    buckets: List[SyncBucket]
    meta: Dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.buckets)

    def covered_ops(self) -> List[str]:
        out: List[str] = []
        for b in self.buckets:
            out.extend(b.ops)
        return out

    def to_jsonable(self) -> dict:
        out = []
        for b in self.buckets:
            d = {"name": b.name, "ops": list(b.ops),
                 "precision": b.precision}
            if b.plan is not None:
                d["plan"] = b.plan.to_jsonable()
            out.append(d)
        return {
            "schema": SCHEDULE_SCHEMA,
            "buckets": out,
            **({"meta": dict(self.meta)} if self.meta else {}),
        }

    @staticmethod
    def from_jsonable(data) -> "SyncSchedule":
        """Parse a persisted schedule (strategy-file ``__meta__`` entry).
        Raises ``ValueError`` on structural malformation — semantic
        legality against a (graph, strategy) is the lint's job
        (``analysis.lint_sync_schedule``)."""
        if not isinstance(data, dict):
            raise ValueError("sync_schedule is not an object")
        if data.get("schema") != SCHEDULE_SCHEMA:
            raise ValueError(
                f"unknown sync_schedule schema {data.get('schema')!r} "
                f"(known: {SCHEDULE_SCHEMA})")
        raw = data.get("buckets")
        if not isinstance(raw, list) or not raw:
            raise ValueError("sync_schedule has no buckets")
        buckets = []
        for i, b in enumerate(raw):
            if not isinstance(b, dict):
                raise ValueError(f"buckets[{i}] is not an object")
            ops = b.get("ops")
            if (not isinstance(ops, list) or not ops
                    or any(not isinstance(o, str) for o in ops)):
                raise ValueError(f"buckets[{i}] has malformed ops {ops!r}")
            prec = b.get("precision", "fp32")
            if prec not in BUCKET_PRECISIONS:
                raise ValueError(
                    f"buckets[{i}] precision {prec!r} not in "
                    f"{BUCKET_PRECISIONS}")
            name = b.get("name")
            if not isinstance(name, str) or not name:
                raise ValueError(f"buckets[{i}] has no name")
            plan = None
            if b.get("plan") is not None:
                from flexflow_tpu_torch.search.reduction_plan import ReductionPlan

                try:
                    plan = ReductionPlan.from_jsonable(b["plan"])
                except ValueError as e:
                    raise ValueError(
                        f"buckets[{i}] carries a malformed reduction "
                        f"plan: {e}") from e
            buckets.append(SyncBucket(name=name, ops=tuple(ops),
                                      precision=prec, plan=plan))
        meta = data.get("meta")
        return SyncSchedule(buckets, dict(meta) if isinstance(meta, dict)
                            else {})


def synced_weight_groups(graph, strategy, cost_model) -> List[Tuple]:
    """Topo-ordered ``(node, view, parts)`` for every op whose weights
    actually sync under ``strategy`` (some propagated weight annot has
    replica > 1) — THE membership rule the schedule builder, the
    simulator's coverage fallback, and the legality lint all share."""
    from flexflow_tpu_torch.core.machine import MachineView

    out = []
    for node in graph.topo_order():
        if not node.op._weight_specs:
            continue
        mv = strategy.get(node.guid)
        if mv is None:
            mv = node.op.fixed_machine_view() or MachineView.trivial(
                node.op.output_shapes[0].ndim
            )
        parts = cost_model.weight_sync_parts(node.op, mv)
        if parts:
            out.append((node, mv, parts))
    return out


def build_bucketed_schedule(
    synced: List[Tuple],
    precision_map: Optional[Dict[str, str]] = None,
    min_bucket_bytes: float = math.inf,
) -> Optional[SyncSchedule]:
    """Greedy reverse-topological coalescing: walk the synced groups in
    backward-readiness order (last topo position first — its grads are
    produced first), open a new bucket whenever the wire precision
    changes or the open bucket's fp32 payload has reached
    ``min_bucket_bytes``.  ``math.inf`` yields the per-precision
    MONOLITHIC schedule — the executed status quo, priced in the same
    currency so the search's comparison is apples to apples."""
    if not synced:
        return None
    pmap = precision_map or {}
    buckets: List[SyncBucket] = []
    cur_ops: List[str] = []
    cur_prec: Optional[str] = None
    cur_bytes = 0.0

    def close():
        nonlocal cur_ops, cur_bytes
        if cur_ops:
            buckets.append(SyncBucket(
                name=f"b{len(buckets)}", ops=tuple(cur_ops),
                precision=cur_prec or "fp32"))
        cur_ops, cur_bytes = [], 0.0

    for node, _mv, parts in reversed(synced):
        prec = pmap.get(node.op.name, "fp32")
        if cur_ops and (prec != cur_prec or cur_bytes >= min_bucket_bytes):
            close()
        cur_prec = prec
        cur_ops.append(node.op.name)
        cur_bytes += sum(p[0] for p in parts)
    close()
    return SyncSchedule(buckets)


def lint_gate(graph, strategy, schedule, precision_map=None,
              cost_model=None) -> None:
    """Always-on legality gate on a schedule THIS tree produced: an
    error finding here is a builder bug, not a user error — fail loudly
    before the artifact is persisted or executed (same discipline as
    ``optimize_strategy``'s strategy gate).  With a ``cost_model`` the
    per-bucket reduction plans are gated too (SHD13x — level coverage,
    group/slice coherence, precision-per-level validity)."""
    from flexflow_tpu_torch.analysis import (
        AnalysisError,
        emit_findings,
        errors_only,
        lint_sync_schedule,
    )

    findings = lint_sync_schedule(graph, strategy, schedule, precision_map)
    if cost_model is not None:
        from flexflow_tpu_torch.analysis import lint_reduction_plan

        findings = findings + lint_reduction_plan(
            graph, strategy, schedule, cost_model)
    bad = errors_only(findings)
    if bad:
        emit_findings(bad)
        raise AnalysisError(
            "sync-schedule builder produced an illegal schedule", bad)


def choose_sync_schedule(
    graph,
    strategy,
    sim,
    precision_map: Optional[Dict[str, str]] = None,
    config=None,
) -> Tuple[Optional[SyncSchedule], Dict]:
    """Pick bucket composition + issue order for ``(graph, strategy)``
    under the simulator's exposed-comm pricing.  Returns
    ``(schedule, info)`` — ``schedule`` is None when no bucketing beats
    the monolithic baseline (the bit-exact status quo then stands);
    ``info`` records the comparison for telemetry/bench.  ``sim`` must
    be the Simulator the search ranked with, so the schedule is chosen
    in the same cost currency the strategy was.  The returned schedule
    has passed the always-on legality gate (``lint_gate``).

    On a hierarchical machine (MachineSpec.topology_levels > 1) the
    search gains the REDUCTION-PLAN dimension: every candidate (the
    monolithic baseline included) is also priced with per-bucket
    staged plans (search/reduction_plan.py — RS within slice, small
    cross-slice exchange at per-level wire precision, AG within slice)
    and the staged variant is adopted only when it beats the flat
    plan.  Flat single-level machines enumerate no plans, so their
    choice is bit-identical to the plan-free search."""
    info: Dict = {"monolithic_s": None, "scheduled_s": None, "buckets": 0,
                  "staged_buckets": 0}
    synced = synced_weight_groups(graph, strategy, sim.cost)
    multi_level = len(sim.cost.levels()) > 1
    if not synced or (len(synced) < 2 and not multi_level):
        return None, info  # nothing to order, coalesce, or stage
    names = [node.op.name for node, _mv, _p in synced]
    if len(names) != len(set(names)):
        # stamped production graphs (segment stamping) can repeat
        # op names; buckets are keyed by name, so a schedule cannot
        # address such groups individually — the monolithic status quo
        # stands (SHD121's exact-once coverage would reject any
        # schedule built here)
        return None, info
    pmap = dict(precision_map or {})
    mono = build_bucketed_schedule(synced, pmap, math.inf)
    base = sim.simulate(graph, strategy, sync_schedule=mono)
    info["monolithic_s"] = base
    if not math.isfinite(base):
        return None, info
    thresholds: List[float] = []
    pinned = getattr(config, "sync_bucket_bytes", 0) if config else 0
    if pinned:
        thresholds = [float(pinned)]
    else:
        total = sum(p[0] for _n, _mv, parts in synced for p in parts)
        thresholds = sorted(
            {float(t) for t in DEFAULT_BUCKET_BYTES}
            # adaptive points so small models still split into a few
            # buckets instead of collapsing to the monolithic shape
            | {max(1.0, total / 8.0), max(1.0, total / 4.0)}
        )
    best: Tuple[Optional[SyncSchedule], float] = (None, base)
    priced = set()  # adjacent thresholds often coalesce identically —
    # don't pay a full simulate per duplicate composition
    for th in thresholds:
        cand = build_bucketed_schedule(synced, pmap, th)
        if cand is None or len(cand.buckets) <= len(mono.buckets):
            continue
        key = tuple(b.ops for b in cand.buckets)
        if key in priced:
            continue
        priced.add(key)
        c = sim.simulate(graph, strategy, sync_schedule=cand)
        if c < best[1]:
            cand.meta = {"bucket_bytes": th}
            best = (cand, c)

    # ---- reduction-plan dimension (hierarchical topologies only) ----
    # the flat-winner AND the monolithic baseline both get a staged
    # variant priced; a staged plan is adopted only when its simulated
    # step beats everything flat (single-level machines enumerate no
    # plans, so this is a no-op there — bit-identical flat behavior)
    if multi_level:
        from flexflow_tpu_torch.search.reduction_plan import (
            assign_reduction_plans,
        )

        plan_candidates = [mono]
        if best[0] is not None:
            plan_candidates.append(best[0])
        for cand in plan_candidates:
            aug, ainfo = assign_reduction_plans(cand, synced, sim.cost)
            if aug is None:
                continue
            c = sim.simulate(graph, strategy, sync_schedule=aug)
            if c < best[1]:
                aug.meta.update(cand.meta)
                aug.meta["reduction_plans"] = {
                    b.name: b.plan.name for b in aug.buckets
                    if b.plan is not None}
                best = (aug, c)
                info["staged_buckets"] = ainfo["staged_buckets"]
                info["flat_sync_s"] = ainfo["flat_sync_s"]
                info["planned_sync_s"] = ainfo["planned_sync_s"]

    schedule, cost = best
    if schedule is None:
        return None, info  # scheduled_s stays None: monolithic stands
    info["scheduled_s"] = cost
    info["buckets"] = len(schedule.buckets)
    schedule.meta.update(
        predicted_monolithic_s=base, predicted_scheduled_s=cost)
    lint_gate(graph, strategy, schedule, pmap, cost_model=sim.cost)
    return schedule, info
