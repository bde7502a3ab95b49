"""Staged per-group reduction plans for hierarchical topologies — a
copy of flexflow_tpu/search/reduction_plan.py.

A flat ring allreduce on a multi-slice machine drags the FULL gradient
around the slow DCN links; the hierarchical shape — reduce-scatter
within each slice, a small cross-slice exchange of the 1/f0 shard,
all-gather within each slice — shrinks the DCN traffic by the
within-slice factor ("Synthesizing Optimal Parallelism Placement and
Reduction Strategies on Hierarchical Systems", arXiv:2110.10548; XLA's
own multislice allreduce has the same shape).  This module makes that
shape a SEARCHED, per-weight-group artifact:

* a ``ReductionPlan`` names the staged decomposition per sync bucket
  (search/sync_schedule.py ``SyncBucket.plan``): one stage per link
  level (``MachineSpec.topology_levels``), the RS/AG pairs below the
  deepest level at fp32 (value-identity on already-reduced grads, like
  the fp32 buckets of comm/bucketed.py) and the cross-level middle
  allreduce at a wire precision composing with the sync-precision map
  (int8 over DCN, fp32 over ICI — the sync-precision map gates which groups may
  compress at all);
* ``enumerate_reduction_plans`` lists the candidates for a machine's
  level count (a flat single-level machine has NONE — the flat ring
  stands bit-identically); ``assign_reduction_plans`` prices each
  bucket's candidates in the cost model's bucket currency
  (``CostModel.bucket_sync_cost(plan=...)``) and attaches a staged
  plan only where it beats the flat ring;
* plans persist inside the strategy file's ``__meta__.sync_schedule``
  behind the digest gate, are linted always-on
  (``analysis.lint_reduction_plan``, SHD13x) and stdlib-only
  (``fflint strategy``, STR206), and execute via
  ``comm/hierarchical.py``'s staged shard_map collectives.

Deliberately torch-free (like sync_schedule): the stdlib lint path must
load it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# stage kinds of the canonical staged shape: RS/AG pairs bracket the
# cross-level allreduce, levels ascending then descending
STAGE_KINDS = ("reduce_scatter", "allreduce", "all_gather")

# wire precisions a stage may carry — mirrors sync_schedule
# BUCKET_PRECISIONS without importing torch
STAGE_PRECISIONS = ("fp32", "bf16", "int8")


@dataclass(frozen=True)
class ReductionStage:
    kind: str  # one of STAGE_KINDS
    level: int  # link level the stage rides (0 = ICI within a slice)
    precision: str = "fp32"


@dataclass(frozen=True)
class ReductionPlan:
    """One staged reduction: stages in issue order.  The canonical
    shape for a plan reaching level L is::

        RS(0) RS(1) ... RS(L-1)  AR(L)  AG(L-1) ... AG(1) AG(0)

    (``canonical_stages``); ``validate_stages`` proves an arbitrary
    stage list has it.  ``level_precisions[i]`` is the wire precision
    of the level-i stage — what the cost model's ``staged_sync_cost``
    and the executor consume."""

    name: str
    stages: Tuple[ReductionStage, ...]

    @property
    def cross_level(self) -> int:
        """The level of the middle allreduce (the plan's reach)."""
        for s in self.stages:
            if s.kind == "allreduce":
                return s.level
        return 0

    @property
    def level_precisions(self) -> Tuple[str, ...]:
        precs: Dict[int, str] = {}
        for s in self.stages:
            precs[s.level] = s.precision
        top = max(precs) if precs else 0
        return tuple(precs.get(i, "fp32") for i in range(top + 1))

    def to_jsonable(self) -> dict:
        return {
            "name": self.name,
            "stages": [
                {"kind": s.kind, "level": s.level, "precision": s.precision}
                for s in self.stages
            ],
        }

    @staticmethod
    def from_jsonable(data) -> "ReductionPlan":
        """Parse a persisted plan (a ``__meta__.sync_schedule`` bucket's
        ``plan`` entry).  Raises ``ValueError`` on structural
        malformation — semantic legality against a (graph, strategy,
        machine) is ``analysis.lint_reduction_plan``'s job."""
        if not isinstance(data, dict):
            raise ValueError("reduction plan is not an object")
        name = data.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError("reduction plan has no name")
        raw = data.get("stages")
        if not isinstance(raw, list) or not raw:
            raise ValueError("reduction plan has no stages")
        stages = []
        for i, s in enumerate(raw):
            if not isinstance(s, dict):
                raise ValueError(f"stages[{i}] is not an object")
            kind = s.get("kind")
            if kind not in STAGE_KINDS:
                raise ValueError(
                    f"stages[{i}] kind {kind!r} not in {STAGE_KINDS}")
            level = s.get("level")
            if not isinstance(level, int) or level < 0:
                raise ValueError(f"stages[{i}] has malformed level {level!r}")
            prec = s.get("precision", "fp32")
            if prec not in STAGE_PRECISIONS:
                raise ValueError(
                    f"stages[{i}] precision {prec!r} not in "
                    f"{STAGE_PRECISIONS}")
            stages.append(ReductionStage(kind, level, prec))
        return ReductionPlan(name, tuple(stages))


def canonical_stages(cross_level: int,
                     cross_precision: str) -> Tuple[ReductionStage, ...]:
    """The staged bracketing reaching ``cross_level``: fp32 RS/AG pairs
    below it (value-identity on already-reduced grads — the executor
    realizes only the compressed wire, comm/hierarchical.py), the
    middle allreduce at ``cross_precision``."""
    rs = [ReductionStage("reduce_scatter", i, "fp32")
          for i in range(cross_level)]
    ag = [ReductionStage("all_gather", i, "fp32")
          for i in reversed(range(cross_level))]
    mid = [ReductionStage("allreduce", cross_level, cross_precision)]
    return tuple(rs + mid + ag)


def validate_stages_split(
    stages, num_levels: int
) -> Tuple[List[str], List[str]]:
    """``(structural, precision)`` errors of a stage list against the
    canonical shape (both [] = well-formed) — split so the lint can map
    them to distinct codes (SHD130 vs SHD133) without string-matching
    the messages."""
    errs: List[str] = []
    if not stages:
        return ["plan has no stages"], []
    for i, s in enumerate(stages):
        if s.kind not in STAGE_KINDS:
            errs.append(f"stages[{i}] kind {s.kind!r} unknown")
        if not isinstance(s.level, int) or not (0 <= s.level < num_levels):
            errs.append(
                f"stages[{i}] level {s.level!r} outside the machine's "
                f"{num_levels} link level(s)")
        if s.precision not in STAGE_PRECISIONS:
            errs.append(f"stages[{i}] precision {s.precision!r} unknown")
    if errs:
        return errs, []
    ars = [s for s in stages if s.kind == "allreduce"]
    if len(ars) != 1:
        return [f"plan must have exactly one cross-level allreduce "
                f"(found {len(ars)})"], []
    want = canonical_stages(ars[0].level, ars[0].precision)
    got = tuple((s.kind, s.level) for s in stages)
    if got != tuple((s.kind, s.level) for s in want):
        return [
            f"stages {[(s.kind, s.level) for s in stages]} do not form "
            f"the canonical RS..AR..AG bracketing for cross level "
            f"{ars[0].level}"], []
    prec_errs = [
        f"{s.kind} at level {s.level} carries {s.precision} — "
        f"only the cross-level allreduce stage may compress "
        f"(the RS/AG pairs are value-identity anchors)"
        for s in stages
        if s.kind != "allreduce" and s.precision != "fp32"]
    return [], prec_errs


def validate_stages(stages, num_levels: int) -> List[str]:
    """Structural + precision errors of a stage list against the
    canonical shape ([] = well-formed).  Shared by the SHD130 lint and
    the builder."""
    structural, prec = validate_stages_split(stages, num_levels)
    return structural + prec


def enumerate_reduction_plans(
    num_levels: int, bucket_precision: str = "fp32"
) -> List[ReductionPlan]:
    """Candidate staged plans for a machine with ``num_levels`` link
    levels and a bucket at ``bucket_precision``.  A flat (single-level)
    machine has none — the flat ring stands and pricing/search stay
    bit-identical.  Cross precision is drawn from {fp32, the bucket's
    precision}: per-level wire precision composes with the
    sync-precision map without contradicting it (SHD123/SHD133)."""
    if num_levels <= 1:
        return []
    precs = ["fp32"]
    if bucket_precision not in (None, "fp32"):
        from flexflow_tpu_torch.search.sync_schedule import wire_base

        # an int8_ef bucket's cross-slice stage runs the plain int8
        # wire: EF compensates the flat ENTRY quantization; the staged
        # exchange carries already-reduced shards the residual never
        # sees (and the raw collective only knows SYNC_PRECISIONS)
        precs.append(wire_base(bucket_precision))
    plans = []
    for cross in range(1, num_levels):
        for pc in precs:
            tag = f"staged_l{cross}" + ("" if pc == "fp32" else f"_{pc}")
            plans.append(ReductionPlan(tag, canonical_stages(cross, pc)))
    return plans


def assign_reduction_plans(schedule, synced, cost_model):
    """Per-bucket plan choice: price every bucket's candidate staged
    plans in the SAME fused-bucket currency the schedule search ranks
    with (``CostModel.bucket_sync_cost``) and attach the cheapest plan
    where it strictly beats the flat ring.  Returns ``(new_schedule,
    info)`` — ``new_schedule`` is None when no bucket improves (the
    flat ring stands; on a single-level machine this is always the
    case, keeping flat-topology searches bit-identical).  ``synced`` is
    the ``synced_weight_groups`` list the schedule was built from."""
    from flexflow_tpu_torch.search.sync_schedule import SyncBucket, SyncSchedule

    num_levels = len(cost_model.levels())
    info: Dict = {"staged_buckets": 0, "flat_sync_s": 0.0,
                  "planned_sync_s": 0.0}
    if num_levels <= 1:
        return None, info
    parts_by_op = {node.op.name: parts for node, _mv, parts in synced}
    new_buckets = []
    changed = False
    for bucket in schedule.buckets:
        parts = [p for op in bucket.ops for p in parts_by_op.get(op, ())]
        flat = cost_model.bucket_sync_cost(parts, bucket.precision)
        # the bucket's candidate plans must reach EXACTLY the deepest
        # link level its replication groups span (the SHD131 rule): a
        # shallower plan leaves the coarse links mispriced, a deeper
        # one prices stages the wire never runs — and pricing ties
        # between them would otherwise let the lint gate reject the
        # search's own choice
        deepest = 0
        for _nbytes, replica, _spans, _n, key in parts:
            if replica <= 1:
                continue
            factors = cost_model.replica_level_split(key, replica)
            if factors is None:
                continue
            deepest = max(deepest, max(
                (i for i, f in enumerate(factors) if f > 1), default=0))
        best_plan, best_cost = None, flat
        for plan in enumerate_reduction_plans(num_levels, bucket.precision):
            if plan.cross_level != deepest:
                continue
            c = cost_model.bucket_sync_cost(parts, bucket.precision,
                                            plan=plan)
            if c < best_cost:
                best_plan, best_cost = plan, c
        info["flat_sync_s"] += flat
        info["planned_sync_s"] += best_cost
        if best_plan is not None:
            info["staged_buckets"] += 1
            changed = True
            new_buckets.append(SyncBucket(
                name=bucket.name, ops=bucket.ops,
                precision=bucket.precision, plan=best_plan))
        else:
            new_buckets.append(bucket)
    if not changed:
        return None, info
    return SyncSchedule(new_buckets, dict(schedule.meta)), info
