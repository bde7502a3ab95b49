"""Joint strategy × comm-plan co-search — a copy of
flexflow_tpu/search/comm_plan.py.

Unity's core claim is that parallelization decisions must be searched
*jointly* — yet until this module the comm plan was chosen
sequentially: the substitution/DP search picked a strategy under the
legacy per-node overlap credit, and only afterwards were the sync wire
precision (search/sync_precision.py), the bucketed issue schedule
(search/sync_schedule.py) and the staged reduction plans
(search/reduction_plan.py) fitted to it.  The search could therefore
commit to a TP-vs-DP trade whose actual comm cost it never priced.

Under ``FFConfig.co_search`` every candidate strategy the search
grounds — substitution proposals, DP re-validations, chain-segment
solves, the champion-vs-DP floor — is priced with its BEST comm plan
through the simulator's exposed-comm semantics
(``Simulator.simulate(sync_schedule=...)``):

* ``JointPricer.price`` = one exposed-comm simulation under the
  strategy's chosen plan, minus the per-group optimizer-sharding
  (ZeRO-1) update credit;
* the plan itself — bucket composition, per-bucket wire precision,
  staged reduction plans, per-group optimizer-state sharding — is
  memoized under the strategy's SYNCED-GROUP SIGNATURE (the
  topo-ordered (op name, op signature, view) tuple of its weighted
  nodes).  Most substitutions insert weightless parallel ops and most
  DP re-validations revisit previously seen view combinations, so the
  plan is *served*, not re-searched; only a genuinely new signature
  pays the full ``choose_sync_schedule`` sweep (~10 simulations);
* served/searched counts land in ``search.perf``
  (``comm_plan_serves`` / ``comm_plan_searches``) and, when telemetry
  is on, every decision emits a ``search.comm_plan`` event (rendered
  by ``ffobs report``);
* plans persist across processes as a third ``COST_CACHE.json`` layer
  (``comm_plans`` under ``comm_schema``, search/cost_cache.py) keyed
  by a process-stable digest of the signature — a warm process serves
  plans the way it already serves cost rows and DP memo rows.

The per-group optimizer-state sharding dimension ("Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training",
arXiv:2004.13336): instead of the global ``FFConfig.zero_dp_shard``
flag, co-search picks, per synced weight group, whether its optimizer
state (and update compute) shards over the group's replication axes —
the update term shrinks by the achieved shard factor, which is the
credit the joint currency subtracts (the RS+AG pair moves the same
ring bytes as the flat allreduce, so the wire is a wash; the update
and memory are not).  The chosen map persists in the strategy file's
``__meta__.zero_groups`` behind the digest gate, is linted always-on
(``analysis.lint_zero_map``, SHD140/141) and stdlib-checked by
``fflint strategy`` (STR207), and executes through the lowering's
per-group ZeRO shardings.

With ``co_search=False`` (the default) nothing here runs and the
sequential strategy→plan pipeline is bit-identical to history — the
regression gate tests/test_co_search.py enforces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.metrics import METRICS

_PLAN_SERVES = METRICS.counter("comm_plan.serves")
_PLAN_SEARCHES = METRICS.counter("comm_plan.searches")


def synced_signature(graph, strategy) -> Tuple:
    """The strategy's synced-group signature: topo-ordered
    ``(op name, op signature, dim degrees, replica degree)`` for every
    WEIGHTED node.  Two (graph, strategy) pairs with equal signatures
    have identical synced-group sets, wire-precision choices, bucket
    memberships and zero-sharding trade-offs — the comm plan transfers
    verbatim (bucket membership is by op name, and names survive
    rewrites: substitutions insert weightless parallel ops).  Cheap by
    construction: no propagation, no cost model — the per-candidate
    hot-path key of the co-search memo."""
    from flexflow_tpu_torch.core.machine import MachineView

    sig = []
    for node in graph.topo_order():
        if not getattr(node.op, "_weight_specs", ()):
            continue
        mv = strategy.get(node.guid)
        if mv is None:
            mv = node.op.fixed_machine_view() or MachineView.trivial(
                node.op.output_shapes[0].ndim
            )
        sig.append((node.op.name, node.op.signature(),
                    tuple(mv.dim_degrees), int(mv.replica_degree)))
    return tuple(sig)


def signature_digest(sig: Tuple, config) -> str:
    """Process-stable digest of a synced-group signature plus the comm
    knobs the cost-cache signature does not already pin — the key of
    the persistent comm-plan layer (op signatures repr-stable the same
    way the persisted cost rows are)."""
    from hashlib import blake2b

    knobs = (int(getattr(config, "sync_bucket_bytes", 0) or 0),)
    return blake2b(repr((sig, knobs)).encode(),
                   digest_size=12).hexdigest()


def zero_weight_shards(cost_model, op, mv):
    """Per-weight ``(update_seconds, shard_factor)`` rows for ``(op,
    mv)`` under per-group ZeRO-1 — the SAME evenly-divisible placement
    rule the lowering's ``_zero_augmented`` and ``CostModel.op_memory``
    apply (``place_zero_factors``, per WEIGHT over the axes that weight
    does not consume), so the priced credit matches what execution
    realizes: an armed op shards EVERY weight over its own free axes,
    each by its own achieved factor.  [] when propagation fails."""
    from flexflow_tpu_torch.parallel.mesh import place_zero_factors, prime_factors

    try:
        osh = op.propagate(mv)
    except Exception:
        return []
    nd = cost_model.num_devices or cost_model.machine.num_devices
    hbm = cost_model.machine.hbm_bandwidth
    rows = []
    for ws, annot in zip(op._weight_specs, osh.weights):
        degrees = annot.degrees if annot is not None else ()
        shard_elems = 1
        for d in ws.shape:
            shard_elems *= d
        sharded = 1
        for d in degrees:
            shard_elems //= max(d, 1)
            sharded *= max(d, 1)
        upd = (cost_model.OPT_UPDATE_PASSES * shard_elems
               * ws.dtype.itemsize / hbm)
        achieved = 1
        if sharded >= 1 and nd % sharded == 0 and nd > sharded:
            extents = [
                s // max(d, 1) if d and s % max(d, 1) == 0 else 1
                for s, d in zip(ws.shape, degrees)
            ]
            free = prime_factors(nd // sharded)
            for _, fi in place_zero_factors(extents, free):
                achieved *= free[fi]
        rows.append((upd, float(achieved)))
    return rows


def zero_update_factor(cost_model, op, mv) -> float:
    """The EFFECTIVE optimizer-update shrink factor per-group ZeRO-1
    achieves for ``(op, mv)``: total update seconds over the sharded
    update seconds, from the per-weight rows above.  1.0 when nothing
    shards (no placeable factor on any weight)."""
    rows = zero_weight_shards(cost_model, op, mv)
    total = sum(u for u, _f in rows)
    sharded = sum(u / f for u, f in rows)
    if total <= 0.0 or sharded <= 0.0 or sharded >= total:
        return 1.0
    return total / sharded


def choose_zero_groups(graph, strategy, cost_model) -> Tuple[Tuple[str, ...],
                                                             float]:
    """Per-group optimizer-state sharding choice: the op names whose
    update term genuinely shrinks under ZeRO-1 sharding (achieved
    factor > 1), plus the total update-seconds credit — the RS+AG pair
    moves the same ring bytes as the flat allreduce it replaces, so
    the wire term is a wash and the priced win is the update compute
    (the memory win additionally relaxes feasibility, credited
    conservatively: never).  Returns ``((), 0.0)`` when nothing
    qualifies."""
    from flexflow_tpu_torch.core.machine import MachineView

    # stamped production graphs (segment stamping) can carry the
    # SAME op name on several weighted nodes — a name-keyed map cannot
    # address them individually, so ambiguous names are skipped (no
    # credit claimed, nothing executed for them)
    weighted = [n for n in graph.topo_order()
                if getattr(n.op, "_weight_specs", ())]
    counts: Dict[str, int] = {}
    for n in weighted:
        counts[n.op.name] = counts.get(n.op.name, 0) + 1
    names = []
    credit = 0.0
    for node in weighted:
        if counts[node.op.name] > 1:
            continue
        mv = strategy.get(node.guid)
        if mv is None:
            mv = node.op.fixed_machine_view() or MachineView.trivial(
                node.op.output_shapes[0].ndim
            )
        try:
            osh = node.op.propagate(mv)
        except Exception:
            continue
        # membership requires a SYNCED (replicated) weight — the wash
        # argument (RS+AG vs flat allreduce) only holds there, and the
        # SHD140 lint enforces it; the credit then sums PER WEIGHT,
        # because an armed op shards every weight over its own free
        # axes by its own factor (lowering._zero_augmented)
        if not any(a is not None and a.replica > 1 for a in osh.weights):
            continue
        rows = zero_weight_shards(cost_model, node.op, mv)
        saving = sum(u * (1.0 - 1.0 / f) for u, f in rows if f > 1.0)
        if not math.isfinite(saving) or saving <= 0.0:
            continue
        names.append(node.op.name)
        credit += saving
    return tuple(names), credit


@dataclass
class CommPlanEntry:
    """One memoized comm plan: the exposed-comm schedule the joint
    currency prices with (ALWAYS present — the monolithic bucket
    composition when nothing beat it), whether bucketing was adopted
    over monolithic, the per-group wire-precision map, and the
    per-group optimizer-sharding choice with its update credit."""

    schedule: object  # search.sync_schedule.SyncSchedule
    adopted: bool
    pmap: Dict[str, str] = field(default_factory=dict)
    zero: Tuple[str, ...] = ()
    zero_credit: float = 0.0

    def to_jsonable(self) -> dict:
        return {
            "schedule": self.schedule.to_jsonable(),
            "adopted": bool(self.adopted),
            "pmap": dict(self.pmap),
            "zero": list(self.zero),
            "credit": float(self.zero_credit),
        }

    @staticmethod
    def from_jsonable(data) -> "CommPlanEntry":
        from flexflow_tpu_torch.search.sync_schedule import SyncSchedule

        if not isinstance(data, dict):
            raise ValueError("comm plan row is not an object")
        pmap = data.get("pmap", {})
        zero = data.get("zero", [])
        credit = data.get("credit", 0.0)
        if (not isinstance(pmap, dict)
                or not isinstance(zero, list)
                or any(not isinstance(z, str) for z in zero)
                or not isinstance(credit, (int, float))):
            raise ValueError("comm plan row carries malformed fields")
        return CommPlanEntry(
            schedule=SyncSchedule.from_jsonable(data.get("schedule")),
            adopted=bool(data.get("adopted")),
            pmap={str(k): str(v) for k, v in pmap.items()},
            zero=tuple(zero),
            zero_credit=float(credit),
        )


class JointPricer:
    """The co-search pricing engine one ``optimize_strategy`` run
    shares: a comm-plan memo (in-process dict + the persistent
    ``comm_plans`` cost-cache layer) and the joint ``price`` function
    every candidate-grounding site calls instead of the legacy
    ``Simulator.simulate``."""

    def __init__(self, config, cost_cache=None):
        self.config = config
        self.cost_cache = cost_cache
        self._memo: Dict[Tuple, Optional[CommPlanEntry]] = {}
        self.serves = 0
        self.searches = 0

    # ------------------------------------------------------------------
    def plan_for(self, graph, strategy, sim) -> Optional[CommPlanEntry]:
        """The best comm plan for ``(graph, strategy)`` — served from
        the signature memo (then the persistent layer) when the synced
        -group signature was seen before, searched fresh otherwise.
        None when the strategy syncs nothing (the comm plan dimension
        is empty and the legacy scalar currency is already exact)."""
        sig = synced_signature(graph, strategy)
        if not sig:
            return None
        if sig in self._memo:
            self.serves += 1
            _PLAN_SERVES.inc()
            if BUS.enabled:
                BUS.emit("search.comm_plan", served=True, source="memo",
                         groups=len(sig))
            return self._memo[sig]
        cc = self.cost_cache
        digest = None
        if cc is not None:
            digest = signature_digest(sig, self.config)
            row = cc.get_comm_plan(digest)
            if row is not None:
                try:
                    entry = CommPlanEntry.from_jsonable(row)
                except ValueError:
                    entry = None  # malformed row: one re-search, and
                    # fflint cache (CCH408) points at the corruption
                if entry is not None:
                    self._memo[sig] = entry
                    self.serves += 1
                    _PLAN_SERVES.inc()
                    if BUS.enabled:
                        BUS.emit("search.comm_plan", served=True,
                                 source="disk", groups=len(sig))
                    return entry
        entry = self._search_plan(graph, strategy, sim)
        self._memo[sig] = entry
        self.searches += 1
        _PLAN_SEARCHES.inc()
        if BUS.enabled:
            BUS.emit("search.comm_plan", served=False, source="search",
                     groups=len(sig),
                     adopted=bool(entry is not None and entry.adopted))
        if entry is not None and cc is not None and digest is not None:
            cc.put_comm_plan(digest, entry.to_jsonable())
        return entry

    def _search_plan(self, graph, strategy, sim) -> Optional[CommPlanEntry]:
        """The full comm-plan search for one signature: per-group wire
        precision, bucketed schedule sweep (+ staged reduction plans on
        hierarchical machines) through ``choose_sync_schedule``, and
        the per-group optimizer-sharding choice.  Falls back to the
        MONOLITHIC bucket composition when nothing beats it — the
        joint currency must price every candidate in the same
        exposed-comm semantics, never the legacy per-node credit."""
        import math as _math

        from flexflow_tpu_torch.search.sync_schedule import (
            build_bucketed_schedule,
            choose_sync_schedule,
            synced_weight_groups,
        )

        synced_names = [
            n.op.name for n in graph.topo_order()
            if getattr(n.op, "_weight_specs", ())
        ]
        if len(synced_names) != len(set(synced_names)):
            # stamped production graphs can repeat op names (the
            # segment stamping) — every comm-plan artifact is keyed by
            # op NAME, so the plan dimension is undefined there: the
            # candidate prices in the legacy scalar currency instead
            return None
        pmap: Dict[str, str] = {}
        if getattr(self.config, "sync_precision", "fp32") != "fp32":
            from flexflow_tpu_torch.search.sync_precision import (
                choose_sync_precision,
            )

            pmap = choose_sync_precision(graph, strategy, sim.cost)
        schedule, _info = choose_sync_schedule(
            graph, strategy, sim, pmap, self.config)
        adopted = schedule is not None
        if schedule is None:
            synced = synced_weight_groups(graph, strategy, sim.cost)
            if not synced:
                return None
            schedule = build_bucketed_schedule(synced, pmap, _math.inf)
            if schedule is None:
                return None
        zero, credit = choose_zero_groups(graph, strategy, sim.cost)
        return CommPlanEntry(schedule=schedule, adopted=adopted,
                             pmap=dict(pmap), zero=zero,
                             zero_credit=credit)

    # ------------------------------------------------------------------
    def price(self, sim, graph, strategy) -> float:
        """The joint currency: the exposed-comm simulated step under
        the strategy's best comm plan, minus the per-group
        optimizer-sharding update credit.  Strategies that sync
        nothing price exactly as the legacy scalar simulation (the two
        currencies coincide there)."""
        entry = self.plan_for(graph, strategy, sim)
        if entry is None:
            return sim.simulate(graph, strategy)
        cost = sim.simulate(graph, strategy, sync_schedule=entry.schedule)
        if not math.isfinite(cost):
            return cost
        return max(0.0, cost - entry.zero_credit)
