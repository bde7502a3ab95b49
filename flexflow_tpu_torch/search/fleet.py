"""Serving fleet searched as one N-block placement + routing question —
a copy of flexflow_tpu/search/fleet.py (runtime/fleet.py executes an
adopted proposal over rank blocks).

``search/disaggregation.py`` prices TWO blocks (prefill, decode) on
disjoint submeshes.  This pass generalizes the move to N REPLICA
blocks: partition the mesh into replica submeshes, give every block its
own full rewriting search at its width (and optionally its own
intra-replica prefill/decode split — the two-block machinery nested
one level down), and price the candidate fleet together with the
per-SLO-class ROUTING fractions that decide which classes land where.
"How many replicas × which strategy each × which classes route where"
is one searched question in one currency: per-class p99 seconds.

The currency extends the serve objective's ragged-arrival model
(search/serving.py) with two fleet-specific terms:

* **arrival shares** — a replica routed a fraction ``x`` of the
  fleet's traffic runs PARTIAL frames: only ``round(x·load·max_seqs)``
  sequence slots are live.  ``ServingSpec.with_occupancy`` prices
  exactly that frame (the decode op's cache stream scales, weights and
  collectives do not — which is why narrow replicas are not free);
* **queueing** — each replica is charged an M/M/1-style wait factor
  per class, ``Q = u/(1-u)`` with ``u`` the utilization its
  PRIORITY-ADMISSION lane sees (only traffic of equal-or-higher
  priority delays a class, mirroring the executor's admission order),
  so a dedicated low-utilization replica is exactly the mechanism that
  buys an interactive class its p99.

Per class the fleet's p99 is the worst replica it routes to:

    p99_c = max_{r: f_{c,r} > 0}  T_r · (1 + Q_{c,r})
    T_r   = T_dec(w_r, slots_r) + pre_r · T_pre(w_r) / L        (coloc)
          | max(T_dec(b, slots_r), pre_r · T_pre(a) / L) + T_handoff
    cost  = Σ_c a_c · p99_c

with ``a_c`` the per-class arrival weights (the normalized ``weight``
field of the SLO class table),
``pre_r`` the replica's share of the prompt-token arrival stream, and
the intra-replica (a, b) split searched per block exactly like the
top-level disaggregation.  The single-replica baseline is the SAME
formula at k = 1, so adoption compares like with like; the winner must
beat it by the search margin.  ``load_scale`` re-parameterizes the
offered load — the controller's elastic re-search feeds the measured
p99 drift ratio back through it, which is how a drift episode can
re-size N (runtime/controller.py's ``observe_fleet`` and
``research_fleet``).

Adopted fleets are always-on lint-gated (SHD166 N-block frame/overlap,
SHD167 routing coverage + pool-geometry coherence, flat SHD101-110 per
block) and persist as ``__meta__.fleet`` behind the digest gate with
import re-lint (model.compile).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.core.machine import MachineView

Strategy = Dict[int, MachineView]

# utilization clamp: past this the M/M/1 wait is effectively "the lane
# is saturated" — an unbounded queue would make every comparison inf
U_CAP = 0.95
DEFAULT_CLASS = {"name": "standard", "priority": 0, "deadline_frames": 0,
                 "quantile": 0.99}


@dataclass
class FleetReplica:
    """One priced replica block: its submesh, its searched strategy,
    its optional intra-replica prefill/decode split, and its share of
    the arrival stream."""

    index: int
    devices: int
    start: int
    prefill_devices: int  # 0 = colocated inside the replica
    decode_devices: int
    share: float  # fraction of total arrival traffic routed here
    occupancy_slots: int  # live sequence slots the share fills
    step_s: float  # priced frame time at this share
    handoff_s: float
    spans_dcn: bool
    # runtime-only (not persisted): the searched block strategies and
    # the (possibly rewritten) block graphs they map
    strategy: Strategy = field(default_factory=dict, repr=False)
    graph: object = field(default=None, repr=False)
    prefill_strategy: Strategy = field(default_factory=dict, repr=False)
    prefill_graph: object = field(default=None, repr=False)

    def to_meta(self) -> dict:
        return {
            "replica": self.index,
            "devices": self.devices,
            "start": self.start,
            "prefill_devices": self.prefill_devices,
            "decode_devices": self.decode_devices,
            "share": round(self.share, 6),
            "occupancy_slots": self.occupancy_slots,
            "step_ms": round(self.step_s * 1e3, 6),
            "handoff_ms": round(self.handoff_s * 1e3, 6),
            "spans_dcn": self.spans_dcn,
            "strategy_ops": len(self.strategy),
        }


@dataclass
class FleetProposal:
    """One priced fleet decision: the replica blocks, the per-class
    routing fractions, and the fleet-vs-single per-class p99
    comparison.  ``adopted`` is the margin-gated verdict — a proposal
    is always returned (the bench records honest zeros), only adopted
    winners persist."""

    num_devices: int
    replicas: Tuple[FleetReplica, ...]
    routing: Dict[str, Tuple[float, ...]]  # class -> per-replica f
    routing_policy: str
    single_cost_s: float
    fleet_cost_s: float
    per_class_p99_s: Dict[str, float]
    single_per_class_p99_s: Dict[str, float]
    adopted: bool
    max_seqs: int
    page_size: int
    pages_per_seq: int
    offered_load: float
    load_scale: float
    slo_classes: Tuple[dict, ...] = ()

    def to_meta(self) -> dict:
        """The jsonable ``__meta__.fleet`` block (what fflint STR212
        re-checks stdlib-only).  Pool geometry rides along because
        every replica's page allocator must agree with the decode
        graph's own frame."""
        return {
            "num_devices": self.num_devices,
            "replicas": [r.to_meta() for r in self.replicas],
            "routing": {c: [round(f, 6) for f in fr]
                        for c, fr in sorted(self.routing.items())},
            "routing_policy": self.routing_policy,
            "single_step_ms": round(self.single_cost_s * 1e3, 6),
            "fleet_step_ms": round(self.fleet_cost_s * 1e3, 6),
            "per_class_p99_ms": {
                c: round(v * 1e3, 6)
                for c, v in sorted(self.per_class_p99_s.items())},
            "max_seqs": self.max_seqs,
            "page_size": self.page_size,
            "pages_per_seq": self.pages_per_seq,
            "offered_load": round(self.offered_load, 6),
            "load_scale": round(self.load_scale, 6),
            "slo_classes": [dict(c) for c in self.slo_classes],
        }


def _partitions(n: int, max_parts: int) -> List[Tuple[int, ...]]:
    """Mesh partitions into replica widths: non-increasing parts, each
    a divisor of ``n`` (submesh-aligned, the same rule the two-block
    budget pairs follow), at most ``max_parts`` parts, summing exactly
    to ``n``.  Deterministic order: widest-first lexicographic."""
    widths = [w for w in range(n, 0, -1) if n % w == 0]
    out: List[Tuple[int, ...]] = []

    def rec(remaining: int, cap: int, acc: List[int]) -> None:
        if remaining == 0:
            out.append(tuple(acc))
            return
        if len(acc) >= max_parts:
            return
        for w in widths:
            if w <= cap and w <= remaining:
                acc.append(w)
                rec(remaining - w, w, acc)
                acc.pop()

    rec(n, n, [])
    return out


def _routing_candidates(classes: Sequence[dict],
                        speeds: Sequence[float]) -> List[Tuple[str, Dict[str, List[float]]]]:
    """The deterministic routing-policy set priced per partition.  Each
    candidate maps class name -> per-replica fractions summing to 1.
    ``speeds`` are full-occupancy frame times per replica (pricing
    evaluates the EXACT fractions afterwards; speeds only order)."""
    k = len(speeds)
    names = [c["name"] for c in classes]
    uniform = {c: [1.0 / k] * k for c in names}
    out = [("uniform", uniform)]
    if k == 1:
        return out
    inv = [1.0 / s if s > 0 else 0.0 for s in speeds]
    tot = sum(inv) or 1.0
    out.append(("capacity", {c: [v / tot for v in inv] for c in names}))
    if len(names) > 1:
        # classes by priority desc then name; replicas fastest-first
        by_pri = sorted(classes,
                        key=lambda c: (-int(c.get("priority", 0)),
                                       c["name"]))
        order = sorted(range(k), key=lambda i: (speeds[i], i))
        fastest = order[0]
        rest = [i for i in range(k) if i != fastest]
        rtot = sum(inv[i] for i in rest) or 1.0
        dedicated = {}
        for c in by_pri:
            f = [0.0] * k
            if c is by_pri[0]:
                f[fastest] = 1.0
            else:
                for i in rest:
                    f[i] = inv[i] / rtot
            dedicated[c["name"]] = f
        out.append(("dedicated", dedicated))
        tiered = {}
        for j, c in enumerate(by_pri):
            f = [0.0] * k
            f[order[j % k]] = 1.0
            tiered[c["name"]] = f
        out.append(("tiered", tiered))
    return out


def propose_fleet(decode_graph, decode_strategy, config, *,
                  calibration=None, prefill_graph=None,
                  prefill_config=None, base_graph=None,
                  load_scale: float = 1.0) -> Optional[FleetProposal]:
    """Search the replica-fleet space for ``decode_graph`` under its
    searched ``decode_strategy`` and return the best N-block proposal
    (``adopted`` when a k > 1 fleet beats the single-replica baseline
    by the search margin), or None when the graph/machine cannot
    express one.  Always-on lint gate: an adopted fleet that fails
    SHD166/167 is a search bug and raises ``AnalysisError`` loudly.

    ``load_scale`` multiplies the configured offered load — the
    controller's elastic re-search passes the measured p99 drift ratio
    here, which is what lets a drift episode re-size N."""
    import dataclasses

    from flexflow_tpu_torch.obs.events import BUS
    from flexflow_tpu_torch.search.disaggregation import kv_handoff_bytes
    from flexflow_tpu_torch.search.placement_search import _budget_pairs
    from flexflow_tpu_torch.search.serving import serving_spec_for
    from flexflow_tpu_torch.search.simulator import Simulator

    n = config.search_devices
    if n < 2:
        return None
    spec = serving_spec_for(decode_graph, config)
    if spec is None:
        return None
    load_pre = spec.prefill_tokens_per_frame()
    L = spec.prompt_tokens_mean or max(1, spec.max_seq_len // 2)
    offered = float(getattr(config, "serve_fleet_offered_load", 0.85))
    ls = offered * max(0.0, float(load_scale))
    max_k = max(1, int(getattr(config, "serve_fleet_max_replicas", 4)))
    classes = [dict(c) for c in
               (getattr(config, "serve_slo_classes", None) or ())]
    if not classes:
        classes = [dict(DEFAULT_CLASS)]
    # per-class arrival weights: the relative rates the SLO table
    # declares (config.parse_slo_classes), normalized to a distribution
    wsum = sum(float(c.get("weight", 1.0)) for c in classes)
    wt = {c["name"]: float(c.get("weight", 1.0)) / wsum for c in classes}

    if prefill_graph is None:
        from flexflow_tpu_torch.models.decode import derive_prefill_model

        pre_model, prefill_config = derive_prefill_model(
            decode_graph, config, seq_len=L)
        prefill_graph = pre_model.graph
    elif prefill_config is None:
        prefill_config = config
    from flexflow_tpu_torch.runtime.prefill import prefill_weight_bridge

    try:
        prefill_weight_bridge(prefill_graph, decode_graph)
    except ValueError:
        return None

    block_graph = base_graph if base_graph is not None else decode_graph
    machine = config.machine_spec
    dph = getattr(machine, "devices_per_host", 0) or n
    bpt = kv_handoff_bytes(decode_graph, 1.0)  # KV bytes per token

    # ---- per-width block solves (memoized, same discipline as the
    # two-block search: each block is a real deployment on its submesh
    # and earns whatever rewrites its mesh admits) -------------------------
    _solve_memo: Dict[Tuple, Tuple] = {}

    def _block_search(graph, cfg, devices, serving_armed):
        key = (id(graph), devices, serving_armed)
        if key in _solve_memo:
            return _solve_memo[key]
        from flexflow_tpu_torch.search.driver import optimize_strategy

        cfg_blk = dataclasses.replace(
            cfg, num_devices=devices, search_num_devices=0,
            export_strategy_file=None, import_strategy_file=None,
            serve_disaggregation="off", serve_fleet="off")
        try:
            g_blk, s_blk = optimize_strategy(graph, cfg_blk,
                                             return_graph=True)
        except Exception:
            _solve_memo[key] = (math.inf, None, None)
            return _solve_memo[key]
        if not s_blk:
            _solve_memo[key] = (math.inf, None, None)
            return _solve_memo[key]
        sim_blk = Simulator.for_config(
            cfg_blk, calibration=calibration,
            serving=spec if serving_armed else None)
        _solve_memo[key] = (sim_blk.simulate(g_blk, s_blk), g_blk, s_blk)
        return _solve_memo[key]

    def _dec_block(devices):
        """(full-occupancy cost, graph, strategy) of a decode block at
        ``devices`` wide.  The full-mesh block reuses the model's own
        searched strategy — the same graph the colocated baseline
        prices, no redundant search."""
        if devices == n:
            key = ("dec-full", n)
            if key not in _solve_memo:
                sim = Simulator.for_config(config, calibration=calibration,
                                           serving=spec)
                _solve_memo[key] = (sim.simulate(decode_graph,
                                                 decode_strategy),
                                    decode_graph, decode_strategy)
            return _solve_memo[key]
        return _block_search(block_graph, config, devices,
                             serving_armed=True)

    # occupancy-priced decode frames: the SAME block (graph, strategy),
    # re-simulated with only ``slots`` live sequence slots — cache
    # stream scales with the share, weights/collectives do not.
    # Detached simulators (bench-local probes, not the search surface).
    _occ_memo: Dict[Tuple[int, int], float] = {}

    def _dec_at(devices: int, slots: int) -> float:
        key = (devices, slots)
        hit = _occ_memo.get(key)
        if hit is not None:
            return hit
        full, g_blk, s_blk = _dec_block(devices)
        if not math.isfinite(full):
            _occ_memo[key] = math.inf
            return math.inf
        if slots >= spec.max_seqs:
            _occ_memo[key] = full
            return full
        sim = Simulator(
            machine, num_devices=devices, calibration=calibration,
            inference=True, serving=spec.with_occupancy(slots))
        _occ_memo[key] = sim.simulate(g_blk, s_blk)
        return _occ_memo[key]

    def _pre_block(devices):
        return _block_search(prefill_graph, prefill_config, devices,
                             serving_armed=False)

    def _replica_price(width: int, start: int, share: float):
        """Best intra-replica phase placement for a block of ``width``
        devices at arrival ``share``: colocated, or the best
        (prefill a, decode b) split — the two-block search nested at
        replica scope.  Returns (step_s, pre_dev, dec_dev, handoff_s,
        spans_dcn, slots) or None."""
        occ = min(1.0, ls * share)
        slots = max(1, min(spec.max_seqs,
                           int(round(occ * spec.max_seqs))))
        pre_load = ls * share * load_pre
        t_dec = _dec_at(width, slots)
        t_pre_w, _, _ = _pre_block(width)
        if not (math.isfinite(t_dec) and math.isfinite(t_pre_w)):
            return None
        best = (t_dec + pre_load * (t_pre_w / L), 0, width, 0.0, False)
        for a, b in _budget_pairs(width):
            t_pre_a, _, _ = _pre_block(a)
            if not math.isfinite(t_pre_a):
                continue
            t_dec_b = _dec_at(b, slots)
            if not math.isfinite(t_dec_b):
                continue
            spans = ((start + a + b - 1) // dph
                     > (start + a - 1) // dph)
            bytes_pf = bpt * pre_load
            if spans:
                handoff = (bytes_pf / machine.dcn_bandwidth
                           + machine.dcn_latency)
            else:
                handoff = (bytes_pf / machine.ici_bandwidth
                           + machine.ici_latency)
            cand = max(t_dec_b, pre_load * (t_pre_a / L)) + handoff
            if cand < best[0]:
                best = (cand, a, b, handoff, spans)
        return best + (slots,)

    def _price(widths, fractions):
        """(cost_s, per_class_p99_s, replica details) for one
        (partition, routing) candidate, or None when any loaded block
        is infeasible."""
        k = len(widths)
        starts = [sum(widths[:i]) for i in range(k)]
        shares = [sum(wt[c["name"]] * fractions[c["name"]][r]
                      for c in classes)
                  for r in range(k)]
        details = []
        for r in range(k):
            priced = _replica_price(widths[r], starts[r], shares[r])
            if priced is None:
                return None
            details.append(priced)
        per_class: Dict[str, float] = {}
        for c in classes:
            pri = int(c.get("priority", 0))
            worst = 0.0
            for r in range(k):
                if fractions[c["name"]][r] <= 1e-12:
                    continue
                # priority admission: only equal-or-higher priority
                # traffic on this replica delays class c
                u = ls * sum(
                    wt[cc["name"]] * fractions[cc["name"]][r]
                    for cc in classes
                    if int(cc.get("priority", 0)) >= pri)
                u = min(U_CAP, u)
                lat = details[r][0] * (1.0 + u / (1.0 - u))
                worst = max(worst, lat)
            if worst == 0.0:
                return None  # class routed nowhere: illegal candidate
            per_class[c["name"]] = worst
        cost = sum(wt[c["name"]] * per_class[c["name"]] for c in classes)
        return cost, per_class, starts, shares, details

    # ---- enumerate partitions × routing policies -------------------------
    best_single = None
    best_fleet = None
    for widths in _partitions(n, max_k):
        k = len(widths)
        speeds = []
        feasible = True
        for w in widths:
            full, _, _ = _dec_block(w)
            if not math.isfinite(full):
                feasible = False
                break
            speeds.append(full)
        if not feasible:
            continue
        for policy, fractions in _routing_candidates(classes, speeds):
            priced = _price(widths, fractions)
            if priced is None:
                continue
            cand = (priced[0], k, widths, policy, fractions, priced)
            if k == 1:
                if best_single is None or cand[0] < best_single[0]:
                    best_single = cand
            elif best_fleet is None or cand[0] < best_fleet[0]:
                best_fleet = cand

    if best_single is None:
        return None
    if best_fleet is None:
        best_fleet = best_single
    margin = max(0.0, config.search_improvement_margin)
    adopted = (best_fleet[1] > 1
               and best_fleet[0] < best_single[0] * (1.0 - margin))
    chosen = best_fleet if adopted else best_single
    cost, k, widths, policy, fractions, priced = chosen
    _, per_class, starts, shares, details = priced

    replicas = []
    for r in range(k):
        step_s, a, b, handoff, spans, slots = details[r]
        _, g_dec, s_dec = _dec_block(b if a else widths[r])
        pre_s, g_pre, s_pre = (None, None, None)
        if a:
            _, g_pre, s_pre = _pre_block(a)
        replicas.append(FleetReplica(
            index=r, devices=widths[r], start=starts[r],
            prefill_devices=a, decode_devices=b if a else widths[r],
            share=shares[r], occupancy_slots=slots, step_s=step_s,
            handoff_s=handoff, spans_dcn=spans,
            strategy=s_dec or {}, graph=g_dec,
            prefill_strategy=s_pre or {}, prefill_graph=g_pre,
        ))
    routing = {c["name"]: tuple(fractions[c["name"]]) for c in classes}
    single_per_class = best_single[5][1]
    proposal = FleetProposal(
        num_devices=n, replicas=tuple(replicas), routing=routing,
        routing_policy=policy, single_cost_s=best_single[0],
        fleet_cost_s=best_fleet[0], per_class_p99_s=dict(per_class),
        single_per_class_p99_s=dict(single_per_class), adopted=adopted,
        max_seqs=spec.max_seqs, page_size=spec.page_size,
        pages_per_seq=spec.pages_per_seq, offered_load=offered,
        load_scale=float(load_scale),
        slo_classes=tuple(dict(c) for c in classes),
    )
    if adopted:
        # always-on legality gate (SHD166/167 + per-block flat lint):
        # an adopted fleet that fails is a search bug
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_fleet,
        )

        blocks = [(rep.graph, rep.strategy, rep.decode_devices)
                  for rep in replicas]
        bad = errors_only(lint_fleet(decode_graph, proposal.to_meta(),
                                     config, replica_blocks=blocks))
        if bad:
            emit_findings(bad)
            raise AnalysisError(
                "fleet search produced an illegal N-block placement",
                bad)
    BUS.emit(
        "search.fleet", adopted=adopted, replicas=k,
        single_ms=round(best_single[0] * 1e3, 6),
        fleet_ms=round(best_fleet[0] * 1e3, 6),
        policy=policy, partition=list(widths),
        per_class_ms={c: round(v * 1e3, 6)
                      for c, v in sorted(per_class.items())},
        blocks=[rep.to_meta() for rep in replicas],
        routing={c: [round(f, 6) for f in fr]
                 for c, fr in sorted(routing.items())},
        load_scale=round(float(load_scale), 6),
    )
    from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

    log.log(
        f"fleet search: {k} replica(s) {list(widths)} policy={policy} "
        f"modeled {cost * 1e3:.4f} ms weighted per-class p99 vs "
        f"single-replica {best_single[0] * 1e3:.4f} ms — "
        f"{'ADOPTED' if adopted else 'single replica stays optimal'}"
    )
    return proposal
