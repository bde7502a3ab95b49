"""Event-driven strategy simulator — a copy of
flexflow_tpu/search/simulator.py.

Predicts the per-iteration runtime of (PCG, strategy) on the machine —
the role of Simulator::simulate_runtime (reference:
src/runtime/simulator.cc:796-1186): per-device timelines, compute tasks
placed on the devices their shards map to, xfer tasks on edges whose
shardings mismatch, and a post-pass adding weight-gradient allreduce
under device-availability constraints (reference: :1062-1186).

Device identity comes from the same canonical axis assignment the
lowering uses (parallel.mesh), so ops sharing axes serialize on the
same timeline while ops on disjoint sub-meshes overlap — which is what
makes VERTICAL/HORIZONTAL resource splits (inter-op parallelism) win
when they should.

The port prices collectives over the fabric its spec describes: the
NVSwitch of an H100 host (``network.nvswitch_network``) for a spec
whose ``platform`` is ``"cuda"``, the reference's torus for its TPU and
CPU specs.  ``simulate(sync_schedule=)`` prices a searched gradient-sync
schedule bucket by bucket (exposed-comm semantics).
``export_chrome_trace`` writes the predicted timeline as Chrome-trace
JSON (obs/trace.py), to load next to a real ``device_trace`` capture,
and ``export_task_graph_dot`` the simulated task graph as graphviz.
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.obs.metrics import METRICS
from flexflow_tpu_torch.search.machine_model import CostModel

# module-cached metric handles (objects stay valid across METRICS.reset)
_FULL_SIMS = METRICS.counter("sim.full")
_DELTA_SIMS = METRICS.counter("sim.delta")
_DELTA_BAILS = METRICS.counter("sim.delta_bails")


def _delta_check_enabled() -> bool:
    """FLEXFLOW_TPU_DELTA_CHECK=1: every delta-served simulate() result
    is re-derived by the full path and asserted bit-identical — the
    exact-equivalence contract as a runtime oracle (tests and debug
    sessions flip it; the hot path reads a module flag)."""
    import os

    return os.environ.get("FLEXFLOW_TPU_DELTA_CHECK", "") not in ("", "0")


DELTA_CHECK = _delta_check_enabled()

# lazily built OperatorType sets mirroring calibration.find_clusters
# membership (heads / fusable followers) — the hot _local_chain and
# cluster-dirty paths must not pay per-call imports or string compares
_HEAD_TYPES: Optional[frozenset] = None
_FUSABLE_TYPES: Optional[frozenset] = None


def _init_chain_types() -> None:
    global _HEAD_TYPES, _FUSABLE_TYPES
    if _HEAD_TYPES is not None:
        return
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.search.calibration import _CLUSTER_HEADS, _fusable

    class _Shim:
        __slots__ = ("op_type",)

        def __init__(self, t):
            self.op_type = t

    _FUSABLE_TYPES = frozenset(
        t for t in OperatorType if _fusable(_Shim(t)))
    _HEAD_TYPES = frozenset(
        t for t in OperatorType if t.value in _CLUSTER_HEADS)


class SimSnapshot:
    """Baseline schedule of one ``(graph, strategy)`` simulation in the
    default (scalar) cost currency — everything ``simulate`` derived
    per node, stored so a *substituted* graph can be re-costed by
    recomputing only the dirty cone (reference: simulator.h
    ``SIMULATE_DELTA``, which re-simulates only the tasks a
    substitution perturbed).

    Per node (by guid): resolved view, propagated sharding, the
    mode-selected cluster-scaled duration, sync/memory costs, the
    per-in-edge xfer seconds (training doubling baked in), and the
    baseline finish time.  Per topo position: the running scan state
    (device avail, memory prefix sum, compute/comm horizons, per-device
    comm timelines) so a delta walk can resume mid-schedule with
    bit-identical floats."""

    __slots__ = (
        "graph", "include_update", "cal_version", "order", "views",
        "ops", "annots", "in_list", "out_list", "rec", "finish",
        "chain", "pre_avail", "pre_mem", "pre_end_time", "pre_end_comm",
        "pre_comm", "total",
    )


class Simulator:
    def __init__(self, machine: MachineSpec, num_devices: Optional[int] = None,
                 use_network_model: bool = True, calibration=None,
                 placement_overlap: bool = False, zero_dp_shard: bool = False,
                 inference: bool = False, sync_precision: str = "fp32",
                 sync_ef: bool = False, cost_cache=None, serving=None):
        self.machine = machine
        self.num_devices = num_devices or machine.num_devices
        # placement_overlap=True credits inter-op COMPUTE overlap for
        # views on disjoint device blocks (start_part offsets — the
        # reference's mapper really places subgraphs on disjoint GPUs,
        # mapper.cc:371-475).  Such strategies EXECUTE in the reference:
        # two-block start_part strategies lower to per-submesh programs
        # (compiler/placement_lowering.py) whose async dispatch overlaps
        # segments across consecutive steps.  The default stays False
        # because the DEFAULT lowering is one SPMD program where a view
        # with fewer parts than devices is replicated, not placed —
        # simulate with placement_overlap=True only when the strategy
        # will go down the placed lowering.  Comm-group overlap (weight
        # syncs over distinct device groups) IS real and stays on
        # view-level device sets in both modes.
        self.placement_overlap = placement_overlap
        # inference=True: simulate() defaults to forward-only costs with
        # no weight sync (the reference's COMP_MODE_INFERENCE,
        # config.h:47-50 / FFModel::compile comp_mode arg) — the search
        # then ranks strategies by inference latency
        self.inference = inference
        self._all_devices = frozenset(range(self.num_devices))
        network = None
        if use_network_model:
            from flexflow_tpu_torch.search.network import (
                ici_network,
                nvswitch_network,
            )

            build = (nvswitch_network if machine.platform == "cuda"
                     else ici_network)
            try:
                network = build(machine, num_devices=self.num_devices)
            except (AssertionError, ValueError):
                network = None
        # serving: a search/serving.py ServingSpec — arms the serve
        # objective's ragged-load pricing (MUST be set at construction,
        # before the persistent cost cache computes its signature, so
        # serve-currency rows never cross-serve train runs)
        self.cost = CostModel(machine, network=network, calibration=calibration,
                              num_devices=self.num_devices,
                              zero_dp_shard=zero_dp_shard,
                              inference=inference,
                              sync_precision=sync_precision,
                              sync_ef=sync_ef,
                              serving=serving)
        self._device_sets: Dict[Tuple, FrozenSet[int]] = {}
        # propagate()/op_cost results per (op signature, view): structural
        # keys stay valid across graph copies and op lifetimes (an id()
        # key could be recycled after GC during a long search)
        self._prop_cache: Dict[Tuple, object] = {}
        self._cost_cache: Dict[Tuple, Tuple[float, float, float]] = {}
        # optional persistent CostCache (search/cost_cache.py): misses
        # of the in-memory row cache consult it before recomputing, so
        # repeated searches across processes start warm
        self.cost_cache = cost_cache
        # delta-simulation baseline (SimSnapshot) + counters.  full_sims
        # counts every full O(nodes+edges) schedule derivation (snapshot
        # builds included); delta_sims the incremental re-costs.
        self._baseline: Optional[SimSnapshot] = None
        self.full_sims = 0
        self.delta_sims = 0
        self.delta_bails = 0

    # ------------------------------------------------------------------
    def view_device_set(self, mv: MachineView, use_start: bool = True) -> FrozenSet[int]:
        """Device ids covered by a view: the contiguous block
        [start_part, start_part + num_parts) — the reference's stride-1
        MachineView box (machine_view.h:14-87).  Ops whose blocks are
        disjoint can overlap in time (inter-op parallelism from
        VERTICAL/HORIZONTAL resource splits); nested blocks (divisor
        degrees at the same start) serialize, like same-device ops.
        With use_start=False the offset is ignored (default executable
        mode, where GSPMD has no placement offsets)."""
        start = (mv.start_part % self.num_devices) if use_start else 0
        key = (mv.num_parts, start)
        hit = self._device_sets.get(key)
        if hit is None:
            n = min(max(1, mv.num_parts), self.num_devices)
            hit = frozenset((start + i) % self.num_devices for i in range(n))
            self._device_sets[key] = hit
        return hit

    @classmethod
    def for_config(cls, config, calibration=None, **kw):
        """Simulator matching an FFConfig's search settings — the ONE
        place every config-derived flag is threaded, so a new flag
        cannot miss a construction site (driver search, MCMC, strategy
        task-graph export).  Attaches the persistent cost cache when
        the config enables one (cost_cache_file / env)."""
        sim = cls(
            config.machine_spec,
            num_devices=config.search_devices,
            calibration=calibration,
            zero_dp_shard=config.zero_dp_shard,
            inference=config.comp_mode == "inference",
            sync_precision=getattr(config, "sync_precision", "fp32"),
            sync_ef=getattr(config, "sync_ef", "off") == "auto",
            **kw,
        )
        if sim.cost_cache is None:
            from flexflow_tpu_torch.search.cost_cache import load_for_simulator

            load_for_simulator(config, sim)
        return sim

    # ------------------------------------------------------------------
    def _node_costs(self, node, mv) -> Tuple[float, float, float, float]:
        """(fwd_cost, full_cost, weight_sync, mem_bytes) cached per
        (op, view)."""
        key = (node.op.signature(), (mv.dim_degrees, mv.replica_degree))
        hit = self._cost_cache.get(key)
        if hit is None:
            cc = self.cost_cache
            if cc is not None:
                hit = cc.get(node.op, mv)
            if hit is None:
                fwd = self.cost.op_cost(node.op, mv, backward=False)
                full = self.cost.op_cost(node.op, mv, backward=True)
                # sync at the precision the cost model's mode selects
                # (per weight group under "search") — both DP engines
                # consume this row, so compressed sync is priced
                # consistently
                sync = self.cost.sync_cost(node.op, mv)
                mem = self.cost.op_memory(node.op, mv)
                hit = (fwd, full, sync, mem)
                if cc is not None:
                    cc.put(node.op, mv, hit)
            self._cost_cache[key] = hit
        return hit

    def _propagate(self, node, mv):
        key = (node.op.signature(), (mv.dim_degrees, mv.replica_degree))
        hit = self._prop_cache.get(key)
        if hit is None:
            try:
                hit = node.op.propagate(mv)
            except AssertionError:
                hit = "invalid"
            self._prop_cache[key] = hit
        return None if hit == "invalid" else hit

    def simulate(
        self,
        graph: Graph,
        strategy: Dict[int, MachineView],
        include_update: Optional[bool] = None,
        schedule: Optional[list] = None,
        breakdown: Optional[dict] = None,
        comm_schedule: Optional[list] = None,
        sync_schedule=None,
    ) -> float:
        """Seconds per training iteration under the strategy (or per
        inference when the simulator was built with inference=True —
        ``include_update`` defaults to the simulator's mode).  Pass a
        list as ``schedule`` to receive per-task placement records
        ``(op_name, start_s, finish_s, device_ids)`` — the simulated
        task graph (reference: simulator.cc:1008-1058 dot export) —
        and as ``comm_schedule`` the weight-sync collective records in
        the same shape (the comm rows of the predicted timeline).
        Pass a dict as ``breakdown`` to receive the predicted phase
        split (compute/comm critical paths, total xfer/sync seconds,
        peak memory) — the predicted side of the obs DriftReport.

        ``sync_schedule`` — a gradient-sync schedule
        (search/sync_schedule.py): weight-gradient sync is then priced
        per BUCKET under exposed-comm semantics — a bucket's collective
        issues when the backward has produced all its members' grads
        and only costs what is not hidden under the backward compute
        still to run at that point (GSPMD async collectives,
        arXiv:2105.04663) — instead of the legacy per-node issuance.
        Per-bucket lanes land in ``comm_schedule`` and ``breakdown``
        gains ``sync_exposed_s`` + ``sync_buckets``.

        When a delta baseline is armed (``set_baseline``), calls in the
        default scalar currency are served incrementally: only the
        substituted nodes plus the downstream cone whose ready-times
        shift are recomputed, with a bit-identical-to-full contract
        (``_simulate_delta``; reference: simulator.h SIMULATE_DELTA)."""
        if include_update is None:
            include_update = not self.inference
        snap = self._baseline
        if (snap is not None and schedule is None and breakdown is None
                and comm_schedule is None and sync_schedule is None
                and not self.placement_overlap
                and include_update == snap.include_update
                and snap.cal_version == getattr(
                    self.cost.calibration, "version", None)):
            got = self._simulate_delta(snap, graph, strategy)
            if got is not None:
                self.delta_sims += 1
                _DELTA_SIMS.inc()
                if DELTA_CHECK:
                    full = self._simulate_full(
                        graph, strategy, include_update)
                    assert got == full or (
                        math.isnan(got) and math.isnan(full)
                    ), (
                        f"delta simulation diverged from full: "
                        f"{got!r} != {full!r}"
                    )
                return got
            self.delta_bails += 1
            _DELTA_BAILS.inc()
        return self._simulate_full(graph, strategy, include_update,
                                   schedule, breakdown, comm_schedule,
                                   sync_schedule)

    def _simulate_full(
        self,
        graph: Graph,
        strategy: Dict[int, MachineView],
        include_update: bool,
        schedule: Optional[list] = None,
        breakdown: Optional[dict] = None,
        comm_schedule: Optional[list] = None,
        sync_schedule=None,
    ) -> float:
        self.full_sims += 1
        _FULL_SIMS.inc()
        ready: Dict[Tuple[int, int], float] = {}  # (guid, out_idx) -> time
        device_avail: Dict[int, float] = {d: 0.0 for d in range(self.num_devices)}
        # per-device COMM timelines for weight-grad allreduces
        # (reference: simulator.cc:1062-1186 schedules NCCL allreduces
        # under device availability): same-device syncs serialize on the
        # shared ICI links, disjoint-device syncs overlap, and comm
        # overlaps later compute (async collectives).
        comm_avail: Dict[int, float] = {d: 0.0 for d in range(self.num_devices)}
        # per-device memory accounting: strategies that overflow HBM are
        # infeasible (the reference's simulator rejects strategies that
        # exhaust its device memory arena, simulator.h:688 allocate;
        # this is what forces big embedding tables to be SHARDED rather
        # than redundantly replicated)
        mem: Dict[int, float] = {d: 0.0 for d in range(self.num_devices)}
        topo = graph.topo_order()
        shardings = {}
        for node in topo:
            mv = strategy.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            osh = self._propagate(node, mv)
            if osh is None:
                return math.inf
            shardings[node.guid] = (mv, osh)

        # measured fusion-cluster overrides: when a producer+followers
        # chain member's view has a fused measurement, scale the
        # member's compute by the measured fused-over-lone ratio (lone
        # probes are upper bounds; the cluster record is what XLA
        # actually runs).  The ratio is keyed on EACH MEMBER'S OWN view
        # — a pure per-(node, view) quantity both engines can bake,
        # keeping native/python parity exact.  For the dominant case (a
        # chain sharing one view, which resharding-inside-an-elementwise
        # -chain xfer costs enforce) this equals the chain-uniform
        # semantics; a member resharded away from its head keeps its
        # own-view ratio even though XLA would break the fusion there —
        # an accepted under-charge on strategies the xfer penalty
        # already rules out.  The optimizer update term is NOT scaled —
        # fusion doesn't shrink it.
        cluster_scale: Dict[int, Tuple[float, float]] = {}
        cal = self.cost.calibration
        if cal is not None and getattr(cal, "num_clusters", 0) > 0:
            for members in self._cluster_chains(graph):
                if any(m.guid not in shardings for m in members):
                    continue
                for pos, m in enumerate(members):
                    got = self._cluster_ratio(members, shardings[m.guid][0])
                    if got is None:
                        continue
                    r, upds = got
                    cluster_scale[m.guid] = (r, upds[pos])

        end_time = 0.0
        end_comm = 0.0
        track = breakdown is not None
        xfer_total = 0.0
        sync_total = 0.0
        compute_total = 0.0
        overlap = self.placement_overlap
        # a gradient-sync schedule replaces the legacy per-node sync
        # issuance with per-bucket exposed-comm pricing (below the loop)
        sched = sync_schedule if include_update else None
        node_rows: Optional[list] = [] if sched is not None else None
        # fast path: in the default (overlap=False) currency every op
        # occupies ALL device timelines, so device availability is ONE
        # scalar and per-device memory is the plain sum — identical math
        # to the full per-device form (and to the native engines), at a
        # fraction of the dict traffic.  The search calls this tens of
        # thousands of times per compile.
        scalar = not overlap and schedule is None
        avail = 0.0
        mem_total = 0.0
        for node in topo:
            mv, osh = shardings[node.guid]
            start = avail if scalar else 0.0
            # input readiness + edge xfer costs
            for e in graph.in_edges[node.guid]:
                src_mv, src_osh = shardings[e.src]
                src_annot = (
                    src_osh.outputs[e.src_idx]
                    if e.src_idx < len(src_osh.outputs)
                    else None
                )
                dst_annot = (
                    osh.inputs[e.dst_idx] if e.dst_idx < len(osh.inputs) else None
                )
                shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
                xfer = self.cost.xfer_cost(shape, src_annot, dst_annot)
                if overlap and src_mv.start_part != mv.start_part:
                    # producer and consumer live on different device
                    # blocks: every shard moves at least one hop even
                    # when shardings agree (reference charges this via
                    # per-pair xfers, simulator.cc:599-731)
                    xfer += self.cost.placement_move_cost(shape, src_annot)
                if include_update and not graph.nodes[e.src].op.is_gradient_free:
                    # training pays every boundary twice: the activation
                    # reshards/moves forward AND its gradient pays the
                    # inverse transfer flowing back (GSPMD emits the
                    # transposed collective in the backward program).
                    # Applied AFTER the placement move so both engines
                    # double the identical baked quantity.  Edges sourced
                    # at inputs/constants carry no cotangent back, so
                    # they pay the forward reshard only.
                    xfer *= 2.0
                if track:
                    xfer_total += xfer
                t = ready.get((e.src, e.src_idx), 0.0) + xfer
                if t > start:
                    start = t
            fwd, full, sync, m_bytes = self._node_costs(node, mv)
            scale = cluster_scale.get(node.guid)
            if scale is not None:
                r, upd = scale
                fwd = fwd * r
                full = (full - upd) * r + upd
            dur = full if include_update else fwd
            if track:
                compute_total += dur
            if scalar:
                mem_total += m_bytes
                finish = start + dur
                avail = finish
            else:
                comm_devs = self.view_device_set(mv, use_start=overlap)
                devs = comm_devs if overlap else self._all_devices
                for d in devs:
                    start = max(start, device_avail[d])
                for d in devs:
                    mem[d] += m_bytes
                finish = start + dur
                for d in devs:
                    device_avail[d] = finish
                if schedule is not None:
                    schedule.append(
                        (node.op.name, start, finish, tuple(sorted(devs))))
            for i in range(len(node.op.output_shapes)):
                ready[(node.guid, i)] = finish
            if finish > end_time:
                end_time = finish
            if node_rows is not None:
                node_rows.append((node, mv, fwd, dur, sync))
            elif include_update and sync > 0:
                if scalar:
                    comm_devs = self.view_device_set(mv, use_start=False)
                s = finish
                for d in comm_devs:
                    s = max(s, comm_avail[d])
                f = s + sync
                for d in comm_devs:
                    comm_avail[d] = f
                end_comm = max(end_comm, f)
                if track:
                    sync_total += sync
                if comm_schedule is not None:
                    comm_schedule.append(
                        (f"{node.op.name}:sync", s, f,
                         tuple(sorted(comm_devs))))

        sync_buckets: Optional[list] = None
        sync_levels: Optional[dict] = None
        if sched is not None:
            end_comm, sync_total, sync_buckets, sync_levels = \
                self._scheduled_sync(
                    sched, node_rows, end_time, comm_avail, comm_schedule)

        peak = mem_total if scalar else max(mem.values())
        total = max(end_time, end_comm)
        oom = peak > self.machine.hbm_capacity
        if track:
            breakdown.update(
                total_s=math.inf if oom else total,
                compute_end_s=end_time,
                comm_end_s=end_comm,
                compute_total_s=compute_total,
                xfer_total_s=xfer_total,
                sync_total_s=sync_total,
                # the EXPOSED sync tail: comm past the last compute —
                # what the step actually pays for gradient sync after
                # overlap credit (0 when fully hidden)
                sync_exposed_s=max(0.0, end_comm - end_time),
                peak_mem_bytes=peak,
                num_devices=self.num_devices,
                include_update=include_update,
                # per-collective records exist in this currency (the
                # pooled-traffic LogicalTaskGraphSimulator sets True
                # and leaves comm_schedule empty by design)
                pooled_comm=False,
            )
            if sync_buckets is not None:
                breakdown["sync_buckets"] = sync_buckets
            # per-link-level sync seconds (ICI vs DCN lanes) — from the
            # scheduled buckets when a schedule priced them, otherwise
            # re-derived per synced node (track mode only: the split is
            # not on the search's hot path)
            if sync_levels is None:
                sync_levels = {}
                for node in topo:
                    mv, _osh = shardings[node.guid]
                    if include_update:
                        for name, t in self.cost.sync_levels(
                                node.op, mv).items():
                            sync_levels[name] = sync_levels.get(
                                name, 0.0) + t
            if sync_levels:
                breakdown["sync_levels_s"] = sync_levels
        if oom:
            return math.inf
        return total

    def _scheduled_sync(self, sync_schedule, node_rows, end_time,
                        comm_avail, comm_schedule):
        """Exposed-comm pricing of a gradient-sync schedule over the
        scan just finished.  Backward model: the backward sweeps the
        graph in REVERSE topo order, so a bucket whose earliest member
        sits at topo position p has all its grads ready once only the
        backward shares of nodes 0..p-1 remain — its fused collective
        issues at ``end_time - bwd_prefix[p]`` and hides under exactly
        that remaining compute (GSPMD async collectives; the legacy
        per-node issuance credits overlap in FORWARD order, which the
        executed post-backward sync never earns).  Buckets serialize on
        their device groups' comm lanes in schedule order; synced
        groups the schedule does not cover issue after the full
        backward (the monolithic behavior execution gives them).
        Returns (end_comm, sync_total, per-bucket breakdown rows,
        per-link-level seconds aggregate)."""
        pos = {node.guid: i for i, (node, *_r) in enumerate(node_rows)}
        bwd_prefix = [0.0] * (len(node_rows) + 1)
        for i, (_n, _mv, fwd, dur, _s) in enumerate(node_rows):
            bwd_prefix[i + 1] = bwd_prefix[i] + max(0.0, dur - fwd)
        by_name = {node.op.name: (node, mv, sync)
                   for node, mv, _f, _d, sync in node_rows}
        end_comm = 0.0
        sync_total = 0.0
        rows = []
        covered = set()
        level_tot: dict = {}
        for bucket in getattr(sync_schedule, "buckets", sync_schedule):
            members = [by_name[nm] for nm in bucket.ops if nm in by_name]
            if not members:
                continue
            covered.update(nm for nm in bucket.ops)
            parts = []
            devs = set()
            min_pos = len(node_rows)
            for node, mv, _sync in members:
                got = self.cost.weight_sync_parts(node.op, mv)
                if got:
                    parts.extend(got)
                    devs |= self.view_device_set(mv, use_start=False)
                    min_pos = min(min_pos, pos[node.guid])
            levels: dict = {}
            cost = self.cost.bucket_sync_cost(
                parts, getattr(bucket, "precision", "fp32"),
                plan=getattr(bucket, "plan", None), level_acc=levels)
            if cost <= 0.0 or not devs:
                continue
            ready = end_time - bwd_prefix[min_pos]
            s = ready
            for d in devs:
                if comm_avail[d] > s:
                    s = comm_avail[d]
            f = s + cost
            for d in devs:
                comm_avail[d] = f
            if f > end_comm:
                end_comm = f
            sync_total += cost
            if comm_schedule is not None:
                comm_schedule.append(
                    (f"bucket:{bucket.name}:sync", s, f,
                     tuple(sorted(devs))))
            plan = getattr(bucket, "plan", None)
            rows.append({
                "name": bucket.name,
                # stable lane id — IDENTICAL to this bucket's
                # comm_schedule record name and to the annotation tag
                # the executed step stamps (obs/annotate.py), so a
                # device-trace capture matches by tag equality
                "lane": f"bucket:{bucket.name}:sync",
                "ops": list(bucket.ops),
                "precision": getattr(bucket, "precision", "fp32"),
                "plan": plan.name if plan is not None else None,
                "ready_s": ready,
                "start_s": s,
                "finish_s": f,
                "sync_s": cost,
                # per-link-level lanes (ICI vs DCN classes): drift on
                # the slow cross-slice links visible separately
                "levels": levels,
            })
            for name, t in levels.items():
                level_tot[name] = level_tot.get(name, 0.0) + t
        # uncovered synced groups: the executed _sync_grads leaves them
        # on the post-backward monolithic path — price them there (the
        # legality lint flags the coverage hole; pricing must not hide
        # it as free communication)
        for node, mv, _f, _d, sync in node_rows:
            if sync <= 0 or node.op.name in covered:
                continue
            devs = self.view_device_set(mv, use_start=False)
            s = end_time
            for d in devs:
                if comm_avail[d] > s:
                    s = comm_avail[d]
            f = s + sync
            for d in devs:
                comm_avail[d] = f
            if f > end_comm:
                end_comm = f
            sync_total += sync
            for name, t in self.cost.sync_levels(node.op, mv).items():
                level_tot[name] = level_tot.get(name, 0.0) + t
            if comm_schedule is not None:
                comm_schedule.append(
                    (f"{node.op.name}:sync", s, f, tuple(sorted(devs))))
        # the exposed share of each bucket's lane: the part of
        # [start, finish] past the end of compute (what the step pays)
        for r in rows:
            r["exposed_s"] = max(0.0, r["finish_s"]
                                 - max(r["start_s"], end_time))
        return end_comm, sync_total, rows, level_tot

    # ---- delta simulation (reference: simulator.h SIMULATE_DELTA) ----
    def set_baseline(self, graph: Graph,
                     strategy: Dict[int, MachineView],
                     include_update: Optional[bool] = None) -> Optional[SimSnapshot]:
        """Arm delta simulation: snapshot the baseline schedule of
        ``(graph, strategy)`` so subsequent ``simulate`` calls on
        substituted variants (or re-viewed strategies) are served
        incrementally.  Returns the snapshot, or None (and disarms)
        when the baseline is infeasible (invalid view / OOM)."""
        snap = self._snapshot(graph, strategy, include_update)
        self._baseline = snap
        return snap

    def clear_baseline(self) -> None:
        self._baseline = None

    def _resolve_view(self, node) -> MachineView:
        mv = node.op.fixed_machine_view()
        if mv is None:
            mv = MachineView.trivial(node.op.output_shapes[0].ndim)
        return mv

    def _snapshot(self, graph: Graph, strategy: Dict[int, MachineView],
                  include_update: Optional[bool] = None) -> Optional[SimSnapshot]:
        """One full scalar-currency simulation, recording every derived
        per-node quantity plus the per-position scan state.  The loop
        MUST stay arithmetic-identical to ``_simulate_full``'s scalar
        path — the delta contract (tests/test_search_delta.py) asserts
        equality to the float."""
        if include_update is None:
            include_update = not self.inference
        self.full_sims += 1
        _FULL_SIMS.inc()
        topo = graph.topo_order()
        snap = SimSnapshot()
        snap.graph = graph
        snap.include_update = include_update
        cal = self.cost.calibration
        snap.cal_version = getattr(cal, "version", None)
        views: Dict[int, MachineView] = {}
        annots: Dict[int, object] = {}
        shardings = {}
        for node in topo:
            mv = strategy.get(node.guid)
            if mv is None:
                mv = self._resolve_view(node)
            osh = self._propagate(node, mv)
            if osh is None:
                return None
            views[node.guid] = mv
            annots[node.guid] = osh
            shardings[node.guid] = (mv, osh)

        cluster_scale: Dict[int, Tuple[float, float]] = {}
        chain: Dict[int, Tuple[int, ...]] = {}
        if cal is not None and getattr(cal, "num_clusters", 0) > 0:
            for members in self._cluster_chains(graph):
                mg = tuple(m.guid for m in members)
                for pos, m in enumerate(members):
                    chain[m.guid] = mg
                    got = self._cluster_ratio(members, views[m.guid])
                    if got is None:
                        continue
                    r, upds = got
                    cluster_scale[m.guid] = (r, upds[pos])

        n = len(topo)
        order = [nd.guid for nd in topo]
        # per-node record: (duration, sync_s, mem_bytes, comm_devs,
        # ((src_guid, xfer_s), ...)) — ONE dict hit per clean node in
        # the delta walk
        rec: Dict[int, Tuple] = {}
        finish_d: Dict[int, float] = {}
        pre_avail: List[float] = [0.0] * (n + 1)
        pre_mem: List[float] = [0.0] * (n + 1)
        pre_end_time: List[float] = [0.0] * (n + 1)
        pre_end_comm: List[float] = [0.0] * (n + 1)
        pre_comm: List[Tuple[float, ...]] = [()] * (n + 1)

        comm_avail = [0.0] * self.num_devices
        comm_state = tuple(comm_avail)
        avail = 0.0
        mem_total = 0.0
        end_time = 0.0
        end_comm = 0.0
        ready: Dict[int, float] = {}
        for i, node in enumerate(topo):
            guid = node.guid
            pre_avail[i] = avail
            pre_mem[i] = mem_total
            pre_end_time[i] = end_time
            pre_end_comm[i] = end_comm
            pre_comm[i] = comm_state
            mv = views[guid]
            osh = annots[guid]
            start = avail
            edges = []
            for e in graph.in_edges[guid]:
                src_osh = annots[e.src]
                src_annot = (
                    src_osh.outputs[e.src_idx]
                    if e.src_idx < len(src_osh.outputs) else None
                )
                dst_annot = (
                    osh.inputs[e.dst_idx] if e.dst_idx < len(osh.inputs)
                    else None
                )
                shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
                xfer = self.cost.xfer_cost(shape, src_annot, dst_annot)
                if include_update and not graph.nodes[e.src].op.is_gradient_free:
                    xfer *= 2.0
                edges.append((e.src, xfer))
                t = ready.get(e.src, 0.0) + xfer
                if t > start:
                    start = t
            fwd, full, sync, m_bytes = self._node_costs(node, mv)
            scale = cluster_scale.get(guid)
            if scale is not None:
                r, upd = scale
                fwd = fwd * r
                full = (full - upd) * r + upd
            d = full if include_update else fwd
            mem_total += m_bytes
            finish = start + d
            avail = finish
            ready[guid] = finish
            finish_d[guid] = finish
            if finish > end_time:
                end_time = finish
            cd = None
            if include_update and sync > 0:
                cd = self.view_device_set(mv, use_start=False)
                s = finish
                for dev in cd:
                    if comm_avail[dev] > s:
                        s = comm_avail[dev]
                f = s + sync
                for dev in cd:
                    comm_avail[dev] = f
                comm_state = tuple(comm_avail)
                if f > end_comm:
                    end_comm = f
            rec[guid] = (d, sync, m_bytes, cd, tuple(edges))
        pre_avail[n] = avail
        pre_mem[n] = mem_total
        pre_end_time[n] = end_time
        pre_end_comm[n] = end_comm
        pre_comm[n] = comm_state

        if mem_total > self.machine.hbm_capacity:
            return None
        snap.order = order
        snap.views = views
        snap.ops = {g: graph.nodes[g].op for g in order}
        snap.annots = annots
        snap.in_list = {g: graph.in_edges[g] for g in order}
        snap.out_list = {g: graph.out_edges[g] for g in order}
        snap.rec = rec
        snap.finish = finish_d
        snap.chain = chain
        snap.pre_avail = pre_avail
        snap.pre_mem = pre_mem
        snap.pre_end_time = pre_end_time
        snap.pre_end_comm = pre_end_comm
        snap.pre_comm = pre_comm
        snap.total = max(end_time, end_comm)
        return snap

    def _local_chain(self, graph: Graph, guid: int):
        """The fusion-cluster chain of ``graph`` containing ``guid``
        (same membership rule as calibration.find_clusters, derived
        locally), or None.  Used by the delta path to detect chain
        membership changes around substituted nodes without re-scanning
        the whole graph."""
        _init_chain_types()
        node = graph.nodes.get(guid)
        if node is None:
            return None
        cur = node
        while cur.op.op_type not in _HEAD_TYPES:
            if cur.op.op_type not in _FUSABLE_TYPES:
                return None
            ins = graph.in_edges[cur.guid]
            if len(ins) != 1:
                return None
            pred = graph.nodes[ins[0].src]
            if len(graph.out_edges[pred.guid]) != 1:
                return None
            cur = pred
        members = [cur]
        while True:
            edges = graph.out_edges[members[-1].guid]
            if len(edges) != 1:
                break
            nxt = graph.nodes[edges[0].dst]
            if len(graph.in_edges[nxt.guid]) != 1:
                break
            if nxt.op.op_type not in _FUSABLE_TYPES:
                break
            members.append(nxt)
        if len(members) < 2:
            return None
        return members if any(m.guid == guid for m in members) else None

    def _mark_cluster_dirty(self, snap: SimSnapshot, graph: Graph,
                            changed: set, cluster_seed) -> None:
        """Fusion-cluster membership can shift around edge rewires even
        for nodes whose own edges/views are untouched — mark every
        member of any OLD or NEW chain through the perturbed region.
        Only chain-typed seeds pay the local walk (substitution-inserted
        parallel ops never form chains)."""
        _init_chain_types()
        chain = snap.chain
        nodes = graph.nodes
        for guid in list(changed | set(cluster_seed)):
            old = chain.get(guid)
            if old is not None:
                changed.update(g for g in old if g in nodes)
            node = nodes.get(guid)
            if node is None:
                continue
            ot = node.op.op_type
            if ot not in _HEAD_TYPES and ot not in _FUSABLE_TYPES:
                continue
            new = self._local_chain(graph, guid)
            if new is not None:
                changed.update(m.guid for m in new)

    def _clusters_active(self) -> bool:
        cal = self.cost.calibration
        return cal is not None and getattr(cal, "num_clusters", 0) > 0

    def simulate_rewrite(self, graph: Graph, resolve_view) -> Optional[float]:
        """Tier-1 candidate estimate: delta re-cost of a substitution
        candidate whose parent is the armed baseline, under the
        caller's CONTRACT that every surviving node resolves to the
        baseline's view (the estimate rule — driver._estimate_strategy)
        and ``resolve_view(node)`` supplies the views of the touched
        nodes.  Skips the per-node strategy dict and view diff the
        generic ``simulate`` routing would pay.  None when no delta
        applies (caller falls back to ``simulate``)."""
        snap = self._baseline
        if snap is None or self.placement_overlap:
            return None
        if snap.include_update != (not self.inference):
            return None
        cv = getattr(graph, "_changed_vs", None)
        if cv is None or cv[0]() is not snap.graph:
            return None
        if snap.cal_version != getattr(self.cost.calibration, "version",
                                       None):
            return None
        nodes = graph.nodes
        changed = {g for g in cv[1] if g in nodes}
        if self._clusters_active():
            self._mark_cluster_dirty(snap, graph, changed, cv[2])
        if len(changed) > max(8, len(nodes) // 2):
            self.delta_bails += 1
            _DELTA_BAILS.inc()
            return None
        got = self._delta_walk(snap, graph, changed, resolve_view)
        self.delta_sims += 1
        _DELTA_SIMS.inc()
        if DELTA_CHECK:
            strategy = {
                guid: (resolve_view(node) if guid in changed
                       else snap.views[guid])
                for guid, node in nodes.items()
            }
            full = self._simulate_full(graph, strategy, snap.include_update)
            assert got == full or (math.isnan(got) and math.isnan(full)), (
                f"delta rewrite estimate diverged from full: "
                f"{got!r} != {full!r}"
            )
        return got

    def _delta_changed(self, snap: SimSnapshot, graph: Graph,
                       strategy: Dict[int, MachineView]):
        """Dirty-node set of ``graph`` vs the snapshot, or None when the
        graphs diverge too much for a delta to pay (the caller then
        full-simulates).  Seeded by the changed-guid sets GraphXfer
        application attaches (``graph._changed_vs``); falls back to a
        structural diff for graphs from other producers."""
        nodes = graph.nodes
        limit = max(8, len(nodes) // 4)
        changed = set()
        view_dirty = set()
        cluster_seed = set()
        if graph is not snap.graph:
            cv = getattr(graph, "_changed_vs", None)
            if cv is not None and cv[0]() is snap.graph:
                changed.update(g for g in cv[1] if g in nodes)
                cluster_seed.update(g for g in cv[2] if g in nodes)
            else:
                if abs(len(nodes) - len(snap.order)) > limit:
                    return None
                in_list = snap.in_list
                out_list = snap.out_list
                ops = snap.ops
                for guid, node in nodes.items():
                    base_in = in_list.get(guid)
                    if base_in is None or node.op is not ops[guid]:
                        changed.add(guid)
                        view_dirty.add(guid)
                        if len(changed) > limit:
                            return None
                        continue
                    cur = graph.in_edges[guid]
                    if cur is not base_in and cur != base_in:
                        changed.add(guid)
                        if len(changed) > limit:
                            return None
                    cur_out = graph.out_edges[guid]
                    base_out = out_list[guid]
                    if cur_out is not base_out and cur_out != base_out:
                        cluster_seed.add(guid)
        # view changes (re-viewed strategies on the same structure)
        views = snap.views
        for guid, node in nodes.items():
            if guid in changed:
                continue
            mv = strategy.get(guid)
            if mv is None:
                mv = self._resolve_view(node)
            base = views.get(guid)
            if mv is not base and mv != base:
                changed.add(guid)
                view_dirty.add(guid)
                if len(changed) > limit:
                    return None
        if not changed and not cluster_seed:
            return changed
        # a view-changed producer changes its consumers' edge xfers —
        # one hop.  Pure edge rewires don't: a surviving node's output
        # annot depends only on (op, view).
        for guid in view_dirty:
            for e in graph.out_edges.get(guid, ()):
                changed.add(e.dst)
        if self._clusters_active():
            self._mark_cluster_dirty(snap, graph, changed, cluster_seed)
        if len(changed) > limit:
            return None
        return changed

    def _simulate_delta(self, snap: SimSnapshot, graph: Graph,
                        strategy: Dict[int, MachineView]) -> Optional[float]:
        """Incremental re-cost against the armed baseline: resume the
        scalar scan at the first dirty topo position, reusing every
        clean node's cached durations/xfers.  Returns None when a delta
        does not apply (caller falls back to the full path).  The
        result is bit-identical to ``_simulate_full`` on the same
        inputs — same values, same arithmetic, same order."""
        changed = self._delta_changed(snap, graph, strategy)
        if changed is None:
            return None

        def resolve_view(node):
            mv = strategy.get(node.guid)
            if mv is None:
                mv = self._resolve_view(node)
            return mv

        return self._delta_walk(snap, graph, changed, resolve_view)

    def _delta_walk(self, snap: SimSnapshot, graph: Graph, changed,
                    resolve_view) -> float:
        """The scalar scan over ``graph`` with every clean node served
        from the snapshot record — same values, same arithmetic, same
        order as ``_simulate_full``, so the result is bit-identical."""
        order = graph.topo_order()
        base_order = snap.order
        n = len(order)
        # longest clean common prefix → resume state from the snapshot
        k = 0
        lim = min(n, len(base_order))
        while k < lim:
            g = order[k].guid
            if g != base_order[k] or g in changed:
                break
            k += 1
        if k == n and n == len(base_order):
            return snap.total  # nothing dirty: the baseline cost stands
        avail = snap.pre_avail[k]
        mem_total = snap.pre_mem[k]
        end_time = snap.pre_end_time[k]
        end_comm = snap.pre_end_comm[k]
        comm_avail = list(snap.pre_comm[k]) if k else [0.0] * self.num_devices
        ready: Dict[int, float] = {}
        ready_get = ready.get
        base_finish = snap.finish
        base_rec = snap.rec
        new_annots: Dict[int, object] = {}
        include_update = snap.include_update
        clusters = self._clusters_active()
        for i in range(k, n):
            node = order[i]
            guid = node.guid
            if guid not in changed:
                start = avail
                dur, sync, m_bytes, comm_devs, edges = base_rec[guid]
                for src, xfer in edges:
                    t = ready_get(src)
                    if t is None:
                        t = base_finish.get(src, 0.0)
                    t += xfer
                    if t > start:
                        start = t
            else:
                mv = resolve_view(node)
                osh = self._propagate(node, mv)
                if osh is None:
                    return math.inf
                new_annots[guid] = osh
                start = avail
                for e in graph.in_edges[guid]:
                    src = e.src
                    s_osh = new_annots.get(src)
                    if s_osh is None:
                        s_osh = snap.annots[src]
                    src_annot = (
                        s_osh.outputs[e.src_idx]
                        if e.src_idx < len(s_osh.outputs) else None
                    )
                    dst_annot = (
                        osh.inputs[e.dst_idx] if e.dst_idx < len(osh.inputs)
                        else None
                    )
                    src_op = graph.nodes[src].op
                    xfer = self.cost.xfer_cost(
                        src_op.output_shapes[e.src_idx], src_annot, dst_annot)
                    if include_update and not src_op.is_gradient_free:
                        xfer *= 2.0
                    t = ready_get(src)
                    if t is None:
                        t = base_finish.get(src, 0.0)
                    t += xfer
                    if t > start:
                        start = t
                fwd, full, sync, m_bytes = self._node_costs(node, mv)
                if clusters:
                    members = self._local_chain(graph, guid)
                    if members is not None:
                        got = self._cluster_ratio(members, mv)
                        if got is not None:
                            r, upds = got
                            pos = next(
                                j for j, m in enumerate(members)
                                if m.guid == guid)
                            upd = upds[pos]
                            fwd = fwd * r
                            full = (full - upd) * r + upd
                dur = full if include_update else fwd
                comm_devs = (self.view_device_set(mv, use_start=False)
                             if include_update and sync > 0 else None)
            mem_total += m_bytes
            finish = start + dur
            avail = finish
            ready[guid] = finish
            if finish > end_time:
                end_time = finish
            if comm_devs is not None:
                s = finish
                for dev in comm_devs:
                    if comm_avail[dev] > s:
                        s = comm_avail[dev]
                f = s + sync
                for dev in comm_devs:
                    comm_avail[dev] = f
                if f > end_comm:
                    end_comm = f
        if mem_total > self.machine.hbm_capacity:
            return math.inf
        return max(end_time, end_comm)

    # ------------------------------------------------------------------
    def _cluster_chains(self, graph: Graph):
        """find_clusters(graph) as flat member lists, weakly cached —
        simulate() runs thousands of times per search on the same
        graphs."""
        if not hasattr(self, "_cluster_graph_cache"):
            import weakref

            self._cluster_graph_cache = weakref.WeakKeyDictionary()
            self._cluster_ratio_cache: Dict = {}
        chains = self._cluster_graph_cache.get(graph)
        if chains is None:
            from flexflow_tpu_torch.search.calibration import find_clusters

            chains = [
                [producer] + list(chain)
                for producer, chain in find_clusters(graph)
            ]
            self._cluster_graph_cache[graph] = chains
        return chains

    def _cluster_ratio(self, members, mv):
        """(fused/lone ratio, per-member update costs) for one chain at
        one view, or None — cached per (chain signature, view).  The
        cache drops wholesale when the table mutates (version bump):
        a budget-bounded calibration RESUMED in place would otherwise
        leave permanently-cached None results shadowing the new
        records in both engines."""
        cal = self.cost.calibration
        ver = getattr(cal, "version", None)
        if getattr(self, "_cluster_cache_version", None) != ver:
            self._cluster_ratio_cache = {}
            self._cluster_cache_version = ver
        key = cal.cluster_key([m.op for m in members], mv)
        hit = self._cluster_ratio_cache.get(key, "miss")
        if hit != "miss":
            return hit
        t = cal.get_cluster([m.op for m in members], mv)
        result = None
        if t is not None:
            lone = sum(
                self.cost.op_cost(m.op, mv, backward=False) for m in members
            )
            if lone > 0 and math.isfinite(lone):
                result = (
                    min(1.0, t / lone),
                    tuple(self.cost.update_cost(m.op, mv) for m in members),
                )
        self._cluster_ratio_cache[key] = result
        return result

    def cluster_membership(self, graph: Graph):
        """guid -> (chain members, position) for every fusion-cluster
        member of ``graph``, or an empty dict without cluster records.
        Nodes belong to at most one chain (heads are matmul-family,
        followers elementwise — disjoint sets; followers extend down
        sole-consumer links)."""
        out: Dict[int, Tuple[list, int]] = {}
        cal = self.cost.calibration
        if cal is not None and getattr(cal, "num_clusters", 0) > 0:
            for members in self._cluster_chains(graph):
                for pos, m in enumerate(members):
                    out[m.guid] = (members, pos)
        return out

    def cluster_scaled_costs(self, node, mv, costs, membership):
        """Apply the per-member-own-view fusion-cluster ratio to one
        (node, view) cost row ``(fwd, full, sync, mem)`` — the SAME
        formula simulate() applies, so baked native rows stay parity-
        exact with the python engine."""
        cm = membership.get(node.guid)
        if cm is None:
            return costs
        got = self._cluster_ratio(cm[0], mv)
        if got is None:
            return costs
        r, upds = got
        fwd, full, sync, m_bytes = costs
        upd = upds[cm[1]]
        return (fwd * r, (full - upd) * r + upd, sync, m_bytes)

    # ------------------------------------------------------------------
    def build_native(self, graph: Graph, node_views: Dict[int, list]):
        """Digest (graph, candidate views) onto the native C++ engine
        (native/src/sim_engine.cpp).  Returns (NativeSimGraph,
        guid->index map) or None when the library is unavailable.

        ``node_views[guid]`` lists each node's registrable views in
        order; view indices in native assignments refer to these lists.
        Semantics match ``simulate`` exactly (tests assert equality);
        fusion-cluster ratios are keyed per (member, own view) — a pure
        per-(node, view) quantity — so they bake into the exported cost
        rows (see simulate()'s cluster_scale note).
        """
        from flexflow_tpu_torch import native

        if native.get_lib() is None:
            return None
        topo = graph.topo_order()
        index = {n.guid: i for i, n in enumerate(topo)}
        membership = self.cluster_membership(graph)
        ns = native.NativeSimGraph(len(topo), self.num_devices)
        ns.set_mem_cap(self.machine.hbm_capacity)
        annots = {}  # (node_index, view_index) -> OpSharding | None
        for i, node in enumerate(topo):
            for vi, mv in enumerate(node_views[node.guid]):
                osh = self._propagate(node, mv)
                annots[(i, vi)] = osh
                if osh is None:
                    ns.add_view(i, 0.0, 0.0, 0.0, [], [], valid=False)
                    continue
                fwd, full, sync, m_bytes = self.cluster_scaled_costs(
                    node, mv, self._node_costs(node, mv), membership)
                comm_devs = sorted(
                    self.view_device_set(mv, use_start=self.placement_overlap)
                )
                devs = (comm_devs if self.placement_overlap
                        else list(range(self.num_devices)))
                ns.add_view(i, fwd, full, sync, devs, comm_devs,
                            mem=m_bytes, valid=True)
        for guid in graph.nodes:
            for e in graph.out_edges[guid]:
                si, di = index[e.src], index[e.dst]
                src_views = node_views[e.src]
                dst_views = node_views[e.dst]
                shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
                mat = []
                for svi in range(len(src_views)):
                    s_osh = annots[(si, svi)]
                    for dvi in range(len(dst_views)):
                        d_osh = annots[(di, dvi)]
                        if s_osh is None or d_osh is None:
                            mat.append(math.inf)
                            continue
                        src_annot = (
                            s_osh.outputs[e.src_idx]
                            if e.src_idx < len(s_osh.outputs) else None
                        )
                        dst_annot = (
                            d_osh.inputs[e.dst_idx]
                            if e.dst_idx < len(d_osh.inputs) else None
                        )
                        x = self.cost.xfer_cost(shape, src_annot, dst_annot)
                        # baked at 1x: both engines apply the 2x
                        # training factor at simulate time, keyed on
                        # include_update
                        if self.placement_overlap and (
                            src_views[svi].start_part
                            != dst_views[dvi].start_part
                        ):
                            # keep exact parity with simulate()'s
                            # cross-block movement charge
                            x += self.cost.placement_move_cost(shape, src_annot)
                        mat.append(x)
                ns.add_edge(
                    si, di,
                    np.asarray(mat, dtype=np.float64).reshape(
                        len(src_views), len(dst_views)),
                    has_grad=not graph.nodes[e.src].op.is_gradient_free,
                )
        return ns, index

    def node_cost_row(self, node, mv) -> Tuple[float, float, float, float]:
        """Public per-(op, view) cost row ``(fwd_s, full_s, sync_s,
        mem_bytes)`` — the strategy-explanation table (obs telemetry)
        reads predicted costs through this."""
        return self._node_costs(node, mv)

    # ------------------------------------------------------------------
    def export_chrome_trace(
        self,
        graph: Graph,
        strategy: Dict[int, MachineView],
        path: str,
        include_update: Optional[bool] = None,
        label: Optional[str] = None,
        schedule: Optional[list] = None,
        comm_schedule: Optional[list] = None,
        total_s: Optional[float] = None,
    ) -> float:
        """Write the simulated schedule as Chrome-trace JSON loadable
        in Perfetto/chrome://tracing — the PREDICTED timeline, viewable
        next to the real ``runtime.profiler.device_trace`` capture.
        Returns the simulated iteration seconds.  Callers that already
        simulated (e.g. for a breakdown) pass their ``schedule``/
        ``comm_schedule``/``total_s`` to skip the re-simulation."""
        from flexflow_tpu_torch.obs.trace import write_chrome_trace

        if schedule is None:
            schedule, comm_schedule = [], []
            total_s = self.simulate(
                graph, strategy, include_update=include_update,
                schedule=schedule, comm_schedule=comm_schedule,
            )
        write_chrome_trace(
            path, schedule, comm_schedule or [],
            label=label or f"predicted ({type(self).__name__})",
            meta={"simulated_step_s": total_s,
                  "num_devices": self.num_devices,
                  "machine": self.machine.name},
        )
        return total_s

    def export_task_graph_dot(self, graph: Graph,
                              strategy: Dict[int, MachineView],
                              path: str) -> float:
        """Write the simulated schedule as graphviz (reference:
        export_strategy_task_graph_file, simulator.cc:1008-1058).
        Returns the simulated iteration seconds."""
        schedule: list = []
        cost = self.simulate(graph, strategy, schedule=schedule)
        lines = ["digraph taskgraph {", "  rankdir=LR;"]
        for op_name, start, finish, devs in schedule:
            label = (f"{op_name}\\n[{start*1e3:.3f}, {finish*1e3:.3f}] ms"
                     f"\\ndevs={list(devs)}")
            lines.append(f'  "{op_name}" [shape=record, label="{label}"];')
        for g in graph.nodes:
            for e in graph.out_edges[g]:
                a = graph.nodes[e.src].op.name
                b = graph.nodes[e.dst].op.name
                lines.append(f'  "{a}" -> "{b}";')
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return cost

    def strategy_table_rows(
        self,
        graph: Graph,
        strategy: Dict[int, MachineView],
        sync_precision_map: Optional[Dict[str, str]] = None,
    ) -> list:
        """Per-node strategy-explanation rows — op, chosen view, and
        the predicted compute/sync/memory breakdown the search ranked
        it by (plus the chosen gradient-sync wire precision for weight
        groups).  Emitted as the ``strategy.table`` obs event and
        rendered by ``tools/ffobs.py report``."""
        rows = []
        for node in graph.topo_order():
            mv = strategy.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            try:
                fwd, full, sync, mem_b = self._node_costs(node, mv)
            except Exception:  # never let telemetry break a compile
                fwd = full = sync = mem_b = math.nan
            row = {
                "op": node.op.name,
                "type": node.op.op_type.value,
                "view": {
                    "dims": list(mv.dim_degrees),
                    "replica": mv.replica_degree,
                    "start": mv.start_part,
                },
                "fwd_s": fwd,
                "full_s": full,
                "sync_s": sync,
                "mem_bytes": mem_b,
            }
            if getattr(node.op, "_weight_specs", ()):
                row["sync_precision"] = (sync_precision_map or {}).get(
                    node.op.name, "fp32")
            rows.append(row)
        return rows

    # ------------------------------------------------------------------
    def peak_memory(self, graph: Graph, strategy: Dict[int, MachineView]) -> float:
        """Sum of per-device op memory (upper bound; the reference uses a
        scratch arena the same way, simulator.h:688)."""
        total = 0.0
        for node in graph.topo_order():
            mv = strategy.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            total += self.cost.op_memory(node.op, mv)
        return total
