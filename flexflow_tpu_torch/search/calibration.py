"""Measured per-(op, view) cost calibration — the port of
flexflow_tpu/search/calibration.py.

The reference ranks strategies with MEASURED kernel times, cached per
(op params, machine view) and collected on a real GPU inside the search
(reference: src/runtime/simulator.cc:515-554 ProfilingRecord cache;
src/runtime/model.cu:38-74 warmup+repeat cuda-event timing).  The port
measures one forward of the op at its per-shard shapes on the card with
CUDA events (runtime/profiler.measure_operator_cost), in the model's
compute dtype, and persists the result in a ``CalibrationTable`` that
``CostModel.op_cost`` consults before its analytic roofline.  The
table's file format is the reference's; its ``backend`` is the torch
device type the probes ran on (``"cuda"``, or ``"cpu"`` when the caller
asks for the CPU), and the search uses a table only when it matches the
machine spec's ``platform``.

Cluster records: the reference times a matmul-family producer and its
chain of fusable followers as ONE jitted block, because XLA fuses them.
The port runs eagerly and fuses nothing, so its cluster probe runs the
chain's ops one after another, each its own launches, and records what
the port really runs.

Probes that ask for CUDA and find none raise.  An op is left to the
roofline (no record) only by the reference's rules: its view is
rejected by its own ``propagate``, it has no floating input or weight
(inputs, constants), or — reshape — its forward reads its global output
shape and so cannot run at shard shapes.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.obs.metrics import METRICS

# one per forward an (op, view) or cluster probe times
_PROBES = METRICS.counter("calibration.probes")

Key = Tuple[str, Tuple[int, ...], int]


class CalibrationTable:
    """Persisted measured-forward-seconds per (op signature, view) —
    the reference's ProfilingRecord hash cache (simulator.cc:515-554),
    with a JSON file standing in for the in-memory lifetime of the
    reference's single search task."""

    def __init__(self):
        self._t: Dict[Key, float] = {}
        # CLUSTER measurements: a matmul-family producer plus its chain
        # of single-consumer fusable followers, timed as one unit (the
        # reference's XLA fuses them; the port runs them back to back,
        # module docstring).
        self._clusters: Dict[Tuple, float] = {}
        self.backend: Optional[str] = None  # platform the probes ran on
        # bumped on EVERY put (including same-key overwrites): consumers
        # with derived caches (simulator ratio cache, native DP digests)
        # fingerprint this to notice in-place mutation — len() alone
        # misses re-measurements of existing keys
        self.version: int = 0
        # DriftReport staleness flag (obs/drift.py): model.fit marks the
        # persisted table when measured steps drift past the threshold;
        # the NEXT optimize_strategy then re-probes (live backend
        # matching) or discards the table instead of only warning —
        # the ROADMAP re-probe-policy follow-up
        self.stale: bool = False
        self.stale_ratio: Optional[float] = None
        # consecutive auto re-probes without the drift clearing: past
        # MAX_AUTO_REPROBES the driver stops burning the calibration
        # budget (the drift is then a cost-MODEL gap fresh measurements
        # cannot fix, not stale measurements); a healthy calibrated fit
        # resets it (mark_healthy_file)
        self.reprobes: int = 0

    MAX_AUTO_REPROBES = 2

    @staticmethod
    def _sig(op) -> str:
        getsig = getattr(op, "calibration_signature", None)
        return repr(getsig() if getsig is not None else op.signature())

    @staticmethod
    def key(op, mv: MachineView) -> Key:
        return (
            CalibrationTable._sig(op),
            tuple(mv.dim_degrees),
            int(mv.replica_degree),
        )

    def get(self, op, mv: MachineView) -> Optional[float]:
        return self._t.get(self.key(op, mv))

    def put(self, op, mv: MachineView, seconds: float) -> None:
        self._t[self.key(op, mv)] = float(seconds)
        self.version += 1

    @staticmethod
    def cluster_key(ops, mv: MachineView) -> Tuple:
        return (
            tuple(CalibrationTable._sig(op) for op in ops),
            tuple(mv.dim_degrees),
            int(mv.replica_degree),
        )

    def get_cluster(self, ops, mv: MachineView) -> Optional[float]:
        return self._clusters.get(self.cluster_key(ops, mv))

    def put_cluster(self, ops, mv: MachineView, seconds: float) -> None:
        self._clusters[self.cluster_key(ops, mv)] = float(seconds)
        self.version += 1

    @property
    def num_clusters(self) -> int:
        return len(self._clusters)

    def __len__(self) -> int:
        return len(self._t)

    def save(self, path: str) -> None:
        rows = [
            {"sig": k[0], "degrees": list(k[1]), "replica": k[2], "seconds": v}
            for k, v in sorted(self._t.items())
        ]
        clusters = [
            {"sigs": list(k[0]), "degrees": list(k[1]), "replica": k[2],
             "seconds": v}
            for k, v in sorted(self._clusters.items())
        ]
        with open(path, "w") as f:
            json.dump(
                {"version": 1, "backend": self.backend, "records": rows,
                 "clusters": clusters, "stale": self.stale,
                 "stale_ratio": self.stale_ratio,
                 "reprobes": self.reprobes},
                f, indent=1,
            )

    @staticmethod
    def load(path: str) -> "CalibrationTable":
        table = CalibrationTable()
        with open(path) as f:
            data = json.load(f)
        table.backend = data.get("backend")
        table.stale = bool(data.get("stale", False))
        table.stale_ratio = data.get("stale_ratio")
        table.reprobes = int(data.get("reprobes", 0))
        for r in data.get("records", []):
            table._t[(r["sig"], tuple(r["degrees"]), int(r["replica"]))] = float(
                r["seconds"]
            )
        for r in data.get("clusters", []):
            table._clusters[
                (tuple(r["sigs"]), tuple(r["degrees"]), int(r["replica"]))
            ] = float(r["seconds"])
        table.version = len(table._t) + len(table._clusters)
        return table

    @staticmethod
    def mark_stale_file(path: str, ratio: float) -> bool:
        """Flag a persisted table stale IN PLACE (a cheap JSON edit —
        model.fit calls this from the drift path, where re-parsing the
        full table would be waste).  Returns False when the file is
        missing/unreadable."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        data["stale"] = True
        data["stale_ratio"] = float(ratio)
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
        return True

    @staticmethod
    def mark_healthy_file(path: str) -> bool:
        """The drift cleared on a calibrated fit: reset the staleness
        state AND the auto-re-probe counter, so a later genuine
        staleness gets its full re-probe allowance again.  No-op (and
        no rewrite) when the file is already healthy."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        if not data.get("stale") and not data.get("reprobes"):
            return True
        data["stale"] = False
        data["stale_ratio"] = None
        data["reprobes"] = 0
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
        return True

    def begin_reprobe(self) -> None:
        """Drop every measured record so the next ``calibrate_graph``
        re-measures from scratch (probes resume from the loaded table,
        so stale records would otherwise survive a re-probe untouched);
        clears the stale flag — the fresh probes ARE the response —
        and counts the attempt against MAX_AUTO_REPROBES."""
        self._t.clear()
        self._clusters.clear()
        self.stale = False
        self.stale_ratio = None
        self.reprobes += 1
        self.version += 1


def _shard_sizes(sizes, annot) -> Tuple[int, ...]:
    if annot is None:
        return tuple(sizes)
    out = []
    for i, s in enumerate(sizes):
        d = annot.degrees[i] if i < len(annot.degrees) else 1
        out.append(max(1, s // max(d, 1)))
    return tuple(out)


def _probe_inputs(op, osh, device):
    from flexflow_tpu_torch.runtime.profiler import probe_device

    device = probe_device(device)
    return [torch.zeros(_shard_sizes(s.sizes, a), dtype=s.dtype.to_torch(),
                        device=device)
            for s, a in zip(op.input_shapes, osh.inputs)]


def measure_op_view(
    op, mv: MachineView, warmup: int = 1, repeats: int = 3,
    device="cuda", compute_dtype: torch.dtype = torch.bfloat16,
) -> Optional[float]:
    """Median seconds of one forward of ``op`` at the per-shard shapes
    ``mv`` induces (via the op's own degree propagation), on
    ``device``.  None when the view is rejected by the op's
    ``propagate``, the op has no floating leaf (inputs, constants), or
    it is a reshape under a split view (its forward reads its global
    output shape) — callers keep the roofline for those."""
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.runtime.profiler import measure_operator_cost

    try:
        osh = op.propagate(mv)
    except AssertionError:
        return None
    if op.op_type is OperatorType.RESHAPE and mv.num_parts > 1:
        return None
    weight_shapes = {
        ws.name: _shard_sizes(ws.shape, a)
        for ws, a in zip(getattr(op, "_weight_specs", ()), osh.weights)
    }
    _PROBES.inc()
    return measure_operator_cost(
        op,
        batch_inputs=_probe_inputs(op, osh, device),
        warmup=warmup,
        repeats=repeats,
        weight_shapes=weight_shapes,
        device=device,
        compute_dtype=compute_dtype,
    )


class _ChainProbe:
    """Adapter presenting a producer + follower chain as one op-like
    object to measure_operator_cost: forward() threads each member's
    output into the next member's single input, weights are namespaced
    per member.  The port runs the members one after another, unfused,
    which is what its eager execution of the chain does."""

    def __init__(self, ops, oshs):
        import dataclasses

        self.ops = list(ops)
        self.oshs = list(oshs)
        self.name = "cluster:" + "+".join(op.name for op in self.ops)
        self.input_shapes = self.ops[0].input_shapes
        self._weight_specs = []
        self._spec_owner = []  # parallel list: (member_idx, original name)
        for i, op in enumerate(self.ops):
            for ws, annot in zip(getattr(op, "_weight_specs", ()),
                                 self.oshs[i].weights):
                self._weight_specs.append(dataclasses.replace(
                    ws, name=f"{i}.{ws.name}",
                    shape=_shard_sizes(ws.shape, annot)))
                self._spec_owner.append((i, ws.name))

    def state_specs(self):
        return ()

    def forward(self, ctx, inputs, weights):
        outs = list(inputs)
        for i, op in enumerate(self.ops):
            ws = {
                orig: weights[f"{j}.{orig}"]
                for j, orig in self._spec_owner
                if j == i
            }
            outs = op.forward(ctx, outs if i == 0 else [outs[0]], ws)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return outs


def _drain_round_robin(queues, deadline, probe) -> bool:
    """One probe per queue per cycle until every queue drains or the
    deadline passes; mutates the queues in place.  Returns True when
    the deadline cut probing short (callers may log what remains)."""
    while queues:
        for q in queues:
            if not q:
                continue
            if time.monotonic() > deadline:
                return True
            probe(q.pop(0))
        queues = [q for q in queues if q]
    return False


def _any_cluster_unmeasured(table: CalibrationTable, clusters,
                            num_devices: int) -> bool:
    """True when some (cluster, producer-view) probe is not yet in the
    table — the condition under which calibrate_graph reserves budget
    for cluster probing."""
    from flexflow_tpu_torch.search.views import candidate_views

    for producer, chain in clusters:
        ops = [producer.op] + [c.op for c in chain]
        for mv in candidate_views(producer.op, num_devices):
            if table.get_cluster(ops, mv) is None:
                return True
    return False


# matmul-family producers whose follower chains the reference's XLA
# fuses (the cluster set is the reference's, so the two searches see the
# same records' keys)
_CLUSTER_HEADS = {"linear", "conv2d", "batch_matmul"}

_FUSABLE_TYPES = None


def _fusable(op) -> bool:
    # membership precomputed per OperatorType: this predicate runs per
    # node in every cluster scan and per seed in the delta simulator's
    # chain-dirty pass
    global _FUSABLE_TYPES
    if _FUSABLE_TYPES is None:
        from flexflow_tpu_torch.core.optype import OperatorType

        _FUSABLE_TYPES = frozenset(
            t for t in OperatorType
            if t.is_elementwise_unary()
            or t.value in ("softmax", "layernorm", "scalar_add",
                           "scalar_sub", "scalar_mul", "scalar_true_div",
                           "dropout")
        )
    return op.op_type in _FUSABLE_TYPES


def find_clusters(graph: Graph):
    """(producer_node, [follower_nodes...]) chains: producer is
    matmul-family, each follower is the SOLE consumer of its
    predecessor, single-input, and fusable: what the reference's XLA
    producer-consumer fusion merges."""
    out = []
    for node in graph.topo_order():
        if node.op.op_type.value not in _CLUSTER_HEADS:
            continue
        chain = []
        cur = node
        while True:
            edges = graph.out_edges.get(cur.guid, [])
            if len(edges) != 1:
                break
            nxt = graph.nodes[edges[0].dst]
            if len(graph.in_edges.get(nxt.guid, [])) != 1:
                break
            if not _fusable(nxt.op):
                break
            chain.append(nxt)
            cur = nxt
        if chain:
            out.append((node, chain))
    return out


def measure_cluster(producer, followers, mv: MachineView,
                    repeats: int = 3, device="cuda",
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Optional[float]:
    """Median seconds of one forward of the chain at the per-shard
    shapes ``mv`` induces.  None when any member rejects the view."""
    from flexflow_tpu_torch.runtime.profiler import measure_operator_cost

    ops = [producer.op] + [f.op for f in followers]
    oshs = []
    for op in ops:
        try:
            oshs.append(op.propagate(mv))
        except AssertionError:
            return None
    probe = _ChainProbe(ops, oshs)
    _PROBES.inc()
    return measure_operator_cost(
        probe, batch_inputs=_probe_inputs(ops[0], oshs[0], device),
        repeats=repeats, device=device, compute_dtype=compute_dtype)


def calibrate_clusters(
    graph: Graph,
    num_devices: int,
    table: CalibrationTable,
    time_budget_s: float = 60.0,
    repeats: int = 3,
    clusters=None,
    device="cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> CalibrationTable:
    """Measure every fusion cluster of ``graph`` at the producer's
    candidate views (budget-bounded, resumable like calibrate_graph).
    ``clusters`` accepts a precomputed find_clusters(graph) result.

    Probe order is round-robin ACROSS clusters — like calibrate_graph's
    op probes, a sequential walk would let the first chain's view
    sweep eat a tight budget and leave later chains with no record."""
    from flexflow_tpu_torch.search.views import candidate_views

    deadline = time.monotonic() + time_budget_s
    queues = []
    queued = set()  # dedup: N identical chains share one cluster_key
    for producer, chain in (find_clusters(graph) if clusters is None
                            else clusters):
        ops = [producer.op] + [c.op for c in chain]
        q = []
        for mv in candidate_views(producer.op, num_devices):
            key = CalibrationTable.cluster_key(ops, mv)
            if key in queued or key in table._clusters:
                continue
            queued.add(key)
            q.append((producer, chain, ops, mv))
        if q:
            queues.append(q)

    def probe(item):
        producer, chain, ops, mv = item
        t = measure_cluster(producer, chain, mv, repeats=repeats,
                            device=device, compute_dtype=compute_dtype)
        if t is not None and math.isfinite(t) and t > 0:
            table.put_cluster(ops, mv, t)

    _drain_round_robin(queues, deadline, probe)
    return table


def calibrate_graph(
    graph: Graph,
    num_devices: int,
    table: Optional[CalibrationTable] = None,
    time_budget_s: float = 120.0,
    repeats: int = 3,
    cluster_fraction: float = 0.25,
    device="cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> CalibrationTable:
    """Fill ``table`` with measurements for every distinct
    (op signature, candidate view) in ``graph`` — the probe set the
    search will actually query (reference measures lazily mid-search,
    simulator.cc:515; measuring up front keeps the search itself pure).
    Budget-bounded: stops adding new probes when the wall budget is
    spent (existing entries are never re-measured).

    Probe order is round-robin ACROSS op kinds, not topological: a
    topo walk lets the most frequent kind eat the whole budget (the
    reference's early table ended with 87 ``linear`` records and zero for
    softmax/layernorm/pool — exactly the ops the flagship spends real
    time in), whereas one-probe-per-kind-per-cycle leaves every kind
    represented when the clock runs out.  ``cluster_fraction`` of the
    budget is RESERVED for fusion-cluster probes when the graph has
    any — leftover-only scheduling meant zero cluster records ever
    got measured.

    Probes run on ``device`` in ``compute_dtype`` (the model's); the
    table's ``backend`` becomes that device's type, and a table probed
    on another backend is refused rather than mixed."""
    from flexflow_tpu_torch.search.views import boundary_views, candidate_views

    # NOT `table or ...`: an empty CalibrationTable is falsy (__len__ == 0),
    # and the caller's table must be filled in place
    table = table if table is not None else CalibrationTable()
    backend = torch.device(device).type
    if table.backend not in (None, backend):
        raise ValueError(
            f"calibrate_graph on {backend!r} into a table probed on "
            f"{table.backend!r}: the records would mix backends")
    table.backend = backend
    deadline = time.monotonic() + time_budget_s
    by_kind: Dict[str, list] = {}
    queued = set()
    for node in graph.topo_order():
        op = node.op
        views = list(candidate_views(op, num_devices))
        for bv in boundary_views(op, num_devices):
            if bv not in views:
                views.append(bv)
        for mv in views:
            k = CalibrationTable.key(op, mv)
            if k in queued or table._t.get(k) is not None:
                continue
            queued.add(k)
            by_kind.setdefault(op.op_type.value, []).append((op, mv))
    clusters = find_clusters(graph)
    clusters_missing = _any_cluster_unmeasured(
        table, clusters, num_devices)
    op_deadline = deadline
    if clusters_missing:
        # reserve only when there is an unmeasured (cluster, view) probe
        # to spend it on: a resumed run with full cluster coverage would
        # otherwise stop op probing at 75% and return the rest unused
        op_deadline -= cluster_fraction * time_budget_s
    queues = [q for _, q in sorted(by_kind.items())]

    def probe(item):
        op, mv = item
        t = measure_op_view(op, mv, repeats=repeats, device=device,
                            compute_dtype=compute_dtype)
        if t is not None and math.isfinite(t) and t > 0:
            table.put(op, mv, t)

    if _drain_round_robin(queues, op_deadline, probe):
        from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

        log.log(
            f"calibration budget ({time_budget_s:.0f}s) spent with "
            f"{sum(len(x) for x in queues)} probes unmeasured: "
            f"those (op, view) pairs keep the analytic roofline"
        )
    # remaining budget (incl. the reserved fraction) goes to
    # fusion-cluster probes — the refinement over lone-op upper bounds
    remaining = deadline - time.monotonic()
    if remaining > 1.0 and clusters_missing:
        calibrate_clusters(graph, num_devices, table,
                           time_budget_s=remaining, repeats=repeats,
                           clusters=clusters, device=device,
                           compute_dtype=compute_dtype)
    return table
