"""N-replica serving fleet behind a searched SLO-aware router — the
port of flexflow_tpu/runtime/fleet.py.

``search/fleet.py`` decides the fleet shape — how many replica blocks,
which strategy each, and which per-SLO-class routing fractions — in
the per-class p99 currency.  This module EXECUTES that decision: N
``ContinuousBatchingExecutor`` replicas behind a router whose dispatch
follows the searched fractions deterministically.

Routing is deficit-style proportional assignment: per (class, replica)
the router tracks how many requests it has sent, and each arrival goes
to the replica minimizing ``(count + 1) / fraction`` over the replicas
its class routes to — the discrete sequence whose running shares
converge to the searched fractions from the very first requests (a
weighted round-robin, not a sampler).  Exact ties break through a
seeded ``random.Random`` so a trace replayed under the same seed maps
every request to the same replica, bit-reproducibly (the routing
determinism test).

Admission stays the replicas' own: each ``ContinuousBatchingExecutor``
keeps its priority lanes, deadline expiry and preemption
(runtime/decode.py) — the router decides WHERE a request queues, the
replica decides WHEN it runs.

Wall-clock semantics: replicas are independent once routed, so
``run()`` drains each replica to completion separately — every
replica's measured spans are self-consistent on its own clock, and
cross-replica concurrency (real fleets run replicas on disjoint
devices) is represented by NOT serializing one replica's frames into
another's latencies.  ``step()`` advances every live replica one frame
for interleaved/elastic operation under the controller.

Over ranks (``fleet_over_ranks``): replica i of a fleet proposal runs on
its own block of the job's ranks, the proposal's ``start`` and
``decode_devices`` (``runtime.distributed.mesh_over``, as the placed
lowering runs its blocks; an intra-replica prefill block is priced by
the search and not executed, as in the reference), compiled with the
replica's searched views.  Every rank routes the whole trace, so every
rank makes the same assignments, and steps only its block's replica;
the others are ``RemoteReplica`` stand-ins.  ``run`` then gathers each
replica's tokens, request records and summary from the first rank of
its block to every rank, so the roll-ups (``request_records``,
``measured_request_p99``, ``summary``) are the whole fleet's
everywhere.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.tracing import TRACER
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    SLOClass,
)


class RemoteReplica:
    """A replica that runs on another block of the job's ranks: this
    rank routes requests to it and never steps it; ``FleetExecutor.run``
    fills in its records and summary from that block."""

    def __init__(self, replica_label: str):
        self.replica_label = replica_label
        self.queue: List[DecodeRequest] = []
        self.slots: List = []
        self.request_records: List[dict] = []
        self._summary: dict = {}

    def submit(self, requests: Sequence[DecodeRequest]) -> None:
        self.queue.extend(requests)

    def step(self) -> None:
        pass

    def run(self, max_frames: int = 10_000) -> Dict[str, List[int]]:
        self.queue = []
        return {}

    def summary(self) -> dict:
        return dict(self._summary)


class FleetExecutor:
    """Route requests over N decode replicas per searched per-class
    fractions; roll per-replica request records up into fleet-level
    per-class percentiles."""

    def __init__(self, replicas: Sequence[ContinuousBatchingExecutor],
                 routing: Dict[str, Sequence[float]], *,
                 slo_classes: Optional[Sequence[SLOClass]] = None,
                 seed: int = 0):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: List[ContinuousBatchingExecutor] = list(replicas)
        for i, ex in enumerate(self.replicas):
            if ex.replica_label is None:
                ex.replica_label = str(i)
        k = len(self.replicas)
        self.routing: Dict[str, Tuple[float, ...]] = {}
        for name, fr in routing.items():
            fr = tuple(float(v) for v in fr)
            if len(fr) != k:
                raise ValueError(
                    f"routing row {name!r} has {len(fr)} fractions for "
                    f"{k} replicas")
            tot = sum(fr)
            if tot <= 0:
                raise ValueError(
                    f"routing row {name!r} routes nowhere: {fr}")
            self.routing[name] = tuple(v / tot for v in fr)
        self.slo_classes: Dict[str, SLOClass] = {
            c.name: c for c in (slo_classes or ())}
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        # deficit counters: class -> per-replica dispatched counts
        self._sent: Dict[str, List[int]] = {}
        self.assignments: Dict[str, int] = {}  # rid -> replica index

    # ------------------------------------------------------------------
    def _fractions(self, slo: str) -> Tuple[float, ...]:
        fr = self.routing.get(slo)
        if fr is None:
            fr = self.routing.get("standard")
        if fr is None:
            k = len(self.replicas)
            fr = tuple(1.0 / k for _ in range(k))
        return fr

    def route(self, req: DecodeRequest) -> int:
        """The replica this request dispatches to (deficit-minimizing
        over its class's searched fractions, seeded tie-break)."""
        slo = req.slo or "standard"
        fr = self._fractions(slo)
        sent = self._sent.setdefault(slo, [0] * len(self.replicas))
        best = None
        ties: List[int] = []
        for r, f in enumerate(fr):
            if f <= 0.0:
                continue
            score = (sent[r] + 1) / f
            if best is None or score < best:
                best, ties = score, [r]
            elif score == best:
                ties.append(r)
        pick = ties[0] if len(ties) == 1 \
            else ties[self._rng.randrange(len(ties))]
        sent[pick] += 1
        return pick

    def submit(self, requests: Sequence[DecodeRequest]) -> None:
        obs = BUS.enabled  # one check per submit batch
        tr = TRACER.enabled  # ditto for the request span tree
        for req in requests:
            i = self.route(req)
            self.assignments[req.rid] = i
            if tr:
                self._trace_route(req, i)
            self.replicas[i].submit([req])
            if obs:
                BUS.emit("fleet.route", rid=req.rid, replica=i,
                         slo=req.slo or "standard")

    def _trace_route(self, req: DecodeRequest, replica: int) -> None:
        """Mint the request's trace at the FRONT (route time — the
        first component that sees the request) and stamp the router's
        decision as a zero-duration ``route`` child with the replica
        tag; the replica's submit then finds the mapping and only adds
        the queue/prefill/decode children."""
        tid = TRACER.request_root(req.rid, slo=req.slo or "standard")
        TRACER.annotate(tid, "route", parent="request", replica=replica,
                        label=self.replicas[replica].replica_label)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One frame on every replica that has live or queued work —
        the interleaved mode the controller's elastic loop drives.
        Returns how many replicas stepped."""
        stepped = 0
        for ex in self.replicas:
            if ex.queue or any(s is not None for s in ex.slots):
                ex.step()
                stepped += 1
        return stepped

    def run(self, requests: Sequence[DecodeRequest] = (),
            max_frames: int = 10_000) -> Dict[str, List[int]]:
        """Route then drain every replica to completion.  Replicas
        drain INDEPENDENTLY (disjoint devices run concurrently in a
        real fleet): the whole trace is routed first (deficit routing
        sees the global arrival order), then each replica's batch is
        submitted immediately before ITS drain — enqueue stamps land on
        the replica's own clock, so one replica's frames never inflate
        another's queue/TTFT spans.  Returns rid -> generated token ids
        across the fleet."""
        out: Dict[str, List[int]] = {}
        if requests:
            obs = BUS.enabled  # one check per run
            tr = TRACER.enabled
            per_replica: List[List[DecodeRequest]] = \
                [[] for _ in self.replicas]
            for req in requests:
                i = self.route(req)
                self.assignments[req.rid] = i
                per_replica[i].append(req)
                if tr:
                    self._trace_route(req, i)
                if obs:
                    BUS.emit("fleet.route", rid=req.rid, replica=i,
                             slo=req.slo or "standard")
            for ex, batch in zip(self.replicas, per_replica):
                if batch:
                    ex.submit(batch)
                out.update(ex.run(max_frames=max_frames))
        else:
            for ex in self.replicas:
                out.update(ex.run(max_frames=max_frames))
        if any(isinstance(ex, RemoteReplica) for ex in self.replicas):
            out = self._gather(out)
        return out

    def _gather(self, out: Dict[str, List[int]]) -> Dict[str, List[int]]:
        """Every replica's tokens, records and summary on every rank,
        each from the first rank of its block (an all-gather of Python
        objects over the job)."""
        import torch.distributed as dist

        mine = {i: (ex.request_records, ex.summary())
                for i, ex in enumerate(self.replicas)
                if not isinstance(ex, RemoteReplica)}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (out, mine))
        merged: Dict[str, List[int]] = {}
        taken = set()
        for tokens, reps in got:
            new = [i for i in reps if i not in taken]
            for i in new:
                ex = self.replicas[i]
                if isinstance(ex, RemoteReplica):
                    ex.request_records = list(reps[i][0])
                    ex._summary = dict(reps[i][1])
                taken.add(i)
            if new:
                merged.update(tokens)
        return merged

    # ------------------------------------------------------------------
    @property
    def request_records(self) -> List[dict]:
        """Per-replica records merged in replica order (stable — the
        roll-up quantiles are order-independent, determinism tests
        compare the merged list directly)."""
        merged: List[dict] = []
        for i, ex in enumerate(self.replicas):
            for rec in ex.request_records:
                merged.append(dict(rec, replica=i))
        return merged

    def measured_request_p99(self, metric: str = "ttft_s",
                             slo: Optional[str] = None,
                             window: int = 0) -> Optional[float]:
        """Fleet-level per-class request-latency quantile: the merged
        per-replica completions, each class watched at its own
        quantile — the measured side ``TrainingController.
        observe_fleet`` compares against the proposal's predictions."""
        recs = [r for r in self.request_records
                if r.get("phase") == "finish"
                and (slo is None or r.get("slo") == slo)
                and r.get(metric) is not None]
        if window:
            recs = recs[-window:]
        cls = self.slo_classes.get(slo) if slo else None
        return ContinuousBatchingExecutor._quantile(
            [r[metric] for r in recs], cls.quantile if cls else 0.99)

    def summary(self) -> dict:
        """Fleet roll-up: per-replica executor summaries plus merged
        per-class p50/p99 across the whole fleet."""
        q = ContinuousBatchingExecutor._quantile
        recs = [r for r in self.request_records
                if r.get("phase") == "finish"]
        by_class: Dict[str, List[dict]] = {}
        for r in recs:
            by_class.setdefault(r.get("slo", "standard"), []).append(r)
        out = {
            "replicas": len(self.replicas),
            "routing": {c: list(fr)
                        for c, fr in sorted(self.routing.items())},
            "completed": len(recs),
            "per_replica": [ex.summary() for ex in self.replicas],
            "slo_classes": {
                name: {
                    "completed": len(rs),
                    "ttft_p50_s": q([r["ttft_s"] for r in rs
                                     if r.get("ttft_s") is not None],
                                    0.5),
                    "ttft_p99_s": q([r["ttft_s"] for r in rs
                                     if r.get("ttft_s") is not None],
                                    0.99),
                    "e2e_p50_s": q([r["e2e_s"] for r in rs
                                    if r.get("e2e_s") is not None],
                                   0.5),
                    "e2e_p99_s": q([r["e2e_s"] for r in rs
                                    if r.get("e2e_s") is not None],
                                   0.99),
                }
                for name, rs in sorted(by_class.items())
            },
        }
        return out


def fleet_over_ranks(model, proposal,
                     make_executor: Callable[[Callable, int], object], *,
                     prefill_chunk: int = 0, slot_aligned: bool = True,
                     seed: int = 0) -> FleetExecutor:
    """The fleet of an adopted ``proposal`` (search/fleet.py
    ``FleetProposal``, e.g. ``model.fleet``) over the job's ranks: every
    rank builds every replica block's mesh in replica order; on the
    ranks of block i the decode graph (the replica's searched graph,
    else ``model.graph``) compiles with the replica's views on that
    block (``FFModel._compile(mesh=)``, the weights drawn from
    ``model.config.seed`` by name, so every replica holds the model's
    weights, in its pool dtype), and ``make_executor(step, i)`` wraps its
    ``compiled_decode_step`` (built with ``prefill_chunk`` and
    ``slot_aligned``: whether those executors allot slot-aligned pages)
    in a ``ContinuousBatchingExecutor``; the
    other blocks' replicas are ``RemoteReplica`` stand-ins.  Routing is
    the proposal's, the SLO classes its own."""
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.runtime.decode import compiled_decode_step
    from flexflow_tpu_torch.search.serving import decode_nodes

    dtypes = {n.op.kv_dtype for n in decode_nodes(model.graph)}
    kv = dtypes.pop() if len(dtypes) == 1 else "off"
    me = distributed.rank()
    replicas: List[object] = []
    for rep in proposal.replicas:
        start = rep.start + rep.prefill_devices
        width = rep.decode_devices
        mesh = distributed.mesh_over(start=start, width=width)
        if not start <= me < start + width:
            replicas.append(RemoteReplica(str(rep.index)))
            continue
        cfg = dataclasses.replace(
            model.config, num_devices=width, search_num_devices=0,
            serve_fleet="off", serve_disaggregation="off",
            import_strategy_file=None, export_strategy_file=None,
            kv_precision=kv)
        m = FFModel(cfg)
        m.graph = rep.graph if rep.graph is not None else model.graph
        m._compile(comp_mode="inference", strategy=dict(rep.strategy),
                   mesh=mesh)
        step = compiled_decode_step(m, prefill_chunk=prefill_chunk,
                                    slot_aligned=slot_aligned)
        ex = make_executor(step, rep.index)
        ex.replica_label = str(rep.index)
        replicas.append(ex)
    slo = [SLOClass(name=c["name"], priority=int(c.get("priority", 0)),
                    deadline_frames=int(c.get("deadline_frames", 0)),
                    quantile=float(c.get("quantile", 0.99)))
           for c in proposal.slo_classes]
    return FleetExecutor(replicas, proposal.routing, slo_classes=slo,
                         seed=seed)
