"""PCG well-formedness checker — pass 1 of the static-analysis stack;
a copy of flexflow_tpu/analysis/invariants.py.

The substitution machinery performs direct edge-list surgery
(``search/substitution.py``), and a silently corrupt graph poisons
everything downstream: the DP search memoizes it, the persistent cost
cache serves it across processes, and the lowering compiles garbage.
This pass proves the structural invariants every consumer of a
``core.graph.Graph`` assumes:

* **PCG001** acyclicity
* **PCG002** guid-table consistency (node.guid == its key; every guid
  below ``_next_guid``, so fresh allocations cannot collide)
* **PCG003** no dangling edges (both endpoints exist; adjacency tables
  cover exactly the node set)
* **PCG004** edge-mirror symmetry (every edge appears in its source's
  out-list and its destination's in-list, with equal multiplicity, and
  is filed under the right key)
* **PCG005** no duplicate edges / doubly-fed input slots
* **PCG006** input-port arity (a node with any in-edges covers input
  slots 0..k-1 exactly once; nodes with NO in-edges are legal sources —
  DP segment graphs truncate at split boundaries by design)
* **PCG007** src_idx within the producer's output arity
* **PCG008** shape/dtype re-inference agreement: the producer's output
  shape at each edge logically equals the consumer's recorded input
  shape (the check that catches a splice wiring a wrong-shaped tensor)

Hook points: ``search/substitution._finish_rewrite`` runs
``assert_graph_ok`` after every ``GraphXfer.apply`` when verification
is on (``FLEXFLOW_TPU_VERIFY=1`` / ``FFConfig.verify`` / ``--verify``),
and the substitution test suite runs it unconditionally.  Overhead is
tracked in ``CHECK_STATS`` so ``bench_search.py --verify`` can report
the measured cost of always-on checking (the bench is the reference's;
the port's search reads the same counters).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from typing import Dict, List

from flexflow_tpu_torch.analysis.findings import AnalysisError, Finding
from flexflow_tpu_torch.obs.metrics import METRICS

_CHECKS = METRICS.counter("analysis.graph_checks")
_FINDINGS = METRICS.counter("analysis.graph_findings")

# verifier overhead accounting (bench_search.py --verify reads this)
CHECK_STATS: Dict[str, float] = {"checks": 0, "seconds": 0.0, "findings": 0}

_VERIFY = os.environ.get("FLEXFLOW_TPU_VERIFY", "") not in ("", "0", "false")


def verification_enabled() -> bool:
    return _VERIFY


def set_verify(enabled: bool) -> None:
    """Arm/disarm post-rewrite verification process-wide (the env var
    ``FLEXFLOW_TPU_VERIFY=1`` sets the initial state; ``bench_search.py
    --verify`` routes here for a whole run)."""
    global _VERIFY
    _VERIFY = bool(enabled)


@contextlib.contextmanager
def scoped_verify(enabled: bool = True):
    """Arm verification for one dynamic extent, restoring the prior
    state on exit — how ``FFConfig.verify`` scopes to ONE search/compile
    without becoming a sticky process-wide latch (and without ever
    DISARMING an env-armed process: the scope only ORs in)."""
    global _VERIFY
    prev = _VERIFY
    _VERIFY = bool(enabled) or prev
    try:
        yield
    finally:
        _VERIFY = prev


class GraphInvariantError(AnalysisError):
    """A graph failed the well-formedness check."""


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="invariants", message=message, **kw)


def check_graph(graph, strict_shapes: bool = True) -> List[Finding]:
    """All invariant findings for ``graph`` ([] = well-formed).

    Works on any Graph whose ops expose ``input_shapes``/``output_shapes``
    (flexflow_tpu_torch operators); the port/shape checks degrade gracefully
    for bare test doubles without them."""
    findings: List[Finding] = []
    nodes = graph.nodes

    # ---- PCG002: guid table -------------------------------------------
    next_guid = getattr(graph, "_next_guid", None)
    for guid, node in nodes.items():
        if node.guid != guid:
            findings.append(_f(
                "PCG002",
                f"node filed under guid {guid} carries guid {node.guid}",
                node=guid, op=getattr(node.op, "name", None)))
        elif next_guid is not None and guid >= next_guid:
            findings.append(_f(
                "PCG002",
                f"guid {guid} >= _next_guid {next_guid}: a later splice "
                f"can allocate a colliding guid",
                node=guid, op=getattr(node.op, "name", None)))

    # ---- PCG003: adjacency-table coverage -----------------------------
    for table, side in ((graph.in_edges, "in"), (graph.out_edges, "out")):
        for guid in nodes.keys() - table.keys():
            findings.append(_f(
                "PCG003", f"node {guid} has no {side}-edge table entry",
                node=guid))
        for guid in table.keys() - nodes.keys():
            if table[guid]:  # empty stale keys are inert; edges are not
                findings.append(_f(
                    "PCG003",
                    f"{side}-edge table holds edges for deleted guid {guid}",
                    node=guid))

    # ---- PCG003/PCG004/PCG005: edges ----------------------------------
    out_count: Counter = Counter()
    in_count: Counter = Counter()
    for src, edges in graph.out_edges.items():
        per_list = Counter(edges)
        for e, c in per_list.items():
            if c > 1:
                findings.append(_f(
                    "PCG005", f"duplicate edge {e} ({c}x in out-list)",
                    node=src))
            if e.src != src:
                findings.append(_f(
                    "PCG004",
                    f"edge {e} filed under out-list of {src} but src is "
                    f"{e.src}", node=src))
            if e.dst not in nodes:
                findings.append(_f(
                    "PCG003", f"edge {e} points at deleted guid {e.dst}",
                    node=src))
        out_count.update(per_list)
    for dst, edges in graph.in_edges.items():
        per_list = Counter(edges)
        for e, c in per_list.items():
            if e.dst != dst:
                findings.append(_f(
                    "PCG004",
                    f"edge {e} filed under in-list of {dst} but dst is "
                    f"{e.dst}", node=dst))
            if e.src not in nodes:
                findings.append(_f(
                    "PCG003", f"edge {e} reads deleted guid {e.src}",
                    node=dst))
        in_count.update(per_list)
    for e in (out_count.keys() | in_count.keys()):
        if out_count[e] != in_count[e]:
            findings.append(_f(
                "PCG004",
                f"edge {e} mirror asymmetry: {out_count[e]}x in out-lists "
                f"vs {in_count[e]}x in in-lists"))

    # ---- PCG005/PCG006/PCG007/PCG008: ports + shapes ------------------
    for guid, node in nodes.items():
        op = node.op
        in_shapes = getattr(op, "input_shapes", None)
        out_arity = None
        in_list = graph.in_edges.get(guid, [])
        if in_shapes is not None and in_list:
            k = len(in_shapes)
            slots = Counter(e.dst_idx for e in in_list)
            for s, c in sorted(slots.items()):
                if c > 1:
                    findings.append(_f(
                        "PCG005",
                        f"input slot {s} fed by {c} edges",
                        node=guid, op=getattr(op, "name", None)))
                if s < 0 or s >= k:
                    findings.append(_f(
                        "PCG006",
                        f"input slot {s} out of range (op declares {k} "
                        f"inputs)", node=guid, op=getattr(op, "name", None)))
            missing = [s for s in range(k) if s not in slots]
            if missing:
                findings.append(_f(
                    "PCG006",
                    f"input slots {missing} unfed (op declares {k} inputs)",
                    node=guid, op=getattr(op, "name", None)))
        for e in in_list:
            producer = nodes.get(e.src)
            if producer is None:
                continue  # PCG003 already reported
            p_outs = getattr(producer.op, "output_shapes", None)
            if p_outs is None:
                continue
            if e.src_idx < 0 or e.src_idx >= len(p_outs):
                findings.append(_f(
                    "PCG007",
                    f"edge {e} reads output {e.src_idx} of "
                    f"{getattr(producer.op, 'name', e.src)!r}, which has "
                    f"{len(p_outs)} outputs",
                    node=guid, op=getattr(op, "name", None)))
                continue
            if (strict_shapes and in_shapes is not None
                    and 0 <= e.dst_idx < len(in_shapes)):
                got, want = p_outs[e.src_idx], in_shapes[e.dst_idx]
                if hasattr(got, "logical_eq") and not got.logical_eq(want):
                    findings.append(_f(
                        "PCG008",
                        f"edge {e}: producer output {got} disagrees with "
                        f"consumer's recorded input shape {want}",
                        node=guid, op=getattr(op, "name", None)))

    # ---- PCG001: acyclicity (own Kahn — graph.topo_order raises AND
    # caches, and must not be perturbed by a checker) --------------------
    indeg = {g: 0 for g in nodes}
    for g in nodes:
        for e in graph.out_edges.get(g, ()):
            if e.dst in indeg:
                indeg[e.dst] += 1
    ready = [g for g, d in indeg.items() if d == 0]
    done = 0
    while ready:
        g = ready.pop()
        done += 1
        for e in graph.out_edges.get(g, ()):
            if e.dst in indeg:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
    if done != len(nodes):
        stuck = sorted(g for g, d in indeg.items() if d > 0)
        findings.append(_f(
            "PCG001",
            f"graph has a cycle through {len(stuck)} node(s) "
            f"(guids {stuck[:6]}{'…' if len(stuck) > 6 else ''})"))
    return findings


def assert_graph_ok(graph, context: str = "",
                    strict_shapes: bool = True) -> None:
    """``check_graph`` as a gate: raises ``GraphInvariantError`` on any
    finding, emits findings on the obs bus, and accounts its own wall
    time in ``CHECK_STATS``."""
    t0 = time.perf_counter()
    findings = check_graph(graph, strict_shapes=strict_shapes)
    CHECK_STATS["checks"] += 1
    CHECK_STATS["seconds"] += time.perf_counter() - t0
    _CHECKS.inc()
    if findings:
        CHECK_STATS["findings"] += len(findings)
        _FINDINGS.inc(len(findings))
        from flexflow_tpu_torch.analysis.findings import emit_findings

        emit_findings(findings)
        where = f" {context}" if context else ""
        raise GraphInvariantError(
            f"graph invariant violation{where}", findings)
