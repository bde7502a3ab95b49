"""Strategy export/import — a copy of flexflow_tpu/search/strategy_io.py
(reference: src/runtime/strategy.cc:26-197,
--export-strategy/--import-strategy, config.h:140-143).

Format: JSON mapping op name -> {"dims": [...], "replica": r}.  Keyed
by op NAME (stable across runs with deterministic name generation)
rather than guid so strategies transfer between processes.

A reserved ``"__meta__"`` entry (never a legal op name key for
``import_strategy``) carries run provenance: the target graph's
structural digest (``cost_cache.stable_graph_digest`` — ALWAYS
embedded by ``export_strategy``), the simulator's predicted step
breakdown at export time and — via ``attach_meta`` after training —
the measured DriftReport, so a strategy file records what graph it was
searched for, what the search promised, and what execution delivered.

``import_strategy`` REFUSES files whose stored digest does not match
the target graph, files naming ops the graph does not have, and files
covering only part of the graph (a silently-applied partial map leaves
the uncovered ops on default views — the exact drift the static-
analysis PR exists to kill).  Findings use the ``STR2xx`` codes and
raise ``analysis.AnalysisError``.

The port adds the in-memory halves, ``strategy_to_dict`` and
``strategy_from_dict`` (the file functions wrap them): a job of several
ranks searches once on rank 0 and sends every rank the export itself
(model.py), which each rank imports through the same digest gate.  A
file either package writes imports into the other.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from flexflow_tpu_torch.analysis.findings import AnalysisError, Finding
from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView

META_KEY = "__meta__"


def export_strategy(
    path: str,
    graph: Graph,
    strategy: Dict[int, MachineView],
    meta: Optional[dict] = None,
) -> None:
    out = strategy_to_dict(graph, strategy, meta)
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)


def strategy_to_dict(graph: Graph, strategy: Dict[int, MachineView],
                     meta: Optional[dict] = None) -> dict:
    """The export as a dict: op name -> view, plus ``__meta__`` with the
    graph's digest."""
    out = {}
    for guid, mv in strategy.items():
        node = graph.nodes.get(guid)
        if node is None:
            continue
        if node.op.name in out:
            raise ValueError(
                f"duplicate op name {node.op.name!r}: strategies are keyed "
                "by name — give layers unique names to export"
            )
        out[node.op.name] = {
            "dims": list(mv.dim_degrees),
            "replica": mv.replica_degree,
            "start": mv.start_part,
        }
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    meta = dict(meta) if meta else {}
    # the digest is ALWAYS embedded: import can then prove the file was
    # searched for THIS graph instead of silently applying a stale map
    meta.setdefault("graph_digest", stable_graph_digest(graph))
    meta.setdefault("covered_ops", len(out))
    out[META_KEY] = meta
    return out


def import_strategy(path: str, graph: Graph,
                    allow_partial: bool = False) -> Dict[int, MachineView]:
    """Load a strategy file onto ``graph``, verifying provenance first.

    Raises ``AnalysisError`` (STR201) when the file's stored graph
    digest does not match the target graph, and (STR202) when the file
    names ops the graph lacks or covers only a subset of the graph's
    ops.  NOTE: a strategy exported after a REWRITING search is keyed
    to the rewritten graph and will not match a fresh frontend build —
    cross-process reuse of rewritten searches is the cost cache's job
    (search/cost_cache.py), which stores the rewritten graph itself.

    ``allow_partial=True`` is the deliberate escape hatch: every check
    downgrades to a warning (emitted on the obs bus) and the views
    whose op names DO match are applied — the historical best-effort
    behavior, now opt-in instead of silent."""
    with open(path) as f:
        data = json.load(f)
    return strategy_from_dict(data, graph, allow_partial, source=path)


def strategy_from_dict(data: dict, graph: Graph,
                       allow_partial: bool = False,
                       source: str = "<strategy>") -> Dict[int, MachineView]:
    """``import_strategy`` on an export already in memory (``source``
    names it in findings)."""
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    data = dict(data)
    path = source
    meta = data.pop(META_KEY, None) or {}
    severity = "warn" if allow_partial else "error"
    findings = []
    stored = meta.get("graph_digest")
    if stored:
        actual = stable_graph_digest(graph)
        if stored != actual:
            findings.append(Finding(
                code="STR201", pass_name="strategy", severity=severity,
                message=(
                    f"strategy file {path} was exported for a different "
                    f"graph: stored digest {stored[:12]}… != target graph "
                    f"digest {actual[:12]}…"),
            ))
    else:
        # legacy pre-digest file: provenance is unprovable.  Warn (on
        # the bus) rather than refuse — coverage below still guards
        # against partial maps
        findings.append(Finding(
            code="STR203", pass_name="strategy", severity="warn",
            message=(
                f"strategy file {path} carries no __meta__.graph_digest "
                f"— cannot prove it was exported for this graph "
                f"(re-export to embed provenance)"),
        ))
    graph_names = {node.op.name for node in graph.topo_order()}
    unknown = sorted(set(data) - graph_names)
    if unknown:
        findings.append(Finding(
            code="STR202", pass_name="strategy", severity=severity,
            message=(
                f"strategy file names {len(unknown)} op(s) the target "
                f"graph does not have (e.g. {unknown[:4]})"),
        ))
    uncovered = sorted(graph_names - set(data))
    if uncovered:
        findings.append(Finding(
            code="STR202", pass_name="strategy", severity=severity,
            message=(
                f"strategy file covers only {len(data)} of "
                f"{len(graph_names)} graph ops (uncovered e.g. "
                f"{uncovered[:4]}) — refusing to apply a partial map; "
                f"pass allow_partial=True to override"),
        ))
    if findings:
        import warnings

        from flexflow_tpu_torch.analysis.findings import emit_findings, errors_only

        emit_findings(findings)
        errors = errors_only(findings)
        if errors:
            raise AnalysisError(
                f"import_strategy({source!r}) rejected", errors)
        for f in findings:
            # warn-level findings must be VISIBLE even with the obs bus
            # off — a best-effort partial apply that says nothing is the
            # silent drift this module exists to kill
            warnings.warn(f"import_strategy: {f}", stacklevel=2)
    strategy: Dict[int, MachineView] = {}
    for node in graph.topo_order():
        if node.op.name in data:
            d = data[node.op.name]
            strategy[node.guid] = MachineView(
                dim_degrees=tuple(d["dims"]),
                replica_degree=d.get("replica", 1),
                start_part=d.get("start", 0),
            )
    return strategy


def read_meta(path: str) -> dict:
    """The ``__meta__`` provenance block of an exported strategy file
    ({} when absent)."""
    with open(path) as f:
        return json.load(f).get(META_KEY, {})


def attach_meta(path: str, **updates) -> dict:
    """Merge ``updates`` into the strategy file's ``__meta__`` block in
    place (model.fit persists the post-training DriftReport next to
    the strategy this way).  Returns the merged block."""
    with open(path) as f:
        data = json.load(f)
    meta = data.setdefault(META_KEY, {})
    meta.update(updates)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    return meta
