"""Hot-swap legality lint — a copy of flexflow_tpu/analysis/swap.py,
the always-on gate of the live strategy-swap path
(``FFModel.swap_strategy`` / runtime/controller.py).

A mid-run swap re-lowers the model under a new (graph, strategy) and
re-shards the LIVE training state onto the new views (fp32 re-shard is
a value-identity operation).  That is only sound when the new pair can
actually RECEIVE the state: every trainable weight, optimizer slot and
mutable op state (batch-norm stats, caches, EF residuals, KV page
pools) must have an identically-shaped home on the other side, and the
new strategy must cover the new graph completely — an uncovered node
would silently train under a default view the swap gate never priced.

* **SHD170** weight preservation: every ``(op, weight)`` the old graph
  owns exists in the new graph with identical shape + dtype, and the
  new graph introduces no NEW trainable weight (a fresh-initialized
  weight mid-run silently breaks value continuity — the caller must
  fall back to a strategy-only swap on the current graph instead)
* **SHD171** op-state preservation: same rule for the ops' declared
  ``state_specs`` (``{op}/{name}`` keys of the model-state dict) —
  the KV pools and cache/BN state a live swap must carry
* **SHD172** swap coverage: every node of the new graph has a view in
  the new strategy (group coverage of the comm plan derives from the
  weighted nodes' views, so a hole here is a hole in the sync groups)

``lint_swap`` composes the flat SHD101-110 strategy legality lint on
the new pair, so a swap target is at least as checked as a fresh
search result.  Lowering-created state keys (EF residuals) are NOT
linted here: they are derived from the comm plan, and dropping them on
a plan change (e.g. the fp32 monolithic fallback) is the intended
semantics — the restore helper reports them as dropped instead.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from flexflow_tpu_torch.analysis.findings import Finding


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="swap", message=message, **kw)


def _weight_map(graph) -> Dict[Tuple[str, str], Tuple[tuple, str]]:
    out = {}
    for node in graph.topo_order():
        for ws in getattr(node.op, "_weight_specs", ()):
            out[(node.op.name, ws.name)] = (
                tuple(ws.shape), ws.dtype.value)
    return out


def _state_map(graph) -> Dict[str, Tuple[tuple, str]]:
    out = {}
    for node in graph.topo_order():
        ss = getattr(node.op, "state_specs", None)
        if ss is None:
            continue
        for name, shape, dtype, _fill in ss():
            out[f"{node.op.name}/{name}"] = (tuple(shape), str(dtype))
    return out


def lint_swap(old_graph, new_graph, new_strategy,
              num_devices: int) -> List[Finding]:
    """All findings for hot-swapping a live model from ``old_graph``
    onto ``(new_graph, new_strategy)`` ([] = the swap is legal)."""
    findings: List[Finding] = []

    old_w, new_w = _weight_map(old_graph), _weight_map(new_graph)
    for key in sorted(set(old_w) | set(new_w)):
        op, w = key
        if key not in new_w:
            findings.append(_f(
                "SHD170",
                f"weight {op}/{w} {old_w[key][0]} has no home in the "
                f"swap target graph — its live value would be lost",
                op=op))
        elif key not in old_w:
            findings.append(_f(
                "SHD170",
                f"swap target graph introduces a NEW trainable weight "
                f"{op}/{w} {new_w[key][0]} — a fresh init mid-run "
                f"breaks value continuity",
                op=op))
        elif old_w[key] != new_w[key]:
            findings.append(_f(
                "SHD170",
                f"weight {op}/{w} changes shape/dtype across the swap: "
                f"{old_w[key]} -> {new_w[key]}",
                op=op))

    old_s, new_s = _state_map(old_graph), _state_map(new_graph)
    for key in sorted(set(old_s) | set(new_s)):
        if key not in new_s:
            findings.append(_f(
                "SHD171",
                f"op state {key} {old_s[key][0]} has no home in the "
                f"swap target graph — live state (cache/KV pool/BN "
                f"stats) would be lost", op=key.split("/")[0]))
        elif key not in old_s:
            findings.append(_f(
                "SHD171",
                f"swap target graph introduces NEW op state {key} "
                f"{new_s[key][0]} with no live value to carry",
                op=key.split("/")[0]))
        elif old_s[key][0] != new_s[key][0]:
            findings.append(_f(
                "SHD171",
                f"op state {key} changes shape across the swap: "
                f"{old_s[key][0]} -> {new_s[key][0]}", op=key.split("/")[0]))

    for node in new_graph.topo_order():
        if (node.guid not in new_strategy
                and node.op.fixed_machine_view() is None):
            findings.append(_f(
                "SHD172",
                f"swap strategy does not cover node {node.op.name!r} "
                f"(guid {node.guid}) — it would silently train under a "
                f"default view the swap gate never checked",
                node=node.guid, op=node.op.name))

    from flexflow_tpu_torch.analysis.sharding import lint_strategy

    findings += lint_strategy(new_graph, new_strategy, num_devices)
    return findings
