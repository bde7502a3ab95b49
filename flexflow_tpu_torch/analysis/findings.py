"""Shared finding machinery for the static-analysis passes — a copy of
flexflow_tpu/analysis/findings.py.

Every analysis pass (graph invariants, sharding legality, substitution
equivalence, artifact lint) reports the same ``Finding`` shape: a
stable CODE (the contract tests and ``tools/fflint.py`` key on),
the pass that produced it, and a human message.  Findings flow three
ways: returned to callers as plain lists, emitted on the obs event bus
as ``analysis.finding`` events, and — when a pass is used as a gate —
raised inside an ``AnalysisError``.

Code ranges (one prefix per pass, so a seeded corruption can assert it
was caught by the RIGHT pass):

* ``PCG0xx`` — graph well-formedness (``analysis/invariants.py``)
* ``SHD1xx`` — strategy/sharding legality (``analysis/sharding.py``)
* ``STR2xx`` — strategy-file provenance (``search/strategy_io.py``)
* ``EQV3xx`` — rewrite numeric equivalence (``analysis/equivalence.py``)
* ``CCH4xx`` — cost-cache artifact lint (``tools/fflint.py``)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence


@dataclass
class Finding:
    """One analysis result: a stable code + where + what."""

    code: str
    pass_name: str  # invariants | sharding | strategy | equivalence | artifact
    message: str
    op: Optional[str] = None  # op name, when the finding is node-scoped
    node: Optional[int] = None  # node guid, when known
    severity: str = "error"  # "error" gates; "warn" only reports

    def __str__(self) -> str:
        where = f" (op {self.op!r})" if self.op else ""
        return f"[{self.code}] {self.message}{where}"


class AnalysisError(ValueError):
    """A gating analysis pass failed; carries the findings."""

    def __init__(self, message: str, findings: Sequence[Finding] = ()):
        self.findings: List[Finding] = list(findings)
        if self.findings:
            message += " — " + "; ".join(str(f) for f in self.findings[:4])
            if len(self.findings) > 4:
                message += f"; … {len(self.findings) - 4} more"
        super().__init__(message)


def errors_only(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def emit_findings(findings: Iterable[Finding]) -> None:
    """Publish findings as ``analysis.finding`` events (no-op when the
    bus is disabled — same one-boolean-check discipline as every other
    emitter)."""
    from flexflow_tpu_torch.obs.events import BUS

    if not BUS.enabled:
        return
    for f in findings:
        BUS.emit(
            "analysis.finding",
            **{
                "pass": f.pass_name,
                "code": f.code,
                "msg": f.message,
                "op": f.op,
                "severity": f.severity,
            },
        )
