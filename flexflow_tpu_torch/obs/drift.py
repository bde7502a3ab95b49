"""Predicted-vs-measured drift reporting.

The entire search rests on ``Simulator.simulate``'s fidelity; a
``DriftReport`` makes that falsifiable per run: the simulator's
predicted step breakdown (``breakdown=`` dict from ``simulate``)
against ``StepProfiler`` measurements, per phase.  Drift beyond
``threshold`` flags the strategy as mispredicted — and, when the
prediction consulted a measured CalibrationTable, flags the TABLE as
stale (the ROADMAP's calibration-staleness follow-up needs exactly
this signal).

Phase semantics are honest about what is measurable: the executed
step is ONE fused XLA program, so only the total step time has a
measured counterpart; the predicted compute/sync split and the host
``dispatch``/``wait`` phases are recorded single-sided (``ratio``
None) rather than invented.

The port's copy of flexflow_tpu/obs/drift.py, imports rewired; the
event schemas, environment variables and file formats are the
reference's, so ``tools/ffobs.py`` reads the port's logs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class DriftReport:
    predicted_s: float
    measured_s: float
    ratio: float  # measured / predicted (>1: slower than predicted)
    threshold: float
    stale: bool
    calibrated: bool = False
    calibration_stale: bool = False
    phases: Dict[str, dict] = field(default_factory=dict)
    # per-bucket rows of a gradient-sync SCHEDULE's predicted lanes
    # (search/sync_schedule.py): issue/sync/exposed seconds per bucket.
    # The executed step is one fused XLA program, so each bucket's
    # measured side stays None (honesty rule above) — the schedule's
    # overlap claim is verified by the measured STEP delta between the
    # scheduled and monolithic programs (bench_search --sync-schedule),
    # not by inventing per-bucket host timings.
    sync_buckets: list = field(default_factory=list)

    def to_dict(self) -> dict:
        out = {
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s,
            "ratio": self.ratio,
            "threshold": self.threshold,
            "stale": self.stale,
            "calibrated": self.calibrated,
            "calibration_stale": self.calibration_stale,
            "phases": self.phases,
        }
        if self.sync_buckets:
            out["sync_buckets"] = self.sync_buckets
        return out

    def __str__(self) -> str:
        flag = (" STALE-CALIBRATION" if self.calibration_stale
                else " STALE" if self.stale else "")
        return (
            f"predicted={self.predicted_s * 1e3:.3f}ms "
            f"measured={self.measured_s * 1e3:.3f}ms "
            f"ratio={self.ratio:.2f}{flag}"
        )


def _phase(predicted_s: Optional[float], measured_s: Optional[float]) -> dict:
    ratio = None
    if (predicted_s and measured_s and predicted_s > 0
            and math.isfinite(predicted_s)):
        ratio = measured_s / predicted_s
    return {"predicted_s": predicted_s, "measured_s": measured_s,
            "ratio": ratio}


def build_drift_report(
    predicted: Dict[str, float],
    measured_step_s: float,
    measured_phases: Optional[Dict[str, dict]] = None,
    threshold: float = 0.5,
    calibrated: bool = False,
) -> Optional[DriftReport]:
    """``predicted`` is a ``Simulator.simulate(breakdown=...)`` dict
    (``total_s``/``compute_end_s``/``comm_end_s``/...); ``measured_phases``
    is ``StepProfiler.phase_summary()``.  None when there is nothing
    comparable (no finite prediction or measurement)."""
    total = predicted.get("total_s")
    if (not total or not math.isfinite(total) or not measured_step_s
            or not math.isfinite(measured_step_s)):
        return None
    ratio = measured_step_s / total
    stale = ratio > 1.0 + threshold or ratio < 1.0 / (1.0 + threshold)
    phases: Dict[str, dict] = {
        "step": _phase(total, measured_step_s),
        "compute": _phase(predicted.get("compute_end_s"), None),
        "sync": _phase(predicted.get("comm_end_s"), None),
    }
    if predicted.get("sync_exposed_s") is not None:
        # the EXPOSED sync tail the schedule search minimizes — the
        # single-sided prediction whose measured counterpart is the
        # scheduled-vs-monolithic step delta
        phases["sync_exposed"] = _phase(predicted["sync_exposed_s"], None)
    # per-link-level predicted comm rows (hierarchical topologies): the
    # slow DCN class's share is visible separately from intra-slice
    # traffic, so drift on the cross-slice links can be attributed
    # without un-mixing one aggregate number.  Single-sided like the
    # other sub-step phases (one fused program has no per-link timer).
    for name, secs in (predicted.get("sync_levels_s") or {}).items():
        phases[f"sync_{name}"] = _phase(secs, None)
    for name, stats in (measured_phases or {}).items():
        phases[name] = _phase(None, stats.get("mean_s"))
    buckets = []
    for row in predicted.get("sync_buckets") or []:
        buckets.append({
            "name": row.get("name"),
            # the STABLE lane id shared with comm_schedule records and
            # the executed step's trace annotations — what a real
            # device_trace capture tag-matches against
            # (obs/trace_ingest.apply_lane_measurements fills the
            # measured fields below from a matched capture)
            "lane": row.get("lane") or f"bucket:{row.get('name')}:sync",
            "precision": row.get("precision"),
            "plan": row.get("plan"),
            "ops": len(row.get("ops") or []),
            "predicted_ready_s": row.get("ready_s"),
            "predicted_issue_s": row.get("start_s"),
            "predicted_sync_s": row.get("sync_s"),
            "predicted_exposed_s": row.get("exposed_s"),
            "predicted_levels_s": row.get("levels") or {},
            # None until a device-trace capture is matched — the fused
            # program has no per-bucket host timer without one
            "measured_s": None,
            "measured_issue_s": None,
        })
    return DriftReport(
        predicted_s=float(total),
        measured_s=float(measured_step_s),
        ratio=float(ratio),
        threshold=float(threshold),
        stale=bool(stale),
        calibrated=bool(calibrated),
        calibration_stale=bool(stale and calibrated),
        phases=phases,
        sync_buckets=buckets,
    )
