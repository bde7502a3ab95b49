"""Device-trace ingestion + predicted-lane matching — the port of
flexflow_tpu/obs/trace_ingest.py.

``runtime.profiler.device_trace`` (``torch.profiler``) writes one
Chrome-trace file per rank (``<worker>.<n>.pt.trace.json``) under its
logdir; this module parses it (and the reference's layout,
``plugins/profile/<run>/<host>.trace.json[.gz]``) into normalized
event rows and matches the ``obs/annotate.py`` tags found there
against the simulator's predicted lanes — by TAG EQUALITY on the
stable lane ids both sides share (``bucket:<name>:sync``), never by
kernel names.  The result is a ``LaneDriftReport``: per sync bucket,
predicted vs measured issue time, duration, and their step-relative
fractions.

Where the port departs from the reference's reader:

* a ``torch.profiler`` capture holds rows whose ``pid``/``tid`` are not
  numbers (``"PyTorch Profiler (0)"`` with pid ``"Spans"``); they are
  skipped, where the reference's ``int()`` raises;
* on a CUDA capture every ``record_function`` range appears twice: on
  the host thread and, as ``cat: gpu_user_annotation``, on the stream
  over the device work launched inside it.  ``ingest`` reads each tag
  once: from the device copies when every annotated tag of the capture
  has one (``source`` ``"device_trace"``: step windows and lane marks
  on the device's timeline), else from the host copies
  (``"host_trace"``, the reference's label; a CPU capture, or the
  reference's XLA host trace).

Stdlib-only (json/gzip), so captures ingest anywhere the file lands.
The scale-free comparison (each lane's issue point and duration as
fractions of its own step) is the drift signal (``*_frac_ratio``);
absolute ratios are reported alongside, labeled by ``source``.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.obs.annotate import (
    LANE_PREFIX,
    PHASE_PREFIX,
    STEP_PHASE,
    parse_tag,
)

DEVICE_CAT = "gpu_user_annotation"


@dataclass
class TraceEvent:
    """One normalized complete-slice event from the capture."""

    name: str
    ts_us: float
    dur_us: float
    pid: int = 0
    tid: int = 0
    cat: str = ""


def find_trace_file(path: str, worker: Optional[str] = None
                    ) -> Optional[str]:
    """Resolve a capture to its Chrome-trace JSON: ``path`` may be the
    logdir handed to ``device_trace`` (the newest
    ``*.pt.trace.json[.gz]`` there, or ``plugins/profile/<run>/
    *.trace.json[.gz]`` in the reference's layout, wins; ``worker``
    keeps one rank's ``<worker>.*`` files), a run directory, or the
    trace file itself."""
    if os.path.isfile(path):
        return path
    hits = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        if worker is not None:
            pat = f"{worker}.{pat}"
        hits += glob.glob(os.path.join(path, pat))
        hits += glob.glob(os.path.join(path, "plugins", "profile", "*", pat))
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


def _id(v) -> Optional[int]:
    """A row's ``pid``/``tid`` as an int (missing: 0, as the
    reference's ``int(... or 0)``); None when it is not a number."""
    if v is None or v == "":
        return 0
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str) and v.lstrip("-").isdigit():
        return int(v)
    return None


def read_trace_events(path: str) -> List[TraceEvent]:
    """Normalized ``X``-phase rows of one Chrome-trace JSON file
    (gzipped or plain); rows whose ``pid`` or ``tid`` is not a number
    are skipped.  Raises ValueError on a file that is not a trace
    document."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array")
    out: List[TraceEvent] = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = e.get("name")
        ts = e.get("ts")
        if not isinstance(name, str) or not isinstance(ts, (int, float)):
            continue
        pid, tid = _id(e.get("pid")), _id(e.get("tid"))
        if pid is None or tid is None:
            continue
        dur = e.get("dur")
        cat = e.get("cat")
        out.append(TraceEvent(
            name=name, ts_us=float(ts),
            dur_us=float(dur) if isinstance(dur, (int, float)) else 0.0,
            pid=pid, tid=tid, cat=cat if isinstance(cat, str) else ""))
    out.sort(key=lambda ev: ev.ts_us)
    return out


@dataclass
class IngestResult:
    """The annotated content of one capture: step windows, paired lane
    marker spans, and named phase spans, and which copy of the tags
    they were read from (``source``)."""

    path: str
    events: int
    # [(start_us, end_us)] of ff.phase/step annotation windows
    step_spans: List[Tuple[float, float]] = field(default_factory=list)
    # lane_id -> [(issue_ts_us, done_ts_us)] paired in time order
    lanes: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    # phase tag -> [duration seconds] of non-step ff.phase/* spans
    phases: Dict[str, List[float]] = field(default_factory=dict)
    source: str = "host_trace"


def _tagged(events: List[TraceEvent]):
    """The annotated rows to read, each tag once, and their source:
    the device copies when every annotated tag has one, else the host
    copies (module docstring)."""
    tags = [e for e in events
            if e.name.startswith((PHASE_PREFIX, LANE_PREFIX))]
    on_device = {e.name for e in tags if e.cat == DEVICE_CAT}
    if on_device and on_device == {e.name for e in tags}:
        return [e for e in tags if e.cat == DEVICE_CAT], "device_trace"
    return [e for e in tags if e.cat != DEVICE_CAT], "host_trace"


def ingest(path: str, emit: bool = True) -> Optional[IngestResult]:
    """Parse a capture (logdir or trace file) and pull out every
    annotated tag.  None when no trace file exists.  Emits a
    ``trace.ingest`` event when the bus is armed."""
    trace_file = find_trace_file(path)
    if trace_file is None:
        return None
    events = read_trace_events(trace_file)
    tagged, source = _tagged(events)
    result = IngestResult(path=trace_file, events=len(events),
                          source=source)
    open_issue: Dict[str, float] = {}
    for e in tagged:
        if e.name.startswith(PHASE_PREFIX):
            if e.name == STEP_PHASE:
                result.step_spans.append((e.ts_us, e.ts_us + e.dur_us))
            else:
                result.phases.setdefault(e.name, []).append(
                    e.dur_us / 1e6)
            continue
        parsed = parse_tag(e.name)
        if parsed is None:
            continue
        lane, marker = parsed
        if marker == "issue":
            # a re-issued lane before its done marker (dropped done —
            # e.g. capture stopped mid-step) abandons the open stamp
            open_issue[lane] = e.ts_us
        elif marker == "done" and lane in open_issue:
            result.lanes.setdefault(lane, []).append(
                (open_issue.pop(lane), e.ts_us))
    if emit:
        from flexflow_tpu_torch.obs.events import BUS

        if BUS.enabled:
            BUS.emit("trace.ingest", path=result.path,
                     events=result.events, lanes=len(result.lanes),
                     steps=len(result.step_spans))
    return result


@dataclass
class LaneDriftReport:
    """Predicted-vs-measured drift per sync lane, from a real capture.

    ``lanes`` rows:
      lane, samples, matched,
      predicted_issue_s / predicted_sync_s / predicted_exposed_s
        (the simulator's bucket lane, seconds from step start),
      measured_issue_s / measured_sync_s
        (mean host-trace offsets/durations over the captured steps),
      predicted_issue_frac / measured_issue_frac and
      predicted_sync_frac / measured_sync_frac
        (each side normalized by ITS OWN step length — the scale-free
        comparison a host-clock capture supports),
      issue_frac_ratio / sync_frac_ratio (measured/predicted fraction;
        None when a side is missing or ~0).
    """

    steps: int
    predicted_total_s: float
    measured_step_s: float
    threshold: float
    lanes: List[dict] = field(default_factory=list)
    unmatched_predicted: List[str] = field(default_factory=list)
    unmatched_trace: List[str] = field(default_factory=list)
    source: str = "host_trace"

    @property
    def matched(self) -> int:
        return sum(1 for r in self.lanes if r.get("matched"))

    @property
    def matched_all(self) -> bool:
        return bool(self.lanes) and not self.unmatched_predicted

    @property
    def stale_lanes(self) -> List[str]:
        """Lanes whose measured step-relative sync share drifted past
        the threshold — the per-lane analogue of DriftReport.stale."""
        out = []
        lo = 1.0 / (1.0 + self.threshold)
        hi = 1.0 + self.threshold
        for r in self.lanes:
            ratio = r.get("sync_frac_ratio")
            if isinstance(ratio, (int, float)) and (
                    ratio > hi or ratio < lo):
                out.append(r["lane"])
        return out

    def to_dict(self) -> dict:
        return {
            "steps": self.steps,
            "predicted_total_s": self.predicted_total_s,
            "measured_step_s": self.measured_step_s,
            "threshold": self.threshold,
            "source": self.source,
            "matched": self.matched,
            "matched_all": self.matched_all,
            "stale_lanes": self.stale_lanes,
            "lanes": self.lanes,
            "unmatched_predicted": self.unmatched_predicted,
            "unmatched_trace": self.unmatched_trace,
        }

    def __str__(self) -> str:
        return (
            f"LaneDriftReport: {self.matched}/{len(self.lanes)} lanes "
            f"tag-matched over {self.steps} step(s)"
            + (f", {len(self.stale_lanes)} drifted" if self.stale_lanes
               else "")
            + (f", unmatched predicted: {self.unmatched_predicted}"
               if self.unmatched_predicted else ""))


def _ratio(meas, pred) -> Optional[float]:
    if (isinstance(meas, (int, float)) and isinstance(pred, (int, float))
            and pred > 1e-12 and math.isfinite(pred)
            and math.isfinite(meas)):
        return meas / pred
    return None


def match_lanes(
    result: IngestResult,
    predicted_breakdown: dict,
    threshold: float = 0.5,
    emit: bool = True,
) -> Optional[LaneDriftReport]:
    """Match the capture's lane markers against the predicted
    ``sync_buckets`` lanes of a ``Simulator.simulate(breakdown=...)``
    dict.  Matching is exact on the shared lane id; each matched lane
    aggregates every (step-window, marker-pair) occurrence.  None when
    the prediction carries no bucket lanes.  Emits one
    ``trace.lane_match`` event per predicted lane when the bus is
    armed."""
    rows = predicted_breakdown.get("sync_buckets") or []
    total = predicted_breakdown.get("total_s")
    if not rows or not isinstance(total, (int, float)) \
            or not math.isfinite(total) or total <= 0:
        return None
    # assign each lane occurrence to the step window containing its
    # issue marker; occurrences outside any window (compile step, the
    # capture's warm-up tail) are dropped rather than skewing the means
    spans = result.step_spans
    if not spans:
        return None
    step_walls = [max(0.0, e - s) / 1e6 for s, e in spans]
    mean_step = sum(step_walls) / len(step_walls)

    def _window(ts_us: float):
        for i, (s, e) in enumerate(spans):
            if s <= ts_us <= e:
                return i
        return None

    report = LaneDriftReport(
        steps=len(spans), predicted_total_s=float(total),
        measured_step_s=mean_step, threshold=threshold,
        source=result.source)
    seen_pred = set()
    for row in rows:
        lane = row.get("lane") or f"bucket:{row.get('name')}:sync"
        seen_pred.add(lane)
        pred_issue = row.get("start_s")
        pred_sync = row.get("sync_s")
        occ = []
        for issue_us, done_us in result.lanes.get(lane, ()):
            w = _window(issue_us)
            if w is None:
                continue
            occ.append(((issue_us - spans[w][0]) / 1e6,
                        (done_us - issue_us) / 1e6,
                        step_walls[w]))
        matched = bool(occ)
        m_issue = m_sync = m_wall = None
        if matched:
            m_issue = sum(o[0] for o in occ) / len(occ)
            m_sync = sum(o[1] for o in occ) / len(occ)
            m_wall = sum(o[2] for o in occ) / len(occ)
        p_issue_frac = _ratio(pred_issue, total)
        p_sync_frac = _ratio(pred_sync, total)
        m_issue_frac = _ratio(m_issue, m_wall)
        m_sync_frac = _ratio(m_sync, m_wall)
        lane_row = {
            "lane": lane,
            "matched": matched,
            "samples": len(occ),
            "predicted_issue_s": pred_issue,
            "predicted_sync_s": pred_sync,
            "predicted_exposed_s": row.get("exposed_s"),
            "measured_issue_s": m_issue,
            "measured_sync_s": m_sync,
            "predicted_issue_frac": p_issue_frac,
            "measured_issue_frac": m_issue_frac,
            "predicted_sync_frac": p_sync_frac,
            "measured_sync_frac": m_sync_frac,
            "issue_frac_ratio": _ratio(m_issue_frac, p_issue_frac),
            "sync_frac_ratio": _ratio(m_sync_frac, p_sync_frac),
        }
        report.lanes.append(lane_row)
        if not matched:
            report.unmatched_predicted.append(lane)
    report.unmatched_trace = sorted(
        lane for lane in result.lanes if lane not in seen_pred)
    if emit:
        from flexflow_tpu_torch.obs.events import BUS

        if BUS.enabled:
            for r in report.lanes:
                BUS.emit("trace.lane_match", lane=r["lane"],
                         matched=r["matched"], samples=r["samples"],
                         predicted_sync_s=r["predicted_sync_s"],
                         measured_sync_s=r["measured_sync_s"],
                         sync_frac_ratio=r["sync_frac_ratio"])
    return report


def build_lane_drift_report(
    path: str,
    predicted_breakdown: Optional[dict],
    threshold: float = 0.5,
    emit: bool = True,
) -> Optional[LaneDriftReport]:
    """ingest + match in one call: capture logdir/file -> report.
    None when there is no capture, no annotated step window, or no
    predicted bucket lane to match against."""
    if not predicted_breakdown:
        return None
    result = ingest(path, emit=emit)
    if result is None:
        return None
    return match_lanes(result, predicted_breakdown,
                       threshold=threshold, emit=emit)


def apply_lane_measurements(drift_report, lane_report) -> int:
    """Fill the measured side of a ``DriftReport``'s per-bucket rows
    from a matched ``LaneDriftReport`` — the fields the sync-schedule
    PR honestly recorded as ``None`` until a real capture existed.
    Returns the number of rows populated."""
    if drift_report is None or lane_report is None:
        return 0
    by_lane = {r["lane"]: r for r in lane_report.lanes if r["matched"]}
    filled = 0
    for row in getattr(drift_report, "sync_buckets", None) or []:
        lane = row.get("lane") or f"bucket:{row.get('name')}:sync"
        got = by_lane.get(lane)
        if got is None:
            continue
        row["measured_s"] = got["measured_sync_s"]
        row["measured_issue_s"] = got["measured_issue_s"]
        row["measured_source"] = lane_report.source
        filled += 1
    return filled
