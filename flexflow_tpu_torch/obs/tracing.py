"""Request-scoped tracing: Dapper-style span trees for the serving
fleet and the controller's decision episodes.

The executor keeps SCALAR per-request records (queue/TTFT/TPOT/e2e
numbers in ``executor.request_records``); this module gives those
quantities causal structure.  A **trace id is minted at
enqueue** (``request_root`` — the fleet router's ``route()`` or the
executor's ``submit()``, whichever sees the request first) and child
spans open at every lifecycle edge:

* ``route``   — the router decision (replica tag), zero-duration;
* ``queue``   — enqueue → admission (re-opened on preemption re-queue,
  so a preempted request's timeline partitions into residency windows);
* ``prefill`` — admission → prompt cached (with one ``prefill.chunk``
  child per batched chunk pass, runtime/prefill.py);
* ``decode``  — decode-loop residency (prompt cached → EOS/evict/
  preempt);
* the root ``request`` span closes at eviction/EOS/expiry with the
  outcome.

Controller episodes (re-search, hot swap, refleet, fallback) become
spans too, so a p99-drift → re-search → hot-apply chain reads as ONE
tree in the same export.

The phase children partition the request's lifetime, so their summed
durations reproduce the measured e2e (``validate_trace`` checks
nesting, orphans, and that sum — the well-formedness contract the
bench asserts per request).

Overhead discipline matches the event bus: ``TRACER.enabled`` is a
plain attribute, read ONCE per frame / submit batch by the
instrumented hot paths; disarmed (the default) every edge is a single
boolean check.  Closed spans are kept in a bounded buffer, emitted as
``trace.span`` events when the bus is armed, observed into the
``trace.span_s|span=<name>`` registry histograms, and exported as a
real Chrome-trace/Perfetto JSON (``export_chrome_trace``) viewable
next to the predicted timeline (obs/trace.py) and the device-trace
capture.  ``FLEXFLOW_TPU_TRACE=<path.json>`` arms the tracer at import
and exports the Chrome trace at interpreter exit (``=1`` arms
in-memory only).

Stdlib-only, no jax import (tools must read artifacts without jax).

The port's copy of flexflow_tpu/obs/tracing.py, imports rewired; the
event schemas, environment variables and file formats are the
reference's, so ``tools/ffobs.py`` reads the port's logs.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

# the phase children that PARTITION a request's lifetime (route and
# prefill.chunk nest inside them; their durations must not be double
# counted by the sum-to-e2e validation)
REQUEST_PHASES = ("queue", "prefill", "decode")
REQUEST_ROOT = "request"
EPISODE_ROOT = "controller.episode"


class Span:
    """One span: closed when ``end_s`` is set, open otherwise."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_s",
                 "end_s", "attrs")

    def __init__(self, trace_id: str, span_id: int,
                 parent_id: Optional[int], name: str, start_s: float,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.attrs = dict(attrs) if attrs else {}

    @property
    def dur_s(self) -> Optional[float]:
        return None if self.end_s is None else self.end_s - self.start_s

    def to_jsonable(self) -> dict:
        out = {"trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "span": self.name,
               "start_s": self.start_s}
        if self.end_s is not None:
            out["end_s"] = self.end_s
            out["dur_s"] = self.end_s - self.start_s
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class Tracer:
    """Process-wide span collector.  ``enabled`` is a plain attribute
    (the one-boolean contract); every mutator below is a no-op-shaped
    cheap call the instrumentation sites guard with ONE read of it."""

    def __init__(self, max_spans: int = 65536):
        self.enabled = False
        self.max_spans = max_spans
        self.spans: List[Span] = []  # closed spans, oldest first
        self.dropped = 0             # closed spans the bound evicted
        self._open: Dict[str, List[Span]] = {}  # trace_id -> open spans
        self._rids: Dict[str, str] = {}         # live rid -> trace_id
        self._mint = 0               # trace counter (ids stay unique
        self._sid = 0                # across runs in one process)
        self._export_path: Optional[str] = None
        self._atexit_armed = False

    # -- arming ---------------------------------------------------------
    def configure(self, export_path: Optional[str] = None,
                  max_spans: Optional[int] = None) -> None:
        """Arm the tracer; ``export_path`` additionally schedules a
        Chrome-trace export at interpreter exit."""
        self.enabled = True
        if max_spans:
            self.max_spans = int(max_spans)
        if export_path:
            self._export_path = export_path
            if not self._atexit_armed:
                atexit.register(self._export_at_exit)
                self._atexit_armed = True

    def close(self) -> None:
        self.enabled = False
        self._export_path = None

    def reset(self) -> None:
        """Drop every span and live-trace mapping (tests)."""
        self.spans = []
        self.dropped = 0
        self._open = {}
        self._rids = {}

    def _export_at_exit(self) -> None:
        if self._export_path and (self.spans or self._open):
            try:
                self.export_chrome_trace(self._export_path)
            except OSError:  # telemetry must never break exit
                pass

    # -- minting + span edges -------------------------------------------
    def request_root(self, rid: str, at: Optional[float] = None,
                     **attrs) -> str:
        """The request's trace id, minting a fresh trace + open root
        ``request`` span on first sight of ``rid`` (idempotent: the
        fleet router mints at route time, the replica's ``submit`` then
        finds the mapping and only adds children)."""
        tid = self._rids.get(rid)
        if tid is not None:
            return tid
        self._mint += 1
        tid = f"{rid}#{self._mint}"
        self._rids[rid] = tid
        self.begin(tid, REQUEST_ROOT, parent=None, at=at, rid=rid, **attrs)
        return tid

    def episode_root(self, **attrs) -> str:
        """Mint a controller-episode trace (root span
        ``controller.episode``) and return its trace id."""
        self._mint += 1
        tid = f"ctl#{self._mint}"
        self.begin(tid, EPISODE_ROOT, parent=None, **attrs)
        return tid

    def trace_of(self, rid: str) -> Optional[str]:
        """The LIVE trace id for ``rid`` (None once its root closed)."""
        return self._rids.get(rid)

    def begin(self, trace_id: str, name: str,
              parent: Optional[str] = None, at: Optional[float] = None,
              **attrs) -> Span:
        """Open a child span.  ``parent`` names an OPEN span of the
        same trace (the newest one wins when re-opened names repeat);
        None attaches to the trace's root when one is open.  ``at`` is
        the start time (``time.perf_counter()`` seconds; default: now),
        so one clock read can close a phase and open the next."""
        opens = self._open.setdefault(trace_id, [])
        parent_id = None
        want = parent if parent is not None else None
        for sp in reversed(opens):
            if want is None or sp.name == want:
                parent_id = sp.span_id
                break
        self._sid += 1
        span = Span(trace_id, self._sid, parent_id, name,
                    time.perf_counter() if at is None else at, attrs)
        opens.append(span)
        return span

    def end(self, trace_id: str, name: str, at: Optional[float] = None,
            **attrs) -> Optional[Span]:
        """Close the newest open span named ``name`` at ``at`` (default:
        now; None when no such span is open — callers use that to
        detect which phase a preempted sequence was in)."""
        opens = self._open.get(trace_id)
        if not opens:
            return None
        for i in range(len(opens) - 1, -1, -1):
            if opens[i].name == name:
                span = opens.pop(i)
                if at is not None:
                    span.end_s = at
                self._close(span, attrs)
                return span
        return None

    def end_any(self, trace_id: str, names: Iterable[str],
                at: Optional[float] = None, **attrs) -> Optional[Span]:
        """Close whichever of ``names`` is open (newest first) — the
        preemption edge, where the victim may be mid-prefill or
        mid-decode."""
        for name in names:
            span = self.end(trace_id, name, at=at, **attrs)
            if span is not None:
                return span
        return None

    def annotate(self, trace_id: str, name: str,
                 parent: Optional[str] = None, **attrs) -> Span:
        """A zero-duration span (an instant decision, e.g. the router
        pick) — opened and closed at the same clock read."""
        span = self.begin(trace_id, name, parent=parent, **attrs)
        opens = self._open.get(trace_id)
        if opens and opens[-1] is span:
            opens.pop()
        self._close(span, {})
        span.end_s = span.start_s
        return span

    def finish_trace(self, trace_id: str, **attrs) -> None:
        """Close every still-open span of the trace, the root last
        (root takes ``attrs`` — the request/episode outcome)."""
        opens = self._open.pop(trace_id, None)
        if not opens:
            return
        root = opens[0]
        for span in reversed(opens[1:]):
            self._close(span, {})
        self._close(root, attrs)

    def finish_request(self, rid: str, **attrs) -> None:
        """Close the request's trace and retire the rid mapping (a
        later re-use of the rid mints a FRESH trace)."""
        tid = self._rids.pop(rid, None)
        if tid is not None:
            self.finish_trace(tid, **attrs)

    def _close(self, span: Span, attrs: dict) -> None:
        if span.end_s is None:
            span.end_s = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        self.spans.append(span)
        if len(self.spans) > self.max_spans:
            drop = len(self.spans) - self.max_spans
            del self.spans[:drop]
            self.dropped += drop
        # roll up into the registry (exposition serves it live) + the
        # event stream (ffobs trace/report read it offline)
        from flexflow_tpu_torch.obs.events import BUS
        from flexflow_tpu_torch.obs.metrics import METRICS

        dur = span.end_s - span.start_s
        METRICS.histogram(f"trace.span_s|span={span.name}").observe(dur)
        if BUS.enabled:
            BUS.emit("trace.span", trace_id=span.trace_id,
                     span=span.name, span_id=span.span_id,
                     parent_id=span.parent_id, start_s=span.start_s,
                     dur_s=dur, **span.attrs)

    # -- introspection ---------------------------------------------------
    def open_spans(self, trace_id: Optional[str] = None) -> List[Span]:
        if trace_id is not None:
            return list(self._open.get(trace_id, ()))
        return [s for opens in self._open.values() for s in opens]

    def trace_ids(self) -> List[str]:
        seen: List[str] = []
        for s in self.spans:
            if s.trace_id not in seen:
                seen.append(s.trace_id)
        for tid in self._open:
            if tid not in seen:
                seen.append(tid)
        return seen

    def trace_spans(self, trace_id: str) -> List[Span]:
        out = [s for s in self.spans if s.trace_id == trace_id]
        out += self._open.get(trace_id, [])
        return out

    # -- validation ------------------------------------------------------
    def validate_trace(self, trace_id: str,
                       e2e_s: Optional[float] = None,
                       tol: float = 0.25,
                       eps_s: float = 2e-3) -> List[str]:
        """Well-formedness problems of one span tree ([] = valid):
        every non-root parent must exist (no orphans), children must
        nest inside their parent's window, no span may remain open,
        and — when the measured ``e2e_s`` is supplied — the phase
        children's summed durations must reproduce it within ``tol``
        (relative) + ``eps_s`` (absolute clock slack)."""
        problems: List[str] = []
        spans = self.trace_spans(trace_id)
        if not spans:
            return [f"{trace_id}: no spans"]
        by_id = {s.span_id: s for s in spans}
        roots = [s for s in spans if s.parent_id is None]
        if len(roots) != 1:
            problems.append(f"{trace_id}: {len(roots)} root spans")
        for s in spans:
            if s.end_s is None:
                problems.append(f"{trace_id}: span {s.name!r} still open")
            if s.parent_id is None:
                continue
            parent = by_id.get(s.parent_id)
            if parent is None:
                problems.append(
                    f"{trace_id}: ORPHAN span {s.name!r} "
                    f"(parent {s.parent_id} missing)")
                continue
            if s.start_s < parent.start_s - eps_s or (
                    s.end_s is not None and parent.end_s is not None
                    and s.end_s > parent.end_s + eps_s):
                problems.append(
                    f"{trace_id}: span {s.name!r} escapes parent "
                    f"{parent.name!r} window")
        if e2e_s is not None and roots:
            root_id = roots[0].span_id
            phase_sum = sum(
                (s.dur_s or 0.0) for s in spans
                if s.parent_id == root_id and s.name in REQUEST_PHASES)
            if abs(phase_sum - e2e_s) > tol * max(e2e_s, 1e-9) + eps_s:
                problems.append(
                    f"{trace_id}: phase spans sum to {phase_sum:.4f}s "
                    f"vs measured e2e {e2e_s:.4f}s (tol {tol})")
        return problems

    # -- export ----------------------------------------------------------
    def export_chrome_trace(self, path: str) -> int:
        """Write closed + still-open spans as a Chrome Trace Event JSON
        (the format Perfetto loads — same ``ph:"X"``/``ph:"M"`` µs
        shape as the predicted-timeline export, obs/trace.py).  One
        process row; one thread row per trace, named by its trace id.
        Returns the number of span slices written."""
        spans = list(self.spans) + self.open_spans()
        if not spans:
            events: List[dict] = []
            with open(path, "w") as f:
                json.dump({"traceEvents": events,
                           "displayTimeUnit": "ms"}, f)
            return 0
        t0 = min(s.start_s for s in spans)
        now = time.perf_counter()
        # stable thread rows: traces in first-span order
        tids: Dict[str, int] = {}
        for s in sorted(spans, key=lambda s: s.start_s):
            tids.setdefault(s.trace_id, len(tids) + 1)
        events = [{
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "flexflow_tpu request traces"},
        }]
        for trace_id, tid in tids.items():
            events.append({
                "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": trace_id},
            })
        n = 0
        for s in sorted(spans, key=lambda s: (tids[s.trace_id],
                                              s.start_s, s.span_id)):
            end = s.end_s if s.end_s is not None else now
            args = {"trace_id": s.trace_id, "span_id": s.span_id,
                    "parent_id": s.parent_id, "open": s.end_s is None}
            args.update(s.attrs)
            events.append({
                "ph": "X", "pid": 1, "tid": tids[s.trace_id],
                "name": s.name,
                "ts": round((s.start_s - t0) * 1e6, 3),
                "dur": max(round((end - s.start_s) * 1e6, 3), 0.001),
                "args": args,
            })
            n += 1
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
        return n


TRACER = Tracer()

_env = os.environ.get("FLEXFLOW_TPU_TRACE", "")
if _env and _env != "0":
    TRACER.configure(
        export_path=_env if _env not in ("1", "true") else None)
del _env


def span_forest(records: Iterable[dict]) -> Dict[str, List[dict]]:
    """Group decoded ``trace.span``/``trace.open`` event dicts by
    trace id (stdlib helper shared with tools/ffobs.py — JSONL in,
    per-trace span lists out, submission order preserved)."""
    out: Dict[str, List[dict]] = {}
    for e in records:
        if e.get("kind") in ("trace.span", "trace.open"):
            tid = e.get("trace_id")
            if isinstance(tid, str):
                out.setdefault(tid, []).append(e)
    return out


def forest_stats(forest: Dict[str, List[dict]]) -> Tuple[int, int, int]:
    """(total spans, max tree depth, orphan count) over a span forest
    — the ``ffobs report`` "Request traces" roll-up; orphans are a
    validation failure."""
    total = 0
    orphans = 0
    max_depth = 0
    for spans in forest.values():
        total += len(spans)
        by_id = {e.get("span_id"): e for e in spans
                 if e.get("span_id") is not None}

        def depth(e, seen=()) -> int:
            pid = e.get("parent_id")
            if pid is None or e.get("span_id") in seen:
                return 1
            parent = by_id.get(pid)
            if parent is None:
                return 1
            return 1 + depth(parent, seen + (e.get("span_id"),))

        for e in spans:
            pid = e.get("parent_id")
            if pid is not None and pid not in by_id:
                orphans += 1
            max_depth = max(max_depth, depth(e))
    return total, max_depth, orphans
