"""Always-on flight recorder: a bounded ring of the most recent
events, dumped to a post-mortem JSONL when something goes wrong.

The event bus is off by default — deliberately, the serving hot loop
pays one boolean per frame — which means a fault or controller
fallback in an UNARMED process leaves no artifact at all.  The flight
recorder fixes exactly that hole: ``EventBus.emit`` hands every event
to ``FLIGHT.record`` BEFORE the ``enabled`` check, so the last-N
events are always in memory (a ``collections.deque`` append of an
already-built payload — no JSON encoding, no I/O), and a dump site
(fault injector, controller fallback, atexit/SIGTERM when armed with a
dump dir, or an explicit ``FLIGHT.dump``) writes them out together
with the tracer's still-open spans — the in-flight requests at the
moment of death.

Overhead discipline mirrors the bus: ``FLIGHT.enabled`` is a plain
attribute checked once per emit; ``FLEXFLOW_TPU_FLIGHT=0`` turns the
recorder off entirely, ``FLEXFLOW_TPU_FLIGHT_RING`` resizes the ring
(default 512), ``FLEXFLOW_TPU_FLIGHT_DIR`` arms automatic dumps (and
the atexit/SIGTERM hook) into that directory.

Dump format: JSONL, first line a ``flight.meta`` record (reason,
counts), then the ring's events verbatim (oldest first), then one
``trace.open`` line per still-open span.  ``ffobs trace`` renders it.

The port's copy of flexflow_tpu/obs/flight.py, imports rewired; the
event schemas, environment variables and file formats are the
reference's, so ``tools/ffobs.py`` reads the port's logs.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import time
from typing import Deque, List, Optional, Tuple

_DEF_CAPACITY = 512


class FlightRecorder:
    """Bounded in-memory event ring + post-mortem dump."""

    def __init__(self, capacity: int = _DEF_CAPACITY):
        self.enabled = True
        self.capacity = capacity
        self.ring: Deque[Tuple[float, str, dict]] = collections.deque(
            maxlen=capacity)
        self.recorded = 0  # total ever recorded (ring drops the rest)
        self.dumps = 0
        self.dump_dir: Optional[str] = None
        self.last_dump_path: Optional[str] = None
        self._hooks_armed = False

    # -- hot path --------------------------------------------------------
    def record(self, kind: str, payload: dict) -> None:
        """Called by ``EventBus.emit`` for EVERY event, armed bus or
        not.  Must stay allocation-light: one tuple + deque append."""
        self.recorded += 1
        self.ring.append((time.time(), kind, payload))

    # -- configuration ---------------------------------------------------
    def configure(self, dump_dir: Optional[str] = None,
                  capacity: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if capacity is not None and capacity != self.capacity:
            self.capacity = int(capacity)
            self.ring = collections.deque(self.ring,
                                          maxlen=self.capacity)
        if dump_dir is not None:
            self.dump_dir = dump_dir
            self._arm_hooks()

    def reset(self) -> None:
        """Clear the ring and counters (tests)."""
        self.ring.clear()
        self.recorded = 0
        self.dumps = 0
        self.last_dump_path = None

    def _arm_hooks(self) -> None:
        if self._hooks_armed:
            return
        self._hooks_armed = True
        atexit.register(self._dump_at_exit)
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                self.dump(reason="sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            pass  # non-main thread / restricted env: atexit still fires

    def _dump_at_exit(self) -> None:
        if self.dump_dir and self.ring:
            try:
                self.dump(reason="atexit")
            except OSError:
                pass

    # -- dump ------------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the ring + open spans to ``path`` (or a fresh file in
        ``dump_dir``).  Returns the path, or None when neither is set
        — post-mortems are opt-in by destination, never by overhead."""
        if not self.enabled:
            return None
        if path is None:
            if self.dump_dir is None:
                return None
            self.dumps += 1
            path = os.path.join(
                self.dump_dir,
                f"flight-{os.getpid()}-{self.dumps:03d}.jsonl")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        from flexflow_tpu_torch.obs.events import BUS, _jsonable
        from flexflow_tpu_torch.obs.tracing import TRACER

        events = list(self.ring)
        open_spans = TRACER.open_spans()
        with open(path, "w") as f:
            meta = {"ts": time.time(), "kind": "flight.meta",
                    "reason": reason, "events": len(events),
                    "dropped": max(self.recorded - len(events), 0)}
            f.write(json.dumps(meta, default=_jsonable) + "\n")
            for t, kind, payload in events:
                evt = {"ts": t, "kind": kind}
                evt.update(payload)
                f.write(json.dumps(evt, default=_jsonable) + "\n")
            for span in open_spans:
                evt = {"ts": time.time(), "kind": "trace.open",
                       "trace_id": span.trace_id, "span": span.name,
                       "span_id": span.span_id,
                       "parent_id": span.parent_id,
                       "start_s": span.start_s}
                if span.attrs:
                    evt["attrs"] = dict(span.attrs)
                f.write(json.dumps(evt, default=_jsonable) + "\n")
        self.last_dump_path = path
        if BUS.enabled:
            BUS.emit("flight.dump", path=path, events=len(events),
                     open_spans=len(open_spans), reason=reason)
        return path

    def tail(self, n: int = 50) -> List[Tuple[float, str, dict]]:
        """The most recent ``n`` ring entries (newest last)."""
        if n <= 0:
            return []
        return list(self.ring)[-n:]


FLIGHT = FlightRecorder(
    capacity=int(os.environ.get("FLEXFLOW_TPU_FLIGHT_RING",
                                _DEF_CAPACITY) or _DEF_CAPACITY))
if os.environ.get("FLEXFLOW_TPU_FLIGHT", "") == "0":
    FLIGHT.enabled = False
_dir = os.environ.get("FLEXFLOW_TPU_FLIGHT_DIR", "")
if _dir:
    FLIGHT.configure(dump_dir=_dir)
del _dir
