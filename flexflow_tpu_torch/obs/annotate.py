"""Named trace annotations: the search's lane vocabulary stamped onto
real execution — the port of flexflow_tpu/obs/annotate.py.

The simulator prices weight-gradient sync as LANES, per-bucket
collective records named ``bucket:<name>:sync`` in
``Simulator.simulate``'s ``sync_buckets`` output.  This module stamps
the same identifiers onto the executed step, so a
``runtime.profiler.device_trace`` capture carries them and
``obs/trace_ingest.py`` matches measured events to predicted lanes by
tag equality, never by kernel names:

* ``phase_span(tag)`` wraps a dispatch-level phase (``ff.phase/step``,
  ``ff.phase/decode_frame``, ``ff.phase/prefill_chunk``) in a
  ``torch.profiler.record_function`` range (plus an NVTX range on a
  CUDA host).  On the card the capture holds the range twice: on the
  host thread and, as ``gpu_user_annotation``, on the stream over the
  kernels launched inside it.  It does so only while armed
  (``arm()``/``disarm()``, driven by ``device_trace`` and ``fit``'s
  capture window); disarmed it is one module-global check and a shared
  null context.
* ``lane_stamp(lane_id, marker, device)`` marks a bucket's issue or
  completion (``comm/bucketed.py``, armed by
  ``FFConfig.device_trace_dir``).  The reference's stamp is a callback
  inside the jitted program that runs when the device reaches it; the
  port's step is eager, so a host clock read at issue would time the
  dispatch, not the collective.  On a CUDA device the stamp is a
  ``record_function`` range around a one-element write on the current
  stream (the stream the collective's payload comes from and its
  result lands on), so the capture's device copy of the tag sits where
  the stream reached that point; ``LANES`` records a CUDA event there
  and resolves it to device seconds when read.  On the CPU (gloo) the
  collective has finished when the host goes on, so the stamp is the
  host clock and the host copy of the range.
* ``scope(lane_id)`` is a range carrying the lane tag around the
  lane's ops while armed (the reference's ``jax.named_scope``).

With ``device_trace_dir`` unset no stamp is made and nothing is
recorded: the step is the one it was.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

LANE_PREFIX = "ff.lane/"
PHASE_PREFIX = "ff.phase/"
STEP_PHASE = PHASE_PREFIX + "step"
DECODE_PHASE = PHASE_PREFIX + "decode_frame"
PREFILL_PHASE = PHASE_PREFIX + "prefill_chunk"
ISSUE_MARK = "#issue"
DONE_MARK = "#done"

_ARMED = False
_NULL = contextlib.nullcontext()


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def armed() -> bool:
    return _ARMED


def lane_tag(lane_id: str) -> str:
    """The annotation tag for a simulator lane id (e.g.
    ``bucket:b0:sync`` -> ``ff.lane/bucket:b0:sync``)."""
    return LANE_PREFIX + lane_id


def parse_tag(name: str):
    """``(lane_id, marker)`` for a lane tag (marker ``"issue"``/
    ``"done"``/``None`` for a plain span), or None when ``name`` is not
    a lane tag."""
    if not name.startswith(LANE_PREFIX):
        return None
    body = name[len(LANE_PREFIX):]
    for mark, label in ((ISSUE_MARK, "issue"), (DONE_MARK, "done")):
        if body.endswith(mark):
            return body[: -len(mark)], label
    return body, None


@contextlib.contextmanager
def _span(tag: str):
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(tag):
        if nvtx:
            torch.cuda.nvtx.range_push(tag)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def phase_span(tag: str):
    """Context manager: a profiler range (and an NVTX range on a CUDA
    host) while armed, a shared null context otherwise."""
    if not _ARMED:
        return _NULL
    return _span(tag)


def scope(lane_id: str):
    """A range carrying the lane tag around the lane's ops while armed
    (the reference's ``jax.named_scope``), a null context otherwise."""
    return phase_span(lane_tag(lane_id))


class LaneRecorder:
    """Lane stamp buffer: (tag, seconds) rows in arrival order.  Host
    stamps carry ``time.perf_counter``; device stamps carry device
    seconds since the first device stamp after ``clear()``, resolved
    from their CUDA events when the rows are read (reading waits for
    the last event).  The trace file is the primary consumer of lane
    timings; this buffer is the in-process cross-check."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: List[tuple] = []
        self._events: List[tuple] = []  # (tag, event), unresolved
        self._base = None  # the first device stamp's event

    def record(self, tag: str, t: float) -> None:
        with self._lock:
            self._rows.append((tag, t))

    def record_event(self, tag: str, event) -> None:
        with self._lock:
            if self._base is None:
                self._base = event
            self._events.append((tag, event))

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._events.clear()
            self._base = None

    @property
    def rows(self) -> List[tuple]:
        with self._lock:
            if self._events:
                self._events[-1][1].synchronize()
                for tag, ev in self._events:
                    self._rows.append(
                        (tag, self._base.elapsed_time(ev) * 1e-3))
                self._events.clear()
            return list(self._rows)

    def spans(self) -> Dict[str, List[tuple]]:
        """lane_id -> [(issue_t, done_t), ...] paired in arrival
        order; unpaired stamps are dropped."""
        open_t: Dict[str, float] = {}
        out: Dict[str, List[tuple]] = {}
        for tag, t in self.rows:
            parsed = parse_tag(tag)
            if parsed is None:
                continue
            lane, marker = parsed
            if marker == "issue":
                open_t[lane] = t
            elif marker == "done" and lane in open_t:
                out.setdefault(lane, []).append((open_t.pop(lane), t))
        return out


LANES = LaneRecorder()

_MARKS: Dict[object, object] = {}  # device -> its one-element buffer


def lane_stamp(lane_id: str, marker: str, device=None) -> None:
    """Stamp a lane's ``"issue"`` or ``"done"`` point: a
    ``record_function`` marker carrying the tag, and a ``LANES`` row.
    On a CUDA ``device`` the marker wraps a one-element write on the
    current stream and the row is a CUDA event recorded there (module
    docstring); elsewhere the row is the host clock.  Nothing is
    stamped while the stream is being captured into a CUDA graph.
    Call only from code gated by ``lane_stamps_armed``."""
    import torch

    tag = lane_tag(lane_id) + (ISSUE_MARK if marker == "issue"
                               else DONE_MARK)
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda and torch.cuda.is_current_stream_capturing():
        return
    with torch.profiler.record_function(tag):
        if cuda:
            buf = _MARKS.get(device)
            if buf is None:
                buf = _MARKS[device] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
            buf.fill_(1)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            LANES.record_event(tag, ev)
        else:
            LANES.record(tag, time.perf_counter())


def lane_stamps_armed(config) -> bool:
    """Whether the step should stamp its sync lanes: opt-in through
    ``FFConfig.device_trace_dir`` (the capture's consumer)."""
    return bool(getattr(config, "device_trace_dir", None))
