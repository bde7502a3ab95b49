"""Chrome-trace (Perfetto-loadable) export of simulated schedules — a
copy of flexflow_tpu/obs/trace.py.

``Simulator.simulate(..., schedule=[], comm_schedule=[])`` yields
per-task placement records ``(name, start_s, finish_s, device_ids)``;
this module renders them as Chrome Trace Event JSON — the format the
real ``runtime.profiler.device_trace`` capture (``torch.profiler``)
writes — so the PREDICTED timeline loads in Perfetto/chrome://tracing
next to the measured one (the placement-synthesis papers' per-phase
predicted-timeline artifact; PAPERS.md).

Layout: one process (pid 0, named with ``label``), one thread row per
device for compute slices, plus a ``comm`` row per device (tid offset
by COMM_TID_BASE) for weight-sync collectives.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Tuple

# comm rows sit below the compute rows; 4096 devices of headroom
COMM_TID_BASE = 4096

ScheduleEntry = Tuple[str, float, float, Tuple[int, ...]]


def chrome_trace_events(
    compute: Iterable[ScheduleEntry],
    comm: Iterable[ScheduleEntry] = (),
    label: str = "predicted (simulator)",
) -> List[dict]:
    """Trace-event dicts (``ph: X`` complete slices + ``ph: M``
    metadata).  Timestamps/durations are microseconds per the format."""
    events: List[dict] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": label}},
    ]
    seen_tids = set()

    def add(entries, cat: str, tid_base: int):
        for name, start_s, finish_s, devs in entries:
            for d in devs:
                tid = tid_base + int(d)
                if tid not in seen_tids:
                    seen_tids.add(tid)
                    row = (f"device {d}" if tid_base == 0
                           else f"comm {d}")
                    events.append({
                        "ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_name", "args": {"name": row},
                    })
                events.append({
                    "ph": "X", "pid": 0, "tid": tid, "cat": cat,
                    "name": str(name),
                    "ts": float(start_s) * 1e6,
                    "dur": max(0.0, float(finish_s) - float(start_s)) * 1e6,
                    "args": {"devices": [int(x) for x in devs]},
                })

    add(compute, "compute", 0)
    add(comm, "sync", COMM_TID_BASE)
    return events


def write_chrome_trace(
    path: str,
    compute: Iterable[ScheduleEntry],
    comm: Iterable[ScheduleEntry] = (),
    label: str = "predicted (simulator)",
    meta: dict = None,
) -> None:
    doc = {
        "traceEvents": chrome_trace_events(compute, comm, label=label),
        "displayTimeUnit": "ms",
    }
    if meta:
        doc["otherData"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)
