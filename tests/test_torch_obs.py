"""The port's observability copies against the JAX package's obs
modules, and the executor's request span trees.

* ``EVENT_KINDS`` equal, and ``validate_event`` gives both packages'
  verdicts on every event a traced port run emits and on corrupted
  ones, so ``tools/ffobs.py`` reads the port's logs;
* the metrics histogram summaries and the drift report equal the
  reference's on the same inputs; the flight recorder sees every event;
* with ``TRACER`` armed, every request of a port run with the chunked
  lane and a preemption has one well-formed span tree: one root, no
  orphan, nothing left open, phases summing to the measured e2e;
* ``annotate.phase_span`` is a shared null context while disarmed and a
  ``torch.profiler`` range while armed.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

from flexflow_tpu.obs import drift as jax_drift
from flexflow_tpu.obs import events as jax_events
from flexflow_tpu.obs import metrics as jax_metrics
from flexflow_tpu_torch.obs import annotate, drift, events, metrics
from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.flight import FLIGHT
from flexflow_tpu_torch.obs.tracing import TRACER
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    SLOClass,
)

SLO_TABLE = (SLOClass("interactive", priority=2),
             SLOClass("batch", priority=0))


def _step(ids, table, lens, vocab=31):
    nxt = (np.asarray(ids)[:, 0] * 5 + np.asarray(lens) * 3 + 1) % vocab
    return torch.nn.functional.one_hot(torch.from_numpy(nxt).long(),
                                       vocab).float()[:, None, :]


def _traced_run(tmp_path):
    """A port run through the chunked lane (a recording prefill writer),
    with a preemption, the bus and the tracer armed."""
    log = str(tmp_path / "obs.jsonl")
    BUS.configure(log)
    TRACER.reset()
    TRACER.enabled = True
    try:
        ex = ContinuousBatchingExecutor(
            _step, max_seqs=1, page_size=4, pages_per_seq=4,
            slo_classes=SLO_TABLE, prefill_fn=lambda *a: None,
            prefill_chunk=2)
        ex.submit([DecodeRequest(rid="victim", prompt=[2, 3, 4, 5, 6],
                                 max_new_tokens=6, slo="batch")])
        ex.step()
        ex.submit([DecodeRequest(rid="vip", prompt=[4, 5, 6],
                                 max_new_tokens=2, slo="interactive"),
                   DecodeRequest(rid="late", prompt=[7],
                                 max_new_tokens=2, slo="batch",
                                 deadline_frames=1)])
        ex.run(max_frames=100)
        BUS.flush()
        with open(log) as f:
            evts = [json.loads(line) for line in f]
    finally:
        BUS.close()
        TRACER.enabled = False
    return ex, evts


def test_event_kinds_equal_the_reference():
    assert events.EVENT_KINDS == jax_events.EVENT_KINDS
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION


def test_validate_event_verdicts_equal_the_reference(tmp_path):
    ex, evts = _traced_run(tmp_path)
    kinds = {e["kind"] for e in evts}
    assert {"decode.frame", "decode.request", "decode.prefill",
            "decode.summary"} <= kinds
    bad = [None, [1], {"kind": "decode.frame"},
           {"ts": 1.0, "kind": "no.such.kind"}]
    for e in evts:
        broken = copy.deepcopy(e)
        broken.pop(next(k for k in e if k not in ("ts", "kind")), None)
        bad.append(broken)
    for e in evts:
        assert events.validate_event(e) == [] == jax_events.validate_event(e)
    for e in bad:
        assert events.validate_event(e) == jax_events.validate_event(e)
    assert any(events.validate_event(e) for e in bad)


def test_request_span_trees_validate(tmp_path):
    ex, _ = _traced_run(tmp_path)
    recs = {r["rid"]: r for r in ex.request_records
            if r.get("phase") == "finish"}
    assert set(recs) == {"victim", "vip"} and set(ex.expired) == {"late"}
    assert ex.total_preempted == 1
    assert TRACER.open_spans() == []
    seen = set()
    for tid in TRACER.trace_ids():
        rid = tid.split("#", 1)[0]
        e2e = recs[rid]["e2e_s"] if rid in recs else None
        assert TRACER.validate_trace(tid, e2e_s=e2e) == [], tid
        spans = TRACER.trace_spans(tid)
        assert [s.name for s in spans if s.parent_id is None] == [
            "request"]
        seen.add(rid)
    assert seen == {"victim", "vip", "late"}
    victim = [t for t in TRACER.trace_ids() if t.startswith("victim#")][0]
    names = [s.name for s in TRACER.trace_spans(victim)]
    assert names.count("queue") == 2 and "prefill.chunk" in names


def test_metrics_and_drift_equal_the_reference():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=5000).tolist()  # past the 4096 reservoir
    h, jh = metrics.Histogram("t"), jax_metrics.Histogram("t")
    for x in xs:
        h.observe(x)
        jh.observe(x)
    assert h.summary() == jh.summary()
    for measured in (0.5, 1.0, 3.0):
        pred = {"total_s": 1.0, "compute_end_s": 0.7, "comm_end_s": 0.2}
        got = drift.build_drift_report(pred, measured)
        ref = jax_drift.build_drift_report(pred, measured)
        assert got.to_dict() == ref.to_dict()
    assert drift.build_drift_report({"total_s": 0.0}, 1.0) is None


def test_flight_recorder_sees_every_event():
    FLIGHT.reset()
    assert not BUS.enabled
    BUS.emit("decode.frame", frame=0, active=1, admitted=1, evicted=0,
             pages_in_use=4, queued=0, measured_s=0.1)
    (_, kind, payload), = FLIGHT.tail(1)
    assert kind == "decode.frame" and payload["pages_in_use"] == 4


def test_phase_span_is_free_disarmed_and_a_profiler_range_armed():
    assert not annotate.armed()
    assert annotate.phase_span(annotate.DECODE_PHASE) is annotate.phase_span(
        annotate.PREFILL_PHASE)
    annotate.arm()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with annotate.phase_span(annotate.DECODE_PHASE):
                torch.ones(4).sum()
    finally:
        annotate.disarm()
    assert annotate.DECODE_PHASE in {e.name for e in prof.events()}


def test_one_bus_read_per_frame_when_off(monkeypatch):
    """With telemetry off, the executor's hot path costs one
    ``BUS.enabled`` read per frame (the reference's contract)."""
    assert not BUS.enabled
    reads = []

    class Counting(type(BUS)):
        @property
        def enabled(self):
            reads.append(1)
            return self.__dict__["enabled"]

        @enabled.setter
        def enabled(self, v):
            self.__dict__["enabled"] = v

    monkeypatch.setattr(BUS, "__class__", Counting)
    try:
        ex = ContinuousBatchingExecutor(_step, max_seqs=2, page_size=4,
                                        pages_per_seq=4)
        ex.submit([DecodeRequest(rid="a", prompt=[1, 2], max_new_tokens=3)])
        reads.clear()
        for _ in range(4):
            ex.step()
    finally:
        monkeypatch.undo()
    assert len(reads) == 4
