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
  ``torch.profiler`` range while armed;
* the lane tags and ``LaneRecorder`` pair as the reference's, and a
  CPU ``lane_stamp`` records the host clock and a profiler range;
* ``StepProfiler``'s summaries equal the reference's on the same
  recorded times (its own cases, tests/test_obs.py);
* ``render_prometheus`` gives the reference's text for the same
  observations, and ``MetricsServer`` serves it on loopback.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
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


# ---- the measured side: lane stamps, StepProfiler, exposition ------------
def test_lane_tags_and_recorder_equal_the_reference():
    from flexflow_tpu.obs import annotate as jax_annotate

    for name in ("ff.lane/bucket:b0:sync#issue", "ff.lane/b:x#done",
                 "ff.lane/plain", "ff.phase/step", "other"):
        assert annotate.parse_tag(name) == jax_annotate.parse_tag(name)
    assert annotate.lane_tag("bucket:b1:sync") == jax_annotate.lane_tag(
        "bucket:b1:sync")
    rows = [("ff.lane/a#issue", 1.0), ("ff.lane/b#done", 1.5),
            ("ff.lane/a#done", 2.0), ("ff.lane/a#issue", 3.0),
            ("ff.phase/step", 3.1), ("ff.lane/a#issue", 4.0),
            ("ff.lane/a#done", 5.0)]
    got, ref = annotate.LaneRecorder(), jax_annotate.LaneRecorder()
    for tag, t in rows:
        got.record(tag, t)
        ref.record(tag, t)
    assert got.spans() == ref.spans() == {"a": [(1.0, 2.0), (4.0, 5.0)]}
    assert got.rows == ref.rows
    got.clear()
    assert got.spans() == {}


def test_lane_stamp_on_the_cpu_records_the_host_clock_and_a_range():
    from flexflow_tpu_torch.config import FFConfig

    assert not annotate.lane_stamps_armed(FFConfig(device="cpu"))
    assert annotate.lane_stamps_armed(FFConfig(device="cpu",
                                               device_trace_dir="/x"))
    annotate.LANES.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        annotate.lane_stamp("bucket:b0:sync", "issue", torch.device("cpu"))
        torch.ones(64).sum()
        annotate.lane_stamp("bucket:b0:sync", "done")
    names = {e.name for e in prof.events()}
    assert {"ff.lane/bucket:b0:sync#issue",
            "ff.lane/bucket:b0:sync#done"} <= names
    (span,), = annotate.LANES.spans().values()
    assert span[1] >= span[0]
    annotate.LANES.clear()


def _profilers():
    from flexflow_tpu.runtime.profiler import StepProfiler as JaxProfiler
    from flexflow_tpu_torch.runtime.profiler import StepProfiler

    return StepProfiler(), JaxProfiler()


def test_step_profiler_summaries_equal_the_reference():
    """The reference's cases (tests/test_obs.py) on the same recorded
    times."""
    got, ref = _profilers()
    for p in (got, ref):
        p.start_step()
        p.end_step()
        p.step_times[-1] = 0.5  # the compile step
    assert got.summary() == ref.summary()
    assert got.summary()["includes_compile"] is True
    assert str(got) == str(ref)
    for p in (got, ref):
        for t in (0.010, 0.012, 0.011):
            p.step_times.append(t)
        p.phase_times = {"dispatch": [0.2, 0.001, 0.002, 0.001],
                         "wait": [0.3, 0.009, 0.01]}
        p.end_phase("never_started")
    assert got.summary() == ref.summary()
    assert got.summary()["steps"] == 3
    assert got.summary(skip_first=0) == ref.summary(skip_first=0)
    assert got.phase_summary() == ref.phase_summary()
    assert got.phase_summary(skip_first=4) == ref.phase_summary(
        skip_first=4)
    assert str(got) == str(ref)
    empty, ref_empty = _profilers()
    assert empty.summary() == ref_empty.summary() == {"steps": 0}
    assert str(empty) == str(ref_empty)


def test_step_profiler_phases_time_the_host():
    p, _ = _profilers()
    for _ in range(2):
        p.start_step()
        p.start_phase("dispatch")
        p.end_phase("dispatch")
        p.start_phase("wait")
        torch.ones(1000).sum()
        p.end_phase("wait")
        p.end_step()
    ps = p.phase_summary()
    assert set(ps) == {"dispatch", "wait"}
    assert ps["wait"]["mean_s"] > 0 and ps["wait"]["count"] == 1


def _registry(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("fit.steps").inc(7)
    reg.counter("decode.tokens|replica=0,slo=interactive").inc(3)
    reg.counter("decode.tokens|broken").inc(1)
    reg.gauge("fit.step_mean_s").set(0.125)
    reg.gauge("nan.gauge").set(float("nan"))
    h = reg.histogram("decode.ttft_s|replica=1")
    for v in (0.1, 0.2, 0.4, 0.8):
        h.observe(v)
    reg.histogram("empty.h")
    return reg


def test_prometheus_text_equals_the_reference_and_is_served():
    import urllib.request

    from flexflow_tpu.obs import exposition as jax_exposition
    from flexflow_tpu_torch.obs import exposition

    got = exposition.render_prometheus(_registry(metrics).snapshot())
    ref = jax_exposition.render_prometheus(
        _registry(jax_metrics).snapshot())
    assert got == ref and "# TYPE flexflow_tpu_fit_steps counter" in got
    assert exposition.render_prometheus({}) == ""
    server = exposition.MetricsServer(0, registry=_registry(metrics))
    try:
        assert server.host == "127.0.0.1" and server.port > 0
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            assert r.read().decode() == got
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/other", timeout=10)
    finally:
        server.close()


def test_metrics_server_from_the_environment(monkeypatch):
    from flexflow_tpu_torch.obs import exposition

    for raw in ("", "0", "x", "-3"):
        monkeypatch.setenv("FLEXFLOW_TPU_METRICS_PORT", raw)
        assert exposition.maybe_start_from_env() is None
    assert exposition._SERVER is None
    first = exposition.start_metrics_server(0)
    try:
        assert exposition.start_metrics_server(0) is first
    finally:
        exposition.stop_metrics_server()
    assert exposition._SERVER is None


def test_device_trace_writes_one_rank_file_and_never_moves_to_the_cpu(
        tmp_path):
    from flexflow_tpu_torch.obs.trace_ingest import ingest
    from flexflow_tpu_torch.runtime.profiler import device_trace

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with device_trace(str(tmp_path / "x")):
                pass
    with device_trace(str(tmp_path / "cap"), "cpu") as trace:
        assert annotate.armed()
        for _ in range(3):
            with annotate.phase_span(annotate.DECODE_PHASE):
                torch.ones(8).sum()
    assert not annotate.armed()
    assert os.path.basename(trace.trace_file).startswith("rank0.")
    got = ingest(str(tmp_path / "cap"), emit=False)
    assert got.path == trace.trace_file
    assert len(got.phases[annotate.DECODE_PHASE]) == 3
