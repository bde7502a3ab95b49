"""The port's measured side of the loop against the JAX package's:
``obs/trace_ingest.py``, the simulator's predicted-timeline exports,
``fit``'s ``device_trace_dir`` capture and the data loader's native
gather.

* the committed fixture (tests/data/device_trace_fixture.trace.json, an
  XLA host trace) ingested by both packages gives equal
  ``IngestResult``s and equal ``LaneDriftReport.to_dict()``s, exactly;
* a hand-written ``torch.profiler``-shaped trace (a row whose ``pid`` is
  the string ``"Spans"``, every tag in a host copy and a
  ``gpu_user_annotation`` device copy) reads each tag once, from the
  device copies, where the reference's reader raises; with a tag
  lacking its device copy, from the host copies;
* a CPU ``torch.profiler`` capture of a 2-layer ``build_gpt`` ``fit``
  (seq 512: the flash route's plain version) holds one step window per
  captured step, and the profiler's summary covers the steps;
* ``write_chrome_trace``, ``export_chrome_trace`` and
  ``export_task_graph_dot`` write the reference's documents for the
  same graph and strategy;
* on the gloo world of 4 of tests/test_torch_sync_schedule.py (its
  ``"traced"`` mode: the searched, staged schedule with ``profiling``
  and ``device_trace_dir``), every rank's ``lane_drift_report`` matches
  every predicted lane, from its host copies; the whole report equals
  the reference's ``match_lanes`` on the same capture and the
  reference simulator's breakdown of the same schedule at 1e-9; the
  controller's drift watch takes it from the model;
* the native gather equals numpy's fancy indexing, and the loader's
  batches equal the reference's below and above its 1 MiB switch.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from flexflow_tpu.obs import trace_ingest as jax_ingest
from flexflow_tpu_torch.obs import trace_ingest

from test_torch_sync_schedule import _world, close

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "device_trace_fixture.trace.json")
# a predicted breakdown over the fixture's lanes (b0, b1 predicted; zz
# only in the trace; b2 only predicted)
PREDICTED = {
    "total_s": 1.2e-3,
    "sync_buckets": [
        {"name": "b0", "start_s": 2.0e-4, "sync_s": 1.5e-4,
         "exposed_s": 5.0e-5},
        {"lane": "bucket:b1:sync", "name": "b1", "start_s": 4.0e-4,
         "sync_s": 2.0e-4, "exposed_s": 0.0},
        {"name": "b2", "start_s": 9.0e-4, "sync_s": 1.0e-4,
         "exposed_s": 1.0e-4},
    ],
}


def _fields(result, names):
    return {k: getattr(result, k) for k in names}


def test_fixture_ingests_equal_to_the_reference():
    ref = jax_ingest.ingest(FIXTURE, emit=False)
    got = trace_ingest.ingest(FIXTURE, emit=False)
    names = [f.name for f in dataclasses.fields(ref)]
    assert _fields(got, names) == _fields(ref, names)
    assert got.source == "host_trace"
    assert got.step_spans and got.lanes and got.phases
    for threshold in (0.5, 0.05):
        r = jax_ingest.match_lanes(ref, PREDICTED, threshold, emit=False)
        g = trace_ingest.match_lanes(got, PREDICTED, threshold, emit=False)
        assert g.to_dict() == r.to_dict()
        assert str(g) == str(r)
    assert (trace_ingest.build_lane_drift_report(
        os.path.dirname(FIXTURE), PREDICTED, emit=False).to_dict()
        == jax_ingest.build_lane_drift_report(
            os.path.dirname(FIXTURE), PREDICTED, emit=False).to_dict())


def test_lane_measurements_fill_the_drift_report_as_the_reference():
    from flexflow_tpu.obs import drift as jax_drift
    from flexflow_tpu_torch.obs import drift

    pred = dict(PREDICTED, compute_end_s=8e-4, comm_end_s=1.1e-3)
    ref_d = jax_drift.build_drift_report(pred, measured_step_s=2e-3)
    got_d = drift.build_drift_report(pred, measured_step_s=2e-3)
    ref_l = jax_ingest.build_lane_drift_report(FIXTURE, PREDICTED,
                                               emit=False)
    got_l = trace_ingest.build_lane_drift_report(FIXTURE, PREDICTED,
                                                 emit=False)
    assert (trace_ingest.apply_lane_measurements(got_d, got_l)
            == jax_ingest.apply_lane_measurements(ref_d, ref_l) == 2)
    assert got_d.to_dict() == ref_d.to_dict()


def _profiler_doc(device_copy_of_done=True):
    """A trace shaped as a CUDA ``torch.profiler`` capture: two steps,
    one lane, every tag on the host thread and on the stream."""
    rows = [{"ph": "X", "name": "PyTorch Profiler (0)", "cat": "Trace",
             "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0,
             "dur": 9000.0}]

    def tag(name, ts, dur, device):
        rows.append({"ph": "X", "name": name, "ts": ts, "dur": dur,
                     "cat": "gpu_user_annotation" if device
                     else "user_annotation",
                     "pid": 0 if device else 4242,
                     "tid": 7 if device else 4242})

    for t0 in (1000.0, 5000.0):
        # the host issues ahead of the device: host copies start earlier
        tag("ff.phase/step", t0, 900.0, False)
        tag("ff.phase/step", t0 + 300.0, 2000.0, True)
        tag("ff.lane/bucket:b0:sync#issue", t0 + 100.0, 1.0, False)
        tag("ff.lane/bucket:b0:sync#issue", t0 + 800.0, 2.0, True)
        tag("ff.lane/bucket:b0:sync#done", t0 + 200.0, 1.0, False)
        if device_copy_of_done:
            tag("ff.lane/bucket:b0:sync#done", t0 + 1500.0, 2.0, True)
        rows.append({"ph": "X", "name": "flash_fwd_tc_kernel", "cat":
                     "kernel", "pid": 0, "tid": 7, "ts": t0 + 400.0,
                     "dur": 70.0})
    return {"traceEvents": rows}


def test_torch_profiler_rows_read_each_tag_once(tmp_path):
    path = tmp_path / "rank0.1.pt.trace.json"
    path.write_text(json.dumps(_profiler_doc()))
    with pytest.raises(ValueError):  # the reference's int("Spans")
        jax_ingest.read_trace_events(str(path))
    got = trace_ingest.ingest(
        trace_ingest.find_trace_file(str(tmp_path), "rank0"), emit=False)
    assert got.path == str(path) and got.source == "device_trace"
    assert got.events == 14  # the "Spans" row skipped
    assert got.step_spans == [(1300.0, 3300.0), (5300.0, 7300.0)]
    assert got.lanes == {"bucket:b0:sync": [(1800.0, 2500.0),
                                            (5800.0, 6500.0)]}
    rep = trace_ingest.match_lanes(
        got, {"total_s": 2e-3, "sync_buckets": [
            {"name": "b0", "start_s": 5e-4, "sync_s": 7e-4}]}, emit=False)
    assert rep.matched_all and rep.source == "device_trace"
    row = rep.lanes[0]
    assert row["samples"] == 2
    assert row["measured_issue_s"] == pytest.approx(5e-4)
    assert row["measured_sync_s"] == pytest.approx(7e-4)
    # one tag without its device copy: the host copies, one time base
    path.write_text(json.dumps(_profiler_doc(device_copy_of_done=False)))
    got = trace_ingest.ingest(str(path), emit=False)
    assert got.source == "host_trace"
    assert got.step_spans == [(1000.0, 1900.0), (5000.0, 5900.0)]
    assert got.lanes == {"bucket:b0:sync": [(1100.0, 1200.0),
                                            (5100.0, 5200.0)]}


def test_find_trace_file_layouts(tmp_path):
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    xla = run / "host.trace.json"
    xla.write_text(json.dumps({"traceEvents": []}))
    assert trace_ingest.find_trace_file(str(tmp_path)) == str(xla)
    assert jax_ingest.find_trace_file(str(tmp_path)) == str(xla)
    a = tmp_path / "rank1.5.pt.trace.json"
    a.write_text(json.dumps({"traceEvents": []}))
    os.utime(xla, (1, 1))
    assert trace_ingest.find_trace_file(str(tmp_path)) == str(a)
    assert trace_ingest.find_trace_file(str(tmp_path), "rank1") == str(a)
    assert trace_ingest.find_trace_file(str(tmp_path), "rank0") is None
    assert trace_ingest.ingest(str(tmp_path / "none"), emit=False) is None


def test_fit_capture_holds_a_window_per_captured_step(tmp_path):
    import flexflow_tpu_torch as tff
    from flexflow_tpu_torch.models import build_gpt

    cfg = tff.FFConfig(batch_size=2, device="cpu", compute_dtype="float32",
                       profiling=True, device_trace_dir=str(tmp_path / "cap"))
    m = build_gpt(cfg, vocab=64, num_layers=2, hidden=32, num_heads=2,
                  ff_dim=64, seq_len=512)
    m.compile(optimizer=tff.AdamOptimizer(alpha=1e-3),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    ids = np.random.default_rng(0).integers(0, 64, (8, 513)).astype(np.int32)
    m.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    files = os.listdir(tmp_path / "cap")
    assert len(files) == 1 and files[0].startswith("rank0.")
    got = trace_ingest.ingest(str(tmp_path / "cap"), emit=False)
    # 4 steps: the first (the step's build) before the capture
    assert len(got.step_spans) == 3 and got.source == "host_trace"
    assert all(e > s for s, e in got.step_spans)
    assert not got.lanes  # one device: nothing to sync
    assert m.lane_drift_report is None  # no predicted lane to match
    assert m.profile_summary["steps"] == 3
    assert not m.profile_summary["includes_compile"]
    assert len(m.step_losses) == 4 and np.all(np.isfinite(m.step_losses))


def _pair(n=4):
    """The reference's sync-bound BERT graph and a dp strategy in both
    packages, and their simulators on ``tpu_v5e(n)``."""
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    import flexflow_tpu_torch as tff
    from flexflow_tpu.compiler.lowering import data_parallel_strategy as rdp
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu.search.simulator import Simulator as RefSim
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.search.simulator import Simulator

    kw = dict(num_layers=2, hidden=64, num_heads=4, ff_dim=128, seq_len=16)
    rcfg = ff.FFConfig(batch_size=8, num_devices=n,
                       machine_spec=RefSpec.tpu_v5e(n))
    cfg = tff.FFConfig(batch_size=8, num_devices=n, device="cpu",
                       machine_spec=MachineSpec.tpu_v5e(n))
    rg = jmods.build_transformer(rcfg, **kw).graph
    g = build_transformer(cfg, **kw).graph
    return ((rg, rdp(rg, n), RefSim.for_config(rcfg)),
            (g, data_parallel_strategy(g, n), Simulator.for_config(cfg)))


def test_predicted_timeline_exports_equal_the_reference(tmp_path):
    from flexflow_tpu.obs.trace import write_chrome_trace as jax_write
    from flexflow_tpu_torch.obs.trace import write_chrome_trace

    compute = [("fc1", 0.0, 1e-3, (0, 1)), ("fc2", 1e-3, 2.5e-3, (1,))]
    comm = [("bucket:b0:sync", 2.5e-3, 3e-3, (0, 1))]
    docs = []
    for fn, name in ((jax_write, "ref.json"), (write_chrome_trace,
                                               "got.json")):
        fn(str(tmp_path / name), compute, comm, label="x", meta={"a": 1})
        docs.append(json.loads((tmp_path / name).read_text()))
    assert docs[0] == docs[1]

    (rg, rs, rsim), (g, s, sim) = _pair()
    assert [n.op.name for n in g.topo_order()] == [
        n.op.name for n in rg.topo_order()]
    r_s = rsim.export_chrome_trace(rg, rs, str(tmp_path / "rp.json"))
    g_s = sim.export_chrome_trace(g, s, str(tmp_path / "gp.json"))
    assert close(g_s, r_s)
    ref = json.loads((tmp_path / "rp.json").read_text())
    got = json.loads((tmp_path / "gp.json").read_text())
    assert close(got, ref)
    assert any(e.get("cat") == "sync" for e in got["traceEvents"])
    assert close(sim.export_task_graph_dot(g, s, str(tmp_path / "g.dot")),
                 rsim.export_task_graph_dot(rg, rs, str(tmp_path / "r.dot")))
    assert ((tmp_path / "g.dot").read_text()
            == (tmp_path / "r.dot").read_text())


def test_compile_writes_the_exports_and_ffobs_reads_the_log(tmp_path):
    """The compile-time files of the six fields, and the bus log of a
    profiled fit read by tools/ffobs.py (its ``validate`` and
    ``report``) as the reference's logs are."""
    import subprocess
    import sys

    import flexflow_tpu_torch as tff
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.obs.events import BUS

    files = {k: str(tmp_path / f"{k}") for k in (
        "obs_log_file", "obs_trace_file",
        "export_strategy_computation_graph_file",
        "export_strategy_task_graph_file")}
    cfg = tff.FFConfig(batch_size=8, device="cpu", profiling=True, **files)
    m = build_transformer(cfg, num_layers=1, hidden=32, num_heads=2,
                          ff_dim=64, seq_len=16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 16, 32)).astype(np.float32)
    y = rng.integers(0, 32, size=(24, 16)).astype(np.int32)
    try:
        m.compile(optimizer=tff.SGDOptimizer(lr=0.01))
        assert BUS.enabled
        m.fit(x, y, verbose=False)
    finally:
        BUS.close()
    assert m.predicted_breakdown is not None  # profiling asks it
    assert m.drift_report is not None and m.profile_summary["steps"] == 2
    doc = json.loads(open(files["obs_trace_file"]).read())
    assert doc["otherData"]["simulated_step_s"] == pytest.approx(
        m.predicted_breakdown["total_s"])
    for k in ("export_strategy_computation_graph_file",
              "export_strategy_task_graph_file"):
        assert open(files[k]).read().startswith("digraph")
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "ffobs.py")
    for cmd in ("validate", "report"):
        run = subprocess.run([sys.executable, tool, cmd,
                              files["obs_log_file"]], capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, (cmd, run.stdout, run.stderr)
    assert " 0 invalid" in subprocess.run(
        [sys.executable, tool, "validate", files["obs_log_file"]],
        capture_output=True, text=True, timeout=120).stdout


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def test_lanes_of_a_bucketed_dp_world_match_the_reference(world4):
    """Every rank's report matches every predicted lane, and equals the
    reference's ``match_lanes`` of the same capture against the
    reference simulator's breakdown of the same schedule (module
    docstring)."""
    import flexflow_tpu as ff
    from flexflow_tpu.compiler.lowering import data_parallel_strategy as rdp
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu.search.simulator import Simulator as RefSim
    from flexflow_tpu.search.sync_schedule import SyncSchedule

    from test_torch_sync_schedule import _config, mlp

    n, _, ranks = world4
    sched = ranks[0]["traced"]["schedule"]
    assert sched is not None and sched == ranks[0]["search"]["schedule"]
    rcfg = _config(ff, RefSpec, n, "traced", cost_cache_file="")
    rg = mlp(ff, rcfg).graph
    bd: dict = {}
    RefSim.for_config(rcfg).simulate(
        rg, rdp(rg, n), breakdown=bd,
        sync_schedule=SyncSchedule.from_jsonable(sched))
    lanes = {r.get("lane") or f"bucket:{r['name']}:sync"
             for r in bd["sync_buckets"]}
    assert len(lanes) == len(sched["buckets"])
    for r in ranks:
        t = r["traced"]["trace"]
        assert close(t["predicted"]["sync_buckets"], bd["sync_buckets"])
        assert close(t["predicted"]["total_s"], bd["total_s"])
        rep = t["report"]
        assert rep is not None and rep["matched_all"], rep
        assert rep["source"] == "host_trace" == t["source"]
        assert {row["lane"] for row in rep["lanes"]} == lanes
        # the first step (the capture starts after it) is left out
        assert rep["steps"] == len(t["step_spans"]) == 2
        assert all(row["samples"] == 2 and row["measured_sync_s"] > 0
                   for row in rep["lanes"])
        ref = jax_ingest.match_lanes(
            jax_ingest.IngestResult(path="", events=0,
                                    step_spans=t["step_spans"],
                                    lanes=t["lanes"]), bd, emit=False)
        want = dict(ref.to_dict())
        assert close(rep, want)
        assert t["controller_read"]
        # the in-process recorder saw each lane in each captured step
        assert {k: len(v) for k, v in t["recorder_spans"].items()} == {
            lane: 2 for lane in lanes}
        assert t["profile"]["steps"] == 2
        # the capture changed no number of the step
        assert r["traced"]["losses"] == r["search"]["losses"]


def test_native_gather_equals_numpy():
    from flexflow_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler for the native library")
    rng = np.random.default_rng(0)
    for shape, dtype in (((300, 7), np.float32), ((50, 3, 5), np.int64),
                         ((1000, 1024), np.float16), ((9,), np.int8)):
        a = (rng.normal(size=shape) * 100).astype(dtype)
        idx = rng.integers(0, shape[0], size=2 * shape[0])
        for threads in (1, 4):
            assert np.array_equal(native.gather_rows(a, idx, threads),
                                  a[idx])
    assert native.gather_rows(a, idx[:0]).shape == (0,)
    with pytest.raises(IndexError):
        native.gather_rows(a, np.array([0, 9]))


class _RefCompiled:
    def input_sharding(self, i):
        return None

    def batch_sharding(self):
        return None

    def stacked_input_sharding(self, i):
        return None

    def stacked_batch_sharding(self):
        return None


class _Compiled:
    device = torch.device("cpu")

    def input_slices(self, i, shape):
        return (slice(None),) * len(shape)

    def label_slices(self, shape):
        return (slice(None),) * len(shape)


@pytest.mark.parametrize("width", (16, 32767, 32768))
def test_loader_batches_equal_the_reference(width, monkeypatch):
    """Batches of 8 fp32 rows: 512 B and 1 MiB less 32 B (numpy), and
    1 MiB (the native gather when the library loads, numpy without it),
    in the reference's order, one by one, then stacked 2 at a time (16
    rows: natively from width 32767 on)."""
    from flexflow_tpu.runtime.dataloader import SingleDataLoader as Ref
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, width)).astype(np.float32)
    y = rng.integers(0, 5, size=(40,)).astype(np.int32)
    calls = []
    real = native.gather_rows
    monkeypatch.setattr(native, "gather_rows",
                        lambda a, i: calls.append(len(i)) or real(a, i))
    for no_native in (False, True):
        if no_native:
            monkeypatch.setattr(native, "get_lib", lambda: None)
        ref = Ref(_RefCompiled(), [x], y, 8, seed=3)
        got = SingleDataLoader(_Compiled(), [x], y, 8, seed=3)
        calls.clear()
        for (ri, rl), (gi, gl) in zip(ref, got):
            assert np.array_equal(np.asarray(ri[0]), gi[0].numpy())
            assert np.array_equal(np.asarray(rl), gl.numpy())
        # the native path only from 1 MiB of gathered rows up (the
        # labels' 32 bytes never)
        assert calls == ([8] * 5 if width == 32768 else [])
        calls.clear()
        for (rk, ri, rl), (gk, gi, gl) in zip(ref.iter_traced(2),
                                              got.iter_traced(2)):
            assert rk == gk
            assert np.array_equal(np.asarray(ri[0]), gi[0].numpy())
            assert np.array_equal(np.asarray(rl), gl.numpy())
        assert calls == ([16] * 2 + [8] * (width == 32768)
                         if width > 16 else [])
