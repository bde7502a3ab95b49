"""The port's always-on loop against the JAX package's: the hot swap
(``FFModel.swap_strategy``), the swap lint, the seeded faults
(``runtime/faults.py``), the SLO burn rates (``obs/slo.py``) and the
``TrainingController`` (``runtime/controller.py``).

Every test of the reference's tests/test_controller.py has its port
here, on its tiny dense model ([8, 16] -> dense 32 relu (-> cache) ->
dense 4, SGD 1e-2, fp32 compute on both sides for the comparisons; the
port starts from the JAX model's weights).  Legs of one process run the
port with ``num_devices=1`` against the reference's ``num_devices=4``
(data parallelism computes the same function): the same seeded fault
plan runs in both packages, and the port reaches the reference's loss
history within 1e-5 relative and its ``stats`` counters and its
re-search triggers exactly.  Legs that swap between strategies or
shrink the mesh (4 -> 2) run on one gloo world of 4 CPU ranks
(``shared_world``, once per run), where the swaps are held bit-exact to
their oracles: the pre-swap state (every param, slot and op state), the
whole values cut to the new layout's blocks, and a fresh 2-rank run
from the same snapshot; the ranks a shrink leaves out return from the
loop at the fault's step.  The worker functions import no JAX: the
spawned ranks import this module to find them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.runtime import (
    FaultPlan,
    TrainingController,
    shrink_config,
)
from flexflow_tpu_torch.runtime.distributed import spawn
from flexflow_tpu_torch.search.calibration import CalibrationTable
from test_torch_worlds import shared_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("steps", "swaps", "recoveries", "retries", "fallbacks",
            "restores")
N = 4  # the world's ranks


def _make_model(num_devices=1, seed=0, with_cache=False, start=None,
                **cfg_kw):
    cfg = tff.FFConfig(batch_size=8, num_devices=num_devices,
                       only_data_parallel=True, seed=seed, device="cpu",
                       compute_dtype="float32", **cfg_kw)
    m = tff.FFModel(cfg)
    x = m.create_tensor([8, 16])
    h = m.dense(x, 32, activation="relu", name="d0")
    if with_cache:
        h = m.cache(h, name="c0")
    m.dense(h, 4, name="d1")
    m.compile(optimizer=tff.SGDOptimizer(lr=1e-2),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    if start is not None:
        m.params = params_from_numpy(start, "cpu", m.compiled)
    return m


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 16).astype(np.float32),
            rng.randint(0, 4, size=(n,)).astype(np.int32))


def _fake_table(path, scale=1.0):
    t = CalibrationTable()
    t._t[("('probe', 16, 32)", (1, 1), 1)] = 1e-4 * scale
    t._t[("('probe', 16, 32)", (2, 1), 1)] = 6e-5 * scale
    t.backend = None  # coherent with any machine model
    t.save(path)
    return t


def _trees(m):
    """Whole params, slots and op state by keypath (a collective)."""
    from flexflow_tpu_torch.runtime.checkpoint import snapshot_in_memory

    return snapshot_in_memory(m)["trees"]


def _assert_trees_bit_exact(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys(), name
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k],
                                          err_msg=f"{name}:{k}")


def _losses(out):
    return [h["loss"] for h in out["history"]]


def _counters(out):
    return {k: out["stats"][k] for k in COUNTERS}


def _triggers(out):
    return [d["trigger"] for d in out["stats"]["research_detail"]]


# ---- the JAX package's runs ------------------------------------------------
def _ref_model(num_devices=4, seed=0, with_cache=False, **cfg_kw):
    import flexflow_tpu as ff

    cfg = ff.FFConfig(batch_size=8, num_devices=num_devices,
                      only_data_parallel=True, seed=seed,
                      compute_dtype="float32", cost_cache_file="", **cfg_kw)
    m = ff.FFModel(cfg)
    x = m.create_tensor([8, 16])
    h = m.dense(x, 32, activation="relu", name="d0")
    if with_cache:
        h = m.cache(h, name="c0")
    m.dense(h, 4, name="d1")
    m.compile(optimizer=ff.SGDOptimizer(lr=1e-2),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def _ref_start():
    m = _ref_model()
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in m.params.items()}


def _ref_run(plan_spec, seed, steps, num_devices=4, ctl_kw=None,
             **cfg_kw):
    """The reference's controller run of ``plan_spec``: (history,
    counters, triggers)."""
    from flexflow_tpu.runtime import FaultPlan as RefPlan
    from flexflow_tpu.runtime import TrainingController as RefController

    if "calibration_file" in cfg_kw:
        from flexflow_tpu.search.calibration import (
            CalibrationTable as RefTable,
        )

        t = RefTable()
        t._t[("('probe', 16, 32)", (1, 1), 1)] = 1e-4
        t._t[("('probe', 16, 32)", (2, 1), 1)] = 6e-5
        t.backend = None
        t.save(cfg_kw["calibration_file"])
    m = _ref_model(num_devices=num_devices, **cfg_kw)
    plan = RefPlan.parse(plan_spec, seed=seed) if plan_spec else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = RefController(m, faults=plan, **(ctl_kw or {})).run(
            *_data(), steps=steps)
    return _losses(out), _counters(out), _triggers(out)


@pytest.fixture(scope="module")
def start():
    return _ref_start()


def _port_run(start, plan_spec, seed, steps, ctl_kw=None, **cfg_kw):
    if "calibration_file" in cfg_kw:
        _fake_table(cfg_kw["calibration_file"])
    m = _make_model(start=start, **cfg_kw)
    plan = FaultPlan.parse(plan_spec, seed=seed) if plan_spec else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = TrainingController(m, faults=plan, **(ctl_kw or {})).run(
            *_data(), steps=steps)
    return out, m


def _assert_matches_reference(out, ref):
    losses, counters, triggers = ref
    np.testing.assert_allclose(_losses(out), losses, rtol=1e-5)
    assert _counters(out) == counters
    assert _triggers(out) == triggers


# ---------------------------------------------------------------------------
# hot swap mechanics (one process)
def test_swap_gate_rejects_weight_and_state_loss():
    """SHD170/SHD171: a target graph that drops (or invents) a weight or
    op state is an illegal swap; the gate refuses it before any state
    moves."""
    from flexflow_tpu_torch.analysis import AnalysisError, lint_swap

    m = _make_model(with_cache=True)
    other = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu",
                                     only_data_parallel=True))
    x = other.create_tensor([8, 16])
    h = other.dense(x, 32, activation="relu", name="d0")
    other.dense(h, 8, name="d1")
    strat = data_parallel_strategy(other.graph, 1)
    found = {f.code for f in lint_swap(m.graph, other.graph, strat, 1)}
    assert "SHD170" in found and "SHD171" in found
    before = params_to_numpy(m.params)
    with pytest.raises(AnalysisError):
        m.swap_strategy(strat, graph=other.graph)
    for op, ws in params_to_numpy(m.params).items():
        for w, v in ws.items():
            np.testing.assert_array_equal(v, before[op][w])


def test_swap_gate_rejects_uncovered_node():
    from flexflow_tpu_torch.analysis import lint_swap

    m = _make_model()
    strat = data_parallel_strategy(m.graph, 4)
    victim = next(g for g in strat
                  if len(m.graph.nodes[g].op._weight_specs))
    del strat[victim]
    assert "SHD172" in {f.code for f in lint_swap(m.graph, m.graph, strat,
                                                  4)}


def test_snapshot_shape_mismatch_keeps_fresh_init():
    """A saved state entry whose shape no longer matches keeps the
    template's fresh init, and is reported fresh."""
    from flexflow_tpu_torch.runtime.checkpoint import (
        restore_in_memory,
        snapshot_in_memory,
    )

    m = _make_model(with_cache=True)
    X, Y = _data()
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
    snap = snapshot_in_memory(m)
    good = tuple(m.state["c0/cached"].shape)
    snap["trees"]["state"]["c0/cached"] = np.zeros((1, 1), np.float32)
    report = restore_in_memory(m, snap)
    assert tuple(m.state["c0/cached"].shape) == good
    assert "state/c0/cached" in report["fresh"]


def test_failed_swap_rolls_back_to_old_program(monkeypatch, start):
    """A swap that fails past the gate (the re-lowering raises) leaves
    the model exactly as it was, and it trains on."""
    import flexflow_tpu_torch.compiler.lowering as lowering

    m = _make_model(start=start)
    X, Y = _data()
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
    before = _trees(m)
    old = (m.compiled, m.strategy, m.config, m.graph, m.params)

    def boom(*a, **kw):
        raise RuntimeError("injected lowering failure")

    monkeypatch.setattr(lowering, "CompiledModel", boom)
    with pytest.raises(RuntimeError, match="injected"):
        m.swap_strategy(data_parallel_strategy(m.graph, 1),
                        config=shrink_config(m.config, 1))
    assert (m.compiled, m.strategy, m.config, m.graph, m.params) == old
    _assert_trees_bit_exact(before, _trees(m))
    monkeypatch.undo()
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)  # still alive


def test_shrink_config_preserves_machine_family():
    """Shrinking keeps WHAT machine the model describes: a host_cpu spec
    stays host_cpu (its platform too), a custom spec keeps its
    constants, and the default family (h100_sxm) is re-derived."""
    from flexflow_tpu_torch.core.machine import MachineSpec

    cpu_cfg = tff.FFConfig(batch_size=8, num_devices=8, device="cpu",
                           machine_spec=MachineSpec.host_cpu(8))
    small = shrink_config(cpu_cfg, 4)
    assert small.machine_spec == MachineSpec.host_cpu(4)
    assert small.machine_spec.platform == "cpu"
    default_cfg = tff.FFConfig(batch_size=8, num_devices=8, device="cpu")
    assert shrink_config(default_cfg, 4).machine_spec == \
        MachineSpec.h100_sxm(4)
    custom = dataclasses.replace(MachineSpec.tpu_v5e(8),
                                 peak_flops=1.23e14, name="custom")
    shrunk = shrink_config(tff.FFConfig(batch_size=8, num_devices=8,
                                        device="cpu", machine_spec=custom),
                           4).machine_spec
    assert shrunk.num_devices == 4
    assert shrunk.peak_flops == 1.23e14 and shrunk.name == "custom"
    assert shrink_config(default_cfg, 4).search_num_devices == 0


# ---------------------------------------------------------------------------
# fault plan
def test_fault_plan_parse_and_env(monkeypatch):
    """The reference's spelling and checks; the same seed draws the
    reference's factors."""
    from flexflow_tpu.runtime import FaultPlan as RefPlan

    plan = FaultPlan.parse("calibration_drift@3, device_loss@6:2", seed=5)
    assert [(f.kind, f.step, f.arg) for f in plan.faults] == [
        ("calibration_drift", 3, None), ("device_loss", 6, 2)]
    ref = RefPlan.parse("calibration_drift@3, device_loss@6:2", seed=5)
    assert ([plan._draws[id(f)] for f in plan.faults]
            == [ref._draws[id(f)] for f in ref.faults])
    monkeypatch.setenv("FLEXFLOW_TPU_FAULTS", "collective_failure@1:4")
    monkeypatch.setenv("FLEXFLOW_TPU_FAULT_SEED", "9")
    env = FaultPlan.from_env()
    assert env.seed == 9 and env.faults[0].arg == 4
    with pytest.raises(ValueError):
        FaultPlan.parse("meteor_strike@1")
    with pytest.raises(ValueError, match=">= 1"):
        FaultPlan.parse("collective_failure@3:0")
    with pytest.raises(ValueError, match=">= 1"):
        FaultPlan.parse("device_loss@3:0")
    monkeypatch.delenv("FLEXFLOW_TPU_FAULTS")
    assert FaultPlan.from_env() is None


def test_fault_plan_drift_factor_is_seed_deterministic(tmp_path):
    from flexflow_tpu.runtime import FaultPlan as RefPlan

    seen = []
    for _ in range(2):
        cal = str(tmp_path / "CAL.json")
        _fake_table(cal)
        plan = FaultPlan.parse("calibration_drift@0", seed=11)
        seen.append(plan.inject_calibration_drift(plan.faults[0], cal))
        with open(cal) as f:
            assert json.load(f)["stale"] is True
    ref = RefPlan.parse("calibration_drift@0", seed=11)
    assert seen[0] == seen[1] == ref._draws[id(ref.faults[0])]


# ---------------------------------------------------------------------------
# end-to-end recovery (one process)
def test_drift_research_hot_swap_e2e_and_deterministic(tmp_path, start):
    """Injected calibration drift at step 3: re-search, hot swap between
    steps, the pre-swap trajectory bit-identical to an unfaulted run,
    the post-swap one close, the run bit-reproducible; the reference's
    history, counters and triggers."""
    cal = str(tmp_path / "CALIBRATION.json")
    a, _ = _port_run(start, "calibration_drift@3", 7, 6,
                     calibration_file=cal)
    b, _ = _port_run(start, "calibration_drift@3", 7, 6,
                     calibration_file=cal)
    clean, _ = _port_run(start, None, 7, 6, calibration_file=cal)
    la, lb, lc = _losses(a), _losses(b), _losses(clean)
    assert la == lb
    assert a["stats"]["swaps"] == 1 and a["stats"]["research_seconds"]
    assert la[:3] == lc[:3]
    np.testing.assert_allclose(la, lc, rtol=1e-4, atol=1e-6)
    ref_cal = str(tmp_path / "REF_CALIBRATION.json")
    _assert_matches_reference(a, _ref_run(
        "calibration_drift@3", 7, 6, calibration_file=ref_cal))


def test_drift_swap_step_state_bit_exact_vs_oracle(tmp_path, start):
    """The swap step's whole state is bit-exact to the uninterrupted
    run's at that step (the swap moved no values)."""
    cal = str(tmp_path / "CALIBRATION.json")
    _, m_clean = _port_run(start, None, 7, 3, calibration_file=cal)
    oracle = _trees(m_clean)
    out, m = _port_run(start, "calibration_drift@3", 7, 4,
                       calibration_file=cal)
    assert out["stats"]["swaps"] == 1
    out2, m2 = _port_run(start, "calibration_drift@3", 7, 3,
                         calibration_file=cal)
    assert out2["stats"]["swaps"] == 0  # the fault fires at step 3
    _assert_trees_bit_exact(oracle, _trees(m2))


def test_collective_failure_retry_then_monolithic_fallback(start):
    """Transient collective faults retry within the budget; a persistent
    one degrades to the monolithic fp32 sync and the run completes, as
    the reference's."""
    spec = "collective_failure@2:1,collective_failure@4:99"
    out, m = _port_run(start, spec, 3, 6, ctl_kw={"max_retries": 2})
    assert len(out["history"]) == 6
    assert out["stats"]["retries"] >= 3
    assert out["stats"]["fallbacks"] == 1
    assert m.sync_schedule is None and not m.sync_precision_map
    assert m.config.sync_schedule == "off"
    _assert_matches_reference(out, _ref_run(spec, 3, 6,
                                            ctl_kw={"max_retries": 2}))


def test_corrupt_checkpoint_restore_drill(tmp_path, start):
    """A torn newest snapshot triggers the restore drill: the newest
    complete step, rewound and replayed bit-identically to an unfaulted
    run; the reference's history and counters."""
    kw = {"checkpoint_every": 2}
    out, _ = _port_run(start, "corrupt_checkpoint@5", 1, 8, ctl_kw=dict(
        kw, checkpoint_dir=str(tmp_path / "ck")))
    assert out["stats"]["restores"] == 1
    assert [h["step"] for h in out["history"]] == list(range(8))
    clean, _ = _port_run(start, None, 1, 8, ctl_kw=dict(
        kw, checkpoint_dir=str(tmp_path / "c2")))
    assert _losses(out) == _losses(clean)
    _assert_matches_reference(out, _ref_run(
        "corrupt_checkpoint@5", 1, 8,
        ctl_kw=dict(kw, checkpoint_dir=str(tmp_path / "ref_ck"))))


def test_corrupt_checkpoint_before_first_save_degrades_gracefully(
        tmp_path, start):
    """The fault firing before any snapshot exists skips the drill and
    training continues."""
    out, _ = _port_run(start, "corrupt_checkpoint@1", 1, 6, ctl_kw=dict(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4))
    assert len(out["history"]) == 6
    assert out["stats"]["restores"] == 0


def test_monolithic_fallback_drops_zero_groups(start):
    """The fp32 fallback drops the whole searched comm plan, the
    per-group ZeRO map included."""
    m = _make_model(start=start)
    X, Y = _data()
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
    m.zero_groups = ("d0",)
    ctl = TrainingController(m, faults=FaultPlan.parse(
        "collective_failure@1:99", seed=3), max_retries=1)
    out = ctl.run(X, Y, steps=3)
    assert out["stats"]["fallbacks"] == 1
    assert m.zero_groups == () and m.compiled.zero_groups == ()


def test_research_fallback_degrades_to_dp_past_chain_threshold(
        monkeypatch, start):
    """When the swap gate refuses the rewritten winner on a graph past
    the chain threshold, the re-search degrades to data parallelism and
    the swap proceeds."""
    import flexflow_tpu_torch.analysis as analysis
    from flexflow_tpu_torch.analysis import Finding
    from flexflow_tpu_torch.search import driver as _driver

    m = _make_model(start=start)

    def reject_all(*a, **kw):
        return [Finding(code="SHD170", pass_name="swap",
                        message="forced rejection")]

    monkeypatch.setattr(analysis, "lint_swap", reject_all)
    monkeypatch.setattr(_driver, "CHAIN_MIN_NODES", 1)
    ctl = TrainingController(m)
    g, s = ctl._research(m.config, "calibration_drift", step=0)
    monkeypatch.undo()
    assert g is m.graph
    detail = ctl.stats["research_detail"][-1]
    assert detail["dp_fallback"] is True and detail["searches"] == 1
    ctl._swap(0, s)
    ctl.run(*_data(), steps=2)


# ---------------------------------------------------------------------------
# telemetry and the measured-drift triggers (one process)
def test_controller_events_validate_and_render(tmp_path, start):
    from flexflow_tpu_torch.obs.events import BUS, validate_event

    log = str(tmp_path / "obs.jsonl")
    BUS.configure(log)
    try:
        out, _ = _port_run(start,
                           "calibration_drift@2,collective_failure@4:99", 7,
                           6, ctl_kw={"max_retries": 1},
                           calibration_file=str(tmp_path / "CAL.json"))
        BUS.flush()
    finally:
        BUS.close()
    kinds = set()
    with open(log) as f:
        for line in f:
            evt = json.loads(line)
            assert validate_event(evt) == [], (evt, validate_event(evt))
            kinds.add(evt["kind"])
    assert {"fault.injected", "controller.research", "controller.swap",
            "controller.retry", "controller.fallback",
            "controller.summary"} <= kinds
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "ffobs.py"), "report",
         log], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Always-on controller" in proc.stdout
    assert "Hot swap at step" in proc.stdout
    _assert_matches_reference(out, _ref_run(
        "calibration_drift@2,collective_failure@4:99", 7, 6,
        ctl_kw={"max_retries": 1},
        calibration_file=str(tmp_path / "REF_CAL.json")))


def test_p99_drift_fault_triggers_research(tmp_path, start):
    """A seeded measured-p99 drift past threshold re-searches with the
    "p99_drift" trigger; the event carries the reference's seeded
    ratio."""
    from flexflow_tpu.runtime import FaultPlan as RefPlan
    from flexflow_tpu_torch.obs.events import BUS, validate_event

    log = str(tmp_path / "obs.jsonl")
    BUS.configure(log)
    try:
        out, m = _port_run(start, "p99_drift@2", 7, 5, profiling=True)
        assert m.predicted_breakdown is not None
        assert "p99_drift" in _triggers(out)
        assert out["stats"]["swaps"] >= 1
        assert all(np.isfinite(_losses(out)))
    finally:
        BUS.close()
    events = [json.loads(line) for line in open(log)]
    p99 = [e for e in events if e["kind"] == "controller.p99_drift"]
    assert len(p99) == 1 and p99[0]["drifted"] is True
    assert p99[0]["ratio"] > 1.5
    for e in events:
        assert validate_event(e) == [], e
    ref = RefPlan.parse("p99_drift@2", seed=7)
    assert ref._draws[id(ref.faults[0])] == pytest.approx(p99[0]["ratio"])
    _assert_matches_reference(out, _ref_run("p99_drift@2", 7, 5,
                                            profiling=True))


def test_observe_p99_below_threshold_is_inert():
    m = _make_model(profiling=True)
    ctl = TrainingController(m)
    pred = m.predicted_breakdown["total_s"]
    assert ctl.observe_p99(pred * 1.1, step=0) == pytest.approx(1.1)
    assert ctl._p99_trigger is None
    assert ctl.observe_p99(0.0, step=0) is None


def test_lane_drift_report_triggers_research(start):
    """A lane report with a stale lane arms one "lane_drift" re-search;
    a clean one stays inert, and one report never fires twice.  (The
    reports are the reference's ``LaneDriftReport``: the controller
    reads their ``stale_lanes`` only, and the port's trace ingest is a
    later slice.)"""
    from flexflow_tpu.obs.trace_ingest import LaneDriftReport

    m = _make_model(profiling=True, start=start)
    ctl = TrainingController(m)
    m.lane_drift_report = LaneDriftReport(
        steps=2, predicted_total_s=1e-3, measured_step_s=1e-3,
        threshold=0.5, lanes=[{"lane": "bucket:b0:sync", "matched": True,
                               "sync_frac_ratio": 1.0}])
    ctl.run(*_data(), steps=2)
    assert "lane_drift" not in _triggers({"stats": ctl.stats})
    drifted = LaneDriftReport(
        steps=2, predicted_total_s=1e-3, measured_step_s=1e-3,
        threshold=0.5, lanes=[{"lane": "bucket:b0:sync", "matched": True,
                               "sync_frac_ratio": 9.0}])
    assert drifted.stale_lanes == ["bucket:b0:sync"]
    m.lane_drift_report = drifted
    ctl.run(*_data(), steps=3)
    assert _triggers({"stats": ctl.stats}).count("lane_drift") == 1


def test_burn_rates_equal_the_references():
    """``obs.slo``: the same burn rates and first-fire indices as the
    reference's on one latency stream."""
    from flexflow_tpu.obs.slo import burn_rates as ref_burn
    from flexflow_tpu.obs.slo import first_fire_indices as ref_first
    from flexflow_tpu_torch.obs import burn_rates, first_fire_indices

    rng = np.random.default_rng(4)
    lat = list(0.08 + 0.05 * rng.random(64))
    recs = [{"slo": "interactive" if i % 3 else "batch", "ttft_s": v}
            for i, v in enumerate(lat)]
    targets = {"interactive": 0.1, "batch": 0.12}
    assert burn_rates(recs, targets) == ref_burn(recs, targets)
    assert first_fire_indices(lat, 0.1) == ref_first(lat, 0.1)


# ---------------------------------------------------------------------------
# the world of 4: swaps between strategies, the shrink, the placed refusal
def _placed_refusal():
    """A placed model (two blocks of 2 ranks) refuses to swap."""
    from flexflow_tpu_torch.core.machine import MachineView

    cfg = tff.FFConfig(batch_size=8, num_devices=N, device="cpu",
                       compute_dtype="float32")
    m = tff.FFModel(cfg)
    ids = m.create_tensor([8, 4], dtype="int32", name="ids")
    e = m.embedding(ids, 16, 8, name="emb")
    h = m.flat(e, name="flatten")
    h = m.dense(h, 32, activation="relu", name="mlp1")
    m.dense(h, 4, name="head")
    strat = {}
    for node in m.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        if node.op.name in ("mlp1", "head"):
            strat[node.guid] = MachineView(dim_degrees=(2,) + (1,) * (nd - 1),
                                           start_part=2)
        else:
            strat[node.guid] = (node.op.fixed_machine_view() or MachineView(
                dim_degrees=(2,) + (1,) * (nd - 1)))
    m.compile(loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"], strategy=strat)
    try:
        m.swap_strategy(data_parallel_strategy(m.graph, N))
    except NotImplementedError as e:
        return type(m.compiled).__name__, str(e)
    return type(m.compiled).__name__, None


def _world_rank(rank, start):
    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.search import driver as _driver

    X, Y = _data()
    out = {}
    # swap dp 4 -> dp 2 over the same 4 ranks, a cache op's state riding
    m = _make_model(N, with_cache=True, start=start)
    m.fit(X, Y, batch_size=8, epochs=2, verbose=False)
    before = _trees(m)
    rep = m.swap_strategy(data_parallel_strategy(m.graph, 2))
    out["swap_report"] = (rep["fallback"], list(rep["dropped"]))
    out["swap_bit_exact"] = before, _trees(m)
    # the oracle of the new layout: each rank's block of the whole value
    c = m.compiled
    blocks = {}
    for op, ws in m.params.items():
        for w, t in ws.items():
            whole = before["params"][f"{op}/{w}"]
            sl = c.weight_placement(op, w).local_slices(whole.shape, c.mesh)
            blocks[f"{op}/{w}"] = (whole[sl], t.detach().numpy().copy())
    out["swap_blocks"] = blocks
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
    out["swap_trains"] = list(m.step_losses)

    # a searched comm plan that fails its gate post-swap: fp32 fallback
    m = _make_model(N, sync_schedule="search", start=start)
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)

    def boom(*a, **kw):
        from flexflow_tpu_torch.analysis import AnalysisError

        raise AnalysisError("injected post-swap plan lint failure", [])

    real = _driver._build_sync_schedule
    _driver._build_sync_schedule = boom
    try:
        rep = m.swap_strategy(data_parallel_strategy(m.graph, N))
    finally:
        _driver._build_sync_schedule = real
    m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
    out["plan_fallback"] = (rep["fallback"], m.sync_schedule is None,
                            not m.sync_precision_map)

    # the elastic shrink 4 -> 2 with ZeRO-1 slots
    m = _make_model(N, zero_dp_shard=True, start=start)
    m.fit(X, Y, batch_size=8, epochs=2, verbose=False)
    before = _trees(m)
    m.swap_strategy(data_parallel_strategy(m.graph, 2),
                    config=shrink_config(m.config, 2))
    out["shrink_devices"] = m.config.num_devices
    if m.compiled is None:
        out["shrink"] = None  # left out: its part ended with the snapshot
    else:
        out["shrink"] = (before, _trees(m),
                         sorted(m.compiled._zero_pl))
        m.fit(X, Y, batch_size=8, epochs=1, verbose=False)
        out["shrink_trains"] = list(m.step_losses)

    # device loss at step 3: 4 -> 2 survivors, twice (determinism)
    for key in ("loss_a", "loss_b"):
        m = _make_model(N, start=start)
        res = TrainingController(m, faults=FaultPlan.parse(
            "device_loss@3:2", seed=7)).run(X, Y, steps=8)
        out[key] = (_losses(res), _counters(res), _triggers(res),
                    m.compiled is None,
                    None if m.compiled is None else m.config.num_devices)
        if key == "loss_a" and m.compiled is not None:
            # the oracle: a fresh 2-rank run from the same start
            o = tff.FFModel(tff.FFConfig(
                batch_size=8, num_devices=2, only_data_parallel=True,
                device="cpu", compute_dtype="float32"))
            x = o.create_tensor([8, 16])
            o.dense(o.dense(x, 32, activation="relu", name="d0"), 4,
                    name="d1")
            o._compile(optimizer=tff.SGDOptimizer(lr=1e-2),
                       loss_type="sparse_categorical_crossentropy",
                       metrics=["accuracy"],
                       strategy=data_parallel_strategy(o.graph, 2),
                       mesh=distributed.mesh_over(start=0, width=2))
            o.params = params_from_numpy(start, "cpu", o.compiled)
            res = TrainingController(o).run(X, Y, steps=8)
            out["loss_oracle"] = _losses(res)
    out["placed"] = _placed_refusal()
    return out


def _make_world(tmp_path_factory):
    """(each rank's results, the reference's runs, the start weights)."""
    start = _ref_start()
    # the reference's runs go first, not beside the ranks: XLA's CPU
    # collectives abort when their threads wait past 40 s on a loaded host
    ref = {"loss": _ref_run("device_loss@3:2", 7, 8),
           "oracle": _ref_run(None, 0, 8, num_devices=2)}
    ranks = spawn(_world_rank, N, (start,),
                  init_method=f"file://"
                  f"{tmp_path_factory.mktemp('controller') / 'rdzv'}",
                  device="cpu", timeout=600)
    return ranks, ref, start


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shared_world(tmp_path_factory, "controller_world",
                        lambda: _make_world(tmp_path_factory))


def test_swap_strategy_bit_exact_and_trainable(world):
    """dp 4 -> dp 2 on the 4 ranks: params, slots and op state (the
    cache op's included) value-identical across the re-shard, and the
    model trains on."""
    ranks, _, _ = world
    for r in ranks:
        assert r["swap_report"] == (False, [])
        before, after = r["swap_bit_exact"]
        _assert_trees_bit_exact(before, after)
        assert any("c0/cached" in k for k in before["state"])
        assert all(np.isfinite(r["swap_trains"]))


def test_swap_matches_direct_device_put_oracle(world):
    """Each rank's swapped block equals its block of the pre-swap whole
    value under the new layout (the reference's device_put oracle)."""
    ranks, _, _ = world
    for r in ranks:
        for k, (oracle, live) in r["swap_blocks"].items():
            np.testing.assert_array_equal(live, oracle, err_msg=k)


def test_swap_comm_plan_lint_failure_falls_back_to_fp32(world):
    ranks, _, _ = world
    for r in ranks:
        assert r["plan_fallback"] == (True, True, True)


def test_elastic_swap_with_zero_sharded_optimizer(world):
    """The 4 -> 2 shrink re-homes the ZeRO-1 slots: values bit-exact on
    the survivors, which train on; ranks 2 and 3 leave."""
    ranks, _, _ = world
    for i, r in enumerate(ranks):
        assert r["shrink_devices"] == 2
        if i >= 2:
            assert r["shrink"] is None
            continue
        before, after, zero = r["shrink"]
        _assert_trees_bit_exact(before, after)
        assert zero  # the slots are sharded on the survivors' mesh
        assert all(np.isfinite(r["shrink_trains"]))


def test_device_loss_recovery_matches_shrunken_mesh_trajectory(world):
    """Device loss at step 3 (4 -> 2): the survivors re-search, re-home
    and finish the 8 steps; the lost ranks return at step 3; the run is
    deterministic, bit-equal to a fresh 2-rank run on the steps it
    shares none of (the first 3 ran on 4 ranks), and the reference's
    history, counters and triggers."""
    ranks, ref, _ = world
    for i, r in enumerate(ranks):
        la, counters, triggers, lost, n = r["loss_a"]
        assert r["loss_b"] == r["loss_a"]
        if i >= 2:
            assert lost and len(la) == 3 and counters["recoveries"] == 1
            continue
        assert not lost and n == 2
        assert counters["recoveries"] == 1 and counters["swaps"] == 1
        np.testing.assert_allclose(la, r["loss_oracle"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(la, ref["loss"][0], rtol=1e-5)
        assert counters == ref["loss"][1] and triggers == ref["loss"][2]
        np.testing.assert_allclose(r["loss_oracle"], ref["oracle"][0],
                                   rtol=1e-5)


def test_swap_refuses_placed_lowering(world):
    """A placed model is refused, in the reference's words, never
    re-lowered flat mid-run."""
    ranks, _, _ = world
    for r in ranks:
        kind, msg = r["placed"]
        assert kind == "PlacedCompiledModel"
        assert msg is not None and "placed" in msg
