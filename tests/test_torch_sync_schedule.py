"""The searched gradient-sync schedule in the port — its search side
held to the JAX package's (``search/sync_schedule.py``,
``reduction_plan.py``, ``sync_precision.py``, the cost model's
compressed pricing, ``Simulator.simulate(sync_schedule=)``, the SHD12x
and SHD13x lints, ``LogicalTaskGraphSimulator`` and the match-worker
pool), and its execution (comm/bucketed.py through the lowering) on
gloo worlds of 2 and 4 CPU ranks.

Search side, on the reference's sync-bound BERT (bench_search.py's
``SYNC_BOUND_BERT_KW``, batch 8, 8 devices) and on ``tpu_v5e(8)``, a
two-slice copy of it, and two hosts of the H100 spec: the precision
maps, schedules (buckets, precisions, plans), infos and simulated steps
equal the reference's (prices at 1e-9 relative), and so do the lint
codes of broken schedules and plans, the task-graph simulator's price
and the pooled matches.

Execution, an MLP (64 -> fc1 1024 -> fc2 512 -> head 8, batch 32, 3
steps of SGD at lr 0.05, fp32) from the reference's initial weights:

* the monolithic sum's losses and weights equal the reference's within
  1e-5;
* an fp32 schedule, the same schedule staged on two hosts of n / 2
  ranks, and the schedule under ``grad_accum_steps=2`` give the
  monolithic sum's weights bit for bit at a world of 2, where a sum of
  two addends does not depend on their order; at a world of 4 within
  5e-6, because gloo's all-reduce sums each element in an order set by
  where it sits in the payload, and a bucket's payload is not the
  monolithic one's (the weights of a 3-step run differ by up to 2.5e-7
  here);
* int8 and bf16 (a schedule of int8 buckets, the
  ``sync_precision="int8"``, ``"bf16"`` and ``"search"`` maps, and
  ``sync_ef="auto"``) are held to the reference's own runs, not
  to its multi-step contract: the reference quantizes the gradient
  GSPMD has already summed, the port sums the ranks' quantized shares
  (comm/quantized.py), so each step's gradients may differ by both
  collectives' error bounds, and the weights by lr x 3 steps x twice
  the port's bound (taken on the first step's shares, with 1.5x for
  the later steps' larger gradients; the larger of the int8 and bf16
  bounds);
* ``sync_schedule="search"`` with ``sync_bucket_bytes`` on the
  two-host machine lowers the schedule the reference's compile chooses.
* the same schedule once more with ``profiling`` and a
  ``device_trace_dir`` capture on every rank (``"traced"``), held in
  tests/test_torch_trace_ingest.py.

The rank function imports no JAX: the spawned ranks import this module
to find it."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.runtime.distributed import spawn

from test_torch_worlds import shared_world

REL = 1e-9
BATCH, STEPS, LR = 32, 3, 0.05
MLP = (("fc1", 1024, "relu"), ("fc2", 512, "relu"), ("head", 8, None))
BERT_KW = dict(num_layers=2, hidden=512, num_heads=4, ff_dim=2048,
               seq_len=16)  # bench_search.py's SYNC_BOUND_BERT_KW


def two_level(spec_cls, n):
    """Two hosts of n / 2 devices (the reference's ``tpu_v5e`` spec,
    which both packages have)."""
    return dataclasses.replace(spec_cls.tpu_v5e(n), devices_per_host=n // 2)


def mlp(pkg, cfg):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([BATCH, 64])
    for name, width, act in MLP:
        t = m.dense(t, width, activation=act, name=name)
    return m


def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(STEPS * BATCH, 64)).astype(np.float32),
            rng.integers(0, 8, STEPS * BATCH).astype(np.int32))


# ---- the search side ------------------------------------------------------
def close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    return a == b


def bert_pair(spec_name, n=8):
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.compiler.lowering import data_parallel_strategy as rdp
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.models import build_transformer

    specs = {"flat": (RefSpec.tpu_v5e(n), MachineSpec.tpu_v5e(n)),
             "two_slice": (two_level(RefSpec, n), two_level(MachineSpec, n))}
    rspec, spec = specs[spec_name]
    rg = jmods.build_transformer(ff.FFConfig(batch_size=8, num_devices=n),
                                 **BERT_KW).graph
    g = build_transformer(tff.FFConfig(batch_size=8, num_devices=n,
                                       device="cpu"), **BERT_KW).graph
    return ((rg, rdp(rg, n), rspec), (g, data_parallel_strategy(g, n), spec))


@pytest.mark.parametrize("spec", ("flat", "two_slice"))
@pytest.mark.parametrize("mode", ("fp32", "int8", "search"))
def test_schedule_search_equals_the_reference(spec, mode):
    import flexflow_tpu as ff
    from flexflow_tpu.search.simulator import Simulator as RefSim
    from flexflow_tpu.search.sync_precision import (
        choose_sync_precision as ref_pmap,
    )
    from flexflow_tpu.search.sync_schedule import (
        choose_sync_schedule as ref_choose,
    )
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch.search.sync_precision import (
        choose_sync_precision,
    )
    from flexflow_tpu_torch.search.sync_schedule import choose_sync_schedule

    (rg, rs, rspec), (g, s, pspec) = bert_pair(spec)
    rsim = RefSim(rspec, num_devices=8, sync_precision=mode)
    sim = Simulator(pspec, num_devices=8, sync_precision=mode)
    rmap, pmap = ref_pmap(rg, rs, rsim.cost), choose_sync_precision(
        g, s, sim.cost)
    assert pmap == rmap
    if mode != "fp32":
        assert pmap  # the big groups compress on this config
    rcfg = ff.FFConfig(batch_size=8, num_devices=8)
    cfg = tff.FFConfig(batch_size=8, num_devices=8, device="cpu")
    rsched, rinfo = ref_choose(rg, rs, rsim, rmap, rcfg)
    sched, info = choose_sync_schedule(g, s, sim, pmap, cfg)
    assert close(info, rinfo), (info, rinfo)
    assert (sched is None) == (rsched is None)
    if sched is None:
        return
    assert close(sched.to_jsonable(), rsched.to_jsonable())
    if spec == "two_slice":
        assert any(b.plan is not None for b in sched.buckets)
    bd, rbd = {}, {}
    c = sim.simulate(g, s, breakdown=bd, sync_schedule=sched)
    rc = rsim.simulate(rg, rs, breakdown=rbd, sync_schedule=rsched)
    assert close(c, rc)
    assert close(bd["sync_buckets"], rbd["sync_buckets"])
    assert close(bd["sync_levels_s"], rbd["sync_levels_s"])


@pytest.mark.parametrize("ef", (False, True))
def test_compressed_pricing_equals_the_reference(ef):
    from flexflow_tpu.search.machine_model import CostModel as RefCost
    from flexflow_tpu_torch.search.machine_model import CostModel

    (rg, rs, rspec), (g, s, pspec) = bert_pair("flat")
    for mode in ("int8", "bf16", "search"):
        rcm = RefCost(rspec, num_devices=8, sync_precision=mode, sync_ef=ef)
        cm = CostModel(pspec, num_devices=8, sync_precision=mode, sync_ef=ef)
        for rnode, node in zip(rg.topo_order(), g.topo_order()):
            assert node.op.name == rnode.op.name
            got = cm.sync_precision_choice(node.op, s[node.guid])
            want = rcm.sync_precision_choice(rnode.op, rs[rnode.guid])
            assert got[0] == want[0] and close(got[1], want[1]), (
                node.op.name, mode, got, want)


def _broken(pkg, sched):
    """The reference test's broken schedules (tests/test_sync_schedule.py
    ``test_schedule_lint_codes``) in ``pkg``'s classes."""
    SB, SS = pkg.SyncBucket, pkg.SyncSchedule
    names = sched.covered_ops()
    return {
        "unknown_op": SS([SB("b0", ("nonexistent_op",), "fp32")]
                         + [SB(b.name, b.ops, b.precision)
                            for b in sched.buckets[1:]]),
        "unknown_precision": SS([SB("b0", tuple(names), "fp8")]),
        "twice": SS([SB(b.name, b.ops, b.precision) for b in sched.buckets]
                    + [SB("dup", (names[0],), "fp32")]),
        "hole": SS([SB("b0", tuple(names[:-1]), "fp32")]),
        "inverted": SS([SB(b.name, b.ops, b.precision)
                        for b in reversed(sched.buckets)]),
        "contradicts_map": SS([SB("b0", tuple(names), "int8")]),
    }


def test_lints_equal_the_reference():
    import flexflow_tpu as ff
    import flexflow_tpu.search.sync_schedule as rss
    from flexflow_tpu.analysis import lint_reduction_plan as ref_lrp
    from flexflow_tpu.analysis import lint_sync_schedule as ref_lss
    from flexflow_tpu.search.reduction_plan import ReductionPlan as RefPlan
    from flexflow_tpu.search.simulator import Simulator as RefSim
    import flexflow_tpu_torch.search.sync_schedule as pss
    from flexflow_tpu_torch.analysis import (
        lint_reduction_plan,
        lint_sync_schedule,
    )
    from flexflow_tpu_torch.search.reduction_plan import ReductionPlan
    from flexflow_tpu_torch.search.simulator import Simulator

    (rg, rs, rspec), (g, s, pspec) = bert_pair("two_slice")
    rsim, sim = RefSim(rspec, num_devices=8), Simulator(pspec, num_devices=8)
    rsched, _ = rss.choose_sync_schedule(
        rg, rs, rsim, {}, ff.FFConfig(batch_size=8, num_devices=8))
    sched, _ = pss.choose_sync_schedule(
        g, s, sim, {}, tff.FFConfig(batch_size=8, num_devices=8,
                                    device="cpu"))
    assert lint_sync_schedule(g, s, sched) == []
    rbad, bad = _broken(rss, rsched), _broken(pss, sched)
    for key in bad:
        got = [f.code for f in lint_sync_schedule(g, s, bad[key], {})]
        want = [f.code for f in ref_lss(rg, rs, rbad[key], {})]
        assert got == want and got, key
    # plans: a level past the machine's, an int8 stage off the cross
    # level, a plan on a bucket whose groups cross no host boundary
    plan_cases = {
        "level": {"name": "p", "stages": [
            {"kind": "allreduce", "level": 3, "precision": "fp32"}]},
        "precision": {"name": "p", "stages": [
            {"kind": "reduce_scatter", "level": 0, "precision": "int8"},
            {"kind": "allreduce", "level": 1, "precision": "fp32"},
            {"kind": "all_gather", "level": 0, "precision": "fp32"}]},
        "shape": {"name": "p", "stages": [
            {"kind": "all_gather", "level": 0, "precision": "fp32"},
            {"kind": "allreduce", "level": 1, "precision": "fp32"}]},
    }
    for key, raw in plan_cases.items():
        b0 = sched.buckets[0]
        rb0 = rsched.buckets[0]
        got = [f.code for f in lint_reduction_plan(g, s, pss.SyncSchedule(
            [pss.SyncBucket(b0.name, b0.ops, b0.precision,
                            ReductionPlan.from_jsonable(raw))]), sim.cost)]
        want = [f.code for f in ref_lrp(rg, rs, rss.SyncSchedule(
            [rss.SyncBucket(rb0.name, rb0.ops, rb0.precision,
                            RefPlan.from_jsonable(raw))]), rsim.cost)]
        assert got == want and got, key


def test_reduction_plans_equal_the_reference():
    from flexflow_tpu.search import reduction_plan as rrp
    from flexflow_tpu.search.simulator import Simulator as RefSim
    from flexflow_tpu.search.sync_schedule import (
        build_bucketed_schedule as rbuild,
    )
    from flexflow_tpu.search.sync_schedule import (
        synced_weight_groups as rsynced,
    )
    from flexflow_tpu_torch.search import reduction_plan as prp
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch.search.sync_schedule import (
        build_bucketed_schedule,
        synced_weight_groups,
    )

    for levels in (1, 2, 3):
        for prec in ("fp32", "int8", "int8_ef", "bf16"):
            assert [p.to_jsonable() for p in prp.enumerate_reduction_plans(
                levels, prec)] == [p.to_jsonable() for p in
                                   rrp.enumerate_reduction_plans(levels,
                                                                 prec)]
    (rg, rs, rspec), (g, s, pspec) = bert_pair("two_slice")
    rsim, sim = RefSim(rspec, num_devices=8), Simulator(pspec, num_devices=8)
    for th in (math.inf, 4 << 20):
        rsched = rbuild(rsynced(rg, rs, rsim.cost), {}, th)
        sched = build_bucketed_schedule(synced_weight_groups(g, s, sim.cost),
                                        {}, th)
        assert sched.to_jsonable() == rsched.to_jsonable()
        got, info = prp.assign_reduction_plans(
            sched, synced_weight_groups(g, s, sim.cost), sim.cost)
        want, rinfo = rrp.assign_reduction_plans(
            rsched, rsynced(rg, rs, rsim.cost), rsim.cost)
        assert close(info, rinfo)
        assert got.to_jsonable() == want.to_jsonable()


def test_taskgraph_simulator_equals_the_reference():
    from flexflow_tpu.search.taskgraph_sim import (
        LogicalTaskGraphSimulator as RefTG,
    )
    from flexflow_tpu_torch.search.taskgraph_sim import (
        LogicalTaskGraphSimulator,
    )

    for spec in ("flat", "two_slice"):
        (rg, rs, rspec), (g, s, pspec) = bert_pair(spec)
        rbd, bd = {}, {}
        want = RefTG(rspec, num_devices=8).simulate(rg, rs, breakdown=rbd)
        got = LogicalTaskGraphSimulator(pspec, num_devices=8).simulate(
            g, s, breakdown=bd)
        assert close(got, want) and math.isfinite(got)
        assert close(bd, rbd)


def test_match_worker_pool_equals_the_serial_matcher(monkeypatch):
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.search import match_workers
    from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers

    cfg = tff.FFConfig(batch_size=8, num_devices=4, device="cpu")
    g = build_gpt(cfg, vocab=128, num_layers=2, hidden=64, num_heads=4,
                  ff_dim=128, seq_len=64).graph
    xfers = list(generate_all_pcg_xfers(4))
    monkeypatch.setenv("FLEXFLOW_TPU_MATCH_WORKERS", "2")
    monkeypatch.setattr(match_workers, "MIN_POOL_NODES", 0)
    before = match_workers.BATCHES.value
    try:
        pooled = match_workers.find_all_matches(xfers, g, cfg, 4)
    finally:
        match_workers.shutdown()
    assert pooled is not None and match_workers.BATCHES.value == before + 1

    def key(ms):
        return [m.guid if hasattr(m, "guid") else sorted(m.items())
                for m in ms]

    assert sum(len(ms) for ms in pooled) > 0
    for xf, ms in zip(xfers, pooled):
        assert key(ms) == key(xf.find_matches(g)), getattr(xf, "name", xf)


# ---- execution over ranks -------------------------------------------------
def _schedule(mode, n):
    """The schedule a mode lowers (None: the monolithic sum)."""
    from flexflow_tpu_torch.search.reduction_plan import (
        ReductionPlan,
        canonical_stages,
    )
    from flexflow_tpu_torch.search.sync_schedule import (
        SyncBucket,
        SyncSchedule,
    )

    prec = "int8" if mode == "int8_sched" else "fp32"
    plan = (ReductionPlan("staged_l1", canonical_stages(1, "fp32"))
            if mode == "staged" else None)
    if mode in ("sched", "sched_ga2", "staged", "int8_sched"):
        return SyncSchedule([SyncBucket("b0", ("head", "fc2"), prec, plan),
                             SyncBucket("b1", ("fc1",), prec, plan)])
    return None


MODE_CONFIG = {
    "mono": {}, "sched": {}, "int8_sched": {},
    "mono_ga2": {"grad_accum_steps": 2}, "sched_ga2": {"grad_accum_steps": 2},
    "staged": {"two_level": True},
    "int8_map": {"sync_precision": "int8"},
    "bf16_map": {"sync_precision": "bf16"},
    "search_map": {"sync_precision": "search"},
    "int8_ef": {"sync_precision": "int8", "sync_ef": "auto"},
    "search": {"two_level": True, "sync_schedule": "search",
               "sync_bucket_bytes": 1 << 20},
    # the searched schedule again under a device_trace_dir capture
    # (held in tests/test_torch_trace_ingest.py)
    "traced": {"two_level": True, "sync_schedule": "search",
               "sync_bucket_bytes": 1 << 20, "profiling": True},
}
PORT_MODES = {2: ("mono", "sched", "staged", "mono_ga2", "sched_ga2"),
              4: tuple(MODE_CONFIG)}
REF_MODES = {2: ("mono",), 4: ("mono", "int8_sched", "int8_map", "bf16_map",
                               "search_map", "int8_ef", "search")}


def _config(pkg, spec_cls, n, mode, **extra):
    kw = dict(MODE_CONFIG[mode])
    spec = (two_level(spec_cls, n) if kw.pop("two_level", False)
            else spec_cls.tpu_v5e(n))
    return pkg.FFConfig(batch_size=BATCH, num_devices=n,
                        compute_dtype="float32", only_data_parallel=True,
                        machine_spec=spec, **kw, **extra)


def _rank(rank, n, start, x, y):
    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy

    import tempfile

    torch.manual_seed(0)
    out = {}
    for mode in PORT_MODES[n]:
        extra = ({"device_trace_dir": tempfile.mkdtemp(prefix="fftrace")}
                 if mode == "traced" else {})
        m = mlp(tff, _config(tff, MachineSpec, n, mode, device="cpu",
                             **extra))
        m.compile(optimizer=tff.SGDOptimizer(lr=LR), loss_type=(
            "sparse_categorical_crossentropy"), metrics=[])
        sched = _schedule(mode, n)
        if sched is not None:
            m.compiled.sync_schedule = sched
        m.params = params_from_numpy(start, "cpu", m.compiled)
        if mode == "mono":
            # the first step's shares, for the int8 tolerance
            c = m.compiled
            sl = c.input_slices(0, x[:BATCH].shape)
            _, _, _, g = c.loss_and_grads(
                m.params, m.state, [torch.from_numpy(x[:BATCH][sl])],
                torch.from_numpy(y[:BATCH][c.label_slices(
                    y[:BATCH].shape)]), sync=False)
            out["shares"] = {op: {w: t.numpy().copy() for w, t in ws.items()}
                             for op, ws in g.items()}
        m.fit(x, y, shuffle=False, verbose=False)
        out[mode] = {
            "losses": list(m.step_losses),
            "weights": params_to_numpy(m.params, m.compiled),
            "map": dict(m.sync_precision_map),
            "schedule": (None if m.compiled.sync_schedule is None
                         else m.compiled.sync_schedule.to_jsonable()),
            "ef": {k: v.numpy().copy() for k, v in m.state.items()
                   if k.endswith("/ef_residual")},
        }
        if mode == "traced":
            out[mode]["trace"] = _traced(m, extra["device_trace_dir"])
    return out


def _traced(m, trace_dir):
    """What a rank's captured fit left: its capture ingested, its lane
    report, its predicted lanes, and whether the controller's drift
    watch took the report from the model."""
    import shutil

    from flexflow_tpu_torch.obs.annotate import LANES
    from flexflow_tpu_torch.obs.trace_ingest import ingest
    from flexflow_tpu_torch.runtime.controller import TrainingController

    res = ingest(trace_dir, emit=False)
    shutil.rmtree(trace_dir)
    report = m.lane_drift_report
    ctl = TrainingController(m)
    ctl._watch_drift(0)
    return {"step_spans": res.step_spans, "lanes": res.lanes,
            "source": res.source,
            "report": None if report is None else report.to_dict(),
            "controller_read": report is not None
            and ctl._lane_seen is report,
            "recorder_spans": LANES.spans(),
            "predicted": {k: m.predicted_breakdown[k]
                          for k in ("total_s", "sync_buckets")},
            "profile": m.profile_summary}


def _reference(n, x, y):
    """The JAX package's runs of ``REF_MODES[n]`` on n virtual devices,
    and its initial weights."""
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu.search.sync_schedule import SyncBucket, SyncSchedule

    out = {}
    for mode in REF_MODES[n]:
        m = mlp(ff, _config(ff, RefSpec, n, mode, cost_cache_file=""))
        m.compile(optimizer=ff.SGDOptimizer(lr=LR), loss_type=(
            "sparse_categorical_crossentropy"), metrics=[])
        if mode == "int8_sched":
            m.compiled.sync_schedule = SyncSchedule([
                SyncBucket("b0", ("head", "fc2"), "int8"),
                SyncBucket("b1", ("fc1",), "int8")])
        if "start" not in out:
            out["start"] = {op: {w: np.array(v) for w, v in ws.items()}
                            for op, ws in m.params.items()}
        else:
            import jax.numpy as jnp

            m.params = {op: {w: jnp.asarray(v) for w, v in ws.items()}
                        for op, ws in out["start"].items()}
            m.params = jax_place(m)
        hist = m.fit(x=x, y=y, verbose=False, shuffle=False)
        out[mode] = {
            "loss": hist[-1]["loss"],
            "weights": {op: {w: np.array(v) for w, v in ws.items()}
                        for op, ws in m.params.items()},
            "map": dict(m.sync_precision_map),
            "schedule": (None if m.sync_schedule is None
                         else m.sync_schedule.to_jsonable()),
        }
    return out


def jax_place(m):
    """``m.params`` placed under the compiled model's shardings."""
    import jax

    return {op: {w: jax.device_put(v, m.compiled.param_shardings[op][w])
                 for w, v in ws.items()} for op, ws in m.params.items()}


def _world(n, tmp_path_factory):
    """The reference's runs and the port's ranks at world ``n``, once
    per test run (tests/test_torch_worlds.py)."""
    x, y = data()

    def compute():
        ref = _reference(n, x, y)
        rdzv = tmp_path_factory.mktemp(f"sync{n}") / "rendezvous"
        ranks = spawn(_rank, n, (n, ref["start"], x, y),
                      init_method=f"file://{rdzv}", device="cpu",
                      timeout=600)
        return n, ref, ranks

    return shared_world(tmp_path_factory, f"torch_sync_{n}", compute)


@pytest.fixture(scope="module", params=(2, 4))
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _max_diff(a, b):
    return max(float(np.max(np.abs(a[op][w] - b[op][w])))
               for op in a for w in a[op])


def test_monolithic_sum_equals_the_reference(world):
    n, ref, ranks = world
    for r in ranks:
        assert _max_diff(r["mono"]["weights"], ref["mono"]["weights"]) \
            <= 1e-5
        # the reference's fit reports its last step's loss
        assert abs(r["mono"]["losses"][-1] - ref["mono"]["loss"]) \
            <= 1e-5 * abs(ref["mono"]["loss"])


def test_fp32_schedules_equal_the_monolithic_sum(world):
    """Bit-equal at a world of 2; within 5e-6 at 4 (module
    docstring)."""
    n, _, ranks = world
    tol = 0.0 if n == 2 else 5e-6
    for r in ranks:
        for mode, base in (("sched", "mono"), ("staged", "mono"),
                           ("sched_ga2", "mono_ga2")):
            assert _max_diff(r[mode]["weights"], r[base]["weights"]) <= tol, (
                mode, _max_diff(r[mode]["weights"], r[base]["weights"]))
        # replicas bit-equal
        assert _max_diff(r["staged"]["weights"],
                         ranks[0]["staged"]["weights"]) == 0.0


def _tolerance(ranks):
    """lr x steps x twice the larger of the int8 and bf16 bounds on the
    first step's shares, with 1.5x for the later steps (module
    docstring)."""
    from flexflow_tpu_torch.comm import allreduce_error_bound

    shares = [r["shares"] for r in ranks]
    return {op: {w: 1.5 * LR * STEPS * 2 * max(allreduce_error_bound(
        [s[op][w] for s in shares], p) for p in ("int8", "bf16"))
        for w in shares[0][op]} for op in shares[0]}


def test_int8_sync_is_held_to_the_reference_int8_run(world4):
    n, ref, ranks = world4
    tol = _tolerance(ranks)
    for mode in ("int8_sched", "int8_map", "bf16_map", "search_map",
                 "int8_ef"):
        got, want = ranks[0][mode], ref[mode]
        assert got["map"] == want["map"], mode
        for op, ws in want["weights"].items():
            for w, v in ws.items():
                err = float(np.max(np.abs(got["weights"][op][w] - v)))
                assert err <= tol[op][w], (mode, op, w, err, tol[op][w])
        assert np.all(np.isfinite(got["losses"]))
        for r in ranks:  # replicas bit-equal
            assert _max_diff(r[mode]["weights"], got["weights"]) == 0.0
    assert ranks[0]["int8_map"]["map"] and ranks[0]["int8_ef"]["map"]
    assert set(ranks[0]["int8_ef"]["map"].values()) == {"int8_ef"}
    assert set(ranks[0]["bf16_map"]["map"].values()) == {"bf16"}
    assert ranks[0]["search_map"]["map"]
    # each rank's residual is its own entry error: nonzero, and not the
    # same on every rank
    res = [r["int8_ef"]["ef"] for r in ranks]
    assert res[0] and all(np.abs(v).max() > 0 for v in res[0].values())
    key = next(iter(res[0]))
    assert not np.array_equal(res[0][key], res[1][key])


def test_searched_schedule_equals_the_reference(world4):
    n, ref, ranks = world4
    got, want = ranks[0]["search"], ref["search"]
    assert want["schedule"] is not None
    assert close(got["schedule"], want["schedule"])
    assert any("plan" in b for b in got["schedule"]["buckets"])
    assert _max_diff(got["weights"], ranks[0]["mono"]["weights"]) <= 5e-6
