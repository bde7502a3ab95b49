"""The port's cost-model calibration (search/calibration.py,
runtime/profiler.py), against the reference's contracts
(tests/test_calibration.py): the table's file round trip (a table
either package writes loads into the other, keyed by the same op
identities), measurements that flip the search's ranking, probes on the
CPU when the caller asks for it, a table probed on a backend the machine
model does not describe being ignored, and a CUDA probe without CUDA
raising."""

from __future__ import annotations

import json
import math

import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as RefView
from flexflow_tpu.search.calibration import CalibrationTable as RefTable
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.models import build_gpt
from flexflow_tpu_torch.search.calibration import (
    CalibrationTable,
    calibrate_graph,
    measure_op_view,
)
from flexflow_tpu_torch.search.dp import SearchHelper
from flexflow_tpu_torch.search.driver import optimize_strategy
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.views import boundary_views, candidate_views


def mlp_model(pkg, batch=64, in_dim=128, hidden=256, classes=16, **cfg):
    """tests/test_calibration.py's ``mlp_model``."""
    extra = {"device": "cpu"} if pkg is tff else {}
    m = pkg.FFModel(pkg.FFConfig(batch_size=batch, num_devices=8,
                                 **extra, **cfg))
    x = m.create_tensor([batch, in_dim])
    t = m.dense(x, hidden, activation="relu", name="fc1")
    m.dense(t, classes, name="head")
    return m


def test_table_round_trip_and_cross_package_load(tmp_path):
    port, ref = mlp_model(tff), mlp_model(ff)
    op, rop = port.node_by_name("fc1").op, ref.node_by_name("fc1").op
    table = CalibrationTable()
    table.put(op, MachineView.data_parallel(2, 8), 1.5e-4)
    table.put(op, MachineView.trivial(2), 9e-4)
    table.backend = "cuda"
    path = str(tmp_path / "calib.json")
    table.save(path)
    loaded = CalibrationTable.load(path)
    assert len(loaded) == 2 and loaded.backend == "cuda"
    assert loaded.get(op, MachineView.data_parallel(2, 8)) == 1.5e-4
    assert loaded.get(op, MachineView.trivial(2)) == 9e-4
    # the reference reads the port's file under its own op's identity,
    # and the port reads the reference's
    theirs = RefTable.load(path)
    assert theirs.get(rop, RefView.data_parallel(2, 8)) == 1.5e-4
    rpath = str(tmp_path / "ref_calib.json")
    theirs.put(rop, RefView((4, 1)), 2e-4)
    theirs.save(rpath)
    assert CalibrationTable.load(rpath).get(op, MachineView((4, 1))) == 2e-4
    with open(rpath) as f:
        assert set(json.load(f)) >= {"version", "backend", "records",
                                     "clusters"}


def test_injected_measurements_flip_search_ranking():
    """Measurements alone reverse a decision: the roofline keeps fc1
    whole; a table saying the whole kernel is slow and every split fast
    makes the search split it."""
    m = mlp_model(tff, machine_spec=MachineSpec.tpu_v5e(8))
    fc1 = m.node_by_name("fc1")

    def searched_parts(calibration):
        sim = Simulator(m.config.machine_spec, num_devices=8,
                        calibration=calibration)
        _, strategy = SearchHelper(sim, 8).graph_cost(m.graph)
        return strategy[fc1.guid].num_parts

    assert searched_parts(None) == 1
    table = CalibrationTable()
    for mv in list(candidate_views(fc1.op, 8)) + list(
            boundary_views(fc1.op, 8)):
        table.put(fc1.op, mv, 5e-2 if mv.num_parts == 1 else 1e-6)
    assert searched_parts(table) > 1


def test_cpu_probes_measure_and_fill_a_table(tmp_path):
    """measure_op_view at whole and shard shapes on the CPU (a linear,
    an attention, a layer norm), calibrate_graph filling the caller's
    table in place with backend "cpu", and the search consuming it; the
    compile-time path (``calibrate=True`` with a CPU machine model)
    probes and persists."""
    m = mlp_model(tff, batch=256, in_dim=256, hidden=512, classes=64)
    op = m.node_by_name("fc1").op
    for mv in (MachineView.trivial(2), MachineView.data_parallel(2, 8),
               MachineView((1, 4), replica_degree=2)):
        t = measure_op_view(op, mv, warmup=1, repeats=2, device="cpu")
        assert t is not None and math.isfinite(t) and t > 0, mv
    g = build_gpt(
        tff.FFConfig(batch_size=4, device="cpu"), vocab=64, num_layers=1,
        hidden=32, num_heads=4, ff_dim=64, seq_len=32)
    for node in g.graph.topo_order():
        kind = node.op.op_type.value
        if kind in ("multihead_attention", "layernorm", "embedding"):
            for mv in candidate_views(node.op, 4):
                t = measure_op_view(node.op, mv, warmup=1, repeats=1,
                                    device="cpu",
                                    compute_dtype=torch.float32)
                assert t is not None and t > 0, (kind, mv)
        if kind in ("input", "constant"):  # no floating leaf
            assert measure_op_view(node.op, MachineView.trivial(2),
                                   device="cpu") is None
    mine = CalibrationTable()
    out = calibrate_graph(m.graph, 8, mine, time_budget_s=10.0, repeats=1,
                          device="cpu")
    assert out is mine and len(mine) > 0 and mine.backend == "cpu"
    sim = Simulator(MachineSpec.host_cpu(8), num_devices=8, calibration=mine)
    cost, strategy = SearchHelper(sim, 8).graph_cost(m.graph)
    assert math.isfinite(cost) and strategy
    with pytest.raises(ValueError, match="mix backends"):
        mine.backend = "cuda"
        calibrate_graph(m.graph, 8, mine, time_budget_s=1.0, device="cpu")

    path = str(tmp_path / "cal.json")
    cm = mlp_model(tff, batch=256, in_dim=256, hidden=512, classes=64,
                   search_budget=2, calibrate=True, calibration_file=path,
                   calibration_budget_s=10.0,
                   machine_spec=MachineSpec.host_cpu(8))
    optimize_strategy(cm.graph, cm.config, return_graph=True)
    with open(path) as f:
        data = json.load(f)
    assert data["backend"] == "cpu" and len(data["records"]) > 0


def test_mismatched_backend_calibration_ignored(tmp_path):
    """A table probed on a backend the machine model does not describe
    is discarded; a table of the modeled backend is consulted even when
    the search runs elsewhere (searching for the card from the CPU)."""
    m = mlp_model(tff)
    fc1 = m.node_by_name("fc1")
    views = list(candidate_views(fc1.op, 8)) + list(
        boundary_views(fc1.op, 8))

    def table(path, backend, punish_unsharded):
        t = CalibrationTable()
        for mv in views:
            slow = (mv.num_parts == 1) if punish_unsharded else (
                mv.num_parts > 1)
            t.put(fc1.op, mv, 5e-2 if slow else 1e-6)
        t.backend = backend
        t.save(path)
        return path

    def parts(path, spec):
        cfg = tff.FFConfig(batch_size=64, num_devices=8, search_budget=0,
                           calibration_file=path, machine_spec=spec,
                           device="cpu")
        return optimize_strategy(m.graph, cfg)[fc1.guid].num_parts

    h100 = MachineSpec.h100_sxm(8)
    assert h100.platform == "cuda"
    base = parts(None, h100)
    # a CPU-probed table against the H100 model: ignored
    cpu_path = table(str(tmp_path / "cpu.json"), "cpu",
                     punish_unsharded=base == 1)
    assert parts(cpu_path, h100) == base
    # a card-probed table: consulted, and it flips the pick
    cuda_path = table(str(tmp_path / "cuda.json"), "cuda",
                      punish_unsharded=base == 1)
    assert (parts(cuda_path, h100) > 1) == (base == 1)
    # calibrate=True where the live backend (the CPU) is not the modeled
    # one: no probe runs, the roofline stays
    cfg = tff.FFConfig(batch_size=64, num_devices=8, search_budget=0,
                       calibrate=True, machine_spec=h100, device="cpu")
    assert optimize_strategy(m.graph, cfg)[fc1.guid].num_parts == base


def test_a_cuda_probe_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    op = mlp_model(tff).node_by_name("fc1").op
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_op_view(op, MachineView.trivial(2))
