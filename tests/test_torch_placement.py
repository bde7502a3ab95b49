"""Executed inter-op placement (``compiler/placement_lowering.py``): the
reference's placement cases (tests/test_placement.py:46-246, all but
the recompile case) on one gloo world of 8 CPU ranks, as the reference
uses 8 devices.

* The embedding + flat + MLP model with the embedding on ranks 0-3 and
  the MLP on ranks 4-7: it lowers placed, each block holds its own
  weights, ``fit`` learns, ``evaluate`` and ``predict`` run; with the
  same weights its forward equals the flat data-parallel lowering's.
* Bad cuts are refused (overlapping blocks: ``ValueError``, SHD154); three
  blocks stay on the flat lowering, as the reference's.
* The multi-crossing DLRM-like cut (4 tensors cross) trains as the flat
  lowering does and as the JAX package's placed lowering does from the
  same weights.
* The search proposes the reference's placement and views for the
  memory-bound two-table model (``compile(strategy=None)``), whose
  blocks are 1 and 2 ranks wide (the boundary gathered and scattered
  between unlike blocks), and its steps match the JAX package's; the
  JAX package's export of it (``__meta__.placement``) imports in the
  port and lowers placed.

Losses within 1e-5 relative, outputs within 1e-5.  The worker function
imports no JAX: the spawned ranks import this module to find it."""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.compiler.placement_lowering import placement_blocks
from flexflow_tpu_torch.core.machine import MachineSpec
from flexflow_tpu_torch.interop import params_from_numpy
from flexflow_tpu_torch.runtime.distributed import spawn
from test_torch_worlds import (
    assert_npz_equal,
    checkpoint_round_trip,
    npz_arrays,
    shared_world,
)

N = 8
B, S, V, D = 16, 4, 64, 8
CCE = dict(loss_type="sparse_categorical_crossentropy")


def _build(pkg, cfg):
    m = pkg.FFModel(cfg)
    ids = m.create_tensor([B, S], dtype="int32", name="ids")
    e = m.embedding(ids, V, D, name="emb")
    h = m.flat(e, name="flatten")
    h = m.dense(h, 32, activation="relu", name="mlp1")
    m.dense(h, 4, name="head")
    return m


def _placed_strategy(pkg, m, start_b=4):
    """embeddings+flatten on ranks [0,4) at dp4; MLP on [start_b, +4)."""
    strat = {}
    for node in m.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        if node.op.name in ("mlp1", "head"):
            strat[node.guid] = pkg.MachineView(
                dim_degrees=(4,) + (1,) * (nd - 1), start_part=start_b)
        else:
            strat[node.guid] = (
                node.op.fixed_machine_view()
                or pkg.MachineView(dim_degrees=(4,) + (1,) * (nd - 1)))
    return strat


def _dlrm(pkg, cfg):
    m = pkg.FFModel(cfg)
    dense = m.create_tensor([32, 13], name="dense")
    t = m.dense(dense, 64, activation="relu", name="bot0")
    towers = [t]
    for i in range(3):
        ids = m.create_tensor([32, 2], dtype="int32", name=f"ids{i}")
        towers.append(m.embedding(ids, 1000, 64, aggr="sum", name=f"emb{i}"))
    c = m.concat(towers, axis=1, name="interact")
    h = m.dense(c, 128, activation="relu", name="top0")
    m.dense(h, 4, name="out")
    return m


def _dlrm_strategy(pkg, m):
    strat = {}
    for node in m.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        fv = node.op.fixed_machine_view()
        if fv is not None:
            strat[node.guid] = fv
            continue
        strat[node.guid] = pkg.MachineView(
            dim_degrees=(4,) + (1,) * (nd - 1),
            start_part=4 if node.op.name in ("interact", "top0", "out")
            else 0)
    return strat


def _two_tables(pkg, spec_mod, import_file=None, **kw):
    """The memory-bound two-table model and its machine (reference
    test_search_proposes_placement_memory_bound)."""
    spec = dataclasses.replace(spec_mod.tpu_v5e(N), devices_per_host=4,
                               ici_torus=(), hbm_capacity=20e6)
    cfg = pkg.FFConfig(batch_size=64, num_devices=N, machine_spec=spec,
                       compute_dtype="float32", search_timeout_s=0,
                       import_strategy_file=import_file, **kw)
    m = pkg.FFModel(cfg)
    towers = []
    for i in range(2):
        ids = m.create_tensor([64, 2], dtype="int32", name=f"ids{i}")
        towers.append(m.embedding(ids, 23003, 61, aggr="sum",
                                  name=f"emb{i}"))
    c = m.concat(towers, axis=1, name="interact")
    h = m.dense(c, 64, activation="relu", name="top0")
    m.dense(h, 8, name="out")
    return m


def _views(graph, strategy):
    return sorted((graph.nodes[g].op.name, tuple(v.dim_degrees),
                   v.replica_degree, v.start_part)
                  for g, v in strategy.items() if g in graph.nodes)


def _steps(m, xs, y, n):
    """n ``train_step`` calls on the same batch (the reference tests'
    loop): the losses."""
    c = m.compiled
    ins = [torch.from_numpy(np.ascontiguousarray(x[c.input_slices(i,
                                                                  x.shape)]))
           for i, x in enumerate(xs)]
    lab = torch.from_numpy(np.ascontiguousarray(y[c.label_slices(y.shape)]))
    out = []
    for _ in range(n):
        m.params, m.opt_state, m.state, loss, _ = c.train_step(
            m.params, m.opt_state, m.state, ins, lab)
        out.append(float(loss))
    return out


def _cfg(**kw):
    kw = dict(dict(batch_size=B, device="cpu", num_devices=N,
                   compute_dtype="float32"), **kw)
    return tff.FFConfig(**kw)


def _rank(rank, data, ref, export_path):
    out = {}
    ids, y = data["mlp"]
    m = _build(tff, _cfg())
    m.compile(metrics=["accuracy"], strategy=_placed_strategy(tff, m), **CCE)
    out["kind"] = type(m.compiled).__name__
    out["held"] = sorted(m.params)
    flat = _build(tff, _cfg(only_data_parallel=True))
    flat.compile(metrics=[], **CCE)
    out["forward"] = (m.predict(ids[:B]), flat.predict(ids[:B]))
    hist = m.fit(ids, y, epochs=4, shuffle=False, verbose=False)
    out["history"] = [h["loss"] for h in hist]
    out["evaluate"] = m.evaluate(ids, y)
    out["predict"] = m.predict(ids[:B])

    bad = _build(tff, _cfg())
    try:
        bad.compile(metrics=[], strategy=_placed_strategy(tff, bad, 2),
                    **CCE)
        out["overlap"] = None
    except ValueError as e:  # the refusal, as a value to check
        out["overlap"] = str(e)
    three = _build(tff, _cfg())
    strat = _placed_strategy(tff, three)
    head = three.node_by_name("head")
    strat[head.guid] = tff.MachineView(dim_degrees=(1, 1), start_part=6)
    three.compile(metrics=[], strategy=strat, **CCE)
    out["three_blocks"] = type(three.compiled).__name__

    xs, yd = data["dlrm"]
    flat = _dlrm(tff, _cfg(batch_size=32, only_data_parallel=True))
    flat.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[], **CCE)
    placed = _dlrm(tff, _cfg(batch_size=32))
    placed.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[],
                   strategy=_dlrm_strategy(tff, placed), **CCE)
    out["dlrm_boundaries"] = placed.compiled._n_boundaries
    out["dlrm_flat"] = _steps(flat, xs, yd, 3)
    out["dlrm_placed"] = _steps(placed, xs, yd, 3)
    again = _dlrm(tff, _cfg(batch_size=32))
    again.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[],
                  strategy=_dlrm_strategy(tff, again), **CCE)
    again.params = params_from_numpy(ref["dlrm_start"], "cpu",
                                     again.compiled)
    again.opt_state = again.optimizer.init_state(again.params)
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    tmp = os.path.dirname(export_path)
    CheckpointManager(os.path.join(tmp, "port_ckpt")).save(0, again)
    out["dlrm_from_jax"] = _steps(again, xs, yd, 3)
    fresh = _dlrm(tff, _cfg(batch_size=32))
    fresh.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[],
                  strategy=_dlrm_strategy(tff, fresh), **CCE)
    out["ckpt_kind"] = type(fresh.compiled).__name__
    out["ckpt_round_trip"] = checkpoint_round_trip(
        again, fresh, os.path.join(tmp, "port_ckpt_trained"))

    xs, yt = data["tables"]
    t = _two_tables(tff, MachineSpec, device="cpu")
    t.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[], **CCE)
    out["tables_kind"] = type(t.compiled).__name__
    out["tables_views"] = _views(t.graph, t.strategy)
    out["tables_blocks"] = placement_blocks(t.strategy)
    out["tables_held"] = sorted(t.params)
    t.params = params_from_numpy(ref["tables_start"], "cpu", t.compiled)
    t.opt_state = t.optimizer.init_state(t.params)
    out["tables_losses"] = _steps(t, xs, yt, 4)
    imp = _two_tables(tff, MachineSpec, import_file=export_path,
                      device="cpu")
    imp.compile(optimizer=tff.SGDOptimizer(lr=0.01), metrics=[], **CCE)
    out["imported"] = (type(imp.compiled).__name__,
                       _views(imp.graph, imp.strategy))
    return out


def _jax_steps(m, xs, y, n):
    import jax
    import jax.random as jrandom

    xd = [jax.device_put(x, m.compiled.input_sharding(i))
          for i, x in enumerate(xs)]
    yd = jax.device_put(y, m.compiled.batch_sharding())
    p, o, s = m.params, m.opt_state, m.state
    out = []
    for i in range(n):
        p, o, s, loss, _ = m.compiled.train_step(p, o, s, jrandom.key(i),
                                                 xd, yd)
        out.append(float(loss))
    return out


def _jax_compile(export_path):
    """The JAX package's placed DLRM cut and its searched two-table model
    (compiled, which exports the latter with ``__meta__.placement``)."""
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineSpec as RefSpec

    dl = _dlrm(ff, ff.FFConfig(batch_size=32, num_devices=N,
                               compute_dtype="float32"))
    dl.compile(optimizer=ff.SGDOptimizer(lr=0.01), metrics=[],
               strategy=_dlrm_strategy(ff, dl), **CCE)
    tb = _two_tables(ff, RefSpec, cost_cache_file="",
                     export_strategy_file=export_path)
    tb.compile(optimizer=ff.SGDOptimizer(lr=0.01), metrics=[], **CCE)
    start = {"dlrm_start": dl.params, "tables_start": tb.params}
    return dl, tb, {k: {op: {w: np.array(v) for w, v in ws.items()}
                        for op, ws in p.items()}
                    for k, p in start.items()}


def _data():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (64, S)).astype(np.int32)
    y = (ids.sum(axis=1) % 4).astype(np.int32)
    xs = [rng.normal(size=(32, 13)).astype(np.float32)] + [
        rng.integers(0, 1000, (32, 2)).astype(np.int32) for _ in range(3)]
    yd = rng.integers(0, 4, (32,)).astype(np.int32)
    tables = [rng.integers(0, 23003, (64, 2)).astype(np.int32)
              for _ in range(2)]
    yt = rng.integers(0, 8, (64,)).astype(np.int32)
    return {"mlp": (ids, y), "dlrm": (xs, yd), "tables": (tables, yt)}


def _make_world(tmp_path_factory):
    """(each rank's results, the JAX package's runs)."""
    data = _data()
    tmp = tmp_path_factory.mktemp("placement")
    export = str(tmp / "placed_strategy.json")
    dl, tb, start = _jax_compile(export)
    ref = dict(start)
    # the reference's snapshot of the placed DLRM at its start weights,
    # before its steps run
    from flexflow_tpu.runtime.checkpoint import CheckpointManager as RefMgr

    RefMgr(str(tmp / "ref_ckpt"), use_orbax=False).save(0, dl)
    ref["npz"] = npz_arrays(str(tmp / "ref_ckpt"), 0)
    ref["dl_kind"] = type(dl.compiled).__name__
    ref["tables_views"] = _views(tb.graph, tb.strategy)
    ref["tables_kind"] = type(tb.compiled).__name__

    def run():
        ref["dlrm"] = _jax_steps(dl, *data["dlrm"], 3)
        ref["tables"] = _jax_steps(tb, *data["tables"], 4)

    worker = threading.Thread(target=run)
    worker.start()
    try:
        ranks = spawn(_rank, N, (data, start, export),
                      init_method=f"file://{tmp / 'rendezvous'}",
                      device="cpu", timeout=600)
    finally:
        worker.join()
    assert "tables" in ref, "a JAX run failed"
    ref["port_npz"] = npz_arrays(str(tmp / "port_ckpt"), 0)
    return ranks, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shared_world(tmp_path_factory, "placement_world",
                        lambda: _make_world(tmp_path_factory))


def test_placed_checkpoint_is_the_references_and_round_trips(world):
    """The placed lowering's snapshot of the DLRM cut holds the
    reference's placed model's keys and arrays for the same weights
    (name-keyed, as the flat layout), and after 3 steps a restore into
    a fresh placed compile gives every weight and slot back bit for
    bit on every rank."""
    ranks, ref = world
    assert ref["dl_kind"] == "PlacedCompiledModel"
    assert_npz_equal(ref["port_npz"], ref["npz"])
    for r in ranks:
        assert r["ckpt_kind"] == "PlacedCompiledModel"
        differ, compared = r["ckpt_round_trip"]
        assert differ == [] and compared > 0, differ


def test_vertical_placement_executes_and_places(world):
    ranks, _ = world
    for rank, r in enumerate(ranks):
        assert r["kind"] == "PlacedCompiledModel"
        assert r["held"] == (["emb"] if rank < 4 else ["head", "mlp1"])
        hist = r["history"]
        assert hist[-1] < hist[0], hist
        assert np.isfinite(r["evaluate"]["loss"])
        assert r["predict"].shape == (B, 4)
        np.testing.assert_array_equal(r["predict"], ranks[0]["predict"])


def test_vertical_placement_matches_flat_numerics(world):
    ranks, _ = world
    for r in ranks:
        placed, flat = r["forward"]
        np.testing.assert_allclose(placed, flat, rtol=1e-5, atol=1e-5)


def test_vertical_placement_rejects_bad_cuts(world):
    ranks, _ = world
    for r in ranks:
        # the always-on placement lint refuses it first (AnalysisError,
        # a ValueError), with the finding the constructor's check names
        assert r["overlap"] is not None
        assert "SHD154" in r["overlap"] and "overlap" in r["overlap"]
        # three start_part blocks: outside the placed lowering, inert
        assert r["three_blocks"] == "CompiledModel"


def test_multi_crossing_placement_parity(world):
    ranks, ref = world
    for r in ranks:
        assert r["dlrm_boundaries"] == 4  # bot0 + 3 towers
        np.testing.assert_allclose(r["dlrm_placed"], r["dlrm_flat"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["dlrm_from_jax"], ref["dlrm"],
                                   rtol=1e-5)


def test_search_proposes_placement_memory_bound(world):
    ranks, ref = world
    assert ref["tables_kind"] == "PlacedCompiledModel"
    holders = {}
    for rank, r in enumerate(ranks):
        assert r["tables_kind"] == "PlacedCompiledModel"
        assert r["tables_views"] == ref["tables_views"]
        assert len(r["tables_blocks"]) == 2
        for op in ("emb0", "emb1"):
            if op in r["tables_held"]:
                holders.setdefault(op, set()).add(rank)
        np.testing.assert_allclose(r["tables_losses"], ref["tables"],
                                   rtol=1e-5)
        assert r["tables_losses"][-1] < r["tables_losses"][0]
    assert holders["emb0"] and holders["emb1"]
    assert holders["emb0"].isdisjoint(holders["emb1"])


def test_jax_exported_placement_meta_lowers_placed(world):
    ranks, ref = world
    for r in ranks:
        assert r["imported"] == ("PlacedCompiledModel", ref["tables_views"])
