"""The general staged pipeline (``compiler/staged_pipeline_lowering.py``):
the reference's staged cases (tests/test_staged_pipeline.py:27-133, all
but the recompile case) on one gloo world of 8 CPU ranks.

* A heterogeneous MLP cut into 4 stages of 2 ranks, 4 microbatches:
  its losses and weights after 3 steps equal the flat lowering's, and
  from the JAX package's start weights its losses equal the JAX
  package's flat run; each stage's weights live on its own ranks.
* The deep prime-width stack no flat strategy fits: the port's search
  proposes the reference's staged cut and microbatches, ``compile``
  lowers it staged, ``fit`` learns as the flat lowering does from the
  same weights, ``evaluate`` and ``predict`` run.
* With BatchNorm in every layer the staged lowering refuses the
  state-carrying stages and ``compile`` keeps the flat lowering, the
  proposal still surfaced, as the reference's does.

Losses within 1e-5 relative.  The worker function imports no JAX: the
spawned ranks import this module to find it."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.compiler.staged_pipeline_lowering import (
    StagedPipelinedModel,
)
from flexflow_tpu_torch.core.machine import MachineSpec
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.losses import LossType
from flexflow_tpu_torch.runtime.distributed import spawn
from test_torch_worlds import (
    assert_npz_equal,
    checkpoint_round_trip,
    npz_arrays,
    shared_world,
)

N = 8
DEEP = (1019, 1013, 1009, 997, 991, 983, 977, 1021)


def _hetero(pkg, widths=(96, 48, 80), **kw):
    cfg = pkg.FFConfig(batch_size=16, num_devices=N, compute_dtype="float32",
                       only_data_parallel=True, **kw)
    m = pkg.FFModel(cfg)
    t = m.create_tensor([16, 64])
    for i, w in enumerate(widths):
        t = m.dense(t, w, activation="relu", name=f"fc{i}")
    m.dense(t, 10, name="head")
    return m


def _deep(pkg, spec_cls, batch_norm=False, **kw):
    spec = spec_cls(num_devices=N, devices_per_host=4, platform="cpu",
                    hbm_capacity=40e6)
    cfg = pkg.FFConfig(batch_size=16, num_devices=N, compute_dtype="float32",
                       machine_spec=spec, search_timeout_s=0, **kw)
    m = pkg.FFModel(cfg)
    t = m.create_tensor([16, 1021])
    for i, w in enumerate(DEEP):
        t = m.dense(t, w, activation="relu", name=f"layer{i}_fc")
        if batch_norm:
            t = m.batch_norm(t, name=f"bn{i}")
    m.dense(t, 1021, name="head")
    return m


def _stages(m):
    p = m.pipeline_proposal
    return (p.num_stages, p.num_microbatches,
            [[m.graph.nodes[g].op.name for g in st] for st in p.stage_guids])


def _steps(m, xs, y, n):
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


def _staged_hetero(start=None):
    sm = _hetero(tff, device="cpu")
    topo = [n.guid for n in sm.graph.topo_order()]
    sp = StagedPipelinedModel(
        sm.graph, [topo[:2], topo[2:3], topo[3:4], topo[4:]], 4, sm.config,
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY, ["accuracy"],
        tff.SGDOptimizer(lr=0.1))
    sm.compiled, sm.optimizer = sp, tff.SGDOptimizer(lr=0.1)
    sm.params, sm.state = sp.init_params(sm.config.seed)
    if start is not None:
        sm.params = params_from_numpy(start, "cpu", sp)
    sm.opt_state = sm.optimizer.init_state(sm.params)
    return sm


def _rank(rank, data, ref):
    out = {}
    x, y = data["hetero"]
    flat = _hetero(tff, device="cpu")
    flat.compile(optimizer=tff.SGDOptimizer(lr=0.1),
                 loss_type="sparse_categorical_crossentropy",
                 metrics=["accuracy"])
    out["flat"] = _steps(flat, [x], y, 3)
    out["flat_params"] = params_to_numpy(flat.params, flat.compiled)
    sm = _staged_hetero()
    out["staged"] = _steps(sm, [x], y, 3)
    out["staged_params"] = params_to_numpy(sm.params, sm.compiled)
    out["held"] = sorted(sm.params)
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    sj = _staged_hetero(ref["hetero_start"])
    CheckpointManager(os.path.join(ref["tmp"], "port_ckpt")).save(0, sj)
    out["from_jax"] = _steps(sj, [x], y, 3)
    out["ckpt_round_trip"] = checkpoint_round_trip(
        sj, _staged_hetero(), os.path.join(ref["tmp"], "port_ckpt_trained"))

    x, y = data["deep"]
    m = _deep(tff, MachineSpec, device="cpu")
    m.compile(optimizer=tff.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=[])
    out["deep_kind"] = type(m.compiled).__name__
    out["deep_stages"] = _stages(m)
    out["deep_num_stages"] = m.compiled.num_stages
    start = params_to_numpy(m.params, m.compiled)
    hist = m.fit(x, y, epochs=3, shuffle=False, verbose=False)
    out["deep_history"] = [h["loss"] for h in hist]
    out["deep_losses"] = list(m.step_losses)
    out["deep_evaluate"] = m.evaluate(x, y)
    out["deep_predict"] = m.predict(x[:16])
    fl = _deep(tff, MachineSpec, device="cpu", only_data_parallel=True)
    fl.compile(optimizer=tff.SGDOptimizer(lr=0.05),
               loss_type="mean_squared_error", metrics=[])
    fl.params = params_from_numpy(start, "cpu", fl.compiled)
    fl.fit(x, y, epochs=3, shuffle=False, verbose=False)
    out["deep_flat_losses"] = list(fl.step_losses)

    bn = _deep(tff, MachineSpec, batch_norm=True, device="cpu")
    bn.compile(loss_type="mean_squared_error", metrics=[])
    out["bn_kind"] = type(bn.compiled).__name__
    out["bn_proposal"] = bn.pipeline_proposal is not None
    return out


def _jax_hetero(x, y, out):
    import jax
    import jax.random as jrandom

    import flexflow_tpu as ff

    flat = _hetero(ff)
    flat.compile(optimizer=ff.SGDOptimizer(lr=0.1),
                 loss_type="sparse_categorical_crossentropy",
                 metrics=["accuracy"])
    out["hetero_start"] = {op: {w: np.array(v) for w, v in ws.items()}
                           for op, ws in flat.params.items()}
    # the reference's snapshot at the start weights (its staged lowering
    # merges its stages' trees by name into the flat layout,
    # staged_pipeline_lowering.py:247-263)
    from flexflow_tpu.runtime.checkpoint import CheckpointManager as RefMgr

    RefMgr(os.path.join(out["tmp"], "ref_ckpt"), use_orbax=False).save(
        0, flat)
    out["npz"] = npz_arrays(os.path.join(out["tmp"], "ref_ckpt"), 0)
    p, o, s = flat.params, flat.opt_state, flat.state
    xd = jax.device_put(x, flat.compiled.input_sharding(0))
    yd = jax.device_put(y, flat.compiled.batch_sharding())
    losses = []
    for i in range(3):
        p, o, s, loss, _ = flat.compiled.train_step(p, o, s, jrandom.key(i),
                                                    [xd], yd)
        losses.append(float(loss))
    out["hetero"] = losses


def _jax_searches(out):
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineSpec as RefSpec

    m = _deep(ff, RefSpec, cost_cache_file="")
    m.compile(optimizer=ff.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=[])
    out["deep_kind"] = type(m.compiled).__name__
    out["deep_stages"] = _stages(m)
    bn = _deep(ff, RefSpec, batch_norm=True, cost_cache_file="")
    bn.compile(loss_type="mean_squared_error", metrics=[])
    out["bn_kind"] = type(bn.compiled).__name__


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    y = rng.integers(0, 10, (16,)).astype(np.int32)
    xd = rng.normal(size=(32, 1021)).astype(np.float32)
    yd = np.zeros((32, 1021), np.float32)  # drive outputs to zero
    return {"hetero": (x, y), "deep": (xd, yd)}


def _make_world(tmp_path_factory):
    """(each rank's results, the JAX package's runs)."""
    data = _data()
    tmp = tmp_path_factory.mktemp("staged")
    ref = {"tmp": str(tmp)}
    _jax_hetero(*data["hetero"], ref)
    worker = threading.Thread(target=_jax_searches, args=(ref,))
    worker.start()
    try:
        ranks = spawn(_rank, N, (data, {k: ref[k] for k in
                                        ("hetero_start", "tmp")}),
                      init_method=f"file://{tmp / 'rendezvous'}",
                      device="cpu", timeout=600)
    finally:
        worker.join()
    assert "bn_kind" in ref, "a JAX run failed"
    ref["port_npz"] = npz_arrays(str(tmp / "port_ckpt"), 0)
    return ranks, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shared_world(tmp_path_factory, "staged_world",
                        lambda: _make_world(tmp_path_factory))


def test_staged_checkpoint_is_the_references_and_round_trips(world):
    """The staged lowering's snapshot holds the reference's keys and
    arrays for the same weights (its stages' trees merged by name: the
    flat layout, which the reference's flat model here writes), and
    after 3 steps a restore into a fresh staged lowering gives every
    weight and slot back bit for bit on every rank."""
    ranks, ref = world
    assert_npz_equal(ref["port_npz"], ref["npz"])
    for r in ranks:
        differ, compared = r["ckpt_round_trip"]
        assert differ == [] and compared > 0, differ


def test_staged_pipeline_matches_flat_numerics(world):
    ranks, ref = world
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["staged"], r["flat"], rtol=1e-5)
        for op, ws in r["flat_params"].items():
            for w, v in ws.items():
                np.testing.assert_allclose(r["staged_params"][op][w], v,
                                           rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["from_jax"], ref["hetero"], rtol=1e-5)
        # stage params really live on disjoint blocks: stage s on ranks
        # 2s, 2s+1
        want = {0: ["fc0"], 1: ["fc1"], 2: ["fc2"], 3: ["head"]}[rank // 2]
        assert r["held"] == want


def test_search_lowers_staged_pipeline_for_deep_prime_stack(world):
    ranks, ref = world
    assert ref["deep_kind"] == "StagedPipelinedModel"
    for r in ranks:
        assert r["deep_kind"] == "StagedPipelinedModel"
        assert r["deep_num_stages"] >= 4
        assert r["deep_stages"] == ref["deep_stages"]
        hist = r["deep_history"]
        assert hist[-1] < hist[0], hist
        np.testing.assert_allclose(r["deep_losses"], r["deep_flat_losses"],
                                   rtol=1e-5)
        assert np.isfinite(r["deep_evaluate"]["loss"])
        assert r["deep_predict"].shape == (16, 1021)


def test_staged_pipeline_rejects_stateful_stages(world):
    ranks, ref = world
    assert ref["bn_kind"] != "StagedPipelinedModel"
    for r in ranks:
        assert r["bn_kind"] == "CompiledModel"
        assert r["bn_proposal"]
