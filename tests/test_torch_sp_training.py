"""Sequence-parallel training of the port's ``build_gpt`` on gloo worlds
of 2 and 4 CPU ranks, against the JAX package and against the port's own
one-process run.

A tiny ``build_gpt`` (vocab 64, 2 layers, hidden 32, 2 heads, ff 64,
seq 64, batch 2, fp32) trains 3 Adam steps through ``fit`` under the
pure sequence-parallel strategy (every op with a sequence dim at
(1, n, ...)): each rank holds 64/n positions and every MHA runs the
zigzag ring.  The JAX package runs the sp-leg strategy shape
(__graft_entry__.py:171-186: MHA at (1, n, 1), the rest trivial) on
``num_devices=n`` of the 8-device CPU mesh; the two strategies compute
the same function.  All start from the JAX model's initial weights.
Losses within 1e-5 relative, and every weight entry within 0.01 Adam
step sizes per step at most (0.03 after 3 steps) and 0.01 on average
(tests/test_torch_training.py's fp32 tolerances).  Measured over both
worlds: losses 2.1e-7 relative against JAX and 1.1e-7 against one
process; weights 1.3e-2 and 6.8e-3 alphas at most, 3.0e-5 and 6.0e-6 on
average (the largest at world 4).

One world of each size is spawned per module; the same world also
shows what the port does not lower yet: a strategy other than the
pure sequence-parallel one, Ulysses, ``evaluate``/``predict`` under
SP, and a ``num_devices`` that differs from the job's size.  The worker
functions import no JAX: the spawned ranks import this module to find
them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import AdamOptimizer, FFConfig
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.models import build_gpt, build_transformer
from flexflow_tpu_torch.runtime import distributed
from flexflow_tpu_torch.runtime.distributed import spawn

TINY = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
            seq_len=64)
BATCH, STEPS, ALPHA = 2, 3, 1e-3
# (loss rtol, max weight error per step, mean weight error), in alpha
TOLS = (1e-5, 0.01, 0.01)
COMPILE = dict(loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy"])


def _ids():
    rng = np.random.default_rng(1)
    return rng.integers(0, TINY["vocab"], size=(
        STEPS * BATCH, TINY["seq_len"] + 1)).astype(np.int32)


def sp_strategy(model, n):
    """Every op whose output has a sequence dim split n ways on it."""
    views = {}
    for node in model.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        views[node.guid] = (MachineView((1, n) + (1,) * (nd - 2)) if nd >= 2
                            else MachineView.trivial(nd))
    return views


def sp_leg_strategy(model, n):
    """__graft_entry__.py's sp leg: MHA at (1, n, 1), every other op
    trivial."""
    return {node.guid: (MachineView((1, n, 1))
                        if node.op.op_type.value == "multihead_attention"
                        else MachineView.trivial(
                            node.op.output_shapes[0].ndim))
            for node in model.graph.topo_order()}


def _refusal(fn):
    """The message of the NotImplementedError or ValueError ``fn``
    raises, or None."""
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _train_rank(rank, params, ids, n):
    """One rank: 3 Adam steps through fit under the SP strategy, then
    what the port refuses."""
    cfg = FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32",
                   num_devices=n)
    m = build_gpt(cfg, **TINY)
    m.compile(optimizer=AdamOptimizer(alpha=ALPHA), strategy=sp_strategy(m, n),
              **COMPILE)
    m.params = params_from_numpy(params)
    history = m.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    out = {"losses": list(m.step_losses), "history": history,
           "params": params_to_numpy(m.params), "sp_size": m.compiled.sp_size,
           "slices": (distributed.local_seq_slice(64),
                      distributed.local_batch_slice(8),
                      distributed.transport())}

    def compile_with(strategy_fn, config=cfg):
        model = build_gpt(config, **TINY)
        model.compile(strategy=strategy_fn(model), **COMPILE)
        return model

    out["sp_leg"] = _refusal(lambda: compile_with(
        lambda mm: sp_leg_strategy(mm, n)))
    out["data_parallel"] = _refusal(lambda: compile_with(lambda mm: {
        node.guid: MachineView.data_parallel(
            node.op.output_shapes[0].ndim, n)
        for node in mm.graph.topo_order()}))
    out["no_strategy"] = _refusal(lambda: compile_with(lambda mm: None))
    out["num_devices"] = _refusal(lambda: compile_with(
        lambda mm: sp_strategy(mm, n),
        config=FFConfig(batch_size=BATCH, device="cpu", num_devices=n + 1)))
    out["evaluate"] = _refusal(lambda: m.evaluate(ids[:, :-1], ids[:, 1:]))
    out["predict"] = _refusal(lambda: m.predict(ids[:, :-1]))
    x = torch.zeros((BATCH, 64 // n, 32))
    for mode in ("ulysses", "auto"):
        tm = build_transformer(
            FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32",
                     num_devices=n), num_layers=1, hidden=32, num_heads=4,
            ff_dim=32, seq_len=64, sp_mode=mode)
        tm.compile(strategy=sp_strategy(tm, n), loss_type="mean_squared_error",
                   metrics=[])
        out[mode] = _refusal(lambda: tm.compiled.apply(tm.params, tm.state,
                                                       [x]))
    return out


@pytest.fixture(scope="module")
def jax_start():
    """The JAX model's initial weights, as numpy."""
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineView as JaxView
    from flexflow_tpu.models import build_gpt as jax_build_gpt

    jm = jax_build_gpt(ff.FFConfig(batch_size=BATCH, num_devices=1,
                                   compute_dtype="float32",
                                   cost_cache_file=""), **TINY)
    jm.compile(strategy={n.guid: JaxView.trivial(n.op.output_shapes[0].ndim)
                         for n in jm.graph.topo_order()}, **COMPILE)
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in jm.params.items()}


@pytest.fixture(scope="module")
def one_process(jax_start):
    """The port's one-process run: (step losses, history, weights)."""
    m = build_gpt(FFConfig(batch_size=BATCH, device="cpu",
                           compute_dtype="float32"), **TINY)
    m.compile(optimizer=AdamOptimizer(alpha=ALPHA), **COMPILE)
    m.params = params_from_numpy(jax_start)
    ids = _ids()
    history = m.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    return np.asarray(m.step_losses), history, params_to_numpy(m.params)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, jax_start, tmp_path_factory):
    n = request.param
    rdzv = tmp_path_factory.mktemp(f"sp{n}") / "rendezvous"
    return n, spawn(_train_rank, n, (jax_start, _ids(), n),
                    init_method=f"file://{rdzv}", device="cpu",
                    timeout=600)


def _jax_sp_leg(n, start):
    """The JAX package's 3 Adam steps under the sp-leg strategy on n
    devices: (losses, weights)."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineView as JaxView
    from flexflow_tpu.models import build_gpt as jax_build_gpt

    jm = jax_build_gpt(ff.FFConfig(batch_size=BATCH, num_devices=n,
                                   compute_dtype="float32",
                                   only_data_parallel=False,
                                   cost_cache_file=""), **TINY)
    strategy = {node.guid: (JaxView(dim_degrees=(1, n, 1))
                            if node.op.op_type.value == "multihead_attention"
                            else JaxView.trivial(
                                node.op.output_shapes[0].ndim))
                for node in jm.graph.topo_order()}
    jm.compile(optimizer=ff.AdamOptimizer(alpha=ALPHA), strategy=strategy,
               **COMPILE)
    for op, ws in start.items():  # same initial weights (name-seeded)
        for w, v in ws.items():
            np.testing.assert_array_equal(np.asarray(jm.params[op][w]), v)
    params, opt, state = jm.params, jm.opt_state, jm.state
    ids, losses = _ids(), []
    for i in range(STEPS):
        rows = ids[i * BATCH:(i + 1) * BATCH]
        params, opt, state, loss, _ = jm.compiled.train_step(
            params, opt, state, jax.random.key(i), [jnp.asarray(rows[:, :-1])],
            jnp.asarray(rows[:, 1:]))
        losses.append(float(loss))
    return np.asarray(losses), {op: {w: np.asarray(v) for w, v in ws.items()}
                                for op, ws in params.items()}


def _assert_weights_close(got, ref):
    _, max_tol, mean_tol = TOLS
    for op, ws in ref.items():
        for w, r in ws.items():
            err = np.abs(got[op][w] - r) / ALPHA
            assert err.max() <= max_tol * STEPS, f"{op}/{w}: {err.max():.3e}"
            assert err.mean() <= mean_tol, f"{op}/{w}: {err.mean():.3e}"


def test_sp_fit_matches_jax_sp_leg(world, jax_start):
    n, ranks = world
    ref_losses, ref_params = _jax_sp_leg(n, jax_start)
    for r in ranks:  # every rank reports the job's loss and weights
        assert r["sp_size"] == n
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=TOLS[0])
        _assert_weights_close(r["params"], ref_params)


def test_sp_fit_matches_one_process(world, one_process):
    _, ranks = world
    losses, history, params = one_process
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=TOLS[0])
        _assert_weights_close(r["params"], params)
        (got,), (ref,) = r["history"], history
        assert got["samples"] == ref["samples"] == STEPS * BATCH
        np.testing.assert_allclose(got["accuracy"], ref["accuracy"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOLS[0])


def test_strategies_the_port_does_not_lower_raise(world):
    _, ranks = world
    for r in ranks:
        for key in ("sp_leg", "data_parallel"):
            assert r[key] and r[key].startswith("NotImplementedError"), (
                key, r[key])
            assert "Queue A item 8" in r[key]
        assert r["no_strategy"].startswith("NotImplementedError")


def test_ulysses_raises(world):
    n, ranks = world
    for r in ranks:
        assert r["ulysses"].startswith("NotImplementedError")
        assert "Ulysses" in r["ulysses"]
        # auto picks Ulysses for non-causal attention at n >= 3 only
        assert (r["auto"] is not None) == (n >= 3), r["auto"]


def test_num_devices_must_equal_the_job(world):
    n, ranks = world
    for r in ranks:
        assert r["num_devices"].startswith("ValueError")
        assert f"num_devices={n + 1}" in r["num_devices"]
    m = build_gpt(FFConfig(batch_size=BATCH, device="cpu", num_devices=n),
                  **TINY)
    with pytest.raises(ValueError, match="1 rank"):
        m.compile(strategy=sp_strategy(m, n), **COMPILE)


def test_each_rank_feeds_its_slice(world):
    n, ranks = world
    for r, res in enumerate(ranks):
        seq, batch, transport = res["slices"]
        assert seq == (r * 64 // n, (r + 1) * 64 // n)
        assert batch == (r * 8 // n, (r + 1) * 8 // n)
        assert transport == "gloo"
    assert distributed.local_seq_slice(64) == (0, 64)  # no job: one rank
    assert distributed.transport() is None
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        distributed.initialize("file:///nonexistent", 1, 0, device="tpu")


def test_evaluate_and_predict_refuse_sequence_parallel(world):
    _, ranks = world
    for r in ranks:
        for key in ("evaluate", "predict"):
            assert r[key].startswith("NotImplementedError"), (key, r[key])
