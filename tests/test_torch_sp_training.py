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
runs Ulysses (``sp_mode="ulysses"``, and ``"auto"``, which picks it for
non-causal attention at n >= 3) and ``evaluate``/``predict`` under the
SP strategy against one process, and shows what the port still
refuses: a pipeline whose stages do not divide the ranks and a
``num_devices`` that differs from the job's size; an inference compile
under the SP strategy lowers.  The worker functions import no JAX: the
spawned ranks import this module to find them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import AdamOptimizer, FFConfig
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.models import build_gpt, build_transformer
from flexflow_tpu_torch.parallel import mesh as pmesh
from flexflow_tpu_torch.parallel.pipeline import PipelineConfig
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


def _refusal(fn):
    """The message of the NotImplementedError or ValueError ``fn``
    raises, or None."""
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _ulysses_input():
    return np.random.default_rng(2).normal(size=(BATCH, 64, 32)).astype(
        np.float32)


def _ulysses_model(mode, n):
    m = build_transformer(
        FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32",
                 num_devices=n), num_layers=1, hidden=32, num_heads=4,
        ff_dim=32, seq_len=64, sp_mode=mode)
    m.compile(strategy=sp_strategy(m, n) if n > 1 else None,
              loss_type="mean_squared_error", metrics=[])
    return m


def _train_rank(rank, params, ids, n):
    """One rank: 3 Adam steps through fit under the SP strategy, then
    Ulysses, evaluate and predict, and what the port refuses."""
    cfg = FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32",
                   num_devices=n)
    m = build_gpt(cfg, **TINY)
    m.compile(optimizer=AdamOptimizer(alpha=ALPHA), strategy=sp_strategy(m, n),
              **COMPILE)
    m.params = params_from_numpy(params)
    fresh = build_gpt(cfg, **TINY)  # evaluate and predict at the start
    fresh.compile(strategy=sp_strategy(fresh, n), **COMPILE)
    fresh.params = params_from_numpy(params, "cpu", fresh.compiled)
    history = m.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    label_block = m.compiled.label_slices((BATCH, 64))[1]
    out = {"losses": list(m.step_losses), "history": history,
           "params": params_to_numpy(m.params, m.compiled),
           "sp_size": 64 // (label_block.stop - label_block.start),
           "slices": (distributed.local_seq_slice(64),
                      distributed.local_batch_slice(8),
                      distributed.transport())}

    def compile_with(strategy_fn, config=cfg, **kw):
        model = build_gpt(config, **TINY)
        model.compile(strategy=strategy_fn(model), **dict(COMPILE, **kw))
        return model

    def with_meta(block):
        return lambda mm: dict(sp_strategy(mm, n), __meta__=block)

    out["sync_schedule_meta"] = _refusal(lambda: compile_with(
        with_meta({"sync_schedule": {"buckets": [["layer0_ff1"]]}})))
    out["zero_groups_meta"] = _refusal(lambda: compile_with(
        with_meta({"zero_groups": ["layer0_ff1"]})))
    out["pipeline"] = _refusal(lambda: compile_with(
        lambda mm: sp_strategy(mm, n),
        pipeline=PipelineConfig(num_stages=3, num_microbatches=2)))
    out["inference"] = _refusal(lambda: compile_with(
        lambda mm: sp_strategy(mm, n), comp_mode="inference"))
    out["num_devices"] = _refusal(lambda: compile_with(
        lambda mm: sp_strategy(mm, n),
        config=FFConfig(batch_size=BATCH, device="cpu", num_devices=n + 1)))
    out["evaluate"] = fresh.evaluate(ids[:, :-1], ids[:, 1:])
    out["predict"] = fresh.predict(ids[:, :-1])
    x = _ulysses_input()
    for mode in ("ulysses", "auto"):
        tm = _ulysses_model(mode, n)
        pmesh.reset_comm_counts()
        with torch.no_grad():
            y = tm.compiled.forward_fn()(tm.params, tm.state, [
                torch.from_numpy(x[tm.compiled.input_slices(0, x.shape)])])
        out[mode] = (y.numpy(), pmesh.comm_counts()["all_to_all"]["calls"])
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
    """The port's one-process run: (step losses, history, weights,
    evaluate and predict at the start weights)."""
    cfg = FFConfig(batch_size=BATCH, device="cpu", compute_dtype="float32")
    ids = _ids()
    fresh = build_gpt(cfg, **TINY)
    fresh.compile(**COMPILE)
    fresh.params = params_from_numpy(jax_start)
    m = build_gpt(cfg, **TINY)
    m.compile(optimizer=AdamOptimizer(alpha=ALPHA), **COMPILE)
    m.params = params_from_numpy(jax_start)
    history = m.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    return (np.asarray(m.step_losses), history, params_to_numpy(m.params),
            fresh.evaluate(ids[:, :-1], ids[:, 1:]),
            fresh.predict(ids[:, :-1]))


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
    losses, history, params, _, _ = one_process
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=TOLS[0])
        _assert_weights_close(r["params"], params)
        (got,), (ref,) = r["history"], history
        assert got["samples"] == ref["samples"] == STEPS * BATCH
        np.testing.assert_allclose(got["accuracy"], ref["accuracy"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOLS[0])


def test_strategies_the_port_does_not_lower_raise(world):
    """What the lowering still refuses under SP: a pipeline whose stages
    do not divide the ranks (the pipelined lowering's own guard).  The
    SP strategies themselves lower, and so does an inference compile
    under them (serving over ranks: tests/test_torch_serving_split.py)."""
    _, ranks = world
    # the __meta__ blocks of the gradient-sync plan compile since they
    # were ported: a schedule is adopted only under
    # sync_schedule="search" (as in the reference), and layer0_ff1 is a
    # legal ZeRO-1 group under SP
    for r in ranks:
        assert r["sync_schedule_meta"] is None, r["sync_schedule_meta"]
        assert r["zero_groups_meta"] is None, r["zero_groups_meta"]
    want = {"pipeline": ("ValueError", "must divide num_devices")}
    for r in ranks:
        assert r["inference"] is None, r["inference"]
        for key, (kind, text) in want.items():
            assert r[key] and r[key].startswith(kind), (key, r[key])
            assert text in r[key], (key, r[key])


def test_ulysses_raises(world):
    """Ulysses under the SP strategy gives one process's output (the
    whole output, gathered on every rank); ``auto`` takes it (all-to-all
    exchanges) for non-causal attention at n >= 3 only.  The name is
    kept from the refusal this check replaced: Ulysses no longer
    raises."""
    n, ranks = world
    one = _ulysses_model("ring", 1)
    with torch.no_grad():
        ref = one.compiled.forward_fn()(one.params, one.state, [
            torch.from_numpy(_ulysses_input())]).numpy()
    for r in ranks:
        for mode in ("ulysses", "auto"):
            y, exchanges = r[mode]
            np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)
            assert (exchanges > 0) == (mode == "ulysses" or n >= 3), (
                mode, exchanges)


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


def test_evaluate_and_predict_refuse_sequence_parallel(world, one_process):
    """``evaluate`` and ``predict`` under the SP strategy equal one
    process's from the same weights: the job's loss and metrics, the
    whole output on every rank.  The name is kept from the refusal this
    check replaced: neither refuses any more."""
    _, ranks = world
    _, _, _, evaluated, predicted = one_process
    for r in ranks:
        assert r["evaluate"].keys() == evaluated.keys()
        for k, v in evaluated.items():
            np.testing.assert_allclose(r["evaluate"][k], v, rtol=TOLS[0])
        assert r["predict"].shape == predicted.shape
        np.testing.assert_allclose(r["predict"], predicted, rtol=1e-5,
                                   atol=1e-6)
