"""Hybrid-parallel training of the port on gloo worlds of 4 and 8 CPU
ranks, against the JAX package and against the port's own one-process
run.

Each case builds the same model in both packages, starts from the JAX
model's initial weights (name-seeded, so equal under every strategy),
and trains with Adam (alpha 1e-3), fp32 compute:

1. ``dptp``: __graft_entry__.py's dp x tp leg (:67-113), build_transformer
   2 layers, hidden 32, 4 heads, seq 8, batch 2n; MHA (dp, 1, 1) r tp,
   ff1 (dp, 1, tp), the rest batch-split (n = 8: dp 2 x tp 4; n = 4:
   dp 2 x tp 2); one ``train_step``;
2. ``megatron``: a tiny build_gpt (vocab 64, 2 layers, hidden 32, 4
   heads, ff 64, seq 512, so the flash route's plain version runs),
   batch 4, MHA (2, 1, 1) r 2, ff1 (2, 1, 2), ff2 (2, 1, 1) r 2, the
   rest (2, 1, 1) (on 8 ranks the third axis replicates); 3 ``fit``
   steps;
3. ``dp``: the same GPT at seq 64, batch n, every op batch-split n ways
   (the reference's ``data_parallel_strategy``); 3 ``fit`` steps;
4. ``sp_leg``: the sp leg (:152-186), a causal 1-layer build_transformer
   with MHA (dp_s, sp, 1) on the zigzag ring, the rest (dp_s, 1, 1) (n =
   8: dp_s 2 x sp 4, the product ring of two size-2 axes; n = 4: sp 4);
   one ``train_step``;
5. ``ulysses``: the Ulysses leg (:188-226), the same view on one MHA with
   ``sp_mode="ulysses"`` and a dense head; one ``train_step``;
6. ``vocab``: the GPT at seq 64, batch 4, everything (2, 1, 1) but the
   token embedding at (2, 1, 1) r n/2: its table split over the vocab
   (``EmbeddingOp.forward_sharded``); 3 ``fit`` steps;
7. ``relu_replica``: a dense layer with relu and a dense head, both at
   (2, 1, 1) r n/2 (their in dims split: partial outputs, the relu
   layer's summed inside the op after its bias), batch 4, with plain
   SGD (lr 0.1): its step is the gradient itself, so a bias gradient
   counted once per addend shows in full (Adam's step barely moves with
   the gradient's scale); 2 ``train_step``s.

Checked: the job's losses within 1e-5 relative of both references,
the job's metrics likewise; every weight (gathered) within 0.01 Adam
steps per step at most and 0.01 on average (tests/
test_torch_sp_training.py's fp32 tolerances); every replica of a weight
bit-equal after the last step (fp32 sync); ``evaluate`` and ``predict``
under dp x tp equal one process (case 8); Megatron's forward performs
exactly one all-reduce after MHA and one after ff2 per layer and no
all-gather; the options that were once refused under dp x tp (the
inference compile, ZeRO-1, the compressed and scheduled sync) compile
(case 9).  Weight errors are in units of ALPHA (1e-3) for every case, SGD's
too.  Measured (the test prints them): losses 3.2e-7 relative at most,
weights 3.0e-3 alphas per step at most and 5.9e-6 on average (both
worlds, all cases, against either reference).

One world of each size is spawned per module.  The worker functions
import no JAX: the spawned ranks import this module to find them.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.metrics import PerfMetrics
from flexflow_tpu_torch.models import build_transformer
from flexflow_tpu_torch.parallel import mesh as pmesh
from flexflow_tpu_torch.runtime.distributed import spawn

ALPHA = 1e-3
SGD_LR = 0.1
SGD_CASES = {"relu_replica"}
TOLS = (1e-5, 0.01, 0.01)  # loss rtol; max and mean weight error, alphas
TR = dict(num_layers=2, hidden=32, num_heads=4, ff_dim=64, seq_len=8)
GPT = dict(vocab=64, num_layers=2, hidden=32, num_heads=4, ff_dim=64)
MSE = dict(loss_type="mean_squared_error", metrics=["mean_squared_error"])
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=["accuracy"])


def _dptp(n):
    """The dp x tp leg's degrees (__graft_entry__.py:84-89)."""
    dp = next((d for d in range(max(2, n // 4), n + 1) if n % d == 0), n)
    return dp, n // dp


def _sp(n):
    sp = 4 if n % 4 == 0 else 2
    return n // sp, sp


def _ulysses_model(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 8, 32], name="tok")
    t = m.multihead_attention(x, x, x, embed_dim=32, num_heads=4,
                              causal=True, sp_mode="ulysses", name="umha")
    m.dense(t, 32, name="uhead")
    return m


def _relu_model(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 8, 32], name="feat")
    h = m.dense(x, 64, activation="relu", name="relu1")
    m.dense(h, 32, name="rhead")
    return m


def _optimizer(pkg, case):
    """Adam (alpha ALPHA), or plain SGD for the cases that hold a
    gradient's scale."""
    if case in SGD_CASES:
        return pkg.SGDOptimizer(lr=SGD_LR)
    return pkg.AdamOptimizer(alpha=ALPHA)


# name -> (build(pkg, cfg, models), batch(n), compile kwargs, steps,
# input kind)
CASES = {
    "dptp": (lambda pkg, cfg, mods: mods.build_transformer(cfg, **TR),
             lambda n: 2 * n, MSE, 1, "float"),
    "megatron": (lambda pkg, cfg, mods: mods.build_gpt(cfg, seq_len=512,
                                                       **GPT),
                 lambda n: 4, CCE, 3, "ids512"),
    "dp": (lambda pkg, cfg, mods: mods.build_gpt(cfg, seq_len=64, **GPT),
           lambda n: n, CCE, 3, "ids64"),
    "sp_leg": (lambda pkg, cfg, mods: mods.build_transformer(
        cfg, causal=True, **dict(TR, num_layers=1)),
               lambda n: max(2 * _sp(n)[0], 2), MSE, 1, "float"),
    "ulysses": (lambda pkg, cfg, mods: _ulysses_model(pkg, cfg),
                lambda n: max(2 * _sp(n)[0], 2), MSE, 1, "float"),
    "vocab": (lambda pkg, cfg, mods: mods.build_gpt(cfg, seq_len=64, **GPT),
              lambda n: 4, CCE, 3, "ids64"),
    "relu_replica": (lambda pkg, cfg, mods: _relu_model(pkg, cfg),
                     lambda n: 4, MSE, 2, "float"),
}


def strategy(case, model, n, mv_cls):
    """The case's views (guid -> ``mv_cls``) on n ranks, in either
    package."""
    views = {}
    ops = [node for node in model.graph.topo_order()]

    def dp_view(node, d):
        nd = node.op.output_shapes[0].ndim
        fixed = node.op.fixed_machine_view()
        if fixed is not None:
            return fixed
        if nd and 0 in node.op.splittable_output_dims() and d > 1:
            degs = [1] * nd
            degs[0] = d
            return mv_cls(dim_degrees=tuple(degs))
        return mv_cls(dim_degrees=(1,) * nd)

    kind = lambda node: node.op.op_type.value  # noqa: E731
    if case == "dptp":
        dp, tp = _dptp(n)
        for node in ops:
            views[node.guid] = dp_view(node, dp)
            if kind(node) == "linear" and "ff1" in node.op.name:
                views[node.guid] = mv_cls(dim_degrees=(dp, 1, tp))
            if kind(node) == "multihead_attention":
                views[node.guid] = mv_cls(dim_degrees=(dp, 1, 1),
                                          replica_degree=tp)
    elif case == "megatron":
        for node in ops:
            views[node.guid] = dp_view(node, 2)
            if kind(node) == "multihead_attention" or "ff2" in node.op.name:
                views[node.guid] = mv_cls(dim_degrees=(2, 1, 1),
                                          replica_degree=2)
            if "ff1" in node.op.name:
                views[node.guid] = mv_cls(dim_degrees=(2, 1, 2))
    elif case == "dp":
        for node in ops:
            views[node.guid] = dp_view(node, n)
    elif case in ("sp_leg", "ulysses"):
        dp_s, sp = _sp(n)
        for node in ops:
            views[node.guid] = dp_view(node, dp_s)
            if kind(node) == "multihead_attention":
                views[node.guid] = mv_cls(dim_degrees=(dp_s, sp, 1))
    elif case == "vocab":
        for node in ops:
            views[node.guid] = dp_view(node, 2)
            if node.op.name == "tok_embed":
                views[node.guid] = mv_cls(dim_degrees=(2, 1, 1),
                                          replica_degree=n // 2)
    elif case == "relu_replica":
        for node in ops:
            views[node.guid] = dp_view(node, 2)
            if kind(node) == "linear":
                views[node.guid] = mv_cls(dim_degrees=(2, 1, 1),
                                          replica_degree=n // 2)
    return views


def _data(case, n):
    """(inputs, labels): ``steps`` batches of the case's batch size."""
    _, batch, _, steps, kind = CASES[case]
    rows = batch(n) * steps
    rng = np.random.default_rng(sorted(CASES).index(case))
    if kind == "float":
        x = rng.normal(size=(rows, 8, 32)).astype(np.float32)
        y = rng.normal(size=(rows, 8, 32)).astype(np.float32)
        return x, y
    seq = 512 if kind == "ids512" else 64
    ids = rng.integers(0, GPT["vocab"], size=(rows, seq + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _port_model(case, n, start, one_process=False):
    """The case's port model for a world of n, compiled under its
    strategy, or in one process with no strategy."""
    import flexflow_tpu_torch.models as mods

    build, batch, kw, _, _ = CASES[case]
    cfg = tff.FFConfig(batch_size=batch(n), device="cpu",
                       compute_dtype="float32",
                       num_devices=1 if one_process else n)
    m = build(tff, cfg, mods)
    m.compile(optimizer=_optimizer(tff, case),
              strategy=None if one_process else strategy(
                  case, m, n, MachineView), **kw)
    m.params = params_from_numpy(start, "cpu", m.compiled)
    return m


def _report(step_metrics):
    """The metrics' report (accuracy, mean metric values, samples) of
    per-step sums."""
    pm = PerfMetrics()
    for m in step_metrics:
        pm.update(m)
    return pm.report()


def _train(m, case, x, y):
    """The case's steps: (losses, the metrics' report)."""
    _, batch, _, steps, _ = CASES[case]
    if case in ("megatron", "dp", "vocab"):
        (history,) = m.fit(x, y, shuffle=False, verbose=False)
        return list(m.step_losses), {k: v for k, v in history.items()
                                     if k != "loss"}
    bs = m.config.batch_size
    c = m.compiled
    losses, metrics = [], []
    for i in range(steps):
        rows = slice(i * bs, (i + 1) * bs)
        xi, yi = x[rows], y[rows]
        ins = [torch.from_numpy(np.ascontiguousarray(
            xi[c.input_slices(0, xi.shape)]))]
        lab = torch.from_numpy(np.ascontiguousarray(
            yi[c.label_slices(yi.shape)]))
        m.params, m.opt_state, m.state, loss, met = c.train_step(
            m.params, m.opt_state, m.state, ins, lab)
        losses.append(float(loss))
        metrics.append({k: float(v) for k, v in met.items()})
    return losses, _report(metrics)


def _blocks(m):
    """Per weight: (this rank's block coordinates, a digest of its
    bits)."""
    out = {}
    c = m.compiled
    for op, ws in m.params.items():
        for w, t in ws.items():
            pl = c.weight_placement(op, w)
            key = tuple(c.mesh.index(axes) if axes else 0
                        for axes in pl.dims)
            out[f"{op}/{w}"] = (key, hashlib.sha1(
                t.detach().contiguous().numpy().tobytes()).hexdigest())
    return out


def _refusals(n):
    """What the lowering still refuses, each message."""
    out = {}
    x = np.zeros((2 * n, 8, 32), np.float32)

    def attempt(key, cfg_kw=None, strategy_meta=None, **compile_kw):
        cfg = tff.FFConfig(batch_size=2 * n, device="cpu", num_devices=n,
                           **(cfg_kw or {}))
        m = build_transformer(cfg, **TR)
        views = strategy("dptp", m, n, MachineView)
        if strategy_meta:
            views["__meta__"] = strategy_meta
        try:
            m.compile(strategy=views, **dict(MSE, **compile_kw))
        except NotImplementedError as e:
            out[key] = str(e)
            return
        out[key] = None

    attempt("zero_dp_shard", cfg_kw={"zero_dp_shard": True})
    attempt("sync_precision", cfg_kw={"sync_precision": "int8"})
    attempt("sync_schedule", cfg_kw={"sync_schedule": "search"})
    attempt("zero_groups", strategy_meta={"zero_groups": ["layer0_ff1"]})
    attempt("inference", comp_mode="inference")
    del x
    return out


def _rank(rank, n, starts, data):
    """One rank: every case, then what is refused."""
    out = {}
    for case in CASES:
        m = _port_model(case, n, starts[case])
        x, y = data[case]
        res = {}
        c = m.compiled
        if case == "dptp":
            res["evaluate"] = m.evaluate(x, y)
            res["predict"] = m.predict(x)
        if case == "megatron":
            bs = m.config.batch_size
            ids = x[:bs]
            pmesh.reset_comm_counts()
            with torch.no_grad():
                c.apply(m.params, m.state, [torch.from_numpy(
                    np.ascontiguousarray(ids[c.input_slices(0, ids.shape)]))])
            res["forward_comms"] = pmesh.comm_counts()
        pmesh.reset_comm_counts()
        res["losses"], res["metrics"] = _train(m, case, x, y)
        res["comms"] = pmesh.comm_counts()
        res["params"] = params_to_numpy(m.params, c)
        res["blocks"] = _blocks(m)
        out[case] = res
    out["refused"] = _refusals(n)
    return out


# ---- references ----------------------------------------------------------
@pytest.fixture(scope="module")
def starts():
    """Each case's initial weights: the JAX model's, as numpy."""
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods

    out = {}
    for case, (build, batch, kw, _, _) in CASES.items():
        jm = build(ff, ff.FFConfig(batch_size=batch(1), num_devices=1,
                                   compute_dtype="float32",
                                   cost_cache_file=""), jmods)
        jm.compile(optimizer=_optimizer(ff, case), **kw)
        out[case] = {op: {w: np.array(v) for w, v in ws.items()}
                     for op, ws in jm.params.items()}
    return out


def _jax_run(case, n, start, x, y):
    """The JAX package's steps under the case's strategy on n devices:
    (losses, per-step metrics, weights)."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.core.machine import MachineView as JView

    build, batch, kw, steps, _ = CASES[case]
    bs = batch(n)
    jm = build(ff, ff.FFConfig(batch_size=bs, num_devices=n,
                               compute_dtype="float32",
                               only_data_parallel=False,
                               cost_cache_file=""), jmods)
    jm.compile(optimizer=_optimizer(ff, case),
               strategy=strategy(case, jm, n, JView), **kw)
    for op, ws in start.items():  # same initial weights (name-seeded)
        for w, v in ws.items():
            np.testing.assert_array_equal(np.asarray(jm.params[op][w]), v)
    params, opt, state = jm.params, jm.opt_state, jm.state
    losses, metrics = [], []
    for i in range(steps):
        rows = slice(i * bs, (i + 1) * bs)
        params, opt, state, loss, m = jm.compiled.train_step(
            params, opt, state, jax.random.key(i),
            [jax.device_put(jnp.asarray(x[rows]),
                            jm.compiled.input_sharding(0))],
            jax.device_put(jnp.asarray(y[rows]),
                           jm.compiled.batch_sharding()))
        losses.append(float(loss))
        metrics.append({k: float(v) for k, v in m.items()})
    return losses, _report(metrics), {op: {w: np.asarray(v)
                                           for w, v in ws.items()}
                                      for op, ws in params.items()}


@pytest.fixture(scope="module", params=[4, 8], ids=["world4", "world8"])
def world(request, starts, tmp_path_factory):
    """(n, each rank's results, {case: (JAX run, one-process run)})."""
    n = request.param
    data = {case: _data(case, n) for case in CASES}
    rdzv = tmp_path_factory.mktemp(f"hybrid{n}") / "rendezvous"
    # the JAX runs overlap the ranks' (which take one thread each)
    jax_runs = {}
    worker = threading.Thread(target=lambda: jax_runs.update(
        {case: _jax_run(case, n, starts[case], *data[case])
         for case in CASES}))
    worker.start()
    try:
        ranks = spawn(_rank, n, (n, starts, data),
                      init_method=f"file://{rdzv}", device="cpu",
                      timeout=600)
    finally:
        worker.join()
    assert jax_runs.keys() == CASES.keys(), "a JAX run failed"
    refs = {}
    for case in CASES:
        x, y = data[case]
        one = _port_model(case, n, starts[case], one_process=True)
        res = {"losses_metrics": _train(one, case, x, y),
               "params": params_to_numpy(one.params)}
        if case == "dptp":  # from the start weights, as the ranks did
            fresh = _port_model(case, n, starts[case], one_process=True)
            res["evaluate"] = fresh.evaluate(x, y)
            res["predict"] = fresh.predict(x)
        refs[case] = (jax_runs[case], res)
    return n, ranks, refs


def _assert_weights_close(got, ref, steps):
    """Every weight within the tolerances; returns the worst errors
    (max per step, mean), in alphas."""
    _, max_tol, mean_tol = TOLS
    worst = (0.0, 0.0)
    for op, ws in ref.items():
        for w, r in ws.items():
            err = np.abs(got[op][w] - r) / ALPHA
            assert err.max() <= max_tol * steps, f"{op}/{w}: {err.max():.3e}"
            assert err.mean() <= mean_tol, f"{op}/{w}: {err.mean():.3e}"
            worst = (max(worst[0], err.max() / steps),
                     max(worst[1], err.mean()))
    return worst


# the collective that carries each case's split: (counter, whether the
# case's training steps call it)
CARRIERS = {"dptp": ("all_reduce_sum", True), "megatron": ("all_gather",
                                                           False),
            "dp": ("all_gather", False), "sp_leg": ("ppermute", True),
            "ulysses": ("all_to_all", True), "vocab": ("all_reduce_sum",
                                                       True),
            "relu_replica": ("all_reduce_sum", True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_jax_and_one_process(world, case):
    n, ranks, refs = world
    name, called = CARRIERS[case]
    for r in ranks:
        assert (r[case]["comms"][name]["calls"] > 0) == called, (
            case, r[case]["comms"])
    (jax_losses, jax_metrics, jax_params), one = refs[case]
    one_losses, one_metrics = one["losses_metrics"]
    steps = CASES[case][3]
    for r in ranks:  # every rank reports the job's losses and weights
        got = r[case]
        assert len(got["losses"]) == steps
        for ref_losses, ref_params, what in (
                (jax_losses, jax_params, "jax"),
                (one_losses, one["params"], "one process")):
            np.testing.assert_allclose(got["losses"], ref_losses,
                                       rtol=TOLS[0])
            w_max, w_mean = _assert_weights_close(got["params"], ref_params,
                                                  steps)
            rel = np.max(np.abs(np.subtract(got["losses"], ref_losses))
                         / np.abs(ref_losses))
            print(f"{case} world{n} vs {what}: loss {rel:.2e} rel, "
                  f"weights {w_max:.2e} max per step, {w_mean:.2e} mean "
                  f"(alphas)")
        for ref in (jax_metrics, one_metrics):
            assert got["metrics"].keys() == ref.keys()
            for k, v in ref.items():
                np.testing.assert_allclose(got["metrics"][k], v,
                                           rtol=TOLS[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_weight_replicas_are_bit_equal(world, case):
    _, ranks, _ = world
    seen = {}
    for r in ranks:
        for name, (key, digest) in r[case]["blocks"].items():
            assert seen.setdefault((name, key), digest) == digest, (
                f"{case}: replicas of {name} block {key} differ")
    # a split weight has more than one block: the check compared shards
    # of the same block only
    assert len(seen) >= len(ranks[0][case]["blocks"])


def test_evaluate_and_predict_under_dp_x_tp_equal_one_process(world):
    _, ranks, refs = world
    _, one = refs["dptp"]
    for r in ranks:
        got = r["dptp"]
        assert got["evaluate"].keys() == one["evaluate"].keys()
        for k, v in one["evaluate"].items():
            np.testing.assert_allclose(got["evaluate"][k], v, rtol=TOLS[0])
        assert got["predict"].shape == one["predict"].shape
        np.testing.assert_allclose(got["predict"], one["predict"],
                                   rtol=1e-5, atol=1e-6)


def test_megatron_forward_reduces_once_after_mha_and_ff2(world):
    _, ranks, _ = world
    layers = GPT["num_layers"]
    for r in ranks:
        comms = r["megatron"]["forward_comms"]
        assert comms["all_reduce_sum"]["calls"] == 2 * layers, comms
        assert comms["all_gather"]["calls"] == 0, comms
        assert comms["all_to_all"]["calls"] == 0, comms
        assert comms["ppermute"]["calls"] == 0, comms
        # the transport was the CPU's: no host hops
        assert comms["all_reduce_sum"]["host_hops"] == 0


def test_still_refused_raises_with_its_roadmap_item(world):
    """Nothing here is refused any more: the inference compile under a
    split lowers since serving over ranks was ported
    (tests/test_torch_serving_split.py serves under splits), and ZeRO-1,
    the compressed and scheduled gradient sync and
    ``__meta__.zero_groups`` compile under Megatron dp 2 x tp 2 since
    they were ported (tests/test_torch_zero.py and
    test_torch_sync_schedule.py train them).  The name is kept from the
    refusals this check replaced."""
    _, ranks, _ = world
    for r in ranks:
        for key in ("inference", "zero_dp_shard", "sync_precision",
                    "sync_schedule", "zero_groups"):
            assert r["refused"][key] is None, (key, r["refused"][key])
