"""The port's training path against the JAX package's.

Losses, metrics and one SGD and one Adam update equal the reference's on
the same numpy inputs (fp32 round-off).  ``build_transformer`` at
bench.py's CPU shape and a tiny ``build_gpt`` at seq 512 (where the
causal MHA takes the flash route: the JAX side runs the three Pallas
kernels in interpret mode, the port their plain versions) take the JAX
model's weights and match its losses and updated weights over a few
Adam steps.  Weight errors are measured in Adam's step size alpha: an
Adam step moves every entry by about alpha whatever its gradient's
size, so an entry whose tiny gradient flips sign under another rounding
moves up to 2 alpha the other way.  fp32 compute: losses within 1e-5
relative, every weight entry within 0.01 alpha (summation order only).
bf16 compute: losses within 3e-5 relative; weight entries within
1 alpha per step at most and 0.05 alpha on average (the products keep
their fp32 results on both sides, ops/linear.py ``matmul_acc32``; the
backward rounds the cotangent to bf16 where JAX contracts it in fp32).
These were 1e-4, 2 and 0.1 while the port rounded each product to bf16;
measured then 1.5e-5, 1.16 and 0.080, now 7.7e-6, 0.73 and 0.025.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView
from flexflow_tpu.losses import LossType as JLossType
from flexflow_tpu.losses import compute_loss as jax_compute_loss
from flexflow_tpu.metrics import MetricsType as JMetricsType
from flexflow_tpu.metrics import compute_metrics as jax_compute_metrics
from flexflow_tpu.models import build_gpt as jax_build_gpt
from flexflow_tpu.models import build_transformer as jax_build_transformer
from flexflow_tpu.runtime.dataloader import SingleDataLoader as JaxLoader
from flexflow_tpu_torch import AdamOptimizer, FFConfig, SGDOptimizer
from flexflow_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    tensor_from_numpy,
)
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import PerfMetrics, compute_metrics
from flexflow_tpu_torch.models import build_gpt, build_transformer
from flexflow_tpu_torch.ops.linear import matmul_acc32
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

# bench.py's CPU shape (bench.py:211)
BENCH_CPU = dict(num_layers=2, hidden=64, num_heads=4, ff_dim=128,
                 seq_len=32)
TINY_GPT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
                seq_len=512)
# (loss rtol, max weight error per step, mean weight error), in alpha
# bf16 was (1e-4, 2.0, 0.1) before matmul_acc32; see the docstring
TOLS = {"float32": (1e-5, 0.01, 0.01), "bfloat16": (3e-5, 1.0, 0.05)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trivial(model):
    return {n.guid: MachineView.trivial(n.op.output_shapes[0].ndim)
            for n in model.graph.topo_order()}


def _np_params(jm):
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in jm.params.items()}


def _pair(build_jax, build_port, cfg_kw, model_kw, compile_kw, jax_opt,
          port_opt):
    """(jax model, port model) built alike, compiled, the port holding
    the JAX model's initial weights."""
    jm = build_jax(ff.FFConfig(num_devices=1, cost_cache_file="", **cfg_kw),
                   **model_kw)
    jm.compile(optimizer=jax_opt, strategy=_trivial(jm), **compile_kw)
    pm = build_port(FFConfig(device="cpu", **cfg_kw), **model_kw)
    pm.compile(optimizer=port_opt, **compile_kw)
    assert {op: {w: t.shape for w, t in ws.items()}
            for op, ws in pm.params.items()} == {
        op: {w: tuple(v.shape) for w, v in ws.items()}
        for op, ws in jm.params.items()}
    pm.params = params_from_numpy(_np_params(jm))
    return jm, pm


def _run_steps(jm, pm, batches):
    """Both models through the same batches; per-step losses of each."""
    jl, pl = [], []
    params, opt, state = jm.params, jm.opt_state, jm.state
    for i, (x, y) in enumerate(batches):
        params, opt, state, loss, _ = jm.compiled.train_step(
            params, opt, state, jax.random.key(i), [jnp.asarray(x)],
            jnp.asarray(y))
        jl.append(float(loss))
        pm.params, pm.opt_state, pm.state, ploss, _ = (
            pm.compiled.train_step(pm.params, pm.opt_state, pm.state,
                                   [torch.from_numpy(x)], torch.from_numpy(y)))
        pl.append(float(ploss))
    jm.params = params
    return np.asarray(jl), np.asarray(pl)


def _assert_params_close(jm, pm, alpha, steps, max_tol, mean_tol):
    """Every weight within ``max_tol * steps`` alphas at most and within
    ``mean_tol`` alphas on average."""
    got = params_to_numpy(pm.params)
    for op, ws in _np_params(jm).items():
        for w, ref in ws.items():
            err = np.abs(got[op][w] - ref.astype(np.float32)) / alpha
            assert err.max() <= max_tol * steps, f"{op}/{w}: {err.max():.3f}"
            assert err.mean() <= mean_tol, f"{op}/{w}: {err.mean():.4f}"


# ---------------------------------------------------------------------------
def test_build_transformer_matches_jax_over_5_adam_steps():
    jm, pm = _pair(jax_build_transformer, build_transformer,
                   dict(batch_size=8, compute_dtype="float32"), BENCH_CPU,
                   dict(loss_type="mean_squared_error",
                        metrics=["mean_squared_error"]),
                   ff.AdamOptimizer(alpha=1e-4), AdamOptimizer(alpha=1e-4))
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(8, 32, 64)).astype(np.float32),
                rng.normal(size=(8, 32, 64)).astype(np.float32))
               for _ in range(5)]
    jl, pl = _run_steps(jm, pm, batches)
    loss_tol, max_tol, mean_tol = TOLS["float32"]
    np.testing.assert_allclose(pl, jl, rtol=loss_tol)
    _assert_params_close(jm, pm, 1e-4, 5, max_tol, mean_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_gpt_matches_jax_over_3_adam_steps(dtype):
    jm, pm = _pair(jax_build_gpt, build_gpt,
                   dict(batch_size=2, compute_dtype=dtype), TINY_GPT,
                   dict(loss_type="sparse_categorical_crossentropy",
                        metrics=["accuracy"]),
                   ff.AdamOptimizer(alpha=1e-3), AdamOptimizer(alpha=1e-3))
    assert all(n.op.uses_flash() for n in pm.graph.topo_order()
               if hasattr(n.op, "uses_flash"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY_GPT["vocab"], size=(3, 2, 513)).astype(np.int32)
    jl, pl = _run_steps(jm, pm, [(b[:, :-1], b[:, 1:]) for b in ids])
    loss_tol, max_tol, mean_tol = TOLS[dtype]
    np.testing.assert_allclose(pl, jl, rtol=loss_tol)
    _assert_params_close(jm, pm, 1e-3, 3, max_tol, mean_tol)


def test_fit_returns_history_with_loss_and_accuracy():
    pm = build_gpt(FFConfig(batch_size=2, device="cpu",
                            compute_dtype="float32"),
                   vocab=32, num_layers=1, hidden=16, num_heads=1, ff_dim=32,
                   seq_len=16)
    pm.compile(optimizer=AdamOptimizer(alpha=1e-2),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 8, size=(6, 17)).astype(np.int32)
    hist = pm.fit(ids[:, :-1], ids[:, 1:], epochs=3, verbose=False)
    assert len(hist) == 3 and len(pm.step_losses) == 9
    for logs in hist:
        assert {"loss", "accuracy", "sparse_categorical_crossentropy",
                "samples"} <= set(logs)
        assert 0.0 <= logs["accuracy"] <= 1.0 and logs["samples"] == 6
    assert np.isfinite(pm.step_losses).all()
    assert hist[-1]["loss"] < pm.step_losses[0]
    assert pm.last_throughput > 0
    ev = pm.evaluate(ids[:, :-1], ids[:, 1:])
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0
    pred = pm.predict(ids[:5, :-1])
    assert pred.shape == (5, 16, 32)
    np.testing.assert_allclose(
        pred[:2], pm.compiled.forward_fn()(
            pm.params, pm.state, [torch.from_numpy(ids[:2, :-1])]).numpy(),
        rtol=1e-6, atol=1e-6)


def test_fit_refuses_what_is_not_ported():
    """``fit`` now takes callbacks, validation data or split,
    checkpoints and resume, and ``FFConfig`` remat and
    ``grad_accum_steps``; what it refuses is the reference's errors:
    both validation forms, a split leaving an empty set, a validation
    set under one batch, ``resume`` without a directory, and a
    ``grad_accum_steps`` below 1."""
    pm = build_transformer(FFConfig(batch_size=2, device="cpu"), num_layers=1,
                           hidden=16, num_heads=2, ff_dim=16, seq_len=4)
    pm.compile(loss_type="mean_squared_error", metrics=[])
    x = np.zeros((2, 4, 16), np.float32)
    for kw, match in ((dict(validation_split=0.5), "validation set"),
                      (dict(validation_split=0.6), "empty"),
                      (dict(validation_split=1.5), "not in"),
                      (dict(validation_split=0.5, validation_data=(x, x)),
                       "either"),
                      (dict(validation_data=(x[:1], x[:1])), "smaller"),
                      (dict(validation_data=x), "pair"),
                      (dict(resume=True), "checkpoint_dir")):
        with pytest.raises(ValueError, match=match):
            pm.fit(x, x, **kw)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        FFConfig(device="cpu", grad_accum_steps=0)
    for flag, value in (("remat", True), ("grad_accum_steps", 2)):
        assert getattr(FFConfig(device="cpu", **{flag: value}), flag) == value
def test_default_optimizer_is_sgd_at_the_config_rate():
    pm = build_transformer(FFConfig(batch_size=2, device="cpu",
                                    learning_rate=0.05, weight_decay=0.0),
                           num_layers=1, hidden=16, num_heads=2, ff_dim=16,
                           seq_len=4)
    pm.compile(loss_type="mean_squared_error", metrics=[])
    assert isinstance(pm.optimizer, SGDOptimizer)
    assert pm.optimizer.lr == 0.05 and pm.opt_state == {"step": 0}


# ---------------------------------------------------------------------------
def _logits_and_labels(rng, kind):
    if kind == "per_position":
        return (rng.normal(size=(3, 5, 7)).astype(np.float32),
                rng.integers(0, 7, size=(3, 5)).astype(np.int32))
    if kind == "per_position_singleton":
        return (rng.normal(size=(3, 5, 7)).astype(np.float32),
                rng.integers(0, 7, size=(3, 5, 1)).astype(np.int32))
    if kind == "classification":
        return (rng.normal(size=(4, 7)).astype(np.float32),
                rng.integers(0, 7, size=(4, 1)).astype(np.int32))
    logits = rng.normal(size=(4, 3, 6)).astype(np.float32)
    if kind == "onehot":
        lab = np.eye(6, dtype=np.float32)[rng.integers(0, 6, size=(4, 3))]
        return logits, lab
    return logits, rng.normal(size=(4, 3, 6)).astype(np.float32)


LOSS_CASES = [
    ("sparse_categorical_crossentropy", "per_position"),
    ("sparse_categorical_crossentropy", "per_position_singleton"),
    ("sparse_categorical_crossentropy", "classification"),
    ("categorical_crossentropy", "onehot"),
    ("mean_squared_error", "dense"),
    ("mean_squared_error_avg_reduce", "dense"),
    ("mean_squared_error_sum_reduce", "dense"),
    ("identity", "dense"),
]


@pytest.mark.parametrize("loss,kind", LOSS_CASES)
def test_losses_match_reference(loss, kind):
    logits, labels = _logits_and_labels(np.random.default_rng(3), kind)
    ref = float(jax_compute_loss(loss, jnp.asarray(logits),
                                 jnp.asarray(labels)))
    got = float(compute_loss(loss, torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert LossType.from_any("mse") is LossType.MEAN_SQUARED_ERROR


@pytest.mark.parametrize("loss,kind,metrics", [
    ("sparse_categorical_crossentropy", "per_position",
     ["accuracy", "sparse_categorical_crossentropy"]),
    ("sparse_categorical_crossentropy", "classification",
     ["accuracy", "sparse_categorical_crossentropy"]),
    ("categorical_crossentropy", "onehot",
     ["accuracy", "categorical_crossentropy"]),
    ("mean_squared_error", "dense",
     ["mean_squared_error", "root_mean_squared_error",
      "mean_absolute_error"]),
])
def test_metrics_match_reference(loss, kind, metrics):
    logits, labels = _logits_and_labels(np.random.default_rng(4), kind)
    ref = jax_compute_metrics([JMetricsType(m) for m in metrics],
                              JLossType.from_any(loss),
                              jnp.asarray(logits), jnp.asarray(labels))
    got = compute_metrics(metrics, loss, torch.from_numpy(logits),
                          torch.from_numpy(labels))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    rep = PerfMetrics()
    rep.update(got)
    rep.update(got)
    assert rep.report()["samples"] == 2 * logits.shape[0]


# ---------------------------------------------------------------------------
def _param_tree(rng):
    return {"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)},
            "b": {"table": rng.normal(size=(5, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name,jax_opt,port_opt", [
    ("sgd", ff.SGDOptimizer(lr=0.1, weight_decay=0.01),
     SGDOptimizer(lr=0.1, weight_decay=0.01)),
    ("sgd_nesterov", ff.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                                     weight_decay=0.01),
     SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("adam", ff.AdamOptimizer(alpha=0.01, weight_decay=0.01),
     AdamOptimizer(alpha=0.01, weight_decay=0.01)),
    ("adamw", ff.AdamOptimizer(alpha=0.01, weight_decay=0.01, adamw=True),
     AdamOptimizer(alpha=0.01, weight_decay=0.01, adamw=True)),
])
def test_optimizer_updates_match_reference(name, jax_opt, port_opt):
    """Two updates (the second exercises alpha_t and the moments) on the
    same params and grads."""
    rng = np.random.default_rng(5)
    p0 = _param_tree(rng)
    grads = [_param_tree(rng) for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_opt.init_state(jp)
    pp = params_from_numpy(p0)
    ps = port_opt.init_state(pp)
    for g in grads:
        jp, js = jax_opt.apply(jp, jax.tree.map(jnp.asarray, g), js)
        same, ps = port_opt.apply(pp, params_from_numpy(g), ps)
        assert same is pp  # updated in place
    got = params_to_numpy(pp)
    for op, ws in jp.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(ref),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {op}/{w}")
    assert ps["step"] == 2


# ---------------------------------------------------------------------------
def test_build_gpt_flops_equal_the_reference():
    """Sum of op.flops() over build_gpt at its defaults (the training
    path's MFU counts 3x this sum), and the graphs' op names."""
    jm = jax_build_gpt(ff.FFConfig(batch_size=8, num_devices=1,
                                   cost_cache_file=""))
    pm = build_gpt(FFConfig(batch_size=8, device="cpu"))
    jnodes = {n.op.name: n.op.flops() for n in jm.graph.nodes.values()}
    pnodes = {n.op.name: n.op.flops() for n in pm.graph.nodes.values()}
    assert pnodes == jnodes
    assert sum(pnodes.values()) == sum(jnodes.values())


def test_dataloader_order_equals_the_reference():
    jm = jax_build_transformer(ff.FFConfig(batch_size=2, num_devices=1,
                                           cost_cache_file=""),
                               num_layers=1, hidden=8, num_heads=2,
                               ff_dim=8, seq_len=4)
    jm.compile(loss_type="mean_squared_error", metrics=[],
               strategy=_trivial(jm))
    pm = build_transformer(FFConfig(batch_size=2, device="cpu"),
                           num_layers=1, hidden=8, num_heads=2, ff_dim=8,
                           seq_len=4)
    pm.compile(loss_type="mean_squared_error", metrics=[])
    x = np.arange(7 * 4 * 8, dtype=np.float32).reshape(7, 4, 8)
    y = np.arange(7, dtype=np.float32)
    jl = JaxLoader(jm.compiled, [x], y, 2, shuffle=True, seed=3)
    pl = SingleDataLoader(pm.compiled, [x], y, 2, shuffle=True, seed=3)
    assert pl.num_batches == jl.num_batches == 3
    for _ in range(2):  # two epochs: the shuffle stream advances alike
        for (jx, jy), (px, py) in zip(jl, pl):
            np.testing.assert_array_equal(px[0].numpy(), np.asarray(jx[0]))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


def test_params_to_numpy_carries_bf16_bit_for_bit():
    import ml_dtypes

    a = np.random.default_rng(6).normal(size=(3, 4)).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    back = params_to_numpy({"op": {"w": t}})["op"]["w"]
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.int16), a.view(np.int16))


def test_get_and_set_weight():
    pm = build_transformer(FFConfig(batch_size=2, device="cpu"), num_layers=1,
                           hidden=8, num_heads=2, ff_dim=8, seq_len=4)
    pm.compile(loss_type="mean_squared_error", metrics=[])
    w = pm.get_weight("head", "kernel")
    pm.set_weight("head", "kernel", w + 1.0)
    np.testing.assert_array_equal(pm.get_weight("head", "kernel"), w + 1.0)
    with pytest.raises(ValueError):
        pm.set_weight("head", "kernel", np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_acc32_equals_the_reference_dot(dtype):
    """``matmul_acc32`` against ``jnp.dot(..., preferred_element_type=
    float32)`` on the same operands: an fp32 result within fp32
    round-off (products of bf16 values are exact in fp32; only the
    summation order differs), and exactly ``torch.matmul`` in fp32.
    Gradients come back in the operands' dtype, within 1e-2 of the
    largest entry of JAX's (its transpose contracts the fp32 cotangent,
    the port's the cotangent rounded to bf16)."""
    rng = np.random.default_rng(8)
    jdt = jnp.dtype(dtype)
    ja = jnp.asarray(rng.normal(size=(2, 5, 96)), jdt)
    jb = jnp.asarray(rng.normal(size=(96, 40)), jdt)
    g = rng.normal(size=(2, 5, 40)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32),
        ja, jb)
    jga, jgb = vjp(jnp.asarray(g))
    a = tensor_from_numpy(np.asarray(ja)).requires_grad_(True)
    b = tensor_from_numpy(np.asarray(jb)).requires_grad_(True)
    got = matmul_acc32(a, b)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 40)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-5)
    if dtype == "float32":
        assert torch.equal(got, torch.matmul(a, b))
    got.backward(torch.from_numpy(g))
    for t, ref_g in ((a, jga), (b, jgb)):
        assert t.grad.dtype == t.dtype
        ref_g = np.asarray(ref_g, np.float32)
        err = np.abs(t.grad.float().numpy() - ref_g).max()
        assert err <= 1e-2 * np.abs(ref_g).max()


# ---------------------------------------------------------------------------
# bf16 parameters: the update runs in fp32 and is cast back, the slots
# stay fp32 (reference optimizers.py:61-66)
BF16_OPTIMIZERS = [
    ("sgd_nesterov", ff.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                                     weight_decay=0.01),
     SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("adam", ff.AdamOptimizer(alpha=0.01, weight_decay=0.01),
     AdamOptimizer(alpha=0.01, weight_decay=0.01)),
    ("adamw", ff.AdamOptimizer(alpha=0.01, weight_decay=0.01, adamw=True),
     AdamOptimizer(alpha=0.01, weight_decay=0.01, adamw=True)),
]


def _bf16_linear_model(pkg, ops, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([8, 16], name="x")
    h = m._add_op(ops.LinearOp("fc1", [m._shape_of(x)], out_dim=8,
                               activation="relu", param_dtype="bfloat16"),
                  [x])[0]
    m._add_op(ops.LinearOp("fc2", [m._shape_of(h)], out_dim=4,
                           param_dtype="bfloat16"), [h])
    return m


def _f32_tree(tree):
    return {op: {w: np.asarray(v, np.float32) for w, v in ws.items()}
            for op, ws in tree.items()}


@pytest.mark.parametrize("name,jax_opt,port_opt", BF16_OPTIMIZERS)
def test_bf16_linear_params_train_like_the_reference(name, jax_opt,
                                                     port_opt):
    """``LinearOp(param_dtype="bfloat16")`` through 3 optimizer steps in
    both packages from the same weights: losses within 1e-5, the bf16
    weights within bf16 rounding (8e-3 relative, 1e-3 absolute), the
    fp32 slots within 1e-4 of their largest entry.  The same three
    updates on the same bf16 gradients straight through ``apply``: the
    weights bit-equal, the slots within 1e-6."""
    import flexflow_tpu.ops as jops
    import flexflow_tpu_torch as tff
    import flexflow_tpu_torch.ops as pops

    jm = _bf16_linear_model(ff, jops, ff.FFConfig(
        batch_size=8, num_devices=1, compute_dtype="float32",
        cost_cache_file=""))
    jm.compile(optimizer=jax_opt, strategy=_trivial(jm),
               loss_type="sparse_categorical_crossentropy", metrics=[])
    pm = _bf16_linear_model(tff, pops, FFConfig(
        batch_size=8, device="cpu", compute_dtype="float32"))
    pm.compile(optimizer=port_opt,
               loss_type="sparse_categorical_crossentropy", metrics=[])
    assert pm.params["fc1"]["kernel"].dtype == torch.bfloat16
    p0 = _np_params(jm)  # before the JAX steps donate them
    pm.params = params_from_numpy(p0)
    pm.opt_state = port_opt.init_state(pm.params)
    rng = np.random.default_rng(7)
    params, opt, state = jm.params, jm.opt_state, jm.state
    for step in range(3):
        x = rng.normal(size=(8, 16)).astype(np.float32)
        y = rng.integers(0, 4, size=(8,)).astype(np.int32)
        params, opt, state, jl, _ = jm.compiled.train_step(
            params, opt, state, jax.random.key(step), [jnp.asarray(x)],
            jnp.asarray(y))
        pm.params, pm.opt_state, pm.state, pl, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state, [torch.from_numpy(x)],
            torch.from_numpy(y))
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = params_to_numpy(pm.params)
    for op, ws in params.items():
        for w, v in ws.items():
            assert got[op][w].dtype == np.asarray(v).dtype  # still bf16
            np.testing.assert_allclose(
                np.asarray(got[op][w], np.float32), np.asarray(v, np.float32),
                rtol=8e-3, atol=1e-3, err_msg=f"{op}/{w}")
    for slot in [k for k in opt if k != "step"]:
        ref, mine = _f32_tree(opt[slot]), params_to_numpy(pm.opt_state[slot])
        for op, ws in ref.items():
            for w, v in ws.items():
                assert mine[op][w].dtype == np.float32
                scale = max(float(np.abs(v).max()), 1e-12)
                assert float(np.abs(mine[op][w] - v).max()) <= 1e-4 * scale

    # the update alone, on the same bf16 gradients
    import ml_dtypes

    grads = [{op: {w: rng.normal(size=v.shape).astype(ml_dtypes.bfloat16)
                   for w, v in ws.items()} for op, ws in p0.items()}
             for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_opt.init_state(jp)
    pp = params_from_numpy(p0)
    ps = port_opt.init_state(pp)
    for g in grads:
        jp, js = jax_opt.apply(jp, jax.tree.map(jnp.asarray, g), js)
        port_opt.apply(pp, params_from_numpy(g), ps)
    got = params_to_numpy(pp)
    for op, ws in jp.items():
        for w, v in ws.items():
            np.testing.assert_array_equal(got[op][w].view(np.int16),
                                          np.asarray(v).view(np.int16))
    for slot in [k for k in js if k != "step"]:
        mine = params_to_numpy(ps[slot])
        for op, ws in _f32_tree(js[slot]).items():
            for w, v in ws.items():
                np.testing.assert_allclose(mine[op][w], v, rtol=1e-6,
                                           atol=1e-7)
