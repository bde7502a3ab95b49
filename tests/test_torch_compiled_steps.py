"""The port's compiled steps (compiler/graphs.py) against its eager
steps and against the JAX package's jitted ones.

On the CPU a ``StepGraph`` runs its step eagerly through the same
static buffers a captured graph replays on the card, so these tests
pin what the buffers do: ``train_steps`` over N = 4 stacked batches
equals 4 ``train_step`` calls bit for bit and the reference's
``CompiledModel.train_steps`` (losses [N] and final weights) within
1e-5 in fp32 compute, for SGD and for Adam (whose ``alpha_t`` now
comes from a device step count, as the reference's does);
``fit(trace_steps=4)`` gives the per-step losses of
``fit(trace_steps=1)``, trailing single batch included, and the
reference's ``fit`` history with ``trace_steps=4``; every step keeps
its own loss although each call returns the same static buffer;
``iter_traced`` yields ``__iter__``'s batches in order; the decode
frame over static buffers gives the eager frame's logits, and a
returned logits tensor survives the next frame.  Tiny shapes: 2
layers, hidden 32, seq 16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView
from flexflow_tpu.models import build_gpt as jax_build_gpt
from flexflow_tpu.runtime.dataloader import SingleDataLoader as JaxLoader
from flexflow_tpu_torch import AdamOptimizer, FFConfig, SGDOptimizer
from flexflow_tpu_torch.compiler.graphs import StepGraph, eager
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.models import build_gpt, build_gpt_decode
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
from flexflow_tpu_torch.runtime.decode import compiled_decode_step

GPT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
           seq_len=16)
B = 2
N = 4
TOL = 1e-5  # fp32 compute: summation order only
COMPILE = dict(loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy", "sparse_categorical_crossentropy"])
OPTIMIZERS = {
    "sgd": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9, weight_decay=0.01),
            lambda: SGDOptimizer(lr=0.1, momentum=0.9, weight_decay=0.01)),
    "adam": (lambda: ff.AdamOptimizer(alpha=1e-2, weight_decay=0.01),
             lambda: AdamOptimizer(alpha=1e-2, weight_decay=0.01)),
    "sgd_nesterov": (
        lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                                weight_decay=0.01),
        lambda: SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                             weight_decay=0.01)),
    "adamw": (lambda: ff.AdamOptimizer(alpha=1e-2, weight_decay=0.05,
                                       adamw=True),
              lambda: AdamOptimizer(alpha=1e-2, weight_decay=0.05,
                                    adamw=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, GPT["vocab"], size=(n, GPT["seq_len"] + 1)
                        ).astype(np.int32)


def _port(opt="adam", **cfg):
    pm = build_gpt(FFConfig(batch_size=B, device="cpu",
                            compute_dtype="float32", **cfg), **GPT)
    pm.compile(optimizer=OPTIMIZERS[opt][1](), **COMPILE)
    return pm


def _jax(opt="adam", **cfg):
    jm = jax_build_gpt(ff.FFConfig(batch_size=B, num_devices=1,
                                   cost_cache_file="",
                                   compute_dtype="float32", **cfg), **GPT)
    jm.compile(optimizer=OPTIMIZERS[opt][0](),
               strategy={n.guid: MachineView.trivial(
                   n.op.output_shapes[0].ndim)
                   for n in jm.graph.topo_order()}, **COMPILE)
    return jm


def _carry(jm, pm):
    pm.params = params_from_numpy(
        {op: {w: np.array(v) for w, v in ws.items()}
         for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)


def _stacks(seed):
    ids = _ids(seed, N * B).reshape(N, B, -1)
    return ids[..., :-1], ids[..., 1:]


def _bits_equal(a, b):
    for op, ws in a.items():
        for w, t in ws.items():
            assert np.array_equal(t, b[op][w]), f"{op}/{w}"


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_steps_equals_n_train_step_calls_bit_for_bit(opt):
    x, y = _stacks(0)
    one, many = _port(opt), _port(opt)
    losses = []
    for i in range(N):
        *_, loss, m = one.compiled.train_step(
            one.params, one.opt_state, one.state,
            [torch.from_numpy(x[i])], torch.from_numpy(y[i]))
        losses.append(float(loss))
    *_, got, ms = many.compiled.train_steps(
        many.params, many.opt_state, many.state, [torch.from_numpy(x)],
        torch.from_numpy(y))
    assert got.shape == (N,) and got.tolist() == losses
    assert all(v.shape == (N,) for v in ms.values())
    assert float(ms["train_correct"][-1]) == float(m["train_correct"])
    assert int(one.opt_state["step"]) == int(many.opt_state["step"]) == N
    _bits_equal(params_to_numpy(one.params), params_to_numpy(many.params))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_steps_match_the_reference(opt):
    x, y = _stacks(1)
    jm, pm = _jax(opt), _port(opt)
    _carry(jm, pm)
    jp, jo, js, jl, jms = jm.compiled.train_steps(
        jm.params, jm.opt_state, jm.state, jax.random.key(0),
        [jnp.asarray(x)], jnp.asarray(y))
    *_, pl, pms = pm.compiled.train_steps(
        pm.params, pm.opt_state, pm.state, [torch.from_numpy(x)],
        torch.from_numpy(y))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL)
    for k in ("train_correct", "sparse_cce_loss"):
        np.testing.assert_allclose(pms[k].numpy(), np.asarray(jms[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    got = params_to_numpy(pm.params)
    for op, ws in jp.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(ref),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{op}/{w}")
    assert int(pm.opt_state["step"]) == int(jo["step"]) == N


def test_adam_counts_steps_on_the_device_as_the_reference():
    """The step count is a 0-d int32 tensor beside the weights, and
    five updates from it (``alpha_t`` in fp32 on the device) match the
    reference's (optimizers.py:108, 114-115)."""
    rng = np.random.default_rng(9)
    p0 = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}
    grads = [{"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}
             for _ in range(5)]
    jo, po = ff.AdamOptimizer(alpha=1e-2), AdamOptimizer(alpha=1e-2)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jo.init_state(jp)
    pp = params_from_numpy(p0)
    ps = po.init_state(pp)
    step = ps["step"]
    assert step.dtype == torch.int32 and step.dim() == 0
    assert step.device == pp["a"]["w"].device
    for g in grads:
        jp, js = jo.apply(jp, jax.tree.map(jnp.asarray, g), js)
        po.apply(pp, params_from_numpy(g), ps)
    np.testing.assert_allclose(pp["a"]["w"].numpy(),
                               np.asarray(jp["a"]["w"]), rtol=1e-6,
                               atol=1e-7)
    assert ps["step"] is step  # advanced in place
    assert int(step) == int(js["step"]) == 5


def _fit(pm, ids, epochs=2):
    return pm.fit(ids[:, :-1], ids[:, 1:], epochs=epochs, shuffle=True,
                  verbose=False)


def test_fit_trace_steps_gives_the_per_step_losses_of_single_steps():
    """10 samples, batch 2: 5 batches per epoch, one stack of 4 and a
    trailing single."""
    ids = _ids(2, 10)
    one, four = _port(), _port(trace_steps=4)
    h1, h4 = _fit(one, ids), _fit(four, ids)
    assert len(one.step_losses) == len(four.step_losses) == 10
    assert four.step_losses == one.step_losses
    for a, b in zip(h1, h4):
        assert a["loss"] == b["loss"] and a["samples"] == b["samples"]
        np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=1e-6)
    _bits_equal(params_to_numpy(one.params), params_to_numpy(four.params))


def test_fit_trace_steps_matches_the_reference_fit():
    """The contract of tests/test_end_to_end.py:175 across the packages:
    the same history with trace_steps=4, on the same weights and the
    same shuffled batches, under SGD as there (Adam's parity over many
    steps is measured in its step size, test_torch_training.py)."""
    ids = _ids(3, 10)
    jm, pm = _jax("sgd", trace_steps=4), _port("sgd", trace_steps=4)
    _carry(jm, pm)
    jh = jm.fit(x=ids[:, :-1], y=ids[:, 1:], epochs=2, verbose=False)
    ph = _fit(pm, ids)
    for a, b in zip(jh, ph):
        for k in ("loss", "accuracy", "sparse_categorical_crossentropy"):
            np.testing.assert_allclose(b[k], a[k], rtol=TOL, err_msg=k)
        assert a["samples"] == b["samples"]
    got = params_to_numpy(pm.params)
    for op, ws in jm.params.items():
        for w, ref in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(ref),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{op}/{w}")


def test_step_losses_are_per_step_through_the_static_buffers():
    """Every train_step returns a view of one static loss buffer; fit
    keeps a copy per step, so its losses are the steps' own."""
    ids = _ids(4, 6)
    pm, ref = _port(), _port()
    pm.fit(ids[:, :-1], ids[:, 1:], epochs=1, shuffle=False, verbose=False)
    losses, first = [], None
    for i in range(0, 6, B):
        *_, loss, _ = ref.compiled.train_step(
            ref.params, ref.opt_state, ref.state,
            [torch.from_numpy(ids[i:i + B, :-1])],
            torch.from_numpy(ids[i:i + B, 1:]))
        first = loss if first is None else first
        losses.append(float(loss))
    assert first.data_ptr() == loss.data_ptr()  # one static buffer
    assert float(first) == losses[-1]
    assert len(set(losses)) == 3
    assert pm.step_losses == losses


def test_iter_traced_yields_the_batches_of_iter_in_order():
    pm = _port()
    x = np.arange(11 * 3, dtype=np.int32).reshape(11, 3)
    y = np.arange(11, dtype=np.int32)
    plain = list(SingleDataLoader(pm.compiled, [x], y, 2, seed=5))
    traced = list(SingleDataLoader(pm.compiled, [x], y, 2,
                                   seed=5).iter_traced(2))
    assert [k for k, *_ in traced] == ["stack", "stack", "single"]
    flat = []
    for kind, xs, lab in traced:
        if kind == "stack":
            assert xs[0].shape == (2, 2, 3) and lab.shape == (2, 2)
            flat += [([xs[0][i]], lab[i]) for i in range(2)]
        else:
            flat.append((xs, lab))
    assert len(flat) == len(plain) == 5
    for (px, py), (tx, ty) in zip(plain, flat):
        assert torch.equal(px[0], tx[0]) and torch.equal(py, ty)
    jm = _jax()
    jl = JaxLoader(jm.compiled, [x], y, 2, seed=5)
    for (kind, jx, jy), (_, tx, ty) in zip(jl.iter_traced(2), traced):
        np.testing.assert_array_equal(tx[0].numpy(), np.asarray(jx[0]))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
DECODE = dict(vocab=128, num_layers=2, hidden=32, num_heads=2, ff_dim=32,
              page_size=4, pages_per_seq=4)


def _frames():
    rng = np.random.default_rng(6)
    table = np.arange(4 * 4, dtype=np.int32).reshape(4, 4)
    return [(rng.integers(0, 128, size=(4, 1)).astype(np.int32), table,
             np.full(4, f, np.int32)) for f in range(3)]


def test_decode_frames_over_static_buffers_equal_the_eager_frames():
    pm = build_gpt_decode(FFConfig(batch_size=4, device="cpu",
                                   compute_dtype="float32"), **DECODE)
    pm.compile(comp_mode="inference")
    start = {k: v.clone() for k, v in pm.state.items()}
    step = compiled_decode_step(pm)
    got = [step(*f) for f in _frames()]
    kept = [g.clone() for g in got]
    assert len({g.data_ptr() for g in got}) == 3  # copies, not the buffer
    for g, k in zip(got, kept):
        assert torch.equal(g, k)  # not overwritten by a later frame
    assert not torch.equal(got[0], got[1])
    state = {k: v.clone() for k, v in start.items()}
    for f, g in zip(_frames(), got):
        want, state = pm.compiled.apply(
            pm.params, state, [torch.from_numpy(a) for a in f])
        assert torch.equal(g, want)
    for k, v in state.items():
        assert torch.equal(step.state["state"][k], v), k
    assert step.graph.report() == []  # the CPU captures nothing


def test_eager_changes_nothing_on_the_cpu():
    pm = build_gpt_decode(FFConfig(batch_size=4, device="cpu",
                                   compute_dtype="float32"), **DECODE)
    pm.compile(comp_mode="inference")
    start = {k: v.clone() for k, v in pm.state.items()}
    a = [compiled_decode_step(pm)(*f) for f in _frames()]
    for k, v in start.items():
        pm.state[k].copy_(v)
    with eager():
        b = [compiled_decode_step(pm)(*f) for f in _frames()]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ids = _ids(7, 4)
    one, two = _port(), _port()
    _fit(one, ids, epochs=1)
    with eager():
        _fit(two, ids, epochs=1)
    assert one.step_losses == two.step_losses


def test_step_graph_keys_by_shape_and_aliases_its_outputs():
    sg = StepGraph("cpu")
    w = torch.ones(3)

    def fn(x):
        w.add_(x.sum())
        return {"y": x * w}

    a = sg(fn, [np.ones((2, 3), np.float32)], [w])["y"]
    b = sg(fn, [torch.full((2, 3), 2.0)], [w])["y"]
    assert a.data_ptr() == b.data_ptr()  # one static output buffer
    assert torch.equal(b, torch.full((2, 3), 2.0 * 19.0))
    c = sg(fn, [torch.ones(1, 3)], [w])["y"]  # another key
    assert c.shape == (1, 3) and c.data_ptr() != b.data_ptr()
    assert float(w[0]) == 22.0
