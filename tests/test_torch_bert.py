"""``build_bert`` in the port against the JAX package's, with attention
dropout, remat and gradient accumulation.

``build_bert`` at 2 layers, hidden 32, 2 heads, ff 64, seq 16, attention
dropout 0.1, batch 4, fp32, SGD (lr 0.05, so a weight's update is its
gradient's and the weights compare at 1e-5), from the JAX model's
weights.  The masks are the reference's own, drawn with its key chain
and handed to the port (tests/test_torch_dropout.py's
``reference_masks``; under ``grad_accum_steps=2`` each microbatch takes
its ``jax.random.split`` key, as the reference's ``_raw_step_accum``).

1. 3 training steps: losses and weights within 1e-5 of the reference's;
   under the reference's remat, losses within rtol 1e-6 (as
   tests/test_preprocessing_remat.py:60 holds its own); under
   ``grad_accum_steps=2`` against the reference's ``ga=2`` within 1e-5.
2. One ``evaluate`` at seq 512: the flash route on both sides (recorded
   by wrapping each package's ``flash_attention``), losses within 1e-5.
3. The port alone, its own masks: remat on against off, 3 steps, losses
   and weights bit-equal; ``grad_accum_steps=2`` against 1 within 1e-5
   (tests/test_end_to_end.py:141's limit): a microbatch draws its rows
   of the whole batch's masks.
4. A gloo world of 2, data parallel with ``grad_accum_steps=2``:
   first-step loss within 1e-5 of one process's and the replicas
   bit-equal after 2 steps (tests/test_torch_checkpoint.py's world).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.models import build_bert as jax_build_bert
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.models import build_bert
from flexflow_tpu_torch.ops.base import LoweringContext

from test_torch_checkpoint import _bert, _bert_data, _step_on, world
from test_torch_dropout import reference_masks

BERT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
            seq_len=16, num_classes=2, dropout=0.1)
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=["accuracy"])
LR = 0.05
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(bert=BERT, batch=4, **cfg):
    jm = jax_build_bert(ff.FFConfig(batch_size=batch, num_devices=1,
                                    compute_dtype="float32",
                                    cost_cache_file="", **cfg), **bert)
    jm.compile(optimizer=ff.SGDOptimizer(lr=LR),
               strategy={n.guid: JView.trivial(n.op.output_shapes[0].ndim)
                         for n in jm.graph.topo_order()}, **CCE)
    pm = build_bert(tff.FFConfig(batch_size=batch, device="cpu",
                                 compute_dtype="float32",
                                 only_data_parallel=True, **cfg), **bert)
    pm.compile(optimizer=tff.SGDOptimizer(lr=LR), **CCE)
    pm.params = params_from_numpy({op: {w: np.array(v) for w, v in ws.items()}
                                   for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)
    return jm, pm


def _data(seq=16, n=4 * STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, BERT["vocab"], size=(n, seq)).astype(np.int32),
            rng.integers(0, 2, size=(n,)).astype(np.int32))


def _train_both(jm, pm, monkeypatch, ga=1):
    monkeypatch.setattr(LoweringContext, "mask_source", reference_masks(ga))
    x, y = _data()
    jl, pl = [], []
    for step in range(1, STEPS + 1):
        rows = slice(4 * (step - 1), 4 * step)
        jm.params, jm.opt_state, jm.state, loss, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state, jax.random.key(step),
            [jnp.asarray(x[rows])], jnp.asarray(y[rows]))
        jl.append(float(loss))
        pm.params, pm.opt_state, pm.state, loss, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state, [torch.from_numpy(x[rows])],
            torch.from_numpy(y[rows]), seed=step)
        pl.append(float(loss))
    monkeypatch.setattr(LoweringContext, "mask_source", None)
    return jl, pl


def _assert_weights(jm, pm):
    got = params_to_numpy(pm.params)
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(v), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{op}/{w}")


@pytest.mark.parametrize("case", ["plain", "remat", "ga2"])
def test_bert_trains_like_the_reference(case, monkeypatch):
    cfg = {"plain": {}, "remat": {"remat": True},
           "ga2": {"grad_accum_steps": 2}}[case]
    jm, pm = _pair(**cfg)
    jl, pl = _train_both(jm, pm, monkeypatch,
                         ga=cfg.get("grad_accum_steps", 1))
    np.testing.assert_allclose(pl, jl, rtol=1e-6 if case == "remat"
                               else 1e-5)
    _assert_weights(jm, pm)


def test_evaluate_at_seq_512_takes_the_flash_route_on_both_sides(
        monkeypatch):
    import importlib

    # the package's __init__ exports a function of the module's name
    jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")
    pattn = importlib.import_module("flexflow_tpu_torch.ops.attention")

    calls = {"jax": 0, "port": 0}
    jflash, pflash = jfa.flash_attention, pattn.flash_attention

    def jspy(*a, **k):
        calls["jax"] += 1
        return jflash(*a, **k)

    def pspy(*a, **k):
        calls["port"] += 1
        return pflash(*a, **k)

    monkeypatch.setattr(jfa, "flash_attention", jspy)
    monkeypatch.setattr(pattn, "flash_attention", pspy)
    bert = dict(BERT, seq_len=512)
    jm, pm = _pair(bert, batch=2)
    x, y = _data(seq=512, n=2, seed=3)
    jev = jm.evaluate(x, y, batch_size=2)
    pev = pm.evaluate(x, y, batch_size=2)
    assert calls["jax"] >= bert["num_layers"]
    assert calls["port"] == bert["num_layers"]
    assert abs(pev["loss"] - jev["loss"]) <= 1e-5 * abs(jev["loss"])
    assert pev["accuracy"] == jev["accuracy"]


def _port_run(**cfg):
    m = _bert(**cfg)
    x, y = _bert_data()
    losses = [_step_on(m, x[i:i + 4], y[i:i + 4]) for i in (0, 4, 8)]
    return losses, [t for ws in m.params.values() for t in ws.values()]


def test_remat_is_bit_equal_with_dropout():
    plain, wp = _port_run()
    remat, wr = _port_run(remat=True)
    assert remat == plain
    for a, b in zip(wp, wr):
        assert torch.equal(a, b)


def test_grad_accum_matches_one_microbatch_with_dropout():
    one, w1 = _port_run()
    two, w2 = _port_run(grad_accum_steps=2)
    np.testing.assert_allclose(two, one, rtol=1e-5)
    for a, b in zip(w1, w2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_data_parallel_grad_accum_world_matches_one_process(
        tmp_path_factory):
    ranks = world(tmp_path_factory, "world2")["ranks"]
    one = _bert(grad_accum_steps=2)
    x, y = _bert_data()
    first = _step_on(one, x[:4], y[:4])
    got = ranks[0]["losses"][0]
    assert abs(got - first) <= 1e-5 * abs(first)
    assert ranks[1]["losses"] == ranks[0]["losses"]
    blocks = {}
    for r in ranks:
        for w, (key, digest) in r["digests"].items():
            assert blocks.setdefault((w, key), digest) == digest, w
