"""The port's serving path against the JAX package's: the decode model
built in both packages with the JAX weights copied across
(``params_from_numpy``), per-frame logits within 1e-4 abs (fp32 compute,
summation order differs), and the continuous-batching executors giving
identical greedy tokens on the same seeded requests, on a slot-aligned
pool and on an oversubscribed pool with a scratch page."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView
from flexflow_tpu.models import build_gpt_decode as jax_build_gpt_decode
from flexflow_tpu.runtime import decode as jax_decode
from flexflow_tpu_torch import FFConfig
from flexflow_tpu_torch.interop import params_from_numpy, state_from_numpy
from flexflow_tpu_torch.models import build_gpt_decode
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    compiled_decode_step,
)

B = 4
KW = dict(vocab=128, num_layers=2, hidden=64, num_heads=4, ff_dim=64,
          page_size=8, pages_per_seq=4)
POOLS = {"slot_aligned": 0, "oversubscribed": 2 * KW["pages_per_seq"] + 1}
LOGITS_TOL = 1e-4

_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from threads; one keeps this file from
    crowding the other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(pool: str):
    """(jax model, port model) for one pool size, the port's params and
    state copied from the JAX model's.  Cached: each JAX compile costs
    seconds."""
    if pool not in _MODELS:
        num_pages = POOLS[pool]
        jcfg = ff.FFConfig(batch_size=B, num_devices=1, cost_cache_file="",
                           compute_dtype="float32")
        jm = jax_build_gpt_decode(jcfg, num_pages=num_pages, **KW)
        jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
                   comp_mode="inference", strategy={
                       n.guid: (n.op.fixed_machine_view()
                                or MachineView.trivial(
                                    n.op.output_shapes[0].ndim))
                       for n in jm.graph.topo_order()})
        pm = build_gpt_decode(FFConfig(batch_size=B, device="cpu",
                                       compute_dtype="float32"),
                              num_pages=num_pages, **KW)
        pm.compile(comp_mode="inference")
        assert {op: set(ws) for op, ws in pm.params.items()} == {
            op: set(ws) for op, ws in jm.params.items()}
        pm.params = params_from_numpy(
            {op: {w: np.asarray(v) for w, v in ws.items()}
             for op, ws in jm.params.items()})
        pm.state = state_from_numpy(
            {k: np.asarray(v) for k, v in jm.state.items()})
        _MODELS[pool] = (jm, pm)
    return _MODELS[pool]


def _requests(seed=0, n=7):
    rng = np.random.default_rng(seed)
    return [DecodeRequest(rid=f"r{i}",
                          prompt=rng.integers(0, KW["vocab"],
                                              size=int(rng.integers(1, 7))
                                              ).tolist(),
                          max_new_tokens=int(rng.integers(2, 7)))
            for i in range(n)]


def _reset(pm):
    for t in pm.state.values():
        t.zero_()


def test_decode_model_logits_match_jax_per_frame():
    jm, pm = _models("slot_aligned")
    _reset(pm)
    jstep = jax_decode.compiled_decode_step(jm)
    step = compiled_decode_step(pm)
    rng = np.random.default_rng(1)
    pps = KW["pages_per_seq"]
    table = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    start = np.asarray([0, 3, 7, 12], np.int32)
    for t in range(6):
        ids = rng.integers(0, KW["vocab"], size=(B, 1)).astype(np.int32)
        lens = start + t
        ref = np.asarray(jstep(ids, table, lens))
        got = step(ids, table, lens).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_TOL,
                                   err_msg=f"frame {t}")


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_executor_greedy_tokens_match_jax(pool):
    jm, pm = _models(pool)
    _reset(pm)
    kw = dict(max_seqs=B, page_size=KW["page_size"],
              pages_per_seq=KW["pages_per_seq"], num_pages=POOLS[pool])
    jex = jax_decode.ContinuousBatchingExecutor(
        jax_decode.compiled_decode_step(jm), **kw)
    ref = jex.run([jax_decode.DecodeRequest(rid=r.rid, prompt=r.prompt,
                                            max_new_tokens=r.max_new_tokens)
                   for r in _requests()])
    ex = ContinuousBatchingExecutor(compiled_decode_step(pm), **kw)
    got = ex.run(_requests())
    assert got == ref
    assert ex.slot_aligned == (pool == "slot_aligned")
    assert ex.frame == jex.frame
    assert ex.allocator.pages_in_use == (0 if pool == "slot_aligned" else 1)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_batched_equals_solo(pool):
    _, pm = _models(pool)
    kw = dict(max_seqs=B, page_size=KW["page_size"],
              pages_per_seq=KW["pages_per_seq"], num_pages=POOLS[pool])
    _reset(pm)
    batched = ContinuousBatchingExecutor(
        compiled_decode_step(pm), **kw).run(_requests(seed=2))
    for r in _requests(seed=2)[:2]:
        _reset(pm)
        alone = ContinuousBatchingExecutor(
            compiled_decode_step(pm), **kw).run([r])
        assert alone[r.rid] == batched[r.rid]


def test_executor_refuses_oversized_and_empty_requests():
    ex = ContinuousBatchingExecutor(lambda *a: None, max_seqs=2,
                                    page_size=2, pages_per_seq=2)
    with pytest.raises(ValueError):
        ex.submit([DecodeRequest(rid="big", prompt=[1, 2, 3],
                                 max_new_tokens=2)])
    with pytest.raises(ValueError):
        ex.submit([DecodeRequest(rid="empty", prompt=[])])


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gpt_decode(FFConfig(batch_size=B), **KW)


def test_training_compile_waits_for_its_slice():
    """The training slice has landed: comp_mode="training" compiles,
    with the default SGD optimizer and its state; inference compiles
    carry no optimizer state."""
    pm = build_gpt_decode(FFConfig(batch_size=B, device="cpu"), **KW)
    pm.compile(comp_mode="training")
    assert pm.config.comp_mode == "training"
    assert pm.opt_state == {"step": 0}
    assert pm.compiled.optimizer is pm.optimizer
    pm.compile(comp_mode="inference")
    assert pm.opt_state is None and pm.compiled.optimizer is None
