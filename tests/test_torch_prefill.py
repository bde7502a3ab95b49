"""The port's chunked prefill lane against prefill through decode frames
and against the JAX package (tests/test_prefill.py's contracts).

* Token identity: on the same model and prompts of lengths 1, 2, 5, 9,
  12, 17 and 23 (single-token, exact chunk boundaries, ragged tails),
  the chunked lane (chunk 8) generates exactly the tokens of prefill
  through decode frames, in fp32 and int8 pools; and exactly the tokens
  the JAX package's chunked executor generates on copied weights.
* ``build_chunk_forward`` runs only the nodes upstream of the last
  decode-attention op, and refuses a graph that is not a decode graph;
  ``prefill_weight_bridge`` maps ``build_gpt_prefill``'s weights onto
  the decode graph's as the reference's does.
* TTFT splits exactly into queue + prefill + first frame, and every
  event the lane emits validates under both packages' schemas.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView
from flexflow_tpu.model import _adopt_kv_dtype as jax_adopt_kv_dtype
from flexflow_tpu.models import build_gpt_decode as jax_build_gpt_decode
from flexflow_tpu.models import derive_prefill_model as jax_derive_prefill
from flexflow_tpu.obs.events import validate_event as jax_validate_event
from flexflow_tpu.runtime import decode as jax_decode
from flexflow_tpu.runtime.prefill import (
    prefill_weight_bridge as jax_prefill_weight_bridge,
)
from flexflow_tpu_torch import FFConfig
from flexflow_tpu_torch.interop import params_from_numpy, state_from_numpy
from flexflow_tpu_torch.models import (
    build_gpt,
    build_gpt_decode,
    build_gpt_prefill,
    derive_prefill_model,
)
from flexflow_tpu_torch.obs.events import BUS, validate_event
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    compiled_decode_step,
)
from flexflow_tpu_torch.runtime.prefill import (
    build_chunk_forward,
    prefill_weight_bridge,
)

SMALL_KW = dict(vocab=256, num_layers=2, hidden=64, num_heads=4,
                ff_dim=64, page_size=4, pages_per_seq=8)
SLOTS = 4
LENGTHS = (1, 2, 5, 9, 12, 17, 23)
CHUNK = 8

_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(pool: str):
    """(jax model, port model) with ``pool`` KV pools, the port holding
    the JAX model's weights.  Cached: a JAX compile costs seconds."""
    if pool not in _MODELS:
        jm = jax_build_gpt_decode(
            ff.FFConfig(batch_size=SLOTS, num_devices=1, cost_cache_file="",
                        compute_dtype="float32"), **SMALL_KW)
        jax_adopt_kv_dtype(jm.graph, pool)
        jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
                   comp_mode="inference", strategy={
                       n.guid: (n.op.fixed_machine_view()
                                or MachineView.trivial(
                                    n.op.output_shapes[0].ndim))
                       for n in jm.graph.topo_order()})
        pm = build_gpt_decode(
            FFConfig(batch_size=SLOTS, device="cpu", compute_dtype="float32",
                     kv_precision=pool), **SMALL_KW)
        pm.compile(comp_mode="inference")
        pm.params = params_from_numpy(
            {op: {w: np.asarray(v) for w, v in ws.items()}
             for op, ws in jm.params.items()})
        pm.state = state_from_numpy(
            {k: np.asarray(v) for k, v in jm.state.items()})
        _MODELS[pool] = (jm, pm)
    return _MODELS[pool]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 255, size=n).tolist() for n in LENGTHS]


def _serve(pm, chunk, prompts, max_new=4):
    for t in pm.state.values():
        t.zero_()
    step = compiled_decode_step(pm, prefill_chunk=chunk)
    ex = ContinuousBatchingExecutor(
        step, max_seqs=SLOTS, page_size=SMALL_KW["page_size"],
        pages_per_seq=SMALL_KW["pages_per_seq"],
        prefill_fn=getattr(step, "prefill", None), prefill_chunk=chunk)
    reqs = [DecodeRequest(rid=f"r{i}", prompt=list(p),
                          max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    return ex.run(reqs, max_frames=600), ex


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_chunked_prefill_token_identity_and_jax_tokens(pool):
    jm, pm = _models(pool)
    prompts = _prompts()
    via_decode, ex0 = _serve(pm, 0, prompts)
    chunked, ex1 = _serve(pm, CHUNK, prompts)
    assert chunked == via_decode
    assert ex1.prefill_tokens == sum(n - 1 for n in LENGTHS)
    assert ex1.prefill_chunks == sum(-(-(n - 1) // CHUNK)
                                     for n in LENGTHS if n > 1)
    assert ex1.frame < ex0.frame
    # the JAX package's chunked lane on the same weights
    jstep = jax_decode.compiled_decode_step(jm, prefill_chunk=CHUNK)
    jex = jax_decode.ContinuousBatchingExecutor(
        jstep, max_seqs=SLOTS, page_size=SMALL_KW["page_size"],
        pages_per_seq=SMALL_KW["pages_per_seq"], prefill_fn=jstep.prefill,
        prefill_chunk=CHUNK)
    ref = jex.run([jax_decode.DecodeRequest(rid=f"r{i}", prompt=list(p),
                                            max_new_tokens=4)
                   for i, p in enumerate(prompts)], max_frames=600)
    assert chunked == ref
    assert ex1.frame == jex.frame and ex1.summary()["prefill_chunks"] == (
        jex.summary()["prefill_chunks"])


def test_chunk_forward_runs_only_what_feeds_the_cache():
    """The chunk pass needs no final LayerNorm and no lm_head: it runs
    with their weights removed, and writes the same pools as the step
    function's ``prefill``."""
    _, pm = _models("fp32")
    for t in pm.state.values():
        t.zero_()
    params = {op: ws for op, ws in pm.params.items()
              if op not in ("final_ln", "lm_head")}
    fwd = build_chunk_forward(pm.graph, torch.float32)
    ids = torch.tensor([[5, 6, 7, 8, 9]], dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32)[None]
    table = torch.arange(8, dtype=torch.int32)[None]
    state = fwd(params, dict(pm.state), ids, pos, table)
    got = {k: v.clone() for k, v in state.items()}
    for t in pm.state.values():
        t.zero_()
    compiled_decode_step(pm, prefill_chunk=5).prefill(
        ids.numpy(), pos.numpy(), table.numpy())
    for k, v in got.items():
        assert torch.equal(pm.state[k], v), k
    assert any(v.abs().max() > 0 for v in got.values())


def test_chunk_forward_rejects_non_decode_graph():
    m = build_gpt(FFConfig(batch_size=2, device="cpu"), vocab=16,
                  num_layers=1, hidden=8, num_heads=2, ff_dim=8, seq_len=4)
    with pytest.raises(ValueError, match="no DecodeAttentionOp"):
        build_chunk_forward(m.graph, torch.float32)


def test_prefill_weight_bridge_equals_the_reference():
    cfg = FFConfig(batch_size=SLOTS, device="cpu")
    dec = build_gpt_decode(cfg, **SMALL_KW)
    pre, pre_cfg = derive_prefill_model(dec.graph, cfg, seq_len=16)
    assert pre_cfg.batch_size == 1
    bridge = prefill_weight_bridge(pre.graph, dec.graph)
    jcfg = ff.FFConfig(batch_size=SLOTS, num_devices=1, cost_cache_file="")
    jdec = jax_build_gpt_decode(jcfg, **SMALL_KW)
    jpre, _ = jax_derive_prefill(jdec.graph, jcfg, seq_len=16)
    assert bridge == jax_prefill_weight_bridge(jpre.graph, jdec.graph)
    assert "pos_embed/table" in bridge and "lm_head/kernel" in bridge
    # a vocab mismatch does not ride the positional prefix rule
    wrong = build_gpt_prefill(
        cfg, **{**{k: v for k, v in SMALL_KW.items()
                   if k not in ("page_size", "pages_per_seq")},
                "vocab": 128}, seq_len=16)
    with pytest.raises(ValueError, match="shape mismatch"):
        prefill_weight_bridge(wrong.graph, dec.graph)


def test_ttft_splits_into_queue_prefill_first_frame(tmp_path):
    _, pm = _models("fp32")
    log = str(tmp_path / "obs.jsonl")
    BUS.configure(log)
    try:
        _, ex = _serve(pm, 4, [[1, 2, 3, 4, 5, 6, 7], [9]])
        s = ex.summary()
        assert s["requests_recorded"] == 2
        for r in ex.request_records:
            assert r["phase"] == "finish"
            assert r["ttft_s"] == pytest.approx(
                r["queue_s"] + r["prefill_s"] + r["first_frame_s"],
                rel=1e-6, abs=1e-9)
        assert s["prefill_p50_s"] is not None
        assert s["first_frame_p99_s"] is not None
        BUS.flush()
        with open(log) as f:
            events = [json.loads(line) for line in f]
    finally:
        BUS.close()
    for e in events:
        assert validate_event(e) == [] == jax_validate_event(e)
    kinds = {e["kind"] for e in events}
    assert {"decode.prefill", "decode.frame", "decode.request",
            "decode.summary"} <= kinds
