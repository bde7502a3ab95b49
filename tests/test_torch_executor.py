"""The port's continuous-batching executor: refcounted pages, radix
prefix sharing with copy-on-write, SLO classes (priority admission,
deadline expiry, preemption) and the int8 lane's compile — the
contracts of tests/test_kv.py:93-230 and tests/test_prefill.py:251-340,
held on the port; and the same seeded trace through both packages'
executors giving equal results.

Models are tiny (1 layer, hidden 32) and run on the CPU.  Exceptions
differ from the reference on purpose: where it asserts, the port raises
ValueError (a bad page operation) or RuntimeError (a broken
reserve-on-divergence invariant).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flexflow_tpu.config import parse_slo_classes as jax_parse_slo_classes
from flexflow_tpu.runtime import decode as jax_decode
from flexflow_tpu_torch import FFConfig
from flexflow_tpu_torch.config import parse_slo_classes
from flexflow_tpu_torch.model import _adopt_kv_dtype
from flexflow_tpu_torch.models import build_gpt_decode
from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp
from flexflow_tpu_torch.runtime import decode as port_decode
from flexflow_tpu_torch.runtime.decode import (
    ContinuousBatchingExecutor,
    DecodeRequest,
    PageAllocator,
    SLOClass,
    compiled_decode_step,
)

SYS_PROMPT = list(range(10, 26))  # 16 tokens = 4 full pages of 4
SHARING_KW = dict(vocab=128, num_layers=1, hidden=32, num_heads=2,
                  ff_dim=32, page_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharing_model(pages_per_seq=8, batch=4, kv_precision="off"):
    m = build_gpt_decode(FFConfig(batch_size=batch, device="cpu",
                                  compute_dtype="float32",
                                  kv_precision=kv_precision),
                         pages_per_seq=pages_per_seq, **SHARING_KW)
    m.compile(comp_mode="inference")
    return m


def _run(step, reqs, *, sharing, num_pages, max_seqs=4, pages_per_seq=8,
         submit_later=()):
    """Drive the executor to completion through the chunked lane,
    tracking peak concurrency; ``submit_later`` holds (frame, requests)
    injections."""
    ex = ContinuousBatchingExecutor(
        step, max_seqs=max_seqs, page_size=4, pages_per_seq=pages_per_seq,
        num_pages=num_pages, prefill_fn=step.prefill, prefill_chunk=4,
        prefix_sharing=sharing,
        copy_page_fn=step.copy_page if sharing else None)
    ex.submit(reqs)
    later = sorted(submit_later, key=lambda x: x[0])
    peak = 0
    while ex.queue or any(s is not None for s in ex.slots) or later:
        assert ex.frame < 500, "kv sharing test run stuck"
        while later and later[0][0] <= ex.frame:
            ex.submit(later.pop(0)[1])
        ex.step()
        peak = max(peak, sum(s is not None for s in ex.slots))
    return ex, dict(ex.finished), peak


# ---------------------------------------------------------------------------
def test_page_allocator_refcount_cow_trie():
    pa = PageAllocator(8)
    pages = pa.alloc(3)
    tokens = list(range(100, 110))  # 2.5 pages of 4
    pa.register_prefix(tokens, 4, pages, cached=9)  # 2 full pages
    got, matched, partial = pa.lookup_prefix(tokens[:8], 4)
    assert got == pages[:2] and matched == 8 and partial is None
    sibling = tokens[:9] + [999, 998]
    got, matched, partial = pa.lookup_prefix(sibling, 4)
    assert got == pages[:2] and matched == 8 and partial is None
    pa.register_prefix(tokens + [55, 66], 4, pages, cached=12)
    got, matched, partial = pa.lookup_prefix(sibling, 4)
    assert partial == (pages[2], 1)  # agrees on one token mid-page
    pa.share(pages[:2])
    assert pa.refcount(pages[0]) == 2
    with pytest.raises(RuntimeError, match="reserve-on-divergence"):
        pa.assert_divergence_reserved(pages[:2], 0)
    pa.assert_divergence_reserved(pages[:2], 2)
    pa.free(pages)
    assert pa.refcount(pages[0]) == 1 and pa.refcount(pages[2]) == 0
    assert pa.lookup_prefix(sibling, 4)[2] is None  # its entry is gone
    pa.free([pages[0], pages[1]])
    with pytest.raises(ValueError, match="stale"):
        pa.share([pages[0]])
    with pytest.raises(ValueError, match="not in use"):
        pa.free([pages[0]])
    assert pa.free_pages == 8


@pytest.mark.parametrize("kv_precision", ["off", "int8"])
def test_prefix_sharing_concurrency_and_token_identity(kv_precision):
    """At a fixed 21-page pool the unshared executor fits 2 concurrent
    sequences, the shared one 4; the mid-page divergent request is
    copied on write; every request's tokens equal serving it alone."""
    m = _sharing_model(kv_precision=kv_precision)
    step = compiled_decode_step(m, prefill_chunk=4)

    def reqs():
        return [
            DecodeRequest(rid="r0", prompt=SYS_PROMPT + [100, 101, 102,
                                                         103, 104, 105],
                          max_new_tokens=8),
            DecodeRequest(rid="r1", prompt=SYS_PROMPT + [30, 31],
                          max_new_tokens=2),
            DecodeRequest(rid="r2", prompt=SYS_PROMPT + [40, 41],
                          max_new_tokens=2),
            DecodeRequest(rid="r3", prompt=SYS_PROMPT + [50, 52],
                          max_new_tokens=2),
            # agrees with r0's fifth page on 2 tokens: copy-on-write
            DecodeRequest(rid="rc", prompt=SYS_PROMPT + [100, 101, 110],
                          max_new_tokens=2),
        ]

    pool = 21  # 1 scratch + 2 full 8-page allotments + change
    _, out_off, peak_off = _run(step, reqs(), sharing=False, num_pages=pool)
    ex, out_on, peak_on = _run(step, reqs(), sharing=True, num_pages=pool)
    solo = {}
    for r in reqs():
        solo.update(_run(step, [r], sharing=False, num_pages=0)[1])
    assert out_off == solo and out_on == solo
    assert peak_off == 2 and peak_on >= 2 * peak_off
    s = ex.summary()
    assert s["prefix_hits"] >= 4
    assert s["shared_pages"] >= 12 and s["prefix_tokens"] >= 48
    assert s["cow_copies"] >= 1
    assert s["private_pages"] == ex.total_admitted * 8 - s["shared_pages"]
    assert ex.allocator.free_pages == pool - 1  # the scratch page held
    ex_off = _run(step, reqs()[:2], sharing=False, num_pages=0)[0]
    assert "prefix_hits" not in ex_off.summary()


def test_copy_page_copies_every_pool_and_scale():
    m = _sharing_model(kv_precision="int8")
    step = compiled_decode_step(m)
    for t in m.state.values():
        t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
    step.copy_page(3, 7)
    keys = sorted(m.state)
    assert [k.rsplit("/", 1)[1] for k in keys] == [
        "k_cache", "k_scale", "v_cache", "v_scale"]
    for k in keys:
        assert torch.equal(m.state[k][7], m.state[k][3]), k


def test_preemption_and_expiry_with_shared_pages():
    m = _sharing_model(pages_per_seq=6, batch=2)
    step = compiled_decode_step(m, prefill_chunk=4)
    l0 = DecodeRequest(rid="l0", prompt=SYS_PROMPT + [100, 101, 102, 103],
                       max_new_tokens=4)
    l1 = DecodeRequest(rid="l1", prompt=SYS_PROMPT + [30, 31],
                       max_new_tokens=4)
    e = DecodeRequest(rid="e", prompt=[1, 2], max_new_tokens=2,
                      deadline_frames=1)
    h = DecodeRequest(rid="h", prompt=SYS_PROMPT + [60, 61],
                      max_new_tokens=2, priority=5)
    pool = 13
    ex, out, _ = _run(step, [l0, l1, e], sharing=True, num_pages=pool,
                      max_seqs=2, pages_per_seq=6, submit_later=[(1, [h])])
    assert ex.total_preempted == 1 and ex.total_expired == 1
    assert "e" in ex.expired and set(out) == {"l0", "l1", "h"}
    solo = {}
    for r in (l0, l1, h):
        solo.update(_run(step, [DecodeRequest(
            rid=r.rid, prompt=list(r.prompt),
            max_new_tokens=r.max_new_tokens)], sharing=False, num_pages=0,
            max_seqs=2, pages_per_seq=6)[1])
    assert out == solo  # l1's stream continues across its preemption
    assert ex.summary()["prefix_hits"] >= 2
    assert ex.allocator.free_pages == pool - 1


# ---------------------------------------------------------------------------
def _synthetic_logits(ids, lens, vocab=97):
    nxt = (np.asarray(ids)[:, 0] * 7 + np.asarray(lens) * 13 + 5) % vocab
    logits = np.zeros((len(nxt), 1, vocab), np.float32)
    logits[np.arange(len(nxt)), 0, nxt] = 1.0
    return logits


def _synthetic_step(ids, table, lens):
    return torch.from_numpy(_synthetic_logits(ids, lens))


SLO_TABLE = (
    SLOClass("interactive", priority=2, deadline_frames=0),
    SLOClass("standard", priority=1, deadline_frames=0),
    SLOClass("batch", priority=0, deadline_frames=0),
)


def test_priority_admission_order():
    ex = ContinuousBatchingExecutor(_synthetic_step, max_seqs=1,
                                    page_size=4, pages_per_seq=4,
                                    slo_classes=SLO_TABLE)
    ex.submit([DecodeRequest(rid="batch", prompt=[1], max_new_tokens=2,
                             slo="batch"),
               DecodeRequest(rid="inter", prompt=[2], max_new_tokens=2,
                             slo="interactive")])
    ex.step()
    live = [s for s in ex.slots if s is not None]
    assert live and live[0].req.rid == "inter"
    ex.run(max_frames=50)
    assert set(ex.finished) == {"batch", "inter"}


def test_deadline_expiry_refuses_late_service():
    ex = ContinuousBatchingExecutor(_synthetic_step, max_seqs=1,
                                    page_size=4, pages_per_seq=4)
    ex.submit([DecodeRequest(rid="long", prompt=[1], max_new_tokens=10),
               DecodeRequest(rid="dead", prompt=[2], max_new_tokens=2,
                             deadline_frames=3)])
    out = ex.run(max_frames=100)
    assert "dead" not in out and "dead" in ex.expired
    assert ex.total_expired == 1 and len(out["long"]) == 10


def test_preemption_by_higher_priority_continues_stream():
    expect = ContinuousBatchingExecutor(
        _synthetic_step, max_seqs=1, page_size=4, pages_per_seq=4).run(
        [DecodeRequest(rid="low", prompt=[3, 4], max_new_tokens=6)])
    ex = ContinuousBatchingExecutor(_synthetic_step, max_seqs=1,
                                    page_size=4, pages_per_seq=4,
                                    slo_classes=SLO_TABLE)
    ex.submit([DecodeRequest(rid="low", prompt=[3, 4], max_new_tokens=6,
                             slo="batch")])
    ex.step()
    assert ex.slots[0] is not None and ex.slots[0].req.rid == "low"
    ex.submit([DecodeRequest(rid="hi", prompt=[9], max_new_tokens=2,
                             slo="interactive")])
    out = ex.run(max_frames=100)
    assert ex.total_preempted == 1
    assert out["low"] == expect["low"] and len(out["hi"]) == 2


def _seeded_trace(pkg, step, copies, prefills):
    """A seeded ragged arrival trace with mixed classes, deadlines, pool
    pressure, prefix sharing and the chunked lane through ``pkg``'s
    executor.  The page copier and the prefill writer only record."""
    rng = np.random.default_rng(11)
    table = tuple(pkg.SLOClass(c.name, c.priority, c.deadline_frames)
                  for c in SLO_TABLE)
    ex = pkg.ContinuousBatchingExecutor(
        step, max_seqs=3, page_size=4, pages_per_seq=4, num_pages=10,
        slo_classes=table, prefix_sharing=True,
        copy_page_fn=lambda s, d: copies.append((s, d)),
        prefill_fn=lambda ids, pos, pt: prefills.append(
            (ids.tolist(), pos.tolist(), pt.tolist())),
        prefill_chunk=3)
    shared = [41, 42, 43, 44, 45, 46]
    for wave in range(5):
        reqs = []
        for j in range(3):
            cls = ("interactive", "standard", "batch")[
                int(rng.integers(0, 3))]
            n = int(rng.integers(1, 6))
            prompt = list(map(int, rng.integers(1, 96, size=n)))
            if rng.random() < 0.5:
                prompt = shared[:int(rng.integers(3, 7))] + prompt
            reqs.append(pkg.DecodeRequest(
                rid=f"w{wave}r{j}", prompt=prompt,
                max_new_tokens=int(rng.integers(1, 5)), slo=cls,
                deadline_frames=(2 if cls == "batch" else None)))
        ex.submit(reqs)
        for _ in range(3):
            ex.step()
    ex.run(max_frames=300)
    return ex


def test_both_executors_agree_on_a_seeded_trace():
    jcopies, jpre, copies, pre = [], [], [], []
    jex = _seeded_trace(
        jax_decode, lambda i, t, n: _synthetic_logits(i, n), jcopies, jpre)
    ex = _seeded_trace(port_decode, _synthetic_step, copies, pre)
    assert ex.finished == jex.finished and ex.expired == jex.expired
    assert copies == jcopies and pre == jpre
    timed = {"measured_p50_s", "measured_p99_s"}
    s, js = ex.summary(), jex.summary()
    assert set(s) == set(js)
    assert {k: v for k, v in s.items() if k not in timed} == {
        k: v for k, v in js.items() if k not in timed}
    assert s["preempted"] > 0 and s["expired"] > 0 and s["prefix_hits"] > 0


def test_measured_request_p99_per_class(tmp_path):
    BUS.configure(str(tmp_path / "obs.jsonl"))
    try:
        ex = ContinuousBatchingExecutor(_synthetic_step, max_seqs=2,
                                        page_size=4, pages_per_seq=4,
                                        slo_classes=SLO_TABLE)
        ex.run([DecodeRequest(rid=f"r{i}", prompt=[1 + i],
                              max_new_tokens=2,
                              slo=("interactive" if i % 2 else "batch"))
                for i in range(6)], max_frames=60)
        s = ex.summary()
    finally:
        BUS.close()
    assert set(s["slo_classes"]) == {"interactive", "batch"}
    for name in ("interactive", "batch"):
        v = ex.measured_request_p99("ttft_s", slo=name)
        assert v is not None and v > 0
    assert ex.measured_request_p99("ttft_s") is not None
    ex.predicted_step_s = 1e-9
    report = ex.decode_drift_report()
    assert report is not None and report.phases["decode"]["ratio"] > 1


# ---------------------------------------------------------------------------
def test_kv_precision_through_compile():
    """int8 through compile gives int8 pools with [P, page_size] fp32
    scales; "search" is accepted (the serve-objective search prices the
    dtypes: tests/test_torch_serve_search.py); fp32 adoption is an exact
    no-op (test_kv.py:234)."""
    m = _sharing_model(pages_per_seq=4, kv_precision="int8")
    ops = [n.op for n in m.graph.topo_order()
           if isinstance(n.op, DecodeAttentionOp)]
    assert ops and all(op.attrs["kv_dtype"] == "int8" for op in ops)
    p = ops[0].attrs["num_pages"]
    assert m.state["layer0_mha/k_cache"].dtype == torch.int8
    assert m.state["layer0_mha/v_cache"].shape == (p, 4, 2, 16)
    for name in ("k_scale", "v_scale"):
        t = m.state[f"layer0_mha/{name}"]
        assert t.dtype == torch.float32 and t.shape == (p, 4)
    assert FFConfig(device="cpu", kv_precision="search").kv_precision == (
        "search")
    with pytest.raises(ValueError):
        FFConfig(device="cpu", kv_precision="fp8")

    fresh = build_gpt_decode(FFConfig(batch_size=4, device="cpu"),
                             pages_per_seq=4, **SHARING_KW)
    before = dict(fresh.graph.nodes)
    for dtype in ("fp32", None, "off"):
        _adopt_kv_dtype(fresh.graph, dtype)
    assert all(fresh.graph.nodes[g] is n for g, n in before.items())
    assert all("kv_dtype" not in n.op.attrs for n in before.values()
               if isinstance(n.op, DecodeAttentionOp))
    _adopt_kv_dtype(fresh.graph, "bf16")
    assert {n.op.attrs.get("kv_dtype") for n in fresh.graph.topo_order()
            if isinstance(n.op, DecodeAttentionOp)} == {"bf16"}


@pytest.mark.parametrize("spec", [
    "interactive:1:0,batch:0:0",
    "a:2:64:0.9,b:0:0:0.5:3",
    [{"name": "x", "priority": 1}],
])
def test_parse_slo_classes_equals_the_reference(spec):
    assert parse_slo_classes(spec) == jax_parse_slo_classes(spec)
    cfg = FFConfig(device="cpu", serve_slo_classes=spec)
    assert cfg.serve_slo_classes == jax_parse_slo_classes(spec)
    with pytest.raises(ValueError):
        parse_slo_classes("a:1")
