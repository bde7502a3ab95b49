"""The port's decode graph under head and sequence-slot splits, against
the JAX package's decode graph compiled under the same strategy on its
CPU mesh.

A tiny ``build_gpt_decode`` (vocab 128, 2 layers, hidden 64, 4 heads,
ff 64, 8 frame slots, pages of 8 tokens, 4 pages per sequence, fp32
compute) is compiled for inference in both packages under three
strategies: a head split of 2 (the decode ops at replica degree 2,
every other op whole; a world of 2), a batch split of 2 (every op split
on its batch dim; a world of 2) and both (head 2 x batch 2; a world of
4), with fp32, bf16 and int8 KV pools.  The port's gloo ranks hold the
JAX model's weights (``params_from_numpy`` scatters them) and serve
the same seeded ragged requests through ``ContinuousBatchingExecutor``
three ways: prefill through decode frames, the chunked prefill lane
(chunks of 4), and the lane with prefix sharing behind a 12-token
common prefix (the free-list allotment, whose pages leave a rank's
range under a batch split).

* Every request's tokens equal the JAX package's, in every mode.
* The first 4 frames' logits match within ``LOGITS_TOL`` (fp32 and
  bf16 pools 1e-4, the summation order differs; int8 pools 2e-3: a
  K or V element one rounding step of its token's scale apart).
* Each rank's pools hold 1/degree of the whole pool (int8 scales:
  split with the pages, replicated over the head split); under prefix
  sharing the pools are whole on every rank of the batch group and
  the sequences' pages do leave their ranks' ranges.
* The int8 scale a head-split rank writes is the amax over every head
  (the reference's one scale row), not over its own heads.
* Every rank serves the same tokens.
* A step whose pools stay split refuses a free-list executor.

Each world is spawned once per run (``test_worlds.shared_world``); the
JAX references run in a thread of the same computation meanwhile.  The rank function imports
no JAX: the spawned ranks import this module to find it."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_worlds import shared_world

B = 8
KW = dict(vocab=128, num_layers=2, hidden=64, num_heads=4, ff_dim=64,
          page_size=8, pages_per_seq=4)
# name -> (ranks, batch degree, head degree)
SPLITS = {"head2": (2, 1, 2), "batch2": (2, 2, 1), "head2_batch2": (4, 2, 2)}
POOLS = ("fp32", "bf16", "int8")
MODES = ("frames", "lane", "sharing")
CHUNK = 4
FIRST_FRAMES = 4
PREFIX = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
LOGITS_TOL = {"fp32": 1e-4, "bf16": 1e-4, "int8": 2e-3}


def split_views(graph, view_cls, b, r):
    """The decode ops at (b, 1, 1) with replica degree r, every other op
    split b ways on its batch dim (both packages' graphs)."""
    views = {}
    for node in graph.topo_order():
        op = node.op
        nd = op.output_shapes[0].ndim
        if op.op_type.name == "DECODE_ATTENTION":
            views[node.guid] = view_cls((b, 1, 1), replica_degree=r)
        else:
            views[node.guid] = view_cls((b,) + (1,) * (nd - 1))
    return views


def requests(decode_mod, mode, seed=0, n=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, KW["vocab"],
                              size=int(rng.integers(1, 12))).tolist()
        if mode == "sharing":
            prompt = PREFIX + prompt
        out.append(decode_mod.DecodeRequest(
            rid=f"r{i}", prompt=prompt,
            max_new_tokens=int(rng.integers(2, 9))))
    return out


def serve(decode_mod, step, mode, to_numpy):
    """(tokens, the first frames' logits, (slot, page) pairs of the
    live sequences seen, frames) of the seeded trace through ``step``."""
    frames, seen = [], set()
    box = {}

    def rec(ids, table, lens):
        logits = step(ids, table, lens)
        if len(frames) < FIRST_FRAMES:
            frames.append(to_numpy(logits).copy())
        for i, live in enumerate(box["ex"].slots):
            if live is not None:
                seen.update((i, p) for p in live.pages)
        return logits

    lane = mode != "frames"
    rec.prefill = getattr(step, "prefill", None)
    ex = box["ex"] = decode_mod.ContinuousBatchingExecutor(
        rec, max_seqs=B, page_size=KW["page_size"],
        pages_per_seq=KW["pages_per_seq"],
        prefill_fn=step.prefill if lane else None,
        prefill_chunk=CHUNK if lane else 0,
        prefix_sharing=mode == "sharing", copy_page_fn=step.copy_page)
    tokens = ex.run(requests(decode_mod, mode))
    return tokens, frames, sorted(seen), ex.frame


def _rank(rank, weights):
    """One rank: every (split, pool) of its world size, each served in
    every mode from an empty cache."""
    import torch

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.interop import params_from_numpy
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.ops.base import REPLICA_SLOT
    from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp
    from flexflow_tpu_torch.runtime import decode, distributed

    world = distributed.world_size()
    out = {}
    for split, (n, b, r) in SPLITS.items():
        if n != world:
            continue
        for pool in POOLS:
            cfg = FFConfig(batch_size=B, device="cpu", num_devices=n,
                           compute_dtype="float32", kv_precision=pool)
            m = build_gpt_decode(cfg, **KW)
            m.compile(comp_mode="inference",
                      strategy=split_views(m.graph, MachineView, b, r))
            m.params = params_from_numpy(weights, "cpu", m.compiled)
            res = {"pools": {k: tuple(t.shape)
                             for k, t in m.state.items()}}
            for mode in MODES:
                for t in m.state.values():
                    t.zero_()
                step = decode.compiled_decode_step(
                    m, prefill_chunk=CHUNK if mode != "frames" else 0,
                    slot_aligned=mode != "sharing")
                res[mode] = serve(decode, step, mode,
                                  lambda x: x.numpy())
                res[mode + "_pools"] = {k: tuple(t.shape)
                                        for k, t in step.state[
                                            "state"].items()}
            if b > 1:
                # the layout is the step's, chosen when it is built
                step = decode.compiled_decode_step(m)
                res["split_pages"] = step.split_pages
                try:
                    decode.ContinuousBatchingExecutor(
                        step, max_seqs=B, page_size=KW["page_size"],
                        pages_per_seq=KW["pages_per_seq"],
                        prefix_sharing=True, copy_page_fn=step.copy_page)
                    res["free_list_refused"] = False
                except ValueError:
                    res["free_list_refused"] = True
            if pool == "int8" and r > 1:
                # every rank's heads at their own magnitude: the scale
                # row must be the max over all of them
                op = next(nd.op for nd in m.graph.topo_order()
                          if isinstance(nd.op, DecodeAttentionOp))
                node = next(nd for nd in m.graph.topo_order()
                            if nd.op is op)
                c = m.compiled
                ctx = type("Ctx", (), {})()
                ctx.mesh, ctx.state_in, ctx.state_out = c.mesh, m.state, {}
                hax = c._slot_axes[node.guid][REPLICA_SLOT]
                heads = KW["num_heads"] // r
                g = torch.Generator().manual_seed(7)
                whole = torch.randn((B // b, KW["num_heads"],
                                     KW["hidden"] // KW["num_heads"]),
                                    generator=g)
                whole[:, :heads] *= 3.0  # the first rank's heads larger
                mine = c.mesh.index(hax)
                local = whole[:, mine * heads:(mine + 1) * heads]
                pools = op._pools(ctx)
                page = torch.zeros(B // b, dtype=torch.int32)
                slot = torch.arange(B // b, dtype=torch.int32)
                op._scatter(ctx, pools, page, slot, local, local, hax)
                res["scale"] = {
                    "written": pools["k_scale"][0, :B // b].numpy().copy(),
                    "global": (whole.abs().amax(dim=(1, 2)) / 127.0).numpy(),
                    "local": (local.abs().amax(dim=(1, 2)) / 127.0).numpy()}
            out[(split, pool)] = res
    return out


def _jax_results(weights, n):
    """The JAX package's runs of every (split, pool) of ``n`` devices,
    each mode from an empty cache, on its CPU mesh."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineView
    from flexflow_tpu.model import _adopt_kv_dtype
    from flexflow_tpu.models import build_gpt_decode
    from flexflow_tpu.runtime import decode

    out = {}
    for split, (size, b, r) in SPLITS.items():
        if size != n:
            continue
        for pool in POOLS:
            jm = build_gpt_decode(ff.FFConfig(
                batch_size=B, num_devices=n, cost_cache_file="",
                compute_dtype="float32"), **KW)
            _adopt_kv_dtype(jm.graph, pool)
            jm.compile(loss_type="sparse_categorical_crossentropy",
                       metrics=[], comp_mode="inference",
                       strategy=split_views(jm.graph, MachineView, b, r))
            jm.params = jax.tree_util.tree_map(
                lambda old, new: jax.device_put(jnp.asarray(new),
                                                old.sharding),
                jm.params, {op: {w: weights[op][w] for w in ws}
                            for op, ws in jm.params.items()})
            zeros = jax.tree_util.tree_map(jnp.zeros_like, jm.state)
            step = decode.compiled_decode_step(jm, prefill_chunk=CHUNK)
            res = {}
            for mode in MODES:
                step.state["state"] = zeros
                res[mode] = serve(decode, step, mode, np.asarray)
            out[(split, pool)] = res
    return out


def _weights():
    """The JAX model's initial weights, whole, as numpy."""
    import flexflow_tpu as ff
    from flexflow_tpu.models import build_gpt_decode

    jm = build_gpt_decode(ff.FFConfig(batch_size=B, num_devices=1,
                                      cost_cache_file="",
                                      compute_dtype="float32"), **KW)
    jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
               comp_mode="inference")
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in jm.params.items()}


def _world(n, tmp_path_factory):
    from flexflow_tpu_torch.runtime.distributed import spawn

    root = tmp_path_factory.mktemp(f"serving_split{n}")

    def compute():
        import threading

        weights = _weights()
        ref = {}
        # the JAX references run while the ranks do
        jax_side = threading.Thread(
            target=lambda: ref.update(_jax_results(weights, n)))
        jax_side.start()
        try:
            ranks = spawn(_rank, n, (weights,),
                          init_method=f"file://{root / 'rendezvous'}",
                          device="cpu", timeout=600)
        finally:
            jax_side.join()
        assert len(ref) == sum(s == n for s, _, _ in SPLITS.values()) * len(
            POOLS), "the JAX references did not finish"
        return ref, ranks

    return shared_world(tmp_path_factory, f"torch_serving_split_{n}",
                        compute)


@pytest.fixture(scope="module", params=(2, 4))
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


def _cases(world, want=None):
    ref, ranks = world
    return [(key, ref[key], ranks) for key in sorted(ref)
            if want is None or key[0] in want]


def test_tokens_match_jax_in_every_mode(world):
    for (split, pool), jax_res, ranks in _cases(world):
        for mode in MODES:
            want = jax_res[mode][0]
            assert want, (split, pool, mode)
            for i, r in enumerate(ranks):
                got = r[(split, pool)][mode][0]
                assert got == want, (split, pool, mode, i)
                assert r[(split, pool)][mode][3] == jax_res[mode][3]


def test_first_frames_logits_match_jax(world):
    for (split, pool), jax_res, ranks in _cases(world):
        for mode in MODES:
            want = jax_res[mode][1]
            assert len(want) == FIRST_FRAMES
            for r in ranks:
                for a, b in zip(r[(split, pool)][mode][1], want):
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=LOGITS_TOL[pool],
                        err_msg=f"{split} {pool} {mode}")


def test_each_rank_holds_its_share_of_the_pool(world):
    for (split, pool), _, ranks in _cases(world):
        n, b, r = SPLITS[split]
        pps, ps = KW["pages_per_seq"], KW["page_size"]
        whole = (B * pps, ps, KW["num_heads"], KW["hidden"] // KW["num_heads"])
        for rk in ranks:
            res = rk[(split, pool)]
            for key, shape in res["pools"].items():
                if key.endswith("_cache"):
                    assert np.prod(shape) * b * r == np.prod(whole), key
                    assert shape[2] == KW["num_heads"] // r
                else:  # int8 scales: split with the pages only
                    assert shape == (B * pps // b, ps), key
            # slot-aligned runs keep the split; the free list gathers
            # the page dim whole on every rank of the batch group
            for mode in ("frames", "lane"):
                assert res[mode + "_pools"] == res["pools"]
            for key, shape in res["sharing_pools"].items():
                assert shape[0] == B * pps, key


def test_shared_prefix_pages_leave_the_rank_range(world):
    """Under a batch split the sharing run's sequences own pages of
    another rank's range (and still give the reference's tokens:
    ``test_tokens_match_jax_in_every_mode``)."""
    cases = _cases(world, want=[s for s, (_, b, _) in SPLITS.items()
                                if b > 1])
    assert cases
    for (split, pool), _, ranks in cases:
        _, b, _ = SPLITS[split]
        slots, pages = B // b, B * KW["pages_per_seq"] // b
        seen = ranks[0][(split, pool)]["sharing"][2]
        assert any(i // slots != p // pages for i, p in seen), split


def test_a_split_step_refuses_a_free_list_executor(world):
    """A step built slot-aligned keeps its pools split, and an executor
    that would feed it free-list pages (prefix sharing) refuses it;
    the compiled model's placements stay the lowering's after a
    sharing step gathered its pools whole."""
    cases = _cases(world, want=[s for s, (_, b, _) in SPLITS.items()
                                if b > 1])
    assert cases
    for (split, pool), _, ranks in cases:
        for rk in ranks:
            res = rk[(split, pool)]
            assert res["split_pages"] and res["free_list_refused"]


def test_int8_scale_is_the_amax_over_every_head(world):
    cases = [c for c in _cases(world) if c[0][1] == "int8"
             and SPLITS[c[0][0]][2] > 1]
    assert cases
    for (split, _), _, ranks in cases:
        for i, r in enumerate(ranks):
            s = r[(split, "int8")]["scale"]
            np.testing.assert_array_equal(s["written"], s["global"])
        # on the ranks whose heads are smaller, a local amax differs
        assert any(not np.allclose(r[(split, "int8")]["scale"]["local"],
                                   r[(split, "int8")]["scale"]["global"])
                   for r in ranks)


def test_every_rank_serves_the_same_tokens(world):
    for (split, pool), _, ranks in _cases(world):
        for mode in MODES:
            first = ranks[0][(split, pool)][mode][0]
            assert all(r[(split, pool)][mode][0] == first for r in ranks)
