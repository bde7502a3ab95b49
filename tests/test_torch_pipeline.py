"""The pipelined lowering (``compile(pipeline=PipelineConfig(...))``)
and its GPipe schedule, against the JAX package's, on one gloo world of
4 CPU ranks.

* The schedule (``parallel.pipeline.pipeline_gpipe``) against
  ``pipeline_spmd`` on the reference test's setups, (S, L, M) in
  (4, 4, 8), (2, 4, 4), (4, 8, 4) and (1, 4, 2) (tests/test_pipeline.py
  ``TestPipelineSpmd``): the outputs and the gradients of every stage's
  weights.
* ``__graft_entry__.py``'s pp leg: ``build_transformer`` (4 layers,
  hidden 32, 4 heads, ff 64, seq 8), batch 8, pp 2 x dp 2, M 4, MSE,
  Adam, 2 ``fit`` steps from the JAX pipelined model's weights (carried
  by ``interop.stacked_to_blocks``): losses within 1e-5 relative and
  whole weights within the hybrid tests' units of the JAX package's
  pipelined run and of the port's one process; every replica bit-equal.
* A tiny ``build_gpt`` at seq 512 (the flash route, its plain version
  on the CPU), pp 2, M 2, against one process.
* A strategy file the JAX package exports from a pipelined compile
  (``__meta__.pipeline``) imports in the port and lowers pipelined, and
  the port's export imports in the JAX package the same way.
* ``detect_blocks`` (by name and by ``block_of``) equal to the
  reference's, and the compile guards' errors, in one process.

The worker function imports no JAX: the spawned ranks import this
module to find it."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.compiler.pipeline_lowering import (
    build_pipeline_mesh,
    detect_blocks,
)
from flexflow_tpu_torch.interop import (
    blocks_to_stacked,
    params_from_numpy,
    params_to_numpy,
    stacked_to_blocks,
)
from flexflow_tpu_torch.models import build_gpt, build_transformer
from flexflow_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    merge_microbatches,
    pipeline_gpipe,
    split_microbatches,
)
from flexflow_tpu_torch.runtime.distributed import spawn
from test_torch_worlds import (
    assert_npz_equal,
    checkpoint_round_trip,
    npz_arrays,
    shared_world,
)

N = 4
ALPHA = 1e-3
TOLS = (1e-5, 0.01, 0.01)  # loss rtol; max and mean weight error, alphas
SCHED = [(4, 4, 8), (2, 4, 4), (4, 8, 4), (1, 4, 2)]
TR = dict(num_layers=4, hidden=32, num_heads=4, ff_dim=64, seq_len=8)
GPT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
           seq_len=512)
MSE = dict(loss_type="mean_squared_error", metrics=["mean_squared_error"])
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=["accuracy"])
PP = PipelineConfig(num_stages=2, num_microbatches=4)


def _sched_setup(S, L, M, B=16, D=16):
    """The reference test's ``_setup`` (tests/test_pipeline.py:39-44)."""
    rng = np.random.default_rng(0)
    W = (rng.normal(size=(L, D, D)).astype(np.float32) * 0.1)
    b = (rng.normal(size=(L, D)).astype(np.float32) * 0.1)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return W, b, x


def _sched_rank(S, L, M):
    """This rank's stage of the schedule case: (stage, outputs, the
    gradients of its blocks' W and b)."""
    W, b, x = _sched_setup(S, L, M)
    mesh = build_pipeline_mesh(N, S)
    s = mesh.coord("pp")
    per = L // S
    Wl = torch.from_numpy(W[s * per:(s + 1) * per]).requires_grad_(True)
    bl = torch.from_numpy(b[s * per:(s + 1) * per]).requires_grad_(True)

    def stage(p, xx, m):
        for i in range(per):
            xx = torch.tanh(xx @ p[0][i] + p[1][i])
        return xx

    ym = pipeline_gpipe(stage, [Wl, bl],
                        split_microbatches(torch.from_numpy(x), M), mesh)
    y = merge_microbatches(ym)
    (y ** 2).sum().backward()
    return s, y.detach().numpy(), Wl.grad.numpy(), bl.grad.numpy()


def _transformer(n, pipeline, import_file=None, export_file=None):
    cfg = tff.FFConfig(batch_size=8, device="cpu", num_devices=n,
                       compute_dtype="float32",
                       only_data_parallel=pipeline is None and n == 1,
                       import_strategy_file=import_file,
                       export_strategy_file=export_file)
    m = build_transformer(cfg, **TR)
    m.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), pipeline=pipeline,
              **MSE)
    return m


def _gpt(n, pipeline):
    cfg = tff.FFConfig(batch_size=4, device="cpu", num_devices=n,
                       compute_dtype="float32", only_data_parallel=n == 1)
    m = build_gpt(cfg, **GPT)
    m.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), pipeline=pipeline,
              **CCE)
    return m


def _rank(rank, start, x, y, gpt_ids, export_path, port_export,
          seq_mask_start):
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
    # batch_matmul's sequence mask, pipelined (tests/test_torch_surface)
    from test_torch_surface import seq_mask_rank_leg

    out = {"sched": {c: _sched_rank(*c) for c in SCHED},
           "seq_mask": seq_mask_rank_leg(seq_mask_start)}
    m = _transformer(N, PP, export_file=port_export)
    out["kind"] = type(m.compiled).__name__
    out["held"] = sorted(m.params)
    m.params = params_from_numpy(stacked_to_blocks(start, m.graph), "cpu",
                                 m.compiled)
    m.opt_state = m.optimizer.init_state(m.params)
    tmp = os.path.dirname(export_path)
    CheckpointManager(os.path.join(tmp, "port_ckpt")).save(0, m)
    m.fit(x, y, shuffle=False, verbose=False)
    out["ckpt_round_trip"] = checkpoint_round_trip(
        m, _transformer(N, PP), os.path.join(tmp, "port_ckpt_trained"))
    out["losses"] = list(m.step_losses)
    out["params"] = params_to_numpy(m.params, m.compiled)
    out["own"] = {op: {w: v.detach().numpy().copy() for w, v in ws.items()}
                  for op, ws in m.params.items()}
    out["evaluate"] = m.evaluate(x, y)
    out["predict"] = m.predict(x)
    out["weight"] = m.get_weight("layer3_ff1", "kernel")
    g = _gpt(N, PipelineConfig(num_stages=2, num_microbatches=2))
    g.fit(gpt_ids[:, :-1], gpt_ids[:, 1:], shuffle=False, verbose=False)
    out["gpt_losses"] = list(g.step_losses)
    out["gpt_params"] = params_to_numpy(g.params, g.compiled)
    imp = _transformer(N, None, import_file=export_path)
    out["imported"] = (type(imp.compiled).__name__,
                       imp.compiled.pipeline.num_stages,
                       imp.compiled.pipeline.num_microbatches)
    return out


def _jax_compile(export_path):
    """The JAX package's pipelined pp leg, compiled (which exports its
    strategy with ``__meta__.pipeline``), and its start weights."""
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.parallel import PipelineConfig as RefPipelineConfig

    cfg = ff.FFConfig(batch_size=8, num_devices=N, compute_dtype="float32",
                      export_strategy_file=export_path)
    jm = jmods.build_transformer(cfg, **TR)
    jm.compile(optimizer=ff.AdamOptimizer(alpha=ALPHA),
               pipeline=RefPipelineConfig(num_stages=2, num_microbatches=4),
               **MSE)
    start = {op: {w: np.array(v) for w, v in ws.items()}
             for op, ws in jm.params.items()}
    return jm, start


def _jax_runs(jm, x, y, out):
    """The JAX package's schedule cases and the pp leg's 2 steps; fills
    ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flexflow_tpu.parallel.pipeline import (
        merge_microbatches as jmerge,
        pipeline_spmd,
        split_microbatches as jsplit,
    )

    def stage(p, xx, mb_index):
        del mb_index

        def blk(xx, pb):
            return jnp.tanh(xx @ pb[0] + pb[1]), None

        xx, _ = jax.lax.scan(blk, xx, p)
        return xx

    sched = {}
    for S, L, M in SCHED:
        W, b, xs = _sched_setup(S, L, M)
        mesh = Mesh(np.array(jax.devices()[:S]).reshape(S), ("pp",))

        def loss(p, mesh=mesh, M=M, xs=xs):
            ym = pipeline_spmd(stage, p, jsplit(jnp.asarray(xs), M),
                               mesh=mesh)
            y_ = jmerge(ym)
            return jnp.sum(y_ ** 2), y_

        (_, yv), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            (jnp.asarray(W), jnp.asarray(b)))
        sched[(S, L, M)] = (np.asarray(yv), np.asarray(g[0]),
                            np.asarray(g[1]))
    out["sched"] = sched
    params, opt, state = jm.params, jm.opt_state, jm.state
    losses = []
    for i in range(2):
        rows = slice(i * 8, (i + 1) * 8)
        params, opt, state, loss_, _ = jm.compiled.train_step(
            params, opt, state, jax.random.key(i),
            [jax.device_put(jnp.asarray(x[rows]),
                            jm.compiled.input_sharding(0))],
            jax.device_put(jnp.asarray(y[rows]),
                           jm.compiled.batch_sharding()))
        losses.append(float(loss_))
    out["losses"] = losses
    out["params"] = {op: {w: np.asarray(v) for w, v in ws.items()}
                     for op, ws in params.items()}


def _jax_import(path):
    """The JAX package's compile of the port's exported pipelined
    strategy: (lowering, stages, microbatches)."""
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods

    jm = jmods.build_transformer(ff.FFConfig(
        batch_size=8, num_devices=N, compute_dtype="float32",
        import_strategy_file=path), **TR)
    jm.compile(optimizer=ff.AdamOptimizer(alpha=ALPHA), **MSE)
    p = jm.compiled.pipeline
    return type(jm.compiled).__name__, p.num_stages, p.num_microbatches


def _data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 8, 32)).astype(np.float32)
    y = rng.normal(size=(16, 8, 32)).astype(np.float32)
    ids = rng.integers(0, GPT["vocab"], size=(8, GPT["seq_len"] + 1))
    return x, y, ids.astype(np.int32)


def _make_world(tmp_path_factory):
    """(each rank's results, the JAX runs, the port's one process from
    the same start weights)."""
    x, y, ids = _data()
    tmp = tmp_path_factory.mktemp("pipeline")
    export = str(tmp / "pp_strategy.json")
    port_export = str(tmp / "port_pp_strategy.json")
    jm, start = _jax_compile(export)
    ref = {"start": start}
    from test_torch_surface import reference_seq_mask_step

    ref["seq_mask"] = reference_seq_mask_step()
    # the reference's snapshot of the pipelined model at its start
    # weights, before its steps run (they donate the buffers)
    from flexflow_tpu.runtime.checkpoint import CheckpointManager as RefMgr

    RefMgr(str(tmp / "ref_ckpt"), use_orbax=False).save(0, jm)
    ref["npz"] = npz_arrays(str(tmp / "ref_ckpt"), 0)
    # the JAX steps overlap the ranks' (which take one thread each)
    worker = threading.Thread(target=_jax_runs, args=(jm, x, y, ref))
    worker.start()
    try:
        ranks = spawn(_rank, N, (start, x, y, ids, export, port_export,
                                 ref["seq_mask"][0]),
                      init_method=f"file://{tmp / 'rendezvous'}",
                      device="cpu", timeout=600)
    finally:
        worker.join()
    assert "params" in ref, "the JAX run failed"
    ref["port_npz"] = npz_arrays(str(tmp / "port_ckpt"), 0)
    ref["imported"] = _jax_import(port_export)
    one = _transformer(1, None)
    one.params = params_from_numpy(stacked_to_blocks(start, one.graph))
    one.opt_state = one.optimizer.init_state(one.params)
    one.fit(x, y, shuffle=False, verbose=False)
    gpt = _gpt(1, None)
    gpt.fit(ids[:, :-1], ids[:, 1:], shuffle=False, verbose=False)
    ones = {"losses": list(one.step_losses),
            "params": params_to_numpy(one.params),
            "evaluate": one.evaluate(x, y), "predict": one.predict(x),
            "gpt_losses": list(gpt.step_losses),
            "gpt_params": params_to_numpy(gpt.params)}
    return ranks, ref, ones


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shared_world(tmp_path_factory, "pipeline_world",
                        lambda: _make_world(tmp_path_factory))


def test_pipelined_checkpoint_is_the_references_and_round_trips(world):
    """The pipelined lowering's snapshot (every rank saves, rank 0
    writes) holds the reference's keys and arrays for the same weights:
    each block weight and its Adam slots stacked under the first block's
    op name; after training, a restore into a fresh pipelined compile
    gives every weight and slot back bit for bit."""
    ranks, ref, _ = world
    assert_npz_equal(ref["port_npz"], ref["npz"])
    assert any(k.startswith("opt_state/m/layer0_") for k in ref["npz"])
    for r in ranks:
        differ, compared = r["ckpt_round_trip"]
        assert differ == [] and compared > 0, differ


def _assert_weights_close(got, ref, steps):
    _, max_tol, mean_tol = TOLS
    for op, ws in ref.items():
        for w, r in ws.items():
            err = np.abs(got[op][w] - r) / ALPHA
            assert err.max() <= max_tol * steps, f"{op}/{w}: {err.max():.3e}"
            assert err.mean() <= mean_tol, f"{op}/{w}: {err.mean():.3e}"


@pytest.mark.parametrize("case", SCHED, ids=[f"S{s}L{l}M{m}"
                                             for s, l, m in SCHED])
def test_schedule_matches_pipeline_spmd(world, case):
    """Every rank's outputs, and each stage's gradients of its blocks,
    equal ``pipeline_spmd``'s and ``jax.grad``'s."""
    ranks, ref, _ = world
    y_ref, gw_ref, gb_ref = ref["sched"][case]
    S, L, _ = case
    per = L // S
    for r in ranks:
        s, y, gw, gb = r["sched"][case]
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gw, gw_ref[s * per:(s + 1) * per],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gb, gb_ref[s * per:(s + 1) * per],
                                   rtol=1e-5, atol=1e-5)


def test_pp_leg_lowers_pipelined_and_holds_its_stage(world):
    ranks, _, _ = world
    for rank, r in enumerate(ranks):
        assert r["kind"] == "PipelinedCompiledModel"
        stage = rank // 2  # pp is the leading axis: ranks 0-1, 2-3
        mine = {f"layer{2 * stage}_", f"layer{2 * stage + 1}_"}
        for op in r["held"]:
            assert not op.startswith("layer") or op[:7] in mine, op
        assert "head" in r["held"]


def test_pp_leg_matches_the_jax_pipelined_run(world):
    ranks, ref, _ = world
    want = stacked_to_blocks(ref["params"], _transformer(1, None).graph)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=TOLS[0])
        _assert_weights_close(r["params"], want, 2)


def test_pp_leg_matches_one_process(world):
    ranks, _, one = world
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=TOLS[0])
        _assert_weights_close(r["params"], one["params"], 2)
        np.testing.assert_allclose(r["evaluate"]["loss"],
                                   one["evaluate"]["loss"], rtol=TOLS[0])
        np.testing.assert_allclose(r["predict"], one["predict"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(r["weight"],
                                      r["params"]["layer3_ff1"]["kernel"])


def test_pp_leg_weight_replicas_are_bit_equal(world):
    """Every weight a rank holds is bit-equal to the gathered whole
    weight every rank reports, and the gathered weights agree."""
    ranks, _, _ = world
    for r in ranks:
        for op, ws in r["own"].items():
            for w, v in ws.items():
                np.testing.assert_array_equal(v, r["params"][op][w])
        for op, ws in ranks[0]["params"].items():
            for w, v in ws.items():
                np.testing.assert_array_equal(r["params"][op][w], v)


def test_tiny_gpt_pipelined_matches_one_process(world):
    ranks, _, one = world
    for r in ranks:
        np.testing.assert_allclose(r["gpt_losses"], one["gpt_losses"],
                                   rtol=TOLS[0])
        _assert_weights_close(r["gpt_params"], one["gpt_params"],
                              len(one["gpt_losses"]))


def test_jax_exported_pipeline_meta_lowers_pipelined(world):
    ranks, _, _ = world
    for r in ranks:
        assert r["imported"] == ("PipelinedCompiledModel", 2, 4)


def test_port_exported_pipeline_meta_lowers_pipelined_in_jax(world):
    """The strategy file the port's rank 0 exports from a pipelined
    compile carries ``__meta__.pipeline``, and the JAX package adopts it
    through its digest gate as the same pipeline."""
    _, ref, _ = world
    assert ref["imported"] == ("PipelinedCompiledModel", 2, 4)


def test_stacked_layout_round_trips():
    g = build_transformer(tff.FFConfig(batch_size=8, device="cpu",
                                       compute_dtype="float32"), **TR).graph
    rng = np.random.default_rng(0)
    stacked = {"layer0_ff1": {"kernel": rng.normal(size=(4, 32, 64))},
               "head": {"kernel": rng.normal(size=(32, 32))}}
    whole = stacked_to_blocks(stacked, g)
    assert sorted(whole) == ["head"] + [f"layer{i}_ff1" for i in range(4)]
    np.testing.assert_array_equal(whole["layer2_ff1"]["kernel"],
                                  stacked["layer0_ff1"]["kernel"][2])
    back = blocks_to_stacked(whole, g)
    for op, ws in stacked.items():
        np.testing.assert_array_equal(back[op]["kernel"], ws["kernel"])


def _names(parts):
    blocks, prologue, epilogue = parts
    return ([[n.op.name for n in blk] for blk in blocks],
            [n.op.name for n in prologue], [n.op.name for n in epilogue])


@pytest.mark.parametrize("model", ["transformer", "gpt", "block_of"])
def test_detect_blocks_equals_the_reference(model):
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.compiler.pipeline_lowering import (
        detect_blocks as ref_detect,
    )

    def build(pkg, mods, **kw):
        cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32", **kw)
        if model == "transformer":
            return mods.build_transformer(cfg, **TR)
        if model == "gpt":
            return mods.build_gpt(cfg, **dict(GPT, seq_len=16))
        m = pkg.FFModel(cfg)
        t = m.create_tensor([8, 16], name="x")
        for i in range(4):
            t = m.dense(t, 16, activation="relu", name=f"fc{i}")
        m.dense(t, 4, name="out")
        return m

    import flexflow_tpu_torch.models as tmods

    port = build(tff, tmods, device="cpu")
    ref = build(ff, jmods)
    block_of = None
    if model == "block_of":
        by_name = {n.op.name: n.guid for n in port.graph.topo_order()}
        assert by_name == {n.op.name: n.guid
                           for n in ref.graph.topo_order()}
        block_of = {by_name[f"fc{i}"]: i // 2 for i in range(4)}
    assert (_names(detect_blocks(port.graph, block_of))
            == _names(ref_detect(ref.graph, block_of)))


def _guard_error(build, pipeline, **cfg):
    m = build(tff.FFConfig(batch_size=8, device="cpu",
                           compute_dtype="float32", **cfg))
    with pytest.raises(Exception) as e:
        m.compile(pipeline=pipeline, **MSE)
    return e


def _mlp(cfg, acts=("relu", "relu")):
    m = tff.FFModel(cfg)
    t = m.create_tensor([8, 16], name="x")
    for i, a in enumerate(acts):
        t = m.dense(t, 16, activation=a, name=f"layer{i}_fc")
    m.dense(t, 4, name="head")
    return m


def test_compile_guards_refuse_as_the_reference():
    two = PipelineConfig(num_stages=2, num_microbatches=4)
    e = _guard_error(lambda c: build_transformer(c, **TR),
                     PipelineConfig(num_stages=4, num_microbatches=4),
                     num_devices=2)
    assert e.type is ValueError and "must divide" in str(e.value)
    e = _guard_error(lambda c: _mlp(c, (None, "relu")), two,
                     num_devices=2)
    assert e.type is ValueError and "isomorphic" in str(e.value)
    e = _guard_error(lambda c: _mlp(c, ("relu",) * 3), two, num_devices=2)
    assert e.type is ValueError and "not divisible into 2" in str(e.value)
    e = _guard_error(lambda c: build_gpt(c, **dict(GPT, seq_len=16)), two,
                     num_devices=2, zero_dp_shard=True)
    assert e.type is NotImplementedError and "zero_dp_shard" in str(e.value)

    def no_blocks(c):
        m = tff.FFModel(c)
        m.dense(m.create_tensor([8, 16], name="x"), 4, name="head")
        return m

    e = _guard_error(no_blocks, two, num_devices=2)
    assert e.type is ValueError and "no repeated blocks" in str(e.value)


def test_block_of_pipeline_in_one_process_matches_flat():
    """``compile(pipeline=..., block_of=...)`` with blocks named by
    ``block_of`` (no ``layer<i>_`` names), one stage in one process:
    the microbatched pipeline trains as the flat lowering does, and
    ``get_weight``/``set_weight`` carry whole weights."""
    def build():
        m = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu",
                                     compute_dtype="float32"))
        t = m.create_tensor([8, 16], name="x")
        for i in range(4):
            t = m.dense(t, 16, activation="relu", name=f"fc{i}")
        m.dense(t, 4, name="out")
        return m

    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = rng.normal(size=(16, 4)).astype(np.float32)
    piped, flat = build(), build()
    block_of = {piped.node_by_name(f"fc{i}").guid: i for i in range(4)}
    piped.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA),
                  pipeline=PipelineConfig(num_stages=1, num_microbatches=2),
                  block_of=block_of, loss_type="mean_squared_error",
                  metrics=[])
    flat.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA),
                 loss_type="mean_squared_error", metrics=[])
    assert type(piped.compiled).__name__ == "PipelinedCompiledModel"
    w = flat.get_weight("fc2", "kernel")
    piped.set_weight("fc2", "kernel", w)
    np.testing.assert_array_equal(piped.get_weight("fc2", "kernel"), w)
    piped.fit(x, y, shuffle=False, verbose=False)
    flat.fit(x, y, shuffle=False, verbose=False)
    np.testing.assert_allclose(piped.step_losses, flat.step_losses,
                               rtol=TOLS[0])
    _assert_weights_close(params_to_numpy(piped.params),
                          params_to_numpy(flat.params), 2)
