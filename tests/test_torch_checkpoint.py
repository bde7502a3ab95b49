"""Checkpoint and resume in the port (``runtime/checkpoint.py``), each
test of tests/test_checkpoint.py that needs neither orbax nor keras
mirrored on the port, then the cross-reads with the JAX package.

Mirrored: the round trip (weights and Adam slots, a fresh model of
another seed); an async save overlapping training; training resumed
from a restore; retention; a shape mismatch refused; ``fit`` with
``checkpoint_dir`` and ``resume`` (epochs continue, nothing to do when
done, ``resume`` without a directory refused); a truncated newest step
falling back to the newest complete one; a manifest key mismatch; an
interrupted publish; a re-save of one step; a kill between the rename
pair; and resume equal to an uninterrupted run, here bit for bit with
dropout on (a small model with attention dropout 0.1).

Cross-reads, dropout 0, fp32, Adam: a checkpoint the JAX package writes
(its npz backend) resumes in the port, and the port's next 2 losses
equal the JAX package's own continuation within 1e-5; the reverse; one
written by a gloo world of 4 under Megatron dp 2 x tp 2 resumes on one
process, whose next loss equals the world's within 1e-5.

This module imports no JAX at the top: the spawned ranks import it to
find ``world_rank``, which also runs tests/test_torch_fit_surface.py's
and tests/test_torch_bert.py's multi-rank legs (one world of 4 and one
of 2 per run, tests/test_torch_worlds.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.interop import params_to_numpy
from flexflow_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    restore_in_memory,
    snapshot_in_memory,
)

from test_torch_worlds import shared_world

GPT = dict(vocab=64, num_layers=2, hidden=32, num_heads=4, ff_dim=64,
           seq_len=16)
BERT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
            seq_len=16, num_classes=2, dropout=0.1)
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=["accuracy"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_model(seed=0):
    m = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu", seed=seed,
                                 compute_dtype="float32",
                                 only_data_parallel=True))
    x = m.create_tensor([8, 16])
    h = m.dense(x, 32, activation="relu")
    m.dense(h, 4)
    m.compile(optimizer=tff.AdamOptimizer(alpha=1e-2), **CCE)
    return m


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(24, 16).astype(np.float32),
            rng.randint(0, 4, size=(24,)).astype(np.int32))


def _train_a_bit(m, steps=3, seed=0):
    x, y = _data(seed)
    m.fit(x, y, batch_size=8, epochs=steps, verbose=False)
    return x, y


def _leaves(tree):
    from flexflow_tpu_torch.runtime.checkpoint import _flatten

    return [v for _, v in _flatten(tree)]


def test_save_restore_roundtrip(tmp_path):
    m = _make_model()
    _train_a_bit(m)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, m)
    assert mgr.all_steps() == [7]
    m2 = _make_model(seed=123)
    before = m2.get_weight("dense_0").copy()  # restore writes in place
    assert mgr.restore(m2) == 7
    after = m2.get_weight("dense_0")
    assert not np.allclose(before, after)
    np.testing.assert_array_equal(after, m.get_weight("dense_0"))
    a, b = _leaves(m.opt_state), _leaves(m2.opt_state)
    assert len(a) == len(b) == 9  # step, m and v of 4 weights
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_async_save_overlaps_and_roundtrips(tmp_path):
    m = _make_model()
    _train_a_bit(m, steps=2)
    saved = {op: {w: a.copy() for w, a in ws.items()}
             for op, ws in params_to_numpy(m.params).items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, m)
    _train_a_bit(m, steps=2, seed=9)  # train over the in-flight save
    mgr.wait()
    assert mgr.all_steps() == [7]
    m2 = _make_model(seed=1)
    assert mgr.restore(m2) == 7
    got = params_to_numpy(m2.params)
    for op, ws in saved.items():
        for w, a in ws.items():
            np.testing.assert_array_equal(a, got[op][w])
    mgr.save(8, m)
    mgr.wait()
    assert mgr.latest_step() == 8
    mgr.close()


def test_resume_training_continues(tmp_path):
    m = _make_model()
    x, y = _train_a_bit(m, steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, m)
    m2 = _make_model(seed=9)
    mgr.restore(m2)
    w0 = m2.get_weight("dense_1").copy()
    m2.fit(x, y, batch_size=8, epochs=1, verbose=False)
    assert not np.allclose(w0, m2.get_weight("dense_1"))


def test_retention_gc(tmp_path):
    m = _make_model()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, m)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_shape_mismatch_rejected(tmp_path):
    m = _make_model()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, m)
    m2 = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu",
                                  only_data_parallel=True))
    x = m2.create_tensor([8, 16])
    m2.dense(x, 8)  # another architecture
    m2.compile(loss_type="mean_squared_error",
               metrics=["mean_squared_error"])
    before = {op: {w: a.copy() for w, a in ws.items()}
              for op, ws in params_to_numpy(m2.params).items()}
    with pytest.raises(ValueError):
        mgr.restore(m2)
    after = params_to_numpy(m2.params)  # a failed restore leaves it
    for op, ws in before.items():
        for w, a in ws.items():
            np.testing.assert_array_equal(a, after[op][w])
    # the same keys at another shape: the shape is refused by name
    m3 = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu",
                                  only_data_parallel=True))
    x = m3.create_tensor([8, 16])
    h = m3.dense(x, 24, activation="relu")
    m3.dense(h, 4)
    m3.compile(optimizer=tff.AdamOptimizer(alpha=1e-2), **CCE)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(m3)


def test_fit_checkpoint_dir_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    x, y = _data()
    m1 = _make_model()
    m1.fit(x, y, batch_size=8, epochs=3, verbose=False, checkpoint_dir=d)
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 2
    m2 = _make_model()
    hist = m2.fit(x, y, batch_size=8, epochs=5, verbose=False,
                  checkpoint_dir=d, resume=True)
    assert len(hist) == 2
    assert mgr.latest_step() == 4
    m3 = _make_model()
    assert m3.fit(x, y, batch_size=8, epochs=5, verbose=False,
                  checkpoint_dir=d, resume=True) == []
    with pytest.raises(ValueError, match="checkpoint_dir"):
        m3.fit(x, y, batch_size=8, epochs=1, verbose=False, resume=True)


def test_truncated_newest_step_falls_back_to_complete(tmp_path):
    m = _make_model()
    _train_a_bit(m)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    mgr.save(1, m)
    w_at_1 = m.get_weight("dense_0").copy()
    _train_a_bit(m, seed=5)
    mgr.save(2, m)
    npz = os.path.join(mgr._step_dir(2), "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    assert mgr.snapshot_complete(1) and not mgr.snapshot_complete(2)
    assert mgr.latest_step() == 2
    assert mgr.latest_complete_step() == 1
    m2 = _make_model(seed=9)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert mgr.restore(m2) == 1
    assert any("truncated" in str(w.message) for w in caught)
    np.testing.assert_array_equal(w_at_1, m2.get_weight("dense_0"))
    with pytest.raises(Exception):
        mgr.restore(_make_model(), step=2)


def test_manifest_key_mismatch_is_incomplete(tmp_path):
    m = _make_model()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, m)
    mf = os.path.join(mgr._step_dir(3), "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["trees"]["params"].append("ghost/kernel")
    with open(mf, "w") as f:
        json.dump(manifest, f)
    assert not mgr.snapshot_complete(3)
    assert mgr.latest_complete_step() is None


def test_interrupted_publish_leaves_no_visible_step(tmp_path):
    m = _make_model()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, m)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "step_4.old"))
    assert mgr.all_steps() == [1]
    assert mgr.restore(_make_model(seed=3)) == 1
    mgr.save(2, m)
    assert not os.path.exists(os.path.join(str(tmp_path), "step_9.tmp"))
    assert not os.path.exists(os.path.join(str(tmp_path), "step_4.old"))


def test_resave_same_step_replaces_atomically(tmp_path):
    m = _make_model()
    _train_a_bit(m)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, m)
    _train_a_bit(m, seed=4)
    mgr.save(1, m)
    assert mgr.all_steps() == [1] and mgr.snapshot_complete(1)
    m2 = _make_model(seed=2)
    mgr.restore(m2)
    np.testing.assert_array_equal(m.get_weight("dense_0"),
                                  m2.get_weight("dense_0"))


def test_kill_between_rename_pair_recovers_old_copy(tmp_path):
    m = _make_model()
    _train_a_bit(m)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, m)
    w = m.get_weight("dense_0").copy()
    os.rename(mgr._step_dir(5), mgr._step_dir(5) + ".old")
    assert CheckpointManager(str(tmp_path)).all_steps() == [5]
    m2 = _make_model(seed=4)
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.restore(m2) == 5
    np.testing.assert_array_equal(w, m2.get_weight("dense_0"))
    os.rename(mgr2._step_dir(5), mgr2._step_dir(5) + ".old")
    shutil.rmtree(mgr2._step_dir(5) + ".old")
    os.makedirs(mgr2._step_dir(5) + ".old")  # empty: incomplete
    mgr3 = CheckpointManager(str(tmp_path))
    assert mgr3.all_steps() == []
    assert not os.path.exists(mgr3._step_dir(5) + ".old")


def _bert(seed=0, **cfg):
    from flexflow_tpu_torch.models import build_bert

    cfg = dict(dict(only_data_parallel=True), **cfg)
    m = build_bert(tff.FFConfig(batch_size=4, device="cpu", seed=seed,
                                compute_dtype="float32", **cfg), **BERT)
    m.compile(optimizer=tff.AdamOptimizer(alpha=1e-3), **CCE)
    return m


def _bert_data():
    rng = np.random.default_rng(3)
    return (rng.integers(0, BERT["vocab"], size=(16, BERT["seq_len"])
                         ).astype(np.int32),
            rng.integers(0, 2, size=(16,)).astype(np.int32))


def test_resume_matches_uninterrupted_run_bit_for_bit(tmp_path):
    """With attention dropout on: the shuffle stream fast-forwarded, the
    rng counter restored, so the resumed run's losses and weights equal
    the uninterrupted run's bit for bit."""
    d = str(tmp_path / "eq")
    x, y = _bert_data()
    straight = _bert()
    straight.fit(x, y, epochs=2, verbose=False)
    part1 = _bert()
    part1.fit(x, y, epochs=1, verbose=False, checkpoint_dir=d)
    part2 = _bert()
    part2.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d, resume=True)
    assert part2.step_losses == straight.step_losses[4:]
    for a, b in zip(_leaves(straight.params), _leaves(part2.params)):
        assert torch.equal(a, b)
    assert part2._rng_counter == straight._rng_counter == 8


def test_in_memory_snapshot_roundtrip():
    m = _make_model()
    _train_a_bit(m)
    snap = snapshot_in_memory(m)
    m2 = _make_model(seed=5)
    report = restore_in_memory(m2, snap)
    assert report == {"fresh": [], "dropped": []}
    for a, b in zip(_leaves(m.params), _leaves(m2.params)):
        assert torch.equal(a, b)
    assert m2._rng_counter == m._rng_counter


# ---------------------------------------------------------------------------
# cross-reads with the JAX package (dropout 0, fp32, Adam)
CROSS_BERT = dict(BERT, dropout=0.0)


def _cross_pair(tmp_path):
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineView as JView
    from flexflow_tpu.models import build_bert as jax_build_bert
    from flexflow_tpu_torch.models import build_bert

    jm = jax_build_bert(ff.FFConfig(batch_size=4, num_devices=1,
                                    compute_dtype="float32",
                                    cost_cache_file=""), **CROSS_BERT)
    jm.compile(optimizer=ff.AdamOptimizer(alpha=1e-3),
               strategy={n.guid: JView.trivial(n.op.output_shapes[0].ndim)
                         for n in jm.graph.topo_order()}, **CCE)
    pm = build_bert(tff.FFConfig(batch_size=4, device="cpu",
                                 compute_dtype="float32",
                                 only_data_parallel=True), **CROSS_BERT)
    pm.compile(optimizer=tff.AdamOptimizer(alpha=1e-3), **CCE)
    return jm, pm


def _jax_steps(jm, x, y, first_counter):
    import jax
    import jax.numpy as jnp

    out = []
    for i in range(len(y) // 4):
        rows = slice(4 * i, 4 * i + 4)
        jm.params, jm.opt_state, jm.state, loss, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state,
            jax.random.key(first_counter + i), [jnp.asarray(x[rows])],
            jnp.asarray(y[rows]))
        out.append(float(loss))
    return out


def _port_steps(pm, x, y):
    out = []
    for i in range(len(y) // 4):
        rows = slice(4 * i, 4 * i + 4)
        pm.params, pm.opt_state, pm.state, loss, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state, [torch.from_numpy(x[rows])],
            torch.from_numpy(y[rows]))
        out.append(float(loss))
    return out


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    from flexflow_tpu.runtime.checkpoint import (
        CheckpointManager as JaxManager,
    )

    x, y = _bert_data()
    jm, pm = _cross_pair(tmp_path)
    _jax_steps(jm, x[:8], y[:8], 1)
    JaxManager(str(tmp_path), use_orbax=False).save(1, jm)
    assert CheckpointManager(str(tmp_path)).restore(pm) == 1
    want = _jax_steps(jm, x[8:], y[8:], 3)
    got = _port_steps(pm, x[8:], y[8:])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    import jax

    from flexflow_tpu.runtime.checkpoint import (
        CheckpointManager as JaxManager,
    )

    x, y = _bert_data()
    jm, pm = _cross_pair(tmp_path)
    _port_steps(pm, x[:8], y[:8])
    CheckpointManager(str(tmp_path)).save(1, pm)
    assert JaxManager(str(tmp_path), use_orbax=False).restore(jm) == 1
    assert int(jax.device_get(jm.opt_state["step"])) == 2
    want = _port_steps(pm, x[8:], y[8:])
    got = _jax_steps(jm, x[8:], y[8:], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the gloo worlds: rank functions (no JAX here; the ranks import this)
def megatron_views(m):
    views = {}
    for node in m.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        fixed = node.op.fixed_machine_view()
        if fixed is not None:
            views[node.guid] = fixed
        elif nd and 0 in node.op.splittable_output_dims():
            views[node.guid] = MachineView((2,) + (1,) * (nd - 1))
        else:
            views[node.guid] = MachineView((1,) * nd)
        name = node.op.name
        if node.op.op_type.value == "multihead_attention" or "ff2" in name:
            views[node.guid] = MachineView((2, 1, 1), replica_degree=2)
        if "ff1" in name:
            views[node.guid] = MachineView((2, 1, 2))
    return views


def gpt_ids():
    rng = np.random.default_rng(5)
    return rng.integers(0, GPT["vocab"], size=(12, GPT["seq_len"] + 1)
                        ).astype(np.int32)


def _gpt(n, megatron=False):
    """The tiny GPT on n ranks: Megatron dp 2 x tp 2, or data parallel."""
    from flexflow_tpu_torch.models import build_gpt

    m = build_gpt(tff.FFConfig(batch_size=4, device="cpu", num_devices=n,
                               compute_dtype="float32",
                               only_data_parallel=True), **GPT)
    m.compile(optimizer=tff.AdamOptimizer(alpha=1e-3),
              strategy=megatron_views(m) if megatron else None, **CCE)
    return m


def _step_on(m, x, y):
    c = m.compiled
    ins = [torch.from_numpy(np.ascontiguousarray(
        x[c.input_slices(0, x.shape)]))]
    lab = torch.from_numpy(np.ascontiguousarray(y[c.label_slices(y.shape)]))
    m.params, m.opt_state, m.state, loss, _ = c.train_step(
        m.params, m.opt_state, m.state, ins, lab, seed=m._rng_counter + 1)
    m._rng_counter += 1
    return float(loss)


def _digests(m):
    c = m.compiled
    out = {}
    for op, ws in m.params.items():
        for w, t in ws.items():
            pl = c.weight_placement(op, w)
            key = tuple(c.mesh.index(axes) if axes else 0 for axes in pl.dims)
            out[f"{op}/{w}"] = (key, hashlib.sha1(
                t.detach().contiguous().numpy().tobytes()).hexdigest())
    return out


def _mlp(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([8, 16], name="feat")
    t = m.dense(x, 32, activation="relu", name="a1")
    t = m.dense(t, 32, activation="tanh", name="a2")
    m.dense(t, 4, name="head")
    return m


def _placed_views(m):
    return {n.guid: MachineView((2,) + (1,) * (n.op.output_shapes[0].ndim
                                               - 1),
                                start_part=2 if n.op.name == "head" else 0)
            for n in m.graph.topo_order()}


def _recompile_legs(rank):
    """Pipelined (pp 2 x dp 2, M 2) and placed (2 + 2 ranks) models:
    4 steps straight, and 2 steps, ``recompile()``, 2 steps."""
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

    rng = np.random.default_rng(7)
    out = {}
    xt = rng.normal(size=(32, 8, 16)).astype(np.float32)
    yt = rng.normal(size=(32, 8, 16)).astype(np.float32)
    xm = rng.normal(size=(32, 16)).astype(np.float32)
    ym = rng.integers(0, 4, size=(32,)).astype(np.int32)

    def pipelined():
        m = build_transformer(tff.FFConfig(batch_size=8, device="cpu",
                                           num_devices=4,
                                           compute_dtype="float32",
                                           only_data_parallel=True),
                              num_layers=2, hidden=16, num_heads=2,
                              ff_dim=32, seq_len=8)
        m.compile(optimizer=tff.AdamOptimizer(alpha=1e-3),
                  loss_type="mean_squared_error", metrics=[],
                  pipeline=PipelineConfig(num_stages=2, num_microbatches=2))
        return m, xt, yt

    def placed():
        m = _mlp(tff, tff.FFConfig(batch_size=8, device="cpu",
                                   num_devices=4, compute_dtype="float32"))
        m.compile(optimizer=tff.AdamOptimizer(alpha=1e-3), metrics=[],
                  loss_type="sparse_categorical_crossentropy",
                  strategy=_placed_views(m))
        return m, xm, ym

    for leg, make in (("pipelined", pipelined), ("placed", placed)):
        runs = {}
        for tag in ("straight", "recompiled"):
            m, x, y = make()
            kinds = [type(m.compiled).__name__]
            losses = []
            for i in range(4):
                if tag == "recompiled" and i == 2:
                    m.recompile()
                    kinds.append(type(m.compiled).__name__)
                rows = slice(8 * i, 8 * i + 8)
                losses.append(_step_on(m, x[rows], y[rows]))
            runs[tag] = {"kinds": kinds, "losses": losses}
        out[leg] = runs
    return out


def world_rank(rank, kind, ckpt_dir):
    """One rank of a world: ``"world4"`` trains the GPT under Megatron
    dp 2 x tp 2 for 2 steps, saves (every rank takes part, rank 0
    writes), takes one more step, then runs the recompile legs;
    ``"world2"`` trains the tiny BERT (dropout 0.1) data parallel over
    2 ranks with ``grad_accum_steps=2`` for 2 steps."""
    if kind == "world4":
        m = _gpt(4, megatron=True)
        ids = gpt_ids()
        x, y = ids[:, :-1], ids[:, 1:]
        losses = [_step_on(m, x[i:i + 4], y[i:i + 4]) for i in (0, 4)]
        CheckpointManager(ckpt_dir).save(2, m)
        losses.append(_step_on(m, x[8:12], y[8:12]))
        return {"losses": losses, "recompile": _recompile_legs(rank)}
    m = _bert(num_devices=2, grad_accum_steps=2)
    x, y = _bert_data()
    losses = [_step_on(m, x[i:i + 4], y[i:i + 4]) for i in (0, 4)]
    return {"losses": losses, "digests": _digests(m)}


def world(tmp_path_factory, kind):
    """The world's ranks' results (once per run), with the checkpoint
    directory the world of 4 wrote."""
    def compute():
        from flexflow_tpu_torch.runtime.distributed import spawn

        tmp = tmp_path_factory.mktemp(kind)
        ckpt = str(tmp / "ckpt")
        n = 4 if kind == "world4" else 2
        ranks = spawn(world_rank, n, (kind, ckpt),
                      init_method=f"file://{tmp / 'rendezvous'}",
                      device="cpu", timeout=600)
        return {"ranks": ranks, "ckpt": ckpt}

    return shared_world(tmp_path_factory, f"torch_{kind}_surface", compute)


def test_a_megatron_world_checkpoint_resumes_on_one_process(
        tmp_path_factory):
    got = world(tmp_path_factory, "world4")
    ranks = got["ranks"]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    one = _gpt(1)
    assert CheckpointManager(got["ckpt"]).restore(one) == 2
    ids = gpt_ids()
    loss = _step_on(one, ids[8:12, :-1], ids[8:12, 1:])
    world_next = ranks[0]["losses"][2]
    assert abs(loss - world_next) <= 1e-5 * abs(world_next)
