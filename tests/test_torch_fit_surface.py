"""``fit``'s training surface in the port against the JAX package's, and
``recompile()`` (``runtime/recompile.py``).

* Callbacks: a recording keras-protocol callback sees the reference's
  calls in the reference's order, with the same log keys and (fp32,
  the same weights) losses within 1e-5; a False from ``on_epoch_end``
  stops both after that epoch.
* ``validation_split``: the history keys equal the reference's, the
  ``val_*`` values within 1e-5; every refused form raises the
  reference's exception type and message.
* A ``RecompileState`` whose ``alter`` changes an op's attribute (a
  dropout rate) re-lowers once, mid-``fit``, and carries the weights and
  Adam slots over; the steps after it run the altered op.
* ``recompile()`` of a pipelined (pp 2 x dp 2) and a placed (2 + 2
  ranks) model on a gloo world of 4 keeps it pipelined or placed, and
  its 4 losses equal those of a run without the recompile bit for bit
  (the world is tests/test_torch_checkpoint.py's, spawned once per
  run).
* The export table: every name ``flexflow_tpu_torch`` exports is one of
  the reference's ``_LAZY`` names and resolves.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as JView
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.interop import params_from_numpy
from flexflow_tpu_torch.runtime.recompile import RecompileState

from test_torch_checkpoint import world

CCE = dict(loss_type="sparse_categorical_crossentropy",
           metrics=["accuracy"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    def __init__(self, stop_at=None):
        self.model = None
        self.calls = []
        self.stop_at = stop_at

    def set_model(self, model):
        self.model = model
        self.calls.append(("set_model",))

    def on_train_begin(self, logs=None):
        self.calls.append(("on_train_begin",))

    def on_epoch_begin(self, epoch, logs=None):
        self.calls.append(("on_epoch_begin", epoch))

    def on_epoch_end(self, epoch, logs=None):
        self.calls.append(("on_epoch_end", epoch, dict(logs)))
        return False if epoch == self.stop_at else None

    def on_train_end(self, logs=None):
        self.calls.append(("on_train_end",))


def _mlp(pkg, cfg, rate=0.0):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([8, 16], name="feat")
    t = m.dense(x, 32, activation="relu", name="d0")
    if rate:
        t = m.dropout(t, rate=rate, name="drop")
    m.dense(t, 4, name="d1")
    return m


def _pair():
    jm = _mlp(ff, ff.FFConfig(batch_size=8, num_devices=1,
                              compute_dtype="float32", cost_cache_file=""))
    jm.compile(optimizer=ff.AdamOptimizer(alpha=1e-2),
               strategy={n.guid: JView.trivial(n.op.output_shapes[0].ndim)
                         for n in jm.graph.topo_order()}, **CCE)
    pm = _mlp(tff, tff.FFConfig(batch_size=8, device="cpu",
                                compute_dtype="float32",
                                only_data_parallel=True))
    pm.compile(optimizer=tff.AdamOptimizer(alpha=1e-2), **CCE)
    pm.params = params_from_numpy({op: {w: np.array(v) for w, v in ws.items()}
                                   for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)
    return jm, pm


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 16).astype(np.float32),
            rng.randint(0, 4, size=(n,)).astype(np.int32))


def _strip(calls):
    """The calls with their logs' keys, and the logs by epoch."""
    shape = [c[:2] + (sorted(c[2]),) if len(c) == 3 else c for c in calls]
    logs = [c[2] for c in calls if len(c) == 3]
    return shape, logs


@pytest.mark.parametrize("stop_at", [None, 1])
def test_callbacks_see_the_references_calls_and_logs(stop_at):
    x, y = _data()
    vx, vy = _data(16, seed=1)
    jm, pm = _pair()
    jr, pr = Recorder(stop_at), Recorder(stop_at)
    jh = jm.fit(x, y, epochs=3, shuffle=False, verbose=False, callbacks=[jr],
                validation_data=(vx, vy))
    ph = pm.fit(x, y, epochs=3, shuffle=False, verbose=False, callbacks=[pr],
                validation_data=(vx, vy))
    assert jr.model is jm and pr.model is pm
    (jc, jlogs), (pc, plogs) = _strip(jr.calls), _strip(pr.calls)
    assert pc == jc
    assert len(ph) == len(jh) == (2 if stop_at == 1 else 3)
    for a, b in zip(plogs + ph, jlogs + jh):
        assert sorted(a) == sorted(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1.0), k


def test_validation_split_keys_values_and_errors():
    x, y = _data()
    jm, pm = _pair()
    jh = jm.fit(x, y, epochs=2, shuffle=False, verbose=False,
                validation_split=0.2)
    ph = pm.fit(x, y, epochs=2, shuffle=False, verbose=False,
                validation_split=0.2)
    assert [sorted(h) for h in ph] == [sorted(h) for h in jh]
    assert {"val_loss", "val_accuracy"} <= set(ph[0])
    for a, b in zip(ph, jh):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1.0), k
    for kw in (dict(validation_split=0.1, validation_data=(x, y)),
               dict(validation_split=1.0), dict(validation_split=-0.5),
               dict(validation_split=0.01), dict(validation_data=(x[:4],
                                                                  y[:4])),
               dict(validation_data=x), dict(resume=True)):
        with pytest.raises(Exception) as je:
            jm.fit(x, y, verbose=False, **kw)
        with pytest.raises(Exception) as pe:
            pm.fit(x, y, verbose=False, **kw)
        assert pe.type is je.type and str(pe.value) == str(je.value), kw


def test_a_recompile_state_relowers_once_and_carries_the_weights():
    x, y = _data(48)
    pm = _mlp(tff, tff.FFConfig(batch_size=8, device="cpu",
                                compute_dtype="float32",
                                only_data_parallel=True), rate=0.5)
    pm.compile(optimizer=tff.AdamOptimizer(alpha=1e-2), **CCE)
    seen = {"steps": 0, "recompiles": 0}
    relower = pm.recompile

    def recompile():
        seen["recompiles"] += 1
        seen["before"] = ([t.clone() for ws in pm.params.values()
                           for t in ws.values()],
                          [t.clone() for ws in pm.opt_state["m"].values()
                           for t in ws.values()])
        seen["compiled"] = pm.compiled
        out = relower()
        seen["after"] = ([t.clone() for ws in pm.params.values()
                          for t in ws.values()],
                         [t.clone() for ws in pm.opt_state["m"].values()
                          for t in ws.values()])
        return out

    pm.recompile = recompile

    def trigger(model):
        seen["steps"] += 1
        return seen["steps"] == 3

    def alter(model):
        model.node_by_name("drop").op.attrs["rate"] = 0.0

    rs = RecompileState(trigger, alter)
    hist = pm.fit(x, y, epochs=2, shuffle=False, verbose=False,
                  recompile_state=rs)
    # once altered, the trigger is not consulted again
    assert rs.altered and seen["recompiles"] == 1 and seen["steps"] == 3
    assert pm.compiled is not seen["compiled"]
    for a, b in zip(seen["before"][0] + seen["before"][1],
                    seen["after"][0] + seen["after"][1]):
        assert torch.equal(a, b)
    assert len(hist) == 2 and np.isfinite(pm.step_losses).all()
    # the altered op runs: with rate 0 a training pass is the identity
    c = pm.compiled
    with torch.no_grad():
        a = c.apply(pm.params, pm.state, [torch.from_numpy(x[:8])],
                    train=True, seed=torch.tensor(5))[0]
        b = c.apply(pm.params, pm.state, [torch.from_numpy(x[:8])])[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("leg,kind", [("pipelined", "PipelinedCompiledModel"),
                                      ("placed", "PlacedCompiledModel")])
def test_recompile_keeps_a_pipelined_or_placed_model_as_it_was(
        tmp_path_factory, leg, kind):
    ranks = world(tmp_path_factory, "world4")["ranks"]
    for r in ranks:
        runs = r["recompile"][leg]
        assert runs["straight"]["kinds"] == [kind]
        assert runs["recompiled"]["kinds"] == [kind, kind]
        assert runs["recompiled"]["losses"] == runs["straight"]["losses"]
        assert runs["straight"]["losses"] == ranks[0]["recompile"][leg][
            "straight"]["losses"]


def test_every_export_is_one_of_the_references():
    import flexflow_tpu

    names = set(tff.__all__)
    assert {"CheckpointManager", "RecompileState", "FFModel", "FFConfig",
            "MachineSpec", "Graph"} <= names
    assert names <= set(flexflow_tpu._LAZY), sorted(
        names - set(flexflow_tpu._LAZY))
    for name in names:
        assert getattr(tff, name) is not None
    from flexflow_tpu_torch.models import build_bert  # noqa: F401
