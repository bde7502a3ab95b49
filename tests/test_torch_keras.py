"""The port's keras frontend (``flexflow_tpu_torch/keras/``) against the JAX
package's ``flexflow_tpu.keras``.

* Models: tests/test_keras.py's Sequential MLP and CNN (batch norm and
  dropout; the reference's masks handed to the port,
  tests/test_torch_dropout.py), the functional model with merge layers
  and two inputs, and the embedding model, built alike in both packages:
  the same layer names and ops, and from the reference's weights the
  same ``predict`` (1e-5) and 3 ``train_step``s (losses 1e-5 relative,
  weights 1e-5); ``fit`` over 3 batches gives the reference's history.
* Callbacks: ``LearningRateScheduler`` (the same history as the
  reference, and the captured step released at each change),
  ``EarlyStopping`` (the same stopping epoch), ``VerifyMetrics`` and
  ``EpochVerifyMetrics`` (pass and fail as the reference's), and
  ``ModelCheckpoint``: a directory written by either package restores
  into the other and predicts the same.
* ``datasets`` and ``preprocessing`` return the reference's arrays: the
  loaders' cached archives (one directory serves both packages) and
  their synthetic fallbacks (the generator's arrays, and each loader's
  arguments to it), the sequence and text utilities.
* The keras MNIST accuracy gate (tests/test_accuracy.py:44-66) on the
  port: 1024 rows, Dense 64 relu then Dense 10, SGD 0.1, batch 64, 8
  epochs, ``VerifyMetrics`` at 0.85.
"""

from __future__ import annotations

import importlib
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from flexflow_tpu import keras as jkeras
from flexflow_tpu.runtime.checkpoint import CheckpointManager as JManager
from flexflow_tpu_torch import keras
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

from test_torch_dropout import reference_masks
from test_torch_frontends import (
    close,
    port_config,
    ref_config,
    same_params,
    steps_pair,
    take_reference,
)

CCE = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blobs(n=256, d=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 3
    y = rng.integers(0, classes, size=n)
    x = centers[y] + rng.normal(size=(n, d))
    return x.astype(np.float32), y.astype(np.int32)


def _mlp(k):
    return k.Sequential([
        k.layers.Dense(64, activation="relu", input_shape=(16,)),
        k.layers.Dense(4),
    ])


def _cnn(k):
    return k.Sequential([
        k.layers.Conv2D(8, 3, padding="same", activation="relu",
                        input_shape=(8, 8, 3)),
        k.layers.MaxPooling2D(2),
        k.layers.BatchNormalization(),
        k.layers.Flatten(),
        k.layers.Dropout(0.1),
        k.layers.Dense(4),
    ])


def _functional(k):
    a, b = k.Input((16,)), k.Input((16,))
    h1 = k.layers.Dense(32, activation="relu")(a)
    h2 = k.layers.Dense(32, activation="relu")(b)
    merged = k.layers.Concatenate(axis=-1)([h1, h2])
    out = k.layers.Dense(4)(k.layers.Add()([merged, merged]))
    return k.Model([a, b], out)


def _embedding(k):
    return k.Sequential([
        k.layers.InputLayer((8,), dtype="int32"),
        k.layers.Embedding(50, 16),
        k.layers.Flatten(),
        k.layers.Dense(2),
    ])


def _data(name, n, rng):
    if name == "cnn":
        return ([rng.normal(size=(n, 8, 8, 3)).astype(np.float32)],
                rng.integers(0, 4, n).astype(np.int32))
    if name == "embedding":
        x = rng.integers(0, 50, size=(n, 8)).astype(np.int32)
        return [x], (x.sum(axis=1) % 2).astype(np.int32)
    x, y = blobs(n, seed=int(rng.integers(1 << 30)))
    return ([x, x[::-1].copy()] if name == "functional" else [x]), y


# name -> (builder, batch)
MODELS = {"mlp": (_mlp, 32), "cnn": (_cnn, 16),
          "functional": (_functional, 32), "embedding": (_embedding, 32)}


def _pair(name, optimizer="sgd", **cfg):
    build, batch = MODELS[name]
    jm, pm = build(jkeras), build(keras)
    jopt = (jkeras.optimizers.SGD(0.05) if optimizer == "sgd"
            else jkeras.optimizers.Adam(1e-3))
    popt = (keras.optimizers.SGD(0.05) if optimizer == "sgd"
            else keras.optimizers.Adam(1e-3))
    jm.compile(optimizer=jopt, loss=CCE, metrics=["accuracy"],
               config=ref_config(batch, **cfg))
    pm.compile(optimizer=popt, loss=CCE, metrics=["accuracy"],
               config=port_config(batch, **cfg))
    assert [(n.op.name, type(n.op).__name__)
            for n in pm.ffmodel.graph.topo_order()] == [
        (n.op.name, type(n.op).__name__)
        for n in jm.ffmodel.graph.topo_order()]
    take_reference(jm.ffmodel, pm.ffmodel)
    return jm, pm, batch


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_match_the_reference(name, monkeypatch):
    monkeypatch.setattr(LoweringContext, "mask_source", reference_masks())
    jm, pm, batch = _pair(name)
    rng = np.random.default_rng(3)
    xs, _ = _data(name, 2 * batch, rng)
    close(pm.predict(xs if len(xs) > 1 else xs[0]),
          jm.predict(xs if len(xs) > 1 else xs[0]))
    steps_pair(jm.ffmodel, pm.ffmodel,
               [_data(name, batch, rng) for _ in range(3)])


def test_fit_history_matches_the_reference():
    jm, pm, batch = _pair("mlp", optimizer="adam")
    x, y = blobs(3 * batch, seed=4)
    jh = jm.fit(x, y, epochs=2, shuffle=True, verbose=False)
    ph = pm.fit(x, y, epochs=2, shuffle=True, verbose=False)
    assert [set(h) for h in ph] == [set(h) for h in jh]
    for p, j in zip(ph, jh):
        assert abs(p["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
        assert p["accuracy"] == j["accuracy"]
    same_params(jm.ffmodel, pm.ffmodel, 1e-5)
    assert pm.summary() == jm.summary()
    got = pm.get_weights("dense")
    assert {k: v.dtype for k, v in got.items()} == {
        "kernel": np.float32, "bias": np.float32}
    pm.set_weights("dense", {k: v + 1.0 for k, v in got.items()})
    for k, v in pm.get_weights("dense").items():
        np.testing.assert_array_equal(v, got[k] + 1.0)


def test_lr_schedule_and_early_stopping_match_the_reference():
    jm, pm, batch = _pair("mlp")
    x, y = blobs(4 * batch, seed=5)
    released = []
    graph = pm.ffmodel.compiled.step_graph
    orig = graph.release
    graph.release = lambda: (released.append(1), orig())[1]
    hists = []
    for m, k in ((jm, jkeras), (pm, keras)):
        sched = k.callbacks.LearningRateScheduler(
            lambda e: 0.05 if e < 2 else 0.01)
        stop = k.callbacks.EarlyStopping(monitor="loss", patience=1,
                                         min_delta=0.2)
        hists.append(m.fit(x, y, epochs=8, shuffle=False, verbose=False,
                           callbacks=[sched, stop]))
        assert m.ffmodel.optimizer.lr == 0.01
    jh, ph = hists
    assert len(ph) == len(jh) < 8
    for p, j in zip(ph, jh):
        assert abs(p["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])
    assert released == [1]  # the step released once, at 0.05 -> 0.01
    same_params(jm.ffmodel, pm.ffmodel, 1e-5)


@pytest.mark.parametrize("threshold,passes", [(0.1, True), (0.9, False)])
def test_verify_metrics_pass_and_fail_as_the_reference(threshold, passes):
    jm, pm, batch = _pair("mlp")
    x, _ = blobs(4 * batch, seed=6)
    y = np.random.default_rng(6).integers(0, 4, len(x)).astype(np.int32)
    for m, k in ((jm, jkeras), (pm, keras)):
        cbs = [k.callbacks.VerifyMetrics("accuracy", threshold),
               k.callbacks.EpochVerifyMetrics("accuracy", threshold,
                                              from_epoch=2)]
        if passes:
            m.fit(x, y, epochs=3, shuffle=False, verbose=False,
                  callbacks=cbs)
        else:
            with pytest.raises(AssertionError):
                m.fit(x, y, epochs=3, shuffle=False, verbose=False,
                      callbacks=cbs)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_model_checkpoint_restores_across_packages(writer, tmp_path,
                                                   monkeypatch):
    """``ModelCheckpoint``'s npz snapshots (the reference without
    orbax) restore into the other package's fresh keras model."""
    ref_ckpt = importlib.import_module("flexflow_tpu.runtime.checkpoint")
    monkeypatch.setattr(ref_ckpt, "_HAS_ORBAX", False)
    jm, pm, batch = _pair("cnn")
    monkeypatch.setattr(LoweringContext, "mask_source", reference_masks())
    rng = np.random.default_rng(7)
    (x,), y = _data("cnn", 3 * batch, rng)
    src, k = (pm, keras) if writer == "port" else (jm, jkeras)
    cb = k.callbacks.ModelCheckpoint(str(tmp_path), every=2)
    src.fit(x, y, epochs=3, shuffle=False, verbose=False, callbacks=[cb])
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]
    dst = _cnn(jkeras if writer == "port" else keras)
    if writer == "port":
        dst.compile(optimizer=jkeras.optimizers.SGD(0.05), loss=CCE,
                    metrics=["accuracy"], config=ref_config(batch))
        step = JManager(str(tmp_path), use_orbax=False).restore(dst.ffmodel)
    else:
        dst.compile(optimizer=keras.optimizers.SGD(0.05), loss=CCE,
                    metrics=["accuracy"], config=port_config(batch))
        step = CheckpointManager(str(tmp_path)).restore(dst.ffmodel)
    assert step == 2
    close(dst.predict(x), src.predict(x))
    pair = (src, dst) if writer == "reference" else (dst, src)
    same_params(pair[0].ffmodel, pair[1].ffmodel)


# ---------------------------------------------------------------------------
def test_cached_archives_serve_both_packages(tmp_path, monkeypatch):
    """One ``FLEXFLOW_TPU_DATA_DIR`` holding mnist.npz, the CIFAR-10
    batches and reuters.npz: both packages' loaders return the same
    arrays from it."""
    rng = np.random.default_rng(8)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (6, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 6), x_test=rng.integers(
                 0, 256, (2, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 2))
    cifar = tmp_path / "cifar-10-batches-py"
    cifar.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (2, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 2))}, f)
    seqs = np.empty(10, dtype=object)
    for i in range(10):
        seqs[i] = list(rng.integers(1, 100, rng.integers(3, 9)))
    np.savez(tmp_path / "reuters.npz", x=seqs, y=rng.integers(0, 46, 10))
    monkeypatch.setenv("FLEXFLOW_TPU_DATA_DIR", str(tmp_path))
    tds = importlib.import_module("flexflow_tpu_torch.keras.datasets")
    jds = importlib.import_module("flexflow_tpu.keras.datasets")
    for loader in ("mnist", "cifar10", "reuters"):
        got = getattr(tds, loader).load_data()
        want = getattr(jds, loader).load_data()
        for g_split, w_split in zip(got, want):
            for g, w in zip(g_split, w_split):
                assert g.shape == w.shape and g.dtype == w.dtype, loader
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b, err_msg=loader)


def test_synthetic_fallbacks_match_the_reference(tmp_path, monkeypatch):
    """With no archive each loader warns and falls back to the same
    deterministic data: the generator gives the reference's arrays, and
    each loader asks it for the reference's shapes and seeds (recorded;
    the full-size arrays are generated once, by the chip phase)."""
    monkeypatch.setenv("FLEXFLOW_TPU_DATA_DIR", str(tmp_path))
    tds = importlib.import_module("flexflow_tpu_torch.keras.datasets")
    jds = importlib.import_module("flexflow_tpu.keras.datasets")
    for args in (((28, 28), 10, 40, 8, 12, np.uint8),
                 ((3, 32, 32), 10, 6, 4, 34, np.uint8),
                 ((16,), 4, 32, 8, 5, np.float32)):
        got = tds._synthetic_classification(*args[:5], dtype=args[5])
        want = jds._synthetic_classification(*args[:5], dtype=args[5])
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    calls = {}
    for pkg, mod in (("port", tds), ("reference", jds)):
        recorded = calls.setdefault(pkg, [])
        monkeypatch.setattr(mod, "_synthetic_classification",
                            lambda *a, _r=recorded, **kw: _r.append(
                                (a, kw)) or ((None, None), (None, None)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.mnist.load_data()
            mod.cifar10.load_data()
            got = mod.reuters.load_data(num_words=1000, maxlen=50)
        assert sum("SYNTHETIC" in str(w.message) for w in caught) == 3
        calls[pkg + "_reuters"] = got
    assert calls["port"] == calls["reference"]
    for g_split, w_split in zip(calls["port_reuters"],
                                calls["reference_reuters"]):
        for g, w in zip(g_split, w_split):
            np.testing.assert_array_equal(g, w)
    assert calls["port_reuters"][0][0].shape[1] == 50


def test_digits_and_preprocessing_match_the_reference():
    pytest.importorskip("sklearn")
    tds = importlib.import_module("flexflow_tpu_torch.keras.datasets")
    jds = importlib.import_module("flexflow_tpu.keras.datasets")
    for g_split, w_split in zip(tds.digits.load_data(seed=3),
                                jds.digits.load_data(seed=3)):
        for g, w in zip(g_split, w_split):
            np.testing.assert_array_equal(g, w)
    tp, jp = keras.preprocessing, jkeras.preprocessing
    seqs = [[1, 2, 3], [4, 5], [], [6, 7, 8, 9, 10, 11]]
    for kw in ({}, dict(maxlen=4, padding="post", truncating="post"),
               dict(maxlen=3, value=-1.0, dtype="float32")):
        np.testing.assert_array_equal(tp.pad_sequences(seqs, **kw),
                                      jp.pad_sequences(seqs, **kw))
    np.testing.assert_array_equal(tp.make_sampling_table(50),
                                  jp.make_sampling_table(50))
    seq = [3, 0, 5, 9, 2, 2, 7, 1, 0, 4]
    for kw in ({}, dict(window_size=2, negative_samples=0.5,
                        sampling_table=tp.make_sampling_table(10, 0.5))):
        assert tp.skipgrams(seq, 10, seed=2, **kw) == jp.skipgrams(
            seq, 10, seed=2, **kw)
    text = ["The cat sat; the cat ran!", "A dog, the dog."]
    assert tp.text_to_word_sequence(text[0]) == jp.text_to_word_sequence(
        text[0])
    assert tp.one_hot(text[1], 20) == jp.one_hot(text[1], 20)
    for kw in ({}, dict(num_words=4, oov_token="<oov>")):
        tt, jt = tp.Tokenizer(**kw), jp.Tokenizer(**kw)
        tt.fit_on_texts(text)
        jt.fit_on_texts(text)
        assert tt.word_index == jt.word_index
        assert tt.texts_to_sequences(text) == jt.texts_to_sequences(text)
        for mode in ("binary", "count"):
            np.testing.assert_array_equal(tt.texts_to_matrix(text, mode),
                                          jt.texts_to_matrix(text, mode))


def test_keras_mnist_accuracy_gate_on_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_DATA_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        (x, y), _ = keras.datasets.mnist.load_data()
    x = (x[:1024].astype(np.float32) / 255.0).reshape(-1, 784)
    y = y[:1024].astype(np.int32)
    model = keras.Sequential([
        keras.layers.Dense(64, activation="relu", input_shape=(784,)),
        keras.layers.Dense(10),
    ])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=0.1),
                  loss=CCE, metrics=["accuracy"],
                  config=port_config(64, epochs=8))
    cb = keras.callbacks.VerifyMetrics(metric="accuracy", threshold=0.85)
    hist = model.fit(x, y, epochs=8, verbose=False, callbacks=[cb])
    assert len(hist) == 8 and hist[-1]["accuracy"] >= 0.85, hist[-1]
