"""The port's tf.keras importer (``flexflow_tpu_torch/frontends/tf_keras.py``)
against the JAX package's, on tests/test_tf_frontend.py's models.

TensorFlow is optional: the file is skipped where it is missing (the
card's host has none, so this path is held on the CPU only).  For each
model both packages emit the same ops, ``transfer_tf_weights`` carries
the same arrays, and the forwards are within 1e-5 (fp32) of each other
and within the reference test's tolerance of tf's own; the MLP, the
CNN and the embedding transformer then take 3 SGD steps with losses
within 1e-5 relative and weights within 1e-5.  One ``MultiHeadAttention``
model at seq 512 takes the flash route on both sides (each package's
``flash_attention`` recorded): the port's plain versions of rows 1-3
against the reference's Pallas kernels in interpret mode, the forward
within tests/test_torch_flash_attention.py's fp32 output tolerance and
one step's weights within its gradient tolerance.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
from tensorflow.keras import layers as L  # noqa: E402

import flexflow_tpu as ff  # noqa: E402
from flexflow_tpu.frontends import TFKerasModel as JTFKerasModel  # noqa: E402
from flexflow_tpu.frontends import (  # noqa: E402
    transfer_tf_weights as j_transfer,
)
import flexflow_tpu_torch as tff  # noqa: E402
from flexflow_tpu_torch.frontends import (  # noqa: E402
    TFKerasModel,
    transfer_tf_weights,
)

from test_torch_frontends import (  # noqa: E402
    close,
    compile_pair,
    forwards,
    port_config,
    ref_config,
    same_params,
    steps_pair,
)
from test_torch_flash_attention import FP32_GRAD_TOL, FP32_OUT_TOL  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _functional_mlp():
    inp = tf.keras.Input((16,))
    h1 = L.Dense(32, activation="relu", name="d1")(inp)
    h2 = L.Dense(32, name="d2")(inp)
    m = L.Concatenate(name="cat")([h1, h2])
    out = L.Dense(4, name="head")(L.LayerNormalization(name="ln")(m))
    return tf.keras.Model(inp, out)


def _cnn():
    inp = tf.keras.Input((16, 16, 3))
    h = L.Conv2D(8, 3, padding="same", activation="relu", name="c1")(inp)
    h = L.MaxPooling2D(2, name="p1")(h)
    h = L.Flatten(name="f")(h)
    return tf.keras.Model(inp, L.Dense(4, name="head")(h))


def _sequential():
    return tf.keras.Sequential([
        tf.keras.Input((16,)),
        L.Dense(32, activation="relu", name="s1"),
        L.Dense(4, name="s2"),
    ])


def _transformer_block():
    d, h, s = 32, 4, 10
    inp = tf.keras.Input((s, d))
    att = L.MultiHeadAttention(num_heads=h, key_dim=d // h, name="mha")(
        inp, inp)
    x = L.LayerNormalization(name="ln1", epsilon=1e-5)(
        L.Add(name="res1")([inp, att]))
    f = L.Dense(d, name="ff2")(L.Dense(64, activation="gelu",
                                       name="ff1")(x))
    out = L.LayerNormalization(name="ln2", epsilon=1e-5)(
        L.Add(name="res2")([x, f]))
    return tf.keras.Model(inp, out)


def _embedding_transformer():
    v, d, h, s = 100, 16, 2, 6
    inp = tf.keras.Input((s,), dtype="int32")
    e = L.Embedding(v, d, name="emb")(inp)
    a = L.MultiHeadAttention(num_heads=h, key_dim=d // h, name="mha2")(e, e)
    x = L.LayerNormalization(name="ln")(L.Add(name="res")([e, a]))
    return tf.keras.Model(inp, L.Dense(4, name="head")(L.Flatten(
        name="fl")(x)))


def _mobilenet_block():
    inp = tf.keras.Input((8, 8, 6))
    x = L.DepthwiseConv2D(3, padding="same", name="dw")(inp)
    x = L.Conv2D(12, 1, name="pw")(L.ReLU(name="r1")(x))
    x = L.GlobalMaxPooling2D(name="gmp")(x)
    return tf.keras.Model(inp, L.Dense(4, name="head")(x))


def _depthwise_multiplier():
    inp = tf.keras.Input((6, 6, 4))
    x = L.DepthwiseConv2D(3, depth_multiplier=2, padding="same",
                          name="dw2")(inp)
    return tf.keras.Model(inp, L.GlobalAveragePooling2D(name="gap")(x))


# name -> (builder, input shape, input dtype, tolerance against tf (the
# reference test's), loss for 3 steps or None)
MODELS = {
    "functional_mlp": (_functional_mlp, (8, 16), "float32", 1e-4, "mse"),
    "cnn": (_cnn, (4, 16, 16, 3), "float32", 1e-3, "mse"),
    "sequential": (_sequential, (32, 16), "float32", 1e-4, None),
    "transformer_block": (_transformer_block, (8, 10, 32), "float32", 1e-4,
                          None),
    "embedding_transformer": (_embedding_transformer, (8, 6), "int32", 1e-4,
                              "cce"),
    "mobilenet_block": (_mobilenet_block, (4, 8, 8, 6), "float32", 1e-4,
                        None),
    "depthwise_multiplier": (_depthwise_multiplier, (4, 6, 6, 4),
                             "float32", 1e-4, None),
}


def _inputs(shape, dtype, rng):
    if dtype == "int32":
        return rng.integers(0, 100, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _pair(tfm, shape, dtype, loss):
    jm = ff.FFModel(ref_config(shape[0]))
    jouts = JTFKerasModel(tfm).to_ff(
        jm, [jm.create_tensor(list(shape), dtype=dtype)])
    pm = tff.FFModel(port_config(shape[0]))
    outs = TFKerasModel(tfm).to_ff(
        pm, [pm.create_tensor(list(shape), dtype=dtype)])
    assert [tuple(t.sizes) for t in outs] == [tuple(t.sizes) for t in jouts]
    if loss == "cce":
        compile_pair(jm, pm, loss_type="sparse_categorical_crossentropy",
                     metrics=["accuracy"])
    else:
        compile_pair(jm, pm, loss_type="mean_squared_error",
                     metrics=["mean_squared_error"])
    n = transfer_tf_weights(tfm, pm)
    assert n == j_transfer(tfm, jm) > 0
    same_params(jm, pm)
    return jm, pm, outs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_matches_tf_and_the_reference(name):
    build, shape, dtype, tf_tol, loss = MODELS[name]
    tfm = build()
    jm, pm, outs = _pair(tfm, shape, dtype, loss)
    rng = np.random.default_rng(0)
    x = _inputs(shape, dtype, rng)
    got, ref = forwards(jm, pm, [x])
    close(got, ref)
    np.testing.assert_allclose(got, tfm(x).numpy(), rtol=tf_tol,
                               atol=tf_tol)
    if loss is None:
        return
    out = tuple(outs[0].sizes)

    def label():
        if loss == "cce":
            return rng.integers(0, out[-1], size=shape[0]).astype(np.int32)
        return rng.normal(size=out).astype(np.float32)

    steps_pair(jm, pm, [([_inputs(shape, dtype, rng)], label())
                        for _ in range(3)])


def test_multihead_attention_at_seq_512_takes_the_flash_route(monkeypatch):
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
    b, s, d, h = 1, 512, 32, 2
    inp = tf.keras.Input((s, d))
    att = L.MultiHeadAttention(num_heads=h, key_dim=d // h, name="mha")(
        inp, inp)
    tfm = tf.keras.Model(inp, L.Dense(4, name="head")(L.Add(name="res")(
        [inp, att])))
    jm, pm, outs = _pair(tfm, (b, s, d), "float32", "mse")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    got, ref = forwards(jm, pm, [x])
    assert calls["jax"] >= 1 and calls["port"] == 1
    close(got, ref, FP32_OUT_TOL)
    np.testing.assert_allclose(got, tfm(x).numpy(), rtol=1e-4, atol=1e-4)
    steps_pair(jm, pm, [([x], rng.normal(size=(b, s, 4)).astype(
        np.float32))], tol=FP32_GRAD_TOL)
    assert calls["port"] == 2
