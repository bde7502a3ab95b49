"""tf.keras import example (examples/tf_keras_import.py; reference:
python/flexflow/keras_exp/: traverse a built tf.keras model's layer
graph, emit the matching FFModel, transfer weights, train).  Imports a
small transformer encoder block, MultiHeadAttention included.  Needs
TensorFlow: without it ``main`` raises an ImportError naming it.

Usage: python -m flexflow_tpu_torch.examples.tf_keras_import -b 8 -e 2
"""
import numpy as np

from flexflow_tpu_torch import FFModel
from flexflow_tpu_torch.examples.common import config_of, require


def main(argv=None, config=None):
    config = config_of(argv, config)
    tf = require("tensorflow", "the tf.keras frontend's source model")
    L = tf.keras.layers

    from flexflow_tpu_torch.frontends import TFKerasModel, transfer_tf_weights

    D, H, S = 32, 4, 10
    inp = tf.keras.Input((S, D))
    att = L.MultiHeadAttention(num_heads=H, key_dim=D // H, name="mha")(
        inp, inp)
    h = L.LayerNormalization(name="ln1")(L.Add(name="res1")([inp, att]))
    f = L.Dense(64, activation="gelu", name="ff1")(h)
    f = L.Dense(D, name="ff2")(f)
    h = L.LayerNormalization(name="ln2")(L.Add(name="res2")([h, f]))
    out = L.Dense(4, name="cls")(L.Flatten(name="fl")(h))
    tfm = tf.keras.Model(inp, out)

    model = FFModel(config)
    x = model.create_tensor([config.batch_size, S, D])
    TFKerasModel(tfm).to_ff(model, [x])
    model.compile(loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    n = transfer_tf_weights(tfm, model)
    print(f"imported tf.keras transformer block: {model.graph.num_nodes} "
          f"ops, {n} weights transferred")

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, S, D)).astype(np.float32)
    ys = rng.integers(0, 4, 64).astype(np.int32)
    model.fit(x=xs, y=ys, epochs=config.epochs)
    return model


if __name__ == "__main__":
    main()
