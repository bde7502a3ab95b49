"""Keras-frontend example (examples/keras_mnist_mlp.py; reference:
examples/python/keras/ scripts: a Sequential MNIST-style MLP with
callbacks).

Usage: python -m flexflow_tpu_torch.examples.keras_mnist_mlp -b 16 -e 1
"""
import numpy as np

from flexflow_tpu_torch import keras
from flexflow_tpu_torch.examples.common import config_of


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = keras.Sequential([
        keras.layers.Dense(256, activation="relu", input_shape=(784,)),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dropout(0.1),
        keras.layers.Dense(10),
    ])
    model.compile(optimizer=keras.optimizers.SGD(0.05),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], config=config)
    # synthetic MNIST-shaped data (the reference ships dataset loaders;
    # zero-egress environments use synthetic samples)
    rng = np.random.default_rng(0)
    n = config.batch_size * 16
    digits = rng.integers(0, 10, n)
    x = (rng.normal(size=(n, 784)) * 0.1 + digits[:, None] / 10.0).astype(np.float32)
    model.fit(x, digits.astype(np.int32), epochs=config.epochs,
              callbacks=[keras.callbacks.EarlyStopping(monitor="loss", patience=2)])
    print(model.summary())
    return model


if __name__ == "__main__":
    main()
