"""Keras CIFAR-10 CNN example (examples/keras_cifar10_cnn.py; reference:
examples/python/keras/, the cifar10_cnn family of scripts, plus the
accuracy-callback discipline of accuracy.py).

Loads CIFAR-10 through the dataset loader (the real data when the
archive is cached locally, a loudly-warned deterministic synthetic
fallback otherwise) and trains a small conv net with checkpointing and
early stopping.

Usage: python -m flexflow_tpu_torch.examples.keras_cifar10_cnn -b 32 -e 2
"""
import tempfile

import numpy as np

from flexflow_tpu_torch import keras
from flexflow_tpu_torch.examples.common import config_of


def main(argv=None, config=None):
    config = config_of(argv, config)
    (x_train, y_train), _ = keras.datasets.cifar10.load_data()
    # the loader is NCHW like the reference's; the model is NHWC-native
    n = min(len(x_train), config.batch_size * 16)
    x = (x_train[:n].transpose(0, 2, 3, 1) / 255.0).astype(np.float32)
    y = y_train[:n].astype(np.int32)

    model = keras.Sequential([
        keras.layers.Conv2D(32, (3, 3), activation="relu", padding="same",
                            input_shape=(32, 32, 3)),
        keras.layers.MaxPooling2D((2, 2)),
        keras.layers.Conv2D(64, (3, 3), activation="relu", padding="same"),
        keras.layers.MaxPooling2D((2, 2)),
        keras.layers.Flatten(),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dropout(0.25),
        keras.layers.Dense(10),
    ])
    model.compile(optimizer=keras.optimizers.SGD(0.02),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], config=config)
    # the checkpoints go to a directory of this call's own: another
    # process running the example at the same time keeps its own
    with tempfile.TemporaryDirectory(prefix="ff_keras_cifar_ckpt_") as ckpt:
        model.fit(x, y, epochs=config.epochs, callbacks=[
            keras.callbacks.ModelCheckpoint(ckpt),
            keras.callbacks.EarlyStopping(monitor="loss", patience=3),
        ])
    print(model.summary())
    return model


if __name__ == "__main__":
    main()
