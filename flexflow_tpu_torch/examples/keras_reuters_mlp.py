"""Keras Reuters topic-classification MLP (examples/keras_reuters_mlp.py;
reference: examples/python/keras/reuters_mlp.py: tokenized newswire
sequences, multi-hot encoding, dense classifier).

Usage: python -m flexflow_tpu_torch.examples.keras_reuters_mlp -b 32 -e 2
"""
import numpy as np

from flexflow_tpu_torch import keras
from flexflow_tpu_torch.examples.common import config_of

NUM_WORDS = 2000
CLASSES = 46


def _multi_hot(seqs: np.ndarray) -> np.ndarray:
    """keras reuters semantics: ids >= num_words are out-of-vocabulary
    and simply absent from the multi-hot encoding (folding them with a
    modulo would alias unrelated words onto real features)."""
    out = np.zeros((len(seqs), NUM_WORDS), np.float32)
    for i, row in enumerate(seqs):
        ids = np.asarray(row)
        out[i, ids[ids < NUM_WORDS]] = 1.0
    return out


def main(argv=None, config=None):
    config = config_of(argv, config)
    (x_train, y_train), _ = keras.datasets.reuters.load_data(
        num_words=NUM_WORDS, maxlen=100)
    n = min(len(x_train), config.batch_size * 16)
    x = _multi_hot(x_train[:n])
    y = y_train[:n].astype(np.int32)

    model = keras.Sequential([
        keras.layers.Dense(256, activation="relu",
                           input_shape=(NUM_WORDS,)),
        keras.layers.Dropout(0.2),
        keras.layers.Dense(CLASSES),
    ])
    model.compile(optimizer=keras.optimizers.Adam(1e-3),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], config=config)
    model.fit(x, y, epochs=config.epochs)
    print(model.summary())
    return model


if __name__ == "__main__":
    main()
