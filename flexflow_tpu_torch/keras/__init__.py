"""flexflow_tpu_torch.keras — drop-in Keras-style frontend.

The JAX package's flexflow_tpu/keras, with its exports (after FlexFlow's
python/flexflow/keras/ — models/base_model.py Sequential / functional
Model with compile/fit/evaluate, layers/*, callbacks.py, optimizers.py,
losses.py, metrics.py), lowering onto the port's FFModel.  The model
runs on the card unless ``compile(config=FFConfig(device="cpu"))``.

Usage::

    from flexflow_tpu_torch import keras
    model = keras.Sequential([
        keras.layers.Dense(64, activation="relu", input_shape=(16,)),
        keras.layers.Dense(4),
    ])
    model.compile(optimizer=keras.optimizers.SGD(0.1),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, epochs=4, callbacks=[keras.callbacks.EarlyStopping()])
"""

from flexflow_tpu_torch.keras import (  # noqa: F401
    callbacks,
    datasets,
    layers,
    losses,
    metrics,
    optimizers,
    preprocessing,
)
from flexflow_tpu_torch.keras.layers import Input  # noqa: F401
from flexflow_tpu_torch.keras.models import Model, Sequential  # noqa: F401

__all__ = ["layers", "callbacks", "optimizers", "losses", "metrics",
           "Sequential", "Model", "Input"]
