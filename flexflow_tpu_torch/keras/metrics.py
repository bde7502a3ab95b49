"""Keras metric-name mapping (the JAX package's keras/metrics.py, after
FlexFlow's python/flexflow/keras/metrics.py)."""

from __future__ import annotations

_ALIASES = {
    "accuracy": "accuracy",
    "acc": "accuracy",
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
    "root_mean_squared_error": "root_mean_squared_error",
    "rmse": "root_mean_squared_error",
    "mean_absolute_error": "mean_absolute_error",
    "mae": "mean_absolute_error",
}


class Metric:
    name = "accuracy"


class Accuracy(Metric):
    name = "accuracy"


class SparseCategoricalCrossentropy(Metric):
    name = "sparse_categorical_crossentropy"


class MeanSquaredError(Metric):
    name = "mean_squared_error"


def resolve_metrics(metrics) -> list:
    out = []
    for m in metrics:
        if isinstance(m, Metric):
            out.append(m.name)
        else:
            out.append(_ALIASES.get(m, m))
    return out
