"""Keras loss-name mapping (the JAX package's keras/losses.py, after
FlexFlow's python/flexflow/keras/losses.py)."""

from __future__ import annotations

from flexflow_tpu_torch.losses import LossType


class Loss:
    def __init__(self, loss_type: LossType):
        self.loss_type = loss_type


class SparseCategoricalCrossentropy(Loss):
    def __init__(self):
        super().__init__(LossType.SPARSE_CATEGORICAL_CROSSENTROPY)


class CategoricalCrossentropy(Loss):
    def __init__(self):
        super().__init__(LossType.CATEGORICAL_CROSSENTROPY)


class MeanSquaredError(Loss):
    def __init__(self):
        super().__init__(LossType.MEAN_SQUARED_ERROR)


def resolve_loss(loss) -> LossType:
    if isinstance(loss, Loss):
        return loss.loss_type
    if isinstance(loss, LossType):
        return loss
    return LossType.from_any(loss)
