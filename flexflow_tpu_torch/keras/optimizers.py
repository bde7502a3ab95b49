"""Keras-style optimizer wrappers (the JAX package's keras/optimizers.py,
after FlexFlow's python/flexflow/keras/optimizers.py)."""

from __future__ import annotations

from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer


class SGD:
    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_ff(self, config):
        return SGDOptimizer(lr=self.learning_rate, momentum=self.momentum,
                            nesterov=self.nesterov,
                            weight_decay=self.weight_decay)


class Adam:
    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8):
        self.learning_rate = learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon

    def to_ff(self, config):
        return AdamOptimizer(alpha=self.learning_rate, beta1=self.beta_1,
                             beta2=self.beta_2, epsilon=self.epsilon)


def resolve_optimizer(opt, config):
    """string | keras wrapper | native Optimizer -> native Optimizer."""
    if isinstance(opt, str):
        table = {"sgd": SGD(), "adam": Adam()}
        opt = table[opt.lower()]
    if hasattr(opt, "to_ff"):
        return opt.to_ff(config)
    return opt  # already a native flexflow_tpu_torch Optimizer
