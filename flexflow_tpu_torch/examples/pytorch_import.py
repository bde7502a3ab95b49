"""PyTorch import example (examples/pytorch_import.py; reference:
examples/python/pytorch/*): trace a torch module, import it via
torch.fx, train it with the framework.  The module lives on the
config's device and is traced there.

Usage: python -m flexflow_tpu_torch.examples.pytorch_import -b 32 -e 2
"""
import numpy as np
import torch.nn as nn

from flexflow_tpu_torch import FFModel
from flexflow_tpu_torch.examples.common import config_of
from flexflow_tpu_torch.frontends import PyTorchModel, transfer_torch_weights


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(64, 256)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(256, 10)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def main(argv=None, config=None):
    config = config_of(argv, config)
    torch_net = Net().to(config.torch_device())
    model = FFModel(config)
    x = model.create_tensor([config.batch_size, 64])
    PyTorchModel(torch_net).torch_to_ff(model, [x])
    model.compile(loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    transfer_torch_weights(torch_net, model)

    rng = np.random.default_rng(0)
    n = config.batch_size * 8
    centers = rng.normal(size=(10, 64)) * 2
    y = rng.integers(0, 10, n)
    xs = (centers[y] + rng.normal(size=(n, 64))).astype(np.float32)
    model.fit(x=xs, y=y.astype(np.int32))
    return model


if __name__ == "__main__":
    main()
