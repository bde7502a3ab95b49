"""The port of flexflow_tpu/models/alexnet.py, op names equal to the
reference's (a params dict carries across). AlexNet (reference:
examples/cpp/AlexNet/alexnet.cc:1-428 and
bootcamp_demo/ff_alexnet_cifar10.py). NHWC layout."""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_alexnet(config: FFConfig, num_classes: int = 1000, image: int = 224):
    """Classic AlexNet over [B, image, image, 3]."""
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, image, image, 3], name="image")
    t = model.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation="relu", name="conv1")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool1")
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu", name="conv2")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool2")
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu", name="conv3")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv4")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv5")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool5")
    t = model.flat(t, name="flat")
    t = model.dense(t, 4096, activation="relu", name="fc6")
    t = model.dropout(t, 0.5, name="drop6")
    t = model.dense(t, 4096, activation="relu", name="fc7")
    t = model.dropout(t, 0.5, name="drop7")
    t = model.dense(t, num_classes, name="fc8")
    return model


def build_alexnet_cifar10(config: FFConfig, num_classes: int = 10):
    """CIFAR-sized variant (reference: bootcamp_demo/ff_alexnet_cifar10.py):
    32x32 input, shrunk convs."""
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, 32, 32, 3], name="image")
    t = model.conv2d(x, 64, 5, 5, 1, 1, 2, 2, activation="relu", name="conv1")
    t = model.pool2d(t, 2, 2, 2, 2, name="pool1")
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu", name="conv2")
    t = model.pool2d(t, 2, 2, 2, 2, name="pool2")
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu", name="conv3")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv4")
    t = model.pool2d(t, 2, 2, 2, 2, name="pool4")
    t = model.flat(t, name="flat")
    t = model.dense(t, 2048, activation="relu", name="fc1")
    t = model.dropout(t, 0.5, name="drop1")
    t = model.dense(t, num_classes, name="fc2")
    return model
