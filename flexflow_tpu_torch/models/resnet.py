"""The port of flexflow_tpu/models/resnet.py, op names equal to the
reference's (a params dict carries across). ResNet / ResNeXt-50
(reference: examples/cpp/ResNet/resnet.cc:1-417,
examples/cpp/resnext50/resnext.cc:1-140). NHWC, batch-norm blocks."""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def _bottleneck(model, t, out_ch, stride, name, groups=1, width=None):
    """1x1 -> 3x3(groups) -> 1x1 with projection shortcut
    (reference: resnet.cc BottleneckBlock; resnext.cc groups=32)."""
    width = width or out_ch // 4
    shortcut = t
    in_ch = t.sizes[-1]
    u = model.conv2d(t, width, 1, 1, 1, 1, 0, 0, name=f"{name}_c1", use_bias=False)
    u = model.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = model.conv2d(u, width, 3, 3, stride, stride, 1, 1, groups=groups,
                     name=f"{name}_c2", use_bias=False)
    u = model.batch_norm(u, relu=True, name=f"{name}_bn2")
    u = model.conv2d(u, out_ch, 1, 1, 1, 1, 0, 0, name=f"{name}_c3", use_bias=False)
    u = model.batch_norm(u, relu=False, name=f"{name}_bn3")
    if stride != 1 or in_ch != out_ch:
        shortcut = model.conv2d(shortcut, out_ch, 1, 1, stride, stride, 0, 0,
                                name=f"{name}_proj", use_bias=False)
        shortcut = model.batch_norm(shortcut, relu=False, name=f"{name}_bnp")
    u = model.add(u, shortcut, name=f"{name}_add")
    return model.relu(u, name=f"{name}_relu")


def build_resnet(config: FFConfig, num_classes: int = 1000, image: int = 224,
                 layers=(3, 4, 6, 3), groups: int = 1, base_width: int = 64):
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, image, image, 3], name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, use_bias=False, name="conv1")
    t = model.batch_norm(t, relu=True, name="bn1")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    channels = [256, 512, 1024, 2048]
    for stage, (n_blocks, out_ch) in enumerate(zip(layers, channels)):
        for i in range(n_blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            # ResNeXt widths: base_width=4 per group x 32 groups doubles
            # the 3x3 width vs ResNet (resnext.cc)
            if groups == 1:
                width = (out_ch // 4) * base_width // 64
            else:
                width = out_ch // 2
            t = _bottleneck(model, t, out_ch, stride,
                            f"s{stage}b{i}", groups=groups, width=width)
    t = model.pool2d(t, t.sizes[1], t.sizes[2], 1, 1, pool_type="avg", name="avgpool")
    t = model.flat(t, name="flat")
    t = model.dense(t, num_classes, name="fc")
    return model


def build_resnext50(config: FFConfig, num_classes: int = 1000, image: int = 224):
    """ResNeXt-50 32x4d (reference: resnext.cc — groups=32)."""
    return build_resnet(config, num_classes, image, layers=(3, 4, 6, 3), groups=32)
