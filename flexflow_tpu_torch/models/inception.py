"""The port of flexflow_tpu/models/inception.py, op names equal to the
reference's (a params dict carries across). InceptionV3 (reference:
examples/cpp/InceptionV3/inception.cc:1-231). The multi-branch modules
are the reference's showcase for nonsequence (branch-parallel)
placement in the search."""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def _conv_bn(model, t, ch, kh, kw, sh=1, sw=1, ph=0, pw=0, name=""):
    t = model.conv2d(t, ch, kh, kw, sh, sw, ph, pw, use_bias=False, name=f"{name}_conv")
    return model.batch_norm(t, relu=True, name=f"{name}_bn")


def _inception_a(model, t, pool_ch, name):
    """reference: inception.cc InceptionA"""
    b1 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(model, t, 48, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, 64, 5, 5, 1, 1, 2, 2, name=f"{name}_b2b")
    b3 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3b")
    b3 = _conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3c")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{name}_b4p")
    b4 = _conv_bn(model, b4, pool_ch, 1, 1, name=f"{name}_b4")
    return model.concat([b1, b2, b3, b4], axis=3, name=f"{name}_cat")


def _inception_b(model, t, name):
    b1 = _conv_bn(model, t, 384, 3, 3, 2, 2, name=f"{name}_b1")
    b2 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b2b")
    b2 = _conv_bn(model, b2, 96, 3, 3, 2, 2, name=f"{name}_b2c")
    b3 = model.pool2d(t, 3, 3, 2, 2, name=f"{name}_b3p")
    return model.concat([b1, b2, b3], axis=3, name=f"{name}_cat")


def _inception_c(model, t, c7, name):
    b1 = _conv_bn(model, t, 192, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(model, t, c7, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, c7, 1, 7, 1, 1, 0, 3, name=f"{name}_b2b")
    b2 = _conv_bn(model, b2, 192, 7, 1, 1, 1, 3, 0, name=f"{name}_b2c")
    b3 = _conv_bn(model, t, c7, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(model, b3, c7, 7, 1, 1, 1, 3, 0, name=f"{name}_b3b")
    b3 = _conv_bn(model, b3, c7, 1, 7, 1, 1, 0, 3, name=f"{name}_b3c")
    b3 = _conv_bn(model, b3, c7, 7, 1, 1, 1, 3, 0, name=f"{name}_b3d")
    b3 = _conv_bn(model, b3, 192, 1, 7, 1, 1, 0, 3, name=f"{name}_b3e")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{name}_b4p")
    b4 = _conv_bn(model, b4, 192, 1, 1, name=f"{name}_b4")
    return model.concat([b1, b2, b3, b4], axis=3, name=f"{name}_cat")


def _inception_d(model, t, name):
    b1 = _conv_bn(model, t, 192, 1, 1, name=f"{name}_b1a")
    b1 = _conv_bn(model, b1, 320, 3, 3, 2, 2, name=f"{name}_b1b")
    b2 = _conv_bn(model, t, 192, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, 192, 1, 7, 1, 1, 0, 3, name=f"{name}_b2b")
    b2 = _conv_bn(model, b2, 192, 7, 1, 1, 1, 3, 0, name=f"{name}_b2c")
    b2 = _conv_bn(model, b2, 192, 3, 3, 2, 2, name=f"{name}_b2d")
    b3 = model.pool2d(t, 3, 3, 2, 2, name=f"{name}_b3p")
    return model.concat([b1, b2, b3], axis=3, name=f"{name}_cat")


def _inception_e(model, t, name):
    b1 = _conv_bn(model, t, 320, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(model, t, 384, 1, 1, name=f"{name}_b2a")
    b2a = _conv_bn(model, b2, 384, 1, 3, 1, 1, 0, 1, name=f"{name}_b2b")
    b2b = _conv_bn(model, b2, 384, 3, 1, 1, 1, 1, 0, name=f"{name}_b2c")
    b2 = model.concat([b2a, b2b], axis=3, name=f"{name}_b2cat")
    b3 = _conv_bn(model, t, 448, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(model, b3, 384, 3, 3, 1, 1, 1, 1, name=f"{name}_b3b")
    b3a = _conv_bn(model, b3, 384, 1, 3, 1, 1, 0, 1, name=f"{name}_b3c")
    b3b = _conv_bn(model, b3, 384, 3, 1, 1, 1, 1, 0, name=f"{name}_b3d")
    b3 = model.concat([b3a, b3b], axis=3, name=f"{name}_b3cat")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{name}_b4p")
    b4 = _conv_bn(model, b4, 192, 1, 1, name=f"{name}_b4")
    return model.concat([b1, b2, b3, b4], axis=3, name=f"{name}_cat")


def build_inception_v3(config: FFConfig, num_classes: int = 1000, image: int = 299):
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, image, image, 3], name="image")
    t = _conv_bn(model, x, 32, 3, 3, 2, 2, name="stem1")
    t = _conv_bn(model, t, 32, 3, 3, name="stem2")
    t = _conv_bn(model, t, 64, 3, 3, 1, 1, 1, 1, name="stem3")
    t = model.pool2d(t, 3, 3, 2, 2, name="stem_pool1")
    t = _conv_bn(model, t, 80, 1, 1, name="stem4")
    t = _conv_bn(model, t, 192, 3, 3, name="stem5")
    t = model.pool2d(t, 3, 3, 2, 2, name="stem_pool2")
    t = _inception_a(model, t, 32, "mixed0")
    t = _inception_a(model, t, 64, "mixed1")
    t = _inception_a(model, t, 64, "mixed2")
    t = _inception_b(model, t, "mixed3")
    t = _inception_c(model, t, 128, "mixed4")
    t = _inception_c(model, t, 160, "mixed5")
    t = _inception_c(model, t, 160, "mixed6")
    t = _inception_c(model, t, 192, "mixed7")
    t = _inception_d(model, t, "mixed8")
    t = _inception_e(model, t, "mixed9")
    t = _inception_e(model, t, "mixed10")
    t = model.pool2d(t, t.sizes[1], t.sizes[2], 1, 1, pool_type="avg", name="avgpool")
    t = model.flat(t, name="flat")
    t = model.dense(t, num_classes, name="fc")
    return model
