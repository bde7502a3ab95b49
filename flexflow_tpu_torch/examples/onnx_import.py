"""ONNX import example (examples/onnx_import.py; reference:
examples/python/onnx/: load an .onnx model, apply it onto an FFModel,
train).

With ``--model file.onnx`` any ONNX file is imported (the vendored
wire-format reader parses it even without the onnx package); without
one, a small CNN is built and serialized first so the example needs no
download.

Usage: python -m flexflow_tpu_torch.examples.onnx_import -b 16 -e 2 [--model net.onnx]
"""
import os
import sys
import tempfile

import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer
from flexflow_tpu_torch.examples.common import config_of
from flexflow_tpu_torch.frontends import ONNXModel


def _make_demo_onnx(path: str) -> None:
    from flexflow_tpu_torch.frontends.onnx_minimal import (
        TensorProto,
        helper,
        numpy_helper,
        save,
    )

    rng = np.random.default_rng(0)
    wc = rng.normal(size=(8, 3, 3, 3)).astype(np.float32) * 0.2
    bc = np.zeros(8, np.float32)
    wl = rng.normal(size=(10, 8 * 8 * 8)).astype(np.float32) * 0.1
    bl = np.zeros(10, np.float32)
    nodes = [
        helper.make_node("Conv", ["x", "wc", "bc"], ["h1"], name="conv1",
                         kernel_shape=[3, 3], strides=[1, 1],
                         pads=[1, 1, 1, 1]),
        helper.make_node("Relu", ["h1"], ["h2"], name="relu1"),
        helper.make_node("MaxPool", ["h2"], ["h3"], name="pool1",
                         kernel_shape=[2, 2], strides=[2, 2]),
        helper.make_node("Flatten", ["h3"], ["h4"], name="flat"),
        helper.make_node("Gemm", ["h4", "wl", "bl"], ["y"], name="fc",
                         transB=1),
    ]
    g = helper.make_graph(
        nodes, "demo_cnn",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       (0, 3, 16, 16))],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, (0, 10))],
        [numpy_helper.from_array(a, n) for a, n in
         ((wc, "wc"), (bc, "bc"), (wl, "wl"), (bl, "bl"))],
    )
    save(helper.make_model(g), path)


def main(argv=None, config=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    path = None
    if "--model" in argv:
        i = argv.index("--model")
        path = argv[i + 1]
        del argv[i:i + 2]
    config = config_of(argv, config)
    if path is None:
        # a directory of this call's own: another process running an
        # example at the same time writes its own file
        with tempfile.TemporaryDirectory(prefix="ff_demo_cnn_") as tmp:
            path = os.path.join(tmp, "ff_demo_cnn.onnx")
            _make_demo_onnx(path)
            print(f"serialized demo CNN to {path}")
            om = ONNXModel(path)
    else:
        om = ONNXModel(path)

    model = FFModel(config)
    x = model.create_tensor([config.batch_size, 3, 16, 16], name="x")
    om.apply(model, {om.model.graph.input[0].name: x})
    model.compile(optimizer=SGDOptimizer(lr=0.05),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    n = om.transfer_onnx_weights(model)
    print(f"imported {path}: {model.graph.num_nodes} ops, "
          f"{n} weights transferred")

    rng = np.random.default_rng(1)
    xs = rng.normal(size=(128, 3, 16, 16)).astype(np.float32)
    ys = rng.integers(0, 10, 128).astype(np.int32)
    model.fit(x=xs, y=ys, epochs=config.epochs)
    return model


if __name__ == "__main__":
    main()
