"""The port's ONNX importer (``flexflow_tpu_torch/frontends/onnx_frontend.py``
and its wire-format reader ``onnx_minimal.py``) against the JAX
package's.

* The wire format: the same models built by each package's
  ``onnx_minimal`` serialize to the same bytes, and each package's
  ``load`` reads the other's file back to the same nodes, attributes and
  initializers.
* Imports (neither host has ``onnx``, so ``onnx_minimal`` parses the
  files): tests/test_onnx.py's CNN (Conv, Relu, MaxPool, Flatten, Gemm)
  and MLP (the MatMul + Add decomposition, Gemm, Softmax), and a batch
  norm net (Conv, BatchNormalization with running statistics,
  GlobalAveragePool, Flatten, Gemm).  Both packages build the same ops,
  ``transfer_onnx_weights`` carries the same arrays, the forwards are
  within 1e-5 (fp32) of each other and of an ``F.conv2d``/``F.linear``
  composition, and 3 SGD steps give losses within 1e-5 relative and
  weights within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flexflow_tpu as ff
from flexflow_tpu.frontends import ONNXModel as JONNXModel
from flexflow_tpu.frontends import onnx_minimal as j_onnx
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.frontends import ONNXModel
from flexflow_tpu_torch.frontends import onnx_minimal as t_onnx

from test_torch_frontends import (
    close,
    compile_pair,
    forwards,
    port_config,
    ref_config,
    same_params,
    steps_pair,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(name, rng):
    if name == "cnn":
        return {"wc": rng.normal(size=(8, 3, 3, 3)) * 0.2,
                "bc": rng.normal(size=(8,)) * 0.1,
                "wl": rng.normal(size=(10, 8 * 4 * 4)) * 0.1,
                "bl": rng.normal(size=(10,)) * 0.1}
    if name == "mlp":
        return {"w1": rng.normal(size=(16, 32)) * 0.3,
                "b1": rng.normal(size=(32,)) * 0.1,
                "w2": rng.normal(size=(32, 4)) * 0.3,
                "b2": rng.normal(size=(4,)) * 0.1}
    return {"wc": rng.normal(size=(4, 3, 3, 3)) * 0.3,
            "scale": 1.0 + rng.normal(size=(4,)) * 0.1,
            "shift": rng.normal(size=(4,)) * 0.1,
            "mean": rng.normal(size=(4,)) * 0.2,
            "var": 1.0 + rng.uniform(size=(4,)),
            "wl": rng.normal(size=(2, 4)) * 0.3,
            "bl": rng.normal(size=(2,)) * 0.1}


# name -> (input shape, output width, loss)
GRAPHS = {
    "cnn": ((4, 3, 8, 8), 10, "sparse_categorical_crossentropy"),
    "mlp": ((8, 16), 4, "categorical_crossentropy"),
    "batchnorm": ((4, 3, 8, 8), 2, "mean_squared_error"),
}


def _graph(onnx, name, seed=1):
    """tests/test_onnx.py's graphs, built by one package's
    ``onnx_minimal``: (model, weights)."""
    helper, TensorProto = onnx.helper, onnx.TensorProto
    shape, width, _ = GRAPHS[name]
    w = {k: v.astype(np.float32)
         for k, v in _weights(name, np.random.default_rng(seed)).items()}
    node = helper.make_node
    if name == "cnn":
        nodes = [node("Conv", ["x", "wc", "bc"], ["h1"], name="conv1",
                      kernel_shape=[3, 3], strides=[1, 1],
                      pads=[1, 1, 1, 1]),
                 node("Relu", ["h1"], ["h2"], name="relu1"),
                 node("MaxPool", ["h2"], ["h3"], name="pool1",
                      kernel_shape=[2, 2], strides=[2, 2]),
                 node("Flatten", ["h3"], ["h4"], name="flat"),
                 node("Gemm", ["h4", "wl", "bl"], ["y"], name="fc",
                      transB=1)]
    elif name == "mlp":
        nodes = [node("MatMul", ["x", "w1"], ["h1"], name="mm1"),
                 node("Add", ["h1", "b1"], ["h2"], name="add1"),
                 node("Relu", ["h2"], ["h3"], name="relu"),
                 node("Gemm", ["h3", "w2", "b2"], ["h4"], name="fc2"),
                 node("Softmax", ["h4"], ["y"], name="sm", axis=-1)]
    else:
        nodes = [node("Conv", ["x", "wc"], ["h1"], name="conv",
                      kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
                 node("BatchNormalization",
                      ["h1", "scale", "shift", "mean", "var"], ["h2"],
                      name="bn", epsilon=1e-5, momentum=0.9),
                 node("Relu", ["h2"], ["h3"], name="relu"),
                 node("GlobalAveragePool", ["h3"], ["h4"], name="gap"),
                 node("Flatten", ["h4"], ["h5"], name="flat"),
                 node("Gemm", ["h5", "wl", "bl"], ["y"], name="fc",
                      transB=1)]
    g = helper.make_graph(
        nodes, name,
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, shape)],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT,
                                       (shape[0], width))],
        [onnx.numpy_helper.from_array(a, k) for k, a in w.items()])
    return helper.make_model(g), w


def _torch_forward(name, w, x):
    """The graph's function as an ``F.conv2d``/``F.linear`` composition."""
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    x = torch.from_numpy(x)
    with torch.no_grad():
        if name == "cnn":
            h = F.max_pool2d(F.relu(F.conv2d(x, t["wc"], t["bc"],
                                             padding=1)), 2, 2)
            return F.linear(h.flatten(1), t["wl"], t["bl"]).numpy()
        if name == "mlp":
            h = F.relu(F.linear(x, t["w1"].T, t["b1"]))
            return F.softmax(F.linear(h, t["w2"].T, t["b2"]), -1).numpy()
        h = F.batch_norm(F.conv2d(x, t["wc"], padding=1), t["mean"],
                         t["var"], t["scale"], t["shift"], eps=1e-5)
        h = F.relu(h).mean(dim=(2, 3))
        return F.linear(h, t["wl"], t["bl"]).numpy()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wire_format_is_byte_equal(name, tmp_path):
    jmodel, _ = _graph(j_onnx, name)
    tmodel, _ = _graph(t_onnx, name)
    data = tmodel.serialize()
    assert data == jmodel.serialize()
    j_onnx.save(jmodel, str(tmp_path / "ref.onnx"))
    t_onnx.save(tmodel, str(tmp_path / "port.onnx"))
    assert (tmp_path / "port.onnx").read_bytes() == (
        tmp_path / "ref.onnx").read_bytes() == data
    for load, path, helpers in (
            (t_onnx.load, "ref.onnx", t_onnx), (j_onnx.load, "port.onnx",
                                                j_onnx)):
        back = load(str(tmp_path / path))
        assert back.serialize() == data
        assert [(n.op_type, n.name, list(n.input), list(n.output))
                for n in back.graph.node] == [
            (n.op_type, n.name, list(n.input), list(n.output))
            for n in tmodel.graph.node]
        for a, b in zip(back.graph.initializer, tmodel.graph.initializer):
            assert a.name == b.name
            np.testing.assert_array_equal(helpers.numpy_helper.to_array(a),
                                          t_onnx.numpy_helper.to_array(b))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_import_matches_the_reference(name, tmp_path):
    shape, width, loss = GRAPHS[name]
    model, w = _graph(t_onnx, name)
    path = str(tmp_path / f"{name}.onnx")
    t_onnx.save(model, path)
    jom, om = JONNXModel(path), ONNXModel(path)
    assert set(om.weights) == set(w)
    jm = ff.FFModel(ref_config(shape[0]))
    jouts = jom.apply(jm, {"x": jm.create_tensor(list(shape))})
    pm = tff.FFModel(port_config(shape[0]))
    outs = om.apply(pm, {"x": pm.create_tensor(list(shape))})
    assert [tuple(t.sizes) for t in outs] == [
        tuple(t.sizes) for t in jouts] == [(shape[0], width)]
    metrics = ["mean_squared_error"] if loss == "mean_squared_error" else []
    compile_pair(jm, pm, loss_type=loss, metrics=metrics)
    assert om.transfer_onnx_weights(pm) == jom.transfer_onnx_weights(jm) > 0
    same_params(jm, pm)
    for k, v in jm.state.items():
        np.testing.assert_array_equal(pm.state[k].numpy(), np.asarray(v))
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    got, ref = forwards(jm, pm, [x])
    close(got, ref)
    close(got, _torch_forward(name, w, x))
    close(pm.predict(x), got)

    def labels():
        if loss == "sparse_categorical_crossentropy":
            return rng.integers(0, width, size=shape[0]).astype(np.int32)
        if loss == "categorical_crossentropy":
            return np.eye(width, dtype=np.float32)[
                rng.integers(0, width, size=shape[0])]
        return rng.normal(size=(shape[0], width)).astype(np.float32)

    steps_pair(jm, pm, [([rng.normal(size=shape).astype(np.float32)],
                         labels()) for _ in range(3)])


def test_importer_reads_bytes_without_onnx():
    """With no ``onnx`` installed the port parses serialized bytes through
    ``onnx_minimal`` (tests/test_frontends.py:262)."""
    helper, numpy_helper = t_onnx.helper, t_onnx.numpy_helper
    w = np.ones((4, 3), np.float32)
    g = helper.make_graph(
        [helper.make_node("Gemm", ["x", "w"], ["y"], name="fc", transB=1)],
        "g",
        [helper.make_tensor_value_info("x", t_onnx.TensorProto.FLOAT,
                                       (2, 3))],
        [helper.make_tensor_value_info("y", t_onnx.TensorProto.FLOAT,
                                       (2, 4))],
        [numpy_helper.from_array(w, "w")])
    om = ONNXModel(helper.make_model(g).serialize())
    assert np.array_equal(om.weights["w"], w)
