"""ONNX frontend: ONNX graph → FFModel graph.

The JAX package's frontends/onnx_frontend.py (after FlexFlow's
python/flexflow/onnx/model.py — ``ONNXModel(file)`` +
``apply(ffmodel, input_dict)`` with one ``handle_<OpType>`` per ONNX op,
model.py:74-287), emitting the same ops onto the port's FFModel:

* handlers emit onto the NHWC-native FFModel with the same NCHW↔NHWC
  transpose bracketing the torch importer uses;
* graph initializers (weights baked into the ONNX file) are captured and
  can be copied into a compiled model with ``transfer_onnx_weights``.

The ``onnx`` package is optional: when absent, the vendored minimal
protobuf reader (onnx_minimal.py) parses the file instead, so real
.onnx models import in any environment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

__all__ = ["ONNXModel"]

_NCHW_TO_NHWC = (0, 2, 3, 1)
_NHWC_TO_NCHW = (0, 3, 1, 2)


def _onnx_modules():
    """(onnx-like module, numpy_helper) — the real package when
    installed, the vendored wire-format reader otherwise."""
    try:
        import onnx
        from onnx import numpy_helper

        return onnx, numpy_helper
    except ImportError:
        from flexflow_tpu_torch.frontends import onnx_minimal

        return onnx_minimal, onnx_minimal.numpy_helper


def _attrs(node) -> Dict[str, Any]:
    out = {}
    for a in node.attribute:
        if a.type == a.INT:
            out[a.name] = a.i
        elif a.type == a.FLOAT:
            out[a.name] = a.f
        elif a.type == a.INTS:
            out[a.name] = list(a.ints)
        elif a.type == a.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == a.STRING:
            out[a.name] = a.s.decode()
        elif a.type == a.TENSOR:
            _, numpy_helper = _onnx_modules()
            out[a.name] = numpy_helper.to_array(a.t)
    return out


class ONNXModel:
    """reference: python/flexflow/onnx/model.py ONNXModel."""

    def __init__(self, source):
        onnx, numpy_helper = _onnx_modules()
        if isinstance(source, str):
            self.model = onnx.load(source)
        elif isinstance(source, bytes):
            self.model = onnx.load_model_from_string(source)
        else:
            self.model = source
        self.weights = {
            init.name: numpy_helper.to_array(init)
            for init in self.model.graph.initializer
        }
        self._ff_weight_map: Dict[str, tuple] = {}
        self._state_map: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    def apply(self, ffmodel, input_dict: Dict[str, Any]) -> List:
        """Emit the graph onto ``ffmodel``; ``input_dict`` maps ONNX graph
        input names to FFModel Tensors. Returns output tensors."""
        env: Dict[str, Any] = dict(input_dict)
        g = self.model.graph
        # consumers map for MatMul+Add(bias) fusion (the decomposition
        # exporters emit instead of Gemm)
        self._consumers: Dict[str, List] = {}
        for node in g.node:
            for i in node.input:
                self._consumers.setdefault(i, []).append(node)
        self._fused_adds: Dict[int, str] = {}  # id(add_node) -> alias source
        for node in g.node:
            if id(node) in self._fused_adds:
                env[node.output[0]] = env[self._fused_adds[id(node)]]
                continue
            handler = getattr(self, f"handle_{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(f"unsupported ONNX op {node.op_type}")
            outs = handler(ffmodel, node, env, _attrs(node))
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, t in zip(node.output, outs):
                env[name] = t
        return [env[o.name] for o in g.output]

    # -- helpers ----------------------------------------------------------
    def _w(self, name: str):
        return self.weights.get(name)

    def _record(self, op_name: str, weight_name: str, array) -> None:
        self._ff_weight_map[f"{op_name}/{weight_name}"] = (op_name, weight_name, array)

    # -- handlers (reference: onnx/model.py handle_* table) ----------------
    def handle_Conv(self, ff, node, env, a):
        x = env[node.input[0]]
        w = self._w(node.input[1])  # OIHW
        bias = self._w(node.input[2]) if len(node.input) > 2 else None
        kh, kw = a.get("kernel_shape", list(w.shape[2:]))
        strides = a.get("strides", [1, 1])
        pads = a.get("pads", [0, 0, 0, 0])
        assert pads[0] == pads[2] and pads[1] == pads[3], "asymmetric padding"
        groups = a.get("group", 1)
        name = node.name or node.output[0]
        t = ff.transpose(x, _NCHW_TO_NHWC, name=f"{name}.nhwc")
        y = ff.conv2d(t, w.shape[0], kh, kw, strides[0], strides[1], pads[0],
                      pads[1], groups=groups, use_bias=bias is not None, name=name)
        if w is not None:
            self._record(name, "kernel", w.transpose(2, 3, 1, 0))
        if bias is not None:
            self._record(name, "bias", bias)
        return ff.transpose(y, _NHWC_TO_NCHW, name=f"{name}.nchw")

    def handle_Gemm(self, ff, node, env, a):
        x = env[node.input[0]]
        w = self._w(node.input[1])
        if w is None:
            raise NotImplementedError(
                f"Gemm with non-initializer B operand {node.input[1]!r}"
            )
        bias = self._w(node.input[2]) if len(node.input) > 2 else None
        if a.get("transA", 0):
            raise NotImplementedError("Gemm with transA=1")
        alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
        trans_b = a.get("transB", 0)
        out_dim = w.shape[0] if trans_b else w.shape[1]
        name = node.name or node.output[0]
        y = ff.dense(x, out_dim, use_bias=bias is not None, name=name)
        kernel = (w.T if trans_b else w) * alpha  # fold alpha/beta into weights
        self._record(name, "kernel", kernel)
        if bias is not None:
            self._record(name, "bias", bias * beta)
        return y

    def handle_MatMul(self, ff, node, env, a):
        name = node.name or node.output[0]
        w = self._w(node.input[1])
        if w is not None and w.ndim == 2:
            bias, add_node = self._find_bias_add(node, w.shape[1])
            y = ff.dense(env[node.input[0]], w.shape[1], use_bias=bias is not None,
                         name=name)
            self._record(name, "kernel", w)
            if bias is not None:
                self._record(name, "bias", bias)
                self._fused_adds[id(add_node)] = node.output[0]
            return y
        if w is not None:  # batched (>2-D) initializer — not importable
            raise NotImplementedError(
                f"MatMul with {w.ndim}-D initializer operand {node.input[1]!r}"
            )
        return ff.batch_matmul(env[node.input[0]], env[node.input[1]], name=name)

    def _find_bias_add(self, node, out_dim):
        """MatMul whose sole consumer is Add(out, 1-D initializer) — the
        exporter decomposition of a biased dense; fuse it."""
        users = self._consumers.get(node.output[0], [])
        if len(users) == 1 and users[0].op_type == "Add":
            add = users[0]
            other = add.input[1] if add.input[0] == node.output[0] else add.input[0]
            b = self._w(other)
            if b is not None and b.ndim == 1 and b.shape[0] == out_dim:
                return b, add
        return None, None

    def _pool(self, ff, node, env, a, pool_type):
        x = env[node.input[0]]
        k = a["kernel_shape"]
        s = a.get("strides", [1, 1])
        p = a.get("pads", [0, 0, 0, 0])
        name = node.name or node.output[0]
        t = ff.transpose(x, _NCHW_TO_NHWC, name=f"{name}.nhwc")
        y = ff.pool2d(t, k[0], k[1], s[0], s[1], p[0], p[1],
                      pool_type=pool_type, name=name)
        return ff.transpose(y, _NHWC_TO_NCHW, name=f"{name}.nchw")

    def handle_MaxPool(self, ff, node, env, a):
        return self._pool(ff, node, env, a, "max")

    def handle_AveragePool(self, ff, node, env, a):
        return self._pool(ff, node, env, a, "avg")

    def handle_GlobalAveragePool(self, ff, node, env, a):
        x = env[node.input[0]]
        name = node.name or node.output[0]
        return ff.mean(x, dims=(2, 3), keepdims=True, name=name)

    def handle_BatchNormalization(self, ff, node, env, a):
        x = env[node.input[0]]
        name = node.name or node.output[0]
        t = ff.transpose(x, _NCHW_TO_NHWC, name=f"{name}.nhwc")
        y = ff.batch_norm(t, relu=False, momentum=a.get("momentum", 0.9), name=name)
        scale, bias = self._w(node.input[1]), self._w(node.input[2])
        if scale is not None:
            self._record(name, "scale", scale)
        if bias is not None:
            self._record(name, "bias", bias)
        if len(node.input) > 4:  # trained running statistics
            mean, var = self._w(node.input[3]), self._w(node.input[4])
            if mean is not None:
                self._state_map[f"{name}/running_mean"] = mean
            if var is not None:
                self._state_map[f"{name}/running_var"] = var
        return ff.transpose(y, _NHWC_TO_NCHW, name=f"{name}.nchw")

    def handle_Flatten(self, ff, node, env, a):
        x = env[node.input[0]]
        axis = a.get("axis", 1)
        shp = list(x.sizes)
        lead = 1
        for s in shp[:axis]:
            lead *= s
        tail = 1
        for s in shp[axis:]:
            tail *= s
        return ff.reshape(x, (lead, tail), name=node.name or node.output[0])

    def handle_Reshape(self, ff, node, env, a):
        x = env[node.input[0]]
        shape = [int(s) for s in self._w(node.input[1])]
        # ONNX conventions: 0 copies the input dim, -1 infers from the rest
        shape = [x.sizes[i] if s == 0 else s for i, s in enumerate(shape)]
        total = 1
        for s in x.sizes:
            total *= s
        if -1 in shape:
            known = 1
            for s in shape:
                if s != -1:
                    known *= s
            shape = [total // known if s == -1 else s for s in shape]
        return ff.reshape(x, shape, name=node.name or node.output[0])

    def handle_Transpose(self, ff, node, env, a):
        return ff.transpose(env[node.input[0]], a["perm"],
                            name=node.name or node.output[0])

    def handle_Concat(self, ff, node, env, a):
        return ff.concat([env[i] for i in node.input], axis=a["axis"],
                         name=node.name or node.output[0])

    def handle_Split(self, ff, node, env, a):
        x = env[node.input[0]]
        axis = a.get("axis", 0)
        sizes = a.get("split")
        if sizes is None and len(node.input) > 1:
            sizes = [int(s) for s in self._w(node.input[1])]
        if sizes is None:
            n = len(node.output)
            sizes = [x.sizes[axis] // n] * n
        return ff.split(x, list(sizes), axis=axis, name=node.name or node.output[0])

    def handle_Softmax(self, ff, node, env, a):
        return ff.softmax(env[node.input[0]], axis=a.get("axis", -1),
                          name=node.name or node.output[0])

    def handle_Dropout(self, ff, node, env, a):
        rate = a.get("ratio")
        if rate is None and len(node.input) > 1:  # opset >= 12: ratio input
            r = self._w(node.input[1])
            rate = float(r) if r is not None else None
        return ff.dropout(env[node.input[0]], rate=0.5 if rate is None else rate,
                          name=node.name or node.output[0])

    # ONNX TensorProto dtype enum -> our DataType strings
    _ONNX_DTYPE = {1: "float32", 6: "int32", 7: "int64", 9: "bool",
                   10: "float16", 11: "float64", 16: "bfloat16"}

    def handle_Cast(self, ff, node, env, a):
        to = self._ONNX_DTYPE.get(a.get("to"))
        if to is None:
            raise NotImplementedError(f"Cast to ONNX dtype enum {a.get('to')}")
        return ff.cast(env[node.input[0]], to, name=node.name or node.output[0])

    def handle_ReduceMean(self, ff, node, env, a):
        x = env[node.input[0]]
        axes = a.get("axes")
        if axes is None and len(node.input) > 1:  # opset >= 18: axes input
            w = self._w(node.input[1])
            axes = [int(s) for s in w] if w is not None else None
        if axes is None:  # ONNX default: reduce over ALL dims
            axes = list(range(len(x.sizes)))
        return ff.mean(x, dims=axes, keepdims=bool(a.get("keepdims", 1)),
                       name=node.name or node.output[0])

    def handle_Gather(self, ff, node, env, a):
        # embedding lookup: data is an initializer table
        table = self._w(node.input[0])
        name = node.name or node.output[0]
        if table is not None and table.ndim == 2 and a.get("axis", 0) == 0:
            y = ff.embedding(env[node.input[1]], table.shape[0], table.shape[1],
                             name=name)
            self._record(name, "table", table)
            return y
        return ff.gather(env[node.input[0]], env[node.input[1]],
                         axis=a.get("axis", 0), name=name)

    def _binary(self, ff, node, env, op, scalar_op):
        name = node.name or node.output[0]
        a_in, b_in = node.input[0], node.input[1]
        wa, wb = self._w(a_in), self._w(b_in)
        if wb is not None and wb.size == 1:
            return getattr(ff, scalar_op)(env[a_in], float(wb), name=name)
        if wa is not None and wa.size == 1:
            return getattr(ff, scalar_op)(env[b_in], float(wa), name=name)
        for side, w in ((a_in, wa), (b_in, wb)):
            if w is not None and side not in env:
                raise NotImplementedError(
                    f"{node.op_type} with non-scalar initializer operand "
                    f"{side!r} (shape {w.shape}) — only MatMul+Add bias "
                    "fusion is supported for tensor constants"
                )
        return getattr(ff, op)(env[a_in], env[b_in], name=name)

    def handle_Add(self, ff, node, env, a):
        return self._binary(ff, node, env, "add", "scalar_add")

    def handle_Sub(self, ff, node, env, a):
        return self._binary(ff, node, env, "subtract", "scalar_sub")

    def handle_Mul(self, ff, node, env, a):
        return self._binary(ff, node, env, "multiply", "scalar_multiply")

    def handle_Div(self, ff, node, env, a):
        return self._binary(ff, node, env, "divide", "scalar_true_divide")

    def handle_Relu(self, ff, node, env, a):
        return ff.relu(env[node.input[0]], name=node.name or node.output[0])

    def handle_Sigmoid(self, ff, node, env, a):
        return ff.sigmoid(env[node.input[0]], name=node.name or node.output[0])

    def handle_Tanh(self, ff, node, env, a):
        return ff.tanh(env[node.input[0]], name=node.name or node.output[0])

    def handle_Elu(self, ff, node, env, a):
        return ff.elu(env[node.input[0]], name=node.name or node.output[0])

    def handle_Gelu(self, ff, node, env, a):
        # ONNX Gelu's spec default is approximate='none' (exact erf)
        return ff.gelu(env[node.input[0]], name=node.name or node.output[0],
                       approximate=a.get("approximate", "none") == "tanh")

    def handle_Exp(self, ff, node, env, a):
        return ff.exp(env[node.input[0]], name=node.name or node.output[0])

    def handle_Log(self, ff, node, env, a):
        return ff.log(env[node.input[0]], name=node.name or node.output[0])

    def handle_Identity(self, ff, node, env, a):
        return ff.identity(env[node.input[0]], name=node.name or node.output[0])

    def handle_Pow(self, ff, node, env, a):
        exp = self._w(node.input[1])
        return ff.pow(env[node.input[0]], float(exp),
                      name=node.name or node.output[0])

    def handle_LayerNormalization(self, ff, node, env, a):
        x = env[node.input[0]]
        name = node.name or node.output[0]
        axis = a.get("axis", -1)
        rank = len(x.sizes)
        axes = list(range(axis + rank if axis < 0 else axis, rank))
        y = ff.layer_norm(x, axes=axes, eps=a.get("epsilon", 1e-5), name=name)
        gamma = self._w(node.input[1]) if len(node.input) > 1 else None
        beta = self._w(node.input[2]) if len(node.input) > 2 else None
        if gamma is not None:
            self._record(name, "gamma", gamma)
        if beta is not None:
            self._record(name, "beta", beta)
        return y

    # ------------------------------------------------------------------
    def transfer_onnx_weights(self, ffmodel) -> int:
        """Copy ONNX initializer weights (and BN running statistics)
        into a compiled FFModel."""
        copied = 0
        for op_name, weight_name, array in self._ff_weight_map.values():
            try:
                ffmodel.set_weight(op_name, weight_name, array)
                copied += 1
            except KeyError:
                pass
        for key, array in self._state_map.items():
            try:
                ffmodel.set_state_var(key, array)
                copied += 1
            except KeyError:
                pass
        return copied
