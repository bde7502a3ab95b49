"""Minimal self-contained ONNX reader/writer (no ``onnx`` dependency).

The environment has no ``onnx`` package, so the frontend
(onnx_frontend.py) vendors the tiny slice of it that importing a model
actually needs: the protobuf *wire format* (public spec) and the ONNX
message subset {Model, Graph, Node, Attribute, Tensor, ValueInfo}
with field numbers from the public onnx.proto
(github.com/onnx/onnx/blob/main/onnx/onnx.proto — data layout only;
this is an original implementation, not a port).

Provides the exact API surface onnx_frontend.py consumes —
``load``/``save``, ``numpy_helper.to_array``/``from_array``, and a
``helper`` with ``make_node``/``make_graph``/``make_model``/
``make_tensor_value_info`` — so tests can build real .onnx files and
the importer can read files produced by any exporter.  When the real
``onnx`` package is installed it is preferred (onnx_frontend.py falls
back here only on ImportError).

Reference parity: python/flexflow/onnx/model.py:74-287 assumes the
``onnx`` package; this shim removes that assumption.  It is the JAX
package's flexflow_tpu/frontends/onnx_minimal.py unchanged (stdlib,
``struct`` and numpy), producer name included, so both packages write
the same bytes for the same model and read each other's files.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # two's-complement 10-byte encoding
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) — value is int for
    varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == _I64:
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _I32:
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _emit(out: bytearray, field: int, wt: int, payload) -> None:
    _write_varint(out, (field << 3) | wt)
    if wt == _VARINT:
        _write_varint(out, payload)
    elif wt == _LEN:
        _write_varint(out, len(payload))
        out += payload
    elif wt == _I32:
        out += struct.pack("<I", payload)
    else:
        out += struct.pack("<Q", payload)


# field kinds: how to decode/encode one ONNX message field
# int64 — signed varint; string/bytes — length-delimited; float — fixed32;
# msg — nested message; packed variants accept both packed and unpacked.
class _Field:
    def __init__(self, name: str, kind: str, repeated: bool = False,
                 msg: Optional[type] = None):
        self.name, self.kind, self.repeated, self.msg = name, kind, repeated, msg


class Message:
    """Declarative protobuf message: subclasses define FIELDS."""

    FIELDS: Dict[int, _Field] = {}

    def __init__(self, **kw):
        for f in self.FIELDS.values():
            setattr(self, f.name, [] if f.repeated else None)
        for k, v in kw.items():
            setattr(self, k, v)

    # -- decode --
    @classmethod
    def parse(cls, buf: bytes):
        self = cls()
        for field, wt, raw in _iter_fields(buf):
            f = cls.FIELDS.get(field)
            if f is None:
                continue  # unknown field: skip (forward compat)
            vals = self._decode(f, wt, raw)
            if f.repeated:
                getattr(self, f.name).extend(vals)
            elif vals:
                setattr(self, f.name, vals[-1])
        return self

    @staticmethod
    def _decode(f: _Field, wt: int, raw) -> List[Any]:
        k = f.kind
        if k == "int64":
            if wt == _LEN:  # packed repeated
                out, pos = [], 0
                while pos < len(raw):
                    v, pos = _read_varint(raw, pos)
                    out.append(_signed64(v))
                return out
            return [_signed64(raw)]
        if k == "float":
            if wt == _LEN:
                return list(struct.unpack(f"<{len(raw) // 4}f", raw))
            return [struct.unpack("<f", struct.pack("<I", raw))[0]]
        if k == "double":
            if wt == _LEN:
                return list(struct.unpack(f"<{len(raw) // 8}d", raw))
            return [struct.unpack("<d", struct.pack("<Q", raw))[0]]
        if k == "string":
            return [raw.decode("utf-8", "replace")]
        if k == "bytes":
            return [bytes(raw)]
        if k == "msg":
            return [f.msg.parse(raw)]
        raise ValueError(f"unknown kind {k}")

    # -- encode --
    def serialize(self) -> bytes:
        out = bytearray()
        for field, f in sorted(self.FIELDS.items()):
            v = getattr(self, f.name)
            if v is None or (f.repeated and not v):
                continue
            vals = v if f.repeated else [v]
            for x in vals:
                if f.kind == "int64":
                    _emit(out, field, _VARINT, x)
                elif f.kind == "float":
                    _emit(out, field, _I32, struct.unpack(
                        "<I", struct.pack("<f", x))[0])
                elif f.kind == "double":
                    _emit(out, field, _I64, struct.unpack(
                        "<Q", struct.pack("<d", x))[0])
                elif f.kind == "string":
                    _emit(out, field, _LEN, x.encode("utf-8"))
                elif f.kind == "bytes":
                    _emit(out, field, _LEN, x)
                elif f.kind == "msg":
                    _emit(out, field, _LEN, x.serialize())
        return bytes(out)

    def __repr__(self):
        parts = []
        for f in self.FIELDS.values():
            v = getattr(self, f.name)
            if v not in (None, []):
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# ---------------------------------------------------------------------------
# ONNX messages (field numbers: public onnx.proto)
# ---------------------------------------------------------------------------


class TensorProto(Message):
    # elem type enum (public onnx.proto TensorProto.DataType)
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
    BFLOAT16 = 16
    FIELDS = {
        1: _Field("dims", "int64", True),
        2: _Field("data_type", "int64"),
        4: _Field("float_data", "float", True),
        5: _Field("int32_data", "int64", True),
        6: _Field("string_data", "bytes", True),
        7: _Field("int64_data", "int64", True),
        8: _Field("name", "string"),
        9: _Field("raw_data", "bytes"),
        10: _Field("double_data", "double", True),
        11: _Field("uint64_data", "int64", True),
    }


class AttributeProto(Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = 0, 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10
    FIELDS = {
        1: _Field("name", "string"),
        2: _Field("f", "float"),
        3: _Field("i", "int64"),
        4: _Field("s", "bytes"),
        5: _Field("t", "msg", msg=TensorProto),
        7: _Field("floats", "float", True),
        8: _Field("ints", "int64", True),
        9: _Field("strings", "bytes", True),
        10: _Field("tensors", "msg", True, msg=TensorProto),
        20: _Field("type", "int64"),
    }


class NodeProto(Message):
    FIELDS = {
        1: _Field("input", "string", True),
        2: _Field("output", "string", True),
        3: _Field("name", "string"),
        4: _Field("op_type", "string"),
        5: _Field("attribute", "msg", True, msg=AttributeProto),
        6: _Field("doc_string", "string"),
        7: _Field("domain", "string"),
    }


class _Dimension(Message):
    FIELDS = {
        1: _Field("dim_value", "int64"),
        2: _Field("dim_param", "string"),
    }


class _TensorShapeProto(Message):
    FIELDS = {1: _Field("dim", "msg", True, msg=_Dimension)}


class _TensorTypeProto(Message):
    FIELDS = {
        1: _Field("elem_type", "int64"),
        2: _Field("shape", "msg", msg=_TensorShapeProto),
    }


class TypeProto(Message):
    FIELDS = {1: _Field("tensor_type", "msg", msg=_TensorTypeProto)}


class ValueInfoProto(Message):
    FIELDS = {
        1: _Field("name", "string"),
        2: _Field("type", "msg", msg=TypeProto),
        3: _Field("doc_string", "string"),
    }


class GraphProto(Message):
    FIELDS = {
        1: _Field("node", "msg", True, msg=NodeProto),
        2: _Field("name", "string"),
        5: _Field("initializer", "msg", True, msg=TensorProto),
        10: _Field("doc_string", "string"),
        11: _Field("input", "msg", True, msg=ValueInfoProto),
        12: _Field("output", "msg", True, msg=ValueInfoProto),
        13: _Field("value_info", "msg", True, msg=ValueInfoProto),
    }


class OperatorSetIdProto(Message):
    FIELDS = {
        1: _Field("domain", "string"),
        2: _Field("version", "int64"),
    }


class ModelProto(Message):
    FIELDS = {
        1: _Field("ir_version", "int64"),
        2: _Field("producer_name", "string"),
        3: _Field("producer_version", "string"),
        4: _Field("domain", "string"),
        5: _Field("model_version", "int64"),
        6: _Field("doc_string", "string"),
        7: _Field("graph", "msg", msg=GraphProto),
        8: _Field("opset_import", "msg", True, msg=OperatorSetIdProto),
    }


# ---------------------------------------------------------------------------
# numpy_helper / helper / load / save — the API slice the frontend uses
# ---------------------------------------------------------------------------

_DTYPES = {
    TensorProto.FLOAT: np.float32,
    TensorProto.UINT8: np.uint8,
    TensorProto.INT8: np.int8,
    TensorProto.UINT16: np.uint16,
    TensorProto.INT16: np.int16,
    TensorProto.INT32: np.int32,
    TensorProto.INT64: np.int64,
    TensorProto.BOOL: np.bool_,
    TensorProto.FLOAT16: np.float16,
    TensorProto.DOUBLE: np.float64,
    TensorProto.UINT32: np.uint32,
    TensorProto.UINT64: np.uint64,
}
_NP_TO_ONNX = {np.dtype(v): k for k, v in _DTYPES.items()}


class numpy_helper:
    @staticmethod
    def to_array(t: TensorProto) -> np.ndarray:
        dtype = _DTYPES.get(t.data_type)
        if dtype is None:
            raise ValueError(f"unsupported TensorProto data_type {t.data_type}")
        dims = tuple(t.dims)
        if t.raw_data:
            return np.frombuffer(t.raw_data, dtype=dtype).reshape(dims).copy()
        if t.data_type == TensorProto.FLOAT and t.float_data:
            return np.asarray(t.float_data, np.float32).reshape(dims)
        if t.data_type == TensorProto.DOUBLE and t.double_data:
            return np.asarray(t.double_data, np.float64).reshape(dims)
        if t.data_type == TensorProto.INT64 and t.int64_data:
            return np.asarray(t.int64_data, np.int64).reshape(dims)
        if t.int32_data:
            if t.data_type == TensorProto.FLOAT16:
                # onnx.proto stores float16 in int32_data as raw bit
                # patterns, not values: bits 15360 decode as 1.0
                return (
                    np.asarray(t.int32_data, np.uint16)
                    .view(np.float16)
                    .reshape(dims)
                )
            return np.asarray(t.int32_data, np.int64).astype(dtype).reshape(dims)
        return np.zeros(dims, dtype)

    @staticmethod
    def from_array(arr: np.ndarray, name: str = "") -> TensorProto:
        arr = np.asarray(arr)
        if arr.dtype not in _NP_TO_ONNX:
            raise ValueError(f"unsupported numpy dtype {arr.dtype}")
        return TensorProto(
            dims=list(arr.shape),
            data_type=_NP_TO_ONNX[arr.dtype],
            raw_data=np.ascontiguousarray(arr).tobytes(),
            name=name,
        )


class helper:
    @staticmethod
    def make_attribute(name: str, value) -> AttributeProto:
        a = AttributeProto(name=name)
        if isinstance(value, bool):
            a.i, a.type = int(value), AttributeProto.INT
        elif isinstance(value, int):
            a.i, a.type = value, AttributeProto.INT
        elif isinstance(value, float):
            a.f, a.type = value, AttributeProto.FLOAT
        elif isinstance(value, str):
            a.s, a.type = value.encode(), AttributeProto.STRING
        elif isinstance(value, bytes):
            a.s, a.type = value, AttributeProto.STRING
        elif isinstance(value, TensorProto):
            a.t, a.type = value, AttributeProto.TENSOR
        elif isinstance(value, (list, tuple)):
            if all(isinstance(x, (int, np.integer)) for x in value):
                a.ints, a.type = [int(x) for x in value], AttributeProto.INTS
            elif all(isinstance(x, (float, int, np.floating)) for x in value):
                a.floats = [float(x) for x in value]
                a.type = AttributeProto.FLOATS
            else:
                raise ValueError(f"unsupported attribute list {value!r}")
        else:
            raise ValueError(f"unsupported attribute {value!r}")
        return a

    @staticmethod
    def make_node(op_type: str, inputs, outputs, name: str = "", **attrs):
        return NodeProto(
            op_type=op_type, input=list(inputs), output=list(outputs),
            name=name or f"{op_type}_{id(inputs) & 0xFFFF}",
            attribute=[helper.make_attribute(k, v) for k, v in attrs.items()],
        )

    @staticmethod
    def make_tensor_value_info(name: str, elem_type: int, shape) -> ValueInfoProto:
        dims = [
            _Dimension(dim_param=d) if isinstance(d, str)
            else _Dimension(dim_value=int(d))
            for d in shape
        ]
        return ValueInfoProto(
            name=name,
            type=TypeProto(tensor_type=_TensorTypeProto(
                elem_type=elem_type, shape=_TensorShapeProto(dim=dims))),
        )

    @staticmethod
    def make_graph(nodes, name, inputs, outputs, initializer=()):
        return GraphProto(
            node=list(nodes), name=name, input=list(inputs),
            output=list(outputs), initializer=list(initializer),
        )

    @staticmethod
    def make_model(graph: GraphProto, opset_version: int = 17) -> ModelProto:
        return ModelProto(
            ir_version=8, producer_name="flexflow_tpu.onnx_minimal",
            graph=graph,
            opset_import=[OperatorSetIdProto(domain="", version=opset_version)],
        )


def load(source) -> ModelProto:
    if isinstance(source, (str, bytes)) and not isinstance(source, bytes):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, bytes):
        data = source
    else:  # file-like
        data = source.read()
    return ModelProto.parse(data)


def load_model_from_string(data: bytes) -> ModelProto:
    return ModelProto.parse(data)


def save(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.serialize())
