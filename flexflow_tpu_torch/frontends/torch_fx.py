"""PyTorch frontend: torch.fx symbolic trace → FFModel graph.

The JAX package's frontends/torch_fx.py (after FlexFlow's
python/flexflow/torch/model.py: symbolic_trace to a Node list, per-node
``to_ff`` emission, and a serialized op-list file format via
``torch_to_flexflow``), with the same record vocabulary and the same
file format, so both packages write the same file for the same module
and read each other's:

* the traced graph is normalized into neutral, JSON-serializable
  ``OpRecord``s first; both the file writer and the FFModel applier
  consume records, so the in-memory and on-disk paths are one code path;
* torch models are NCHW; the framework is NHWC.  Conv / pool /
  batch-norm records are lowered with NCHW↔NHWC transposes on each
  side, preserving torch semantics exactly (each transpose is an op of
  the imported graph);
* ``scaled_dot_product_attention`` is decomposed into transpose,
  ``batch_matmul``, ``scalar_multiply``, ``softmax`` and ``dropout``
  records, as the JAX package does, so the search sees the same graph
  (an imported model runs no flash kernel);
* ``transfer_torch_weights`` copies trained torch parameters into a
  compiled FFModel (transposing Linear (out,in)→(in,out) and Conv
  OIHW→HWIO), which is what the reference's align/ harness does with
  set_tensor.

Here torch is the runtime as well as the source: the user's module may
live on the card.  ``ShapeProp`` runs it on the example inputs where
they are, the zeros a lazy trace builds are made on the module's device
(its first parameter's or buffer's), a ``.device`` query folds to that
device, and folded constants and transferred weights reach the host
through ``interop.tensor_to_numpy`` (bfloat16 included).

Usage::

    model = ff.FFModel(cfg)
    x = model.create_tensor((batch, 3, 32, 32))
    outs = PyTorchModel(torch_module).torch_to_ff(model, [x])
    # or round-trip through a file:
    torch_to_flexflow(torch_module, "model.ffir", example_inputs)
    outs = PyTorchModel("model.ffir").torch_to_ff(model, [x])
"""

from __future__ import annotations

import itertools
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from flexflow_tpu_torch.interop import tensor_to_numpy

__all__ = ["OpRecord", "PyTorchModel", "torch_to_flexflow", "transfer_torch_weights"]

FILE_MAGIC = "flexflow_tpu.torch_fx.v1"


@dataclass
class OpRecord:
    """One neutral imported operator (serializable)."""

    name: str
    kind: str
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        def _default(o):
            if hasattr(o, "tolist"):  # ndarray constants stay unboxed
                return o.tolist()     # in memory; lists only on disk
            raise TypeError(f"unserializable attr {type(o).__name__}")

        return json.dumps(
            {"name": self.name, "kind": self.kind, "inputs": self.inputs,
             "attrs": self.attrs},
            default=_default,
        )

    @staticmethod
    def from_json(line: str) -> "OpRecord":
        d = json.loads(line)
        return OpRecord(d["name"], d["kind"], d["inputs"], d["attrs"])


# ---------------------------------------------------------------------------
# Tracing: torch.fx graph -> OpRecord list
# ---------------------------------------------------------------------------


def _tensor_shape(node) -> Optional[List[int]]:
    tm = node.meta.get("tensor_meta")
    if tm is None:
        return None
    try:
        return list(tm.shape)
    except AttributeError:  # tuple of TensorMetadata (multi-output)
        return None


def _norm_dim(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


def _module_device(module):
    """The device of a module's first parameter or buffer (the CPU for
    a module that holds neither)."""
    import torch

    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")


def _torch_dtype_str(arg) -> Optional[str]:
    """torch.dtype -> our DataType string (None if arg isn't a dtype)."""
    import torch

    table = {
        torch.float32: "float32", torch.float16: "float16",
        torch.bfloat16: "bfloat16", torch.float64: "float64",
        torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
    }
    return table.get(arg)


class _Tracer:
    """Walk an fx.GraphModule and emit OpRecords."""

    def __init__(self, module, example_inputs: Sequence):
        import torch
        from torch import fx
        from torch.fx.passes.shape_prop import ShapeProp

        self.torch = torch
        if isinstance(module, fx.GraphModule):
            gm = module
        else:
            gm = fx.symbolic_trace(module)
        self.gm = gm
        self.device = _module_device(gm)
        with torch.no_grad():
            ShapeProp(gm).propagate(*example_inputs)
        self.records: List[OpRecord] = []
        self.env: Dict[str, str] = {}  # fx node name -> record output name
        self.literals: Dict[str, Any] = {}  # shape/int values traced as nodes
        self.constants: Dict[str, Any] = {}  # node name -> folded torch.Tensor
        self.kinds: Dict[str, str] = {}  # record name -> record kind
        self.input_names: List[str] = []
        self.output_names: List[str] = []

    # -- helpers ----------------------------------------------------------
    def emit(self, kind: str, name: str, inputs: List[str], **attrs) -> str:
        self.records.append(OpRecord(name, kind, inputs, attrs))
        self.kinds[name] = kind
        return name

    def ref(self, arg) -> str:
        if arg.name not in self.env and arg.name in self.constants:
            # a folded constant flowing into a real graph op: materialize
            # it as a ConstantOp record on first use
            val = self.constants[arg.name]
            import numpy as np

            arr = (tensor_to_numpy(val) if isinstance(val, self.torch.Tensor)
                   else np.asarray(val))
            self.env[arg.name] = self.emit(
                "constant", arg.name, [],
                value=arr, dtype=str(arr.dtype),
            )
        return self.env[arg.name]

    # -- constant folding -------------------------------------------------
    def _resolve_const(self, a):
        """(value, ok): resolve an fx arg to a concrete python/torch
        value if it is a folded constant, a traced literal, or a plain
        literal (recursing into tuples/lists/slices).  ok=False means
        the arg depends on real graph tensors."""
        fx = self.torch.fx
        if isinstance(a, fx.Node):
            if a.name in self.constants:
                return self.constants[a.name], True
            if a.name in self.literals:
                return self.literals[a.name], True
            return None, False
        if isinstance(a, (tuple, list)):
            vals = []
            for x in a:
                v, ok = self._resolve_const(x)
                if not ok:
                    return None, False
                vals.append(v)
            return type(a)(vals), True
        if isinstance(a, slice):
            parts = []
            for x in (a.start, a.stop, a.step):
                v, ok = self._resolve_const(x)
                if not ok:
                    return None, False
                parts.append(v)
            return slice(*parts), True
        return a, True

    # Targets that must never constant-fold: executing them bakes ONE
    # RNG draw (or an uninitialized buffer) into the imported program as
    # a frozen constant.  Matched by name so tensor methods (normal_,
    # uniform_, ...) are caught too.
    _NONDETERMINISTIC = frozenset({
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
        "randint_like", "normal", "bernoulli", "poisson", "multinomial",
        "empty", "empty_like", "empty_strided", "new_empty",
        "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
        "cauchy_", "log_normal_", "geometric_",
        "dropout", "dropout_", "rrelu", "rrelu_",
    })

    def _try_fold(self, node) -> bool:
        """Execute a node whose inputs are all constants/literals (the
        imported model's mask-construction and position-id chains —
        transformers BERT builds its extended attention mask from
        ones/eq/sub/finfo/masked_fill on traced shapes).  Stores a
        tensor result in ``constants``, anything else in ``literals``.
        Non-deterministic targets are refused — folding them would
        freeze a single RNG draw into the program."""
        torch = self.torch
        tname = (node.target if isinstance(node.target, str)
                 else getattr(node.target, "__name__", str(node.target)))
        if tname in self._NONDETERMINISTIC:
            return False
        for a in list(node.args) + list(node.kwargs.values()):
            _, ok = self._resolve_const(a)
            if not ok:
                return False
        args = []
        for a in node.args:
            v, _ = self._resolve_const(a)
            args.append(v)
        kwargs = {}
        for k, a in node.kwargs.items():
            v, _ = self._resolve_const(a)
            kwargs[k] = v
        try:
            if node.op == "call_method":
                out = getattr(args[0], node.target)(*args[1:], **kwargs)
            else:
                out = node.target(*args, **kwargs)
        except Exception:
            return False
        if isinstance(out, torch.Tensor):
            self.constants[node.name] = out
        else:
            self.literals[node.name] = out
        logging.getLogger(__name__).debug(
            "folded %s (%s) -> %s", node.name, tname, type(out).__name__
        )
        return True

    def run(self) -> List[OpRecord]:
        for node in self.gm.graph.nodes:
            out = self.visit(node)
            if out is not None:
                self.env[node.name] = out
        return self.records

    # -- node dispatch ----------------------------------------------------
    def visit(self, node) -> Optional[str]:
        if node.op == "placeholder":
            self.input_names.append(node.name)
            self.emit("input", node.name, [], shape=_tensor_shape(node))
            return node.name
        if node.op == "output":
            args = node.args[0]
            if isinstance(args, dict):  # HF ModelOutput-style dict
                outs = tuple(args.values())
            else:
                outs = args if isinstance(args, (tuple, list)) else (args,)
            self.output_names = [self.ref(a) for a in outs]
            return None
        if node.op == "call_module":
            mod = self.gm.get_submodule(node.target)
            return self.visit_module(node, mod)
        if node.op in ("call_function", "call_method"):
            return self.visit_function(node)
        if node.op == "get_attr":
            # module buffers (position_ids, token_type_ids, ...) are
            # compile-time constants of the imported graph
            import operator as _op

            try:
                val = _op.attrgetter(node.target)(self.gm)
            except AttributeError:
                val = None
            if isinstance(val, self.torch.nn.Parameter):
                # a TRAINABLE tensor used functionally (F.linear(x,
                # self.weight), custom scales): baking it in as a frozen
                # constant would silently stop it training
                raise NotImplementedError(
                    f"get_attr parameter {node.target!r}: functionally-used "
                    "nn.Parameters are not importable; wrap them in a "
                    "supported layer module"
                )
            if isinstance(val, self.torch.Tensor):
                self.constants[node.name] = val  # non-trainable buffer
                return None
            raise NotImplementedError(
                f"get_attr node {node.target!r}: free non-tensor attributes "
                "are not importable; register them as module buffers/"
                "parameters of a supported layer"
            )
        raise NotImplementedError(f"fx node op {node.op!r}")

    def visit_module(self, node, mod) -> str:
        nn = self.torch.nn
        name = node.name
        x = [self.ref(a) for a in node.args if hasattr(a, "name")]
        if isinstance(mod, nn.Linear):
            return self.emit("linear", name, x, out_dim=mod.out_features,
                             use_bias=mod.bias is not None)
        if isinstance(mod, nn.Conv2d):
            assert mod.padding_mode == "zeros", "only zero padding supported"
            pad = mod.padding if isinstance(mod.padding, tuple) else (mod.padding,) * 2
            return self.emit(
                "conv2d", name, x, out_channels=mod.out_channels,
                kernel=list(mod.kernel_size), stride=list(mod.stride),
                padding=[int(pad[0]), int(pad[1])], groups=mod.groups,
                use_bias=mod.bias is not None)
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) else (mod.stride or k[0],) * 2
            p = mod.padding if isinstance(mod.padding, tuple) else (mod.padding,) * 2
            return self.emit(
                "pool2d", name, x, kernel=[k[0], k[1]], stride=[s[0], s[1]],
                padding=[p[0], p[1]],
                pool_type="max" if isinstance(mod, nn.MaxPool2d) else "avg")
        if isinstance(mod, (nn.AdaptiveAvgPool2d, nn.AdaptiveMaxPool2d)):
            in_shape = _tensor_shape(node.args[0])
            out = mod.output_size if isinstance(mod.output_size, tuple) else (mod.output_size,) * 2
            h, w = in_shape[2], in_shape[3]
            assert h % out[0] == 0 and w % out[1] == 0, (
                f"adaptive pool {in_shape} -> {out} is not an integer stride")
            kh, kw = h // out[0], w // out[1]
            return self.emit(
                "pool2d", name, x, kernel=[kh, kw], stride=[kh, kw],
                padding=[0, 0],
                pool_type="avg" if isinstance(mod, nn.AdaptiveAvgPool2d) else "max")
        if isinstance(mod, nn.BatchNorm2d):
            # torch momentum=None means cumulative averaging, which a
            # static graph can't express — fall back to torch's default 0.1
            tm = 0.1 if mod.momentum is None else mod.momentum
            return self.emit("batchnorm2d", name, x, momentum=1.0 - tm,
                             relu=False)
        if isinstance(mod, nn.LayerNorm):
            rank = len(_tensor_shape(node.args[0]))
            axes = list(range(rank - len(mod.normalized_shape), rank))
            return self.emit("layernorm", name, x, axes=axes,
                             elementwise_affine=mod.elementwise_affine,
                             eps=mod.eps)
        if isinstance(mod, nn.Embedding):
            return self.emit("embedding", name, x, num_entries=mod.num_embeddings,
                             out_dim=mod.embedding_dim)
        if isinstance(mod, nn.Softmax):
            return self.emit("softmax", name, x, axis=mod.dim if mod.dim is not None else -1)
        if isinstance(mod, nn.Dropout):
            return self.emit("dropout", name, x, rate=mod.p)
        if isinstance(mod, nn.Flatten):
            return self.emit("flatten", name, x, start_dim=mod.start_dim,
                             end_dim=mod.end_dim,
                             in_shape=_tensor_shape(node.args[0]))
        if isinstance(mod, nn.MultiheadAttention):
            raise NotImplementedError(
                "nn.MultiheadAttention cannot be fx-traced generically; build "
                "it with FFModel.multihead_attention")
        if isinstance(mod, nn.GELU):
            # nn.GELU(approximate='none') is torch's default: exact erf
            return self.emit(
                "gelu", name, x,
                approximate=getattr(mod, "approximate", "none") == "tanh")
        for cls, kind in ((nn.ReLU, "relu"), (nn.Sigmoid, "sigmoid"),
                          (nn.Tanh, "tanh"),
                          (nn.ELU, "elu"), (nn.Identity, "identity")):
            if isinstance(mod, cls):
                return self.emit(kind, name, x)
        raise NotImplementedError(f"unsupported torch module {type(mod).__name__}")

    def _sdpa(self, node) -> str:
        """torch.nn.functional.scaled_dot_product_attention, decomposed
        into the PCG's own vocabulary (transpose / batch_matmul /
        scalar_multiply / softmax / dropout) exactly as the JAX package
        does, so both import the same graph — the reference's frontend
        has no sdpa path at all (its MHA is the fused cuDNN op only)."""
        import math

        name = node.name
        q, k, v = node.args[:3]
        # positional tail follows torch's signature
        # (q, k, v, attn_mask, dropout_p, is_causal, *, scale)
        pos = {i + 3: a for i, a in enumerate(node.args[3:])}
        kwargs = dict(node.kwargs)

        def arg(key, pos_idx, default):
            raw = kwargs.get(key, pos.get(pos_idx, default))
            val, ok = self._resolve_const(raw)
            if not ok:
                raise NotImplementedError(
                    f"sdpa with tensor-dependent {key} is not importable"
                )
            return val

        mask = arg("attn_mask", 3, None)
        dropout_p = float(arg("dropout_p", 4, 0.0) or 0.0)
        is_causal = bool(arg("is_causal", 5, False))
        scale = arg("scale", 6, None)
        if is_causal:
            raise NotImplementedError(
                "sdpa(is_causal=True) import is not supported; build causal "
                "attention with FFModel.multihead_attention(causal=True)"
            )
        if mask is not None:
            if mask.dtype == self.torch.bool:
                trivial = bool(mask.all())  # all-True = keep everything
            else:
                trivial = float(mask.abs().max()) == 0.0  # additive zeros
            if not trivial:
                raise NotImplementedError(
                    "sdpa with a non-trivial attn_mask is not supported "
                    "(trace with input_names=['input_ids'] so the all-ones "
                    "mask constant-folds to a no-op)"
                )
        q_shape = _tensor_shape(q)
        rank = len(q_shape)
        dh = q_shape[-1]
        if scale is None:
            scale = 1.0 / math.sqrt(dh)
        perm = list(range(rank))
        perm[-1], perm[-2] = perm[-2], perm[-1]
        kt = self.emit("transpose", f"{name}_kt", [self.ref(k)], perm=perm)
        scores = self.emit("batch_matmul", f"{name}_scores",
                           [self.ref(q), kt])
        scaled = self.emit("scalar_multiply", f"{name}_scaled", [scores],
                           scalar=float(scale))
        probs = self.emit("softmax", f"{name}_probs", [scaled], axis=-1)
        if dropout_p > 0.0:
            probs = self.emit("dropout", f"{name}_dropout", [probs],
                              rate=dropout_p)
        return self.emit("batch_matmul", name, [probs, self.ref(v)])

    def _tensor_getitem(self, node, src, idx) -> str:
        """Graph-tensor subscripts: integer indexing realized as
        split + select (+ final reshape to drop the indexed dims and
        insert None dims); full slices pass through."""
        in_shape = _tensor_shape(src)
        idx_t = idx if isinstance(idx, tuple) else (idx,)
        cur = self.ref(src)
        out_shape: List[int] = []
        d = 0  # current dim in the (possibly split) source tensor
        squeeze = False
        for it in idx_t:
            it_v, ok = self._resolve_const(it)
            if not ok:
                raise NotImplementedError("tensor-dependent subscript index")
            if it_v is None:
                out_shape.append(1)
                squeeze = True
                continue
            if isinstance(it_v, slice):
                dim = in_shape[d]
                s0 = 0 if it_v.start is None else int(it_v.start)
                s1 = dim if it_v.stop is None else int(it_v.stop)
                if s0 < 0:
                    s0 += dim
                if s1 < 0:
                    s1 += dim
                s0, s1 = max(0, min(s0, dim)), max(0, min(s1, dim))
                if s1 <= s0:
                    raise NotImplementedError(f"empty tensor slice [{s0}:{s1}]")
                if it_v.step not in (None, 1):
                    raise NotImplementedError("strided tensor slicing")
                if s0 == 0 and s1 == in_shape[d]:
                    out_shape.append(in_shape[d])
                    d += 1
                    continue
                sizes = [s for s in (s0, s1 - s0, in_shape[d] - s1) if s > 0]
                part_idx = 1 if s0 > 0 else 0
                sp = self.emit("split", f"{node.name}_split{d}", [cur],
                               sizes=sizes, axis=d)
                cur = self.emit("getitem", f"{node.name}_part{d}", [sp],
                                index=part_idx)
                out_shape.append(s1 - s0)
                d += 1
                continue
            if isinstance(it_v, int):
                i = it_v % in_shape[d]
                if in_shape[d] > 1:
                    sizes = [s for s in (i, 1, in_shape[d] - i - 1) if s > 0]
                    part_idx = 1 if i > 0 else 0
                    sp = self.emit("split", f"{node.name}_split{d}", [cur],
                                   sizes=sizes, axis=d)
                    cur = self.emit("getitem", f"{node.name}_part{d}", [sp],
                                    index=part_idx)
                squeeze = True
                d += 1
                continue
            raise NotImplementedError(f"unsupported subscript element {it_v!r}")
        out_shape.extend(in_shape[d:])
        target = _tensor_shape(node)
        if squeeze or (target is not None and list(target) != out_shape):
            cur = self.emit("reshape", node.name + "_sq", [cur],
                            shape=[int(s) for s in (target or out_shape)])
        self.env[node.name] = cur
        return cur

    # mapping of simple unary call_function/method targets
    _UNARY = {
        "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh", "gelu": "gelu",
        "elu": "elu", "exp": "exp", "log": "log", "rsqrt": "rsqrt",
        "contiguous": "identity", "clone": "identity", "detach": "identity",
    }
    _BINARY = {"add": "add", "sub": "subtract", "mul": "multiply",
               "truediv": "divide", "div": "divide", "matmul": "batch_matmul",
               "bmm": "batch_matmul", "maximum": "max", "minimum": "min"}
    _SCALAR = {"add": "scalar_add", "sub": "scalar_sub", "mul": "scalar_multiply",
               "truediv": "scalar_true_divide", "div": "scalar_true_divide",
               "pow": "pow"}

    def visit_function(self, node) -> str:
        import operator

        name = node.name
        target = node.target
        fname = target if isinstance(target, str) else getattr(target, "__name__", str(target))
        fname = fname.rstrip("_")  # in-place variants (relu_, add_) fold to pure

        if fname == "getattr" and len(node.args) == 2:
            attr = node.args[1]
            if attr == "shape":
                self.literals[node.name] = _tensor_shape(node.args[0])
                return None
            # dtype/device queries on real graph tensors fold to the
            # traced metadata (constants are handled by _try_fold below)
            src = node.args[0]
            if (
                attr in ("dtype", "device")
                and hasattr(src, "meta")
                and src.name not in self.constants
            ):
                tm = src.meta.get("tensor_meta")
                if attr == "dtype" and tm is not None:
                    self.literals[node.name] = tm.dtype
                    return None
                if attr == "device":
                    self.literals[node.name] = self.device
                    return None
        if fname in ("size", "dim") and node.args and hasattr(node.args[0], "meta") \
                and node.args[0].name not in self.constants \
                and node.args[0].name not in self.literals:
            shape = _tensor_shape(node.args[0])
            if shape is not None:
                if fname == "dim":
                    self.literals[node.name] = len(shape)
                elif len(node.args) > 1:
                    self.literals[node.name] = shape[_norm_dim(node.args[1], len(shape))]
                else:
                    self.literals[node.name] = self.torch.Size(shape)
                return None
        if fname in ("_assert", "_assert_async"):
            cond, ok = self._resolve_const(node.args[0])
            if ok and bool(cond):
                return None
            raise NotImplementedError("data-dependent torch._assert")
        # whole-node constant folding: the imported model's mask and
        # position-id chains (ones/eq/sub/finfo/masked_fill/expand/to on
        # traced shapes and buffers) execute at import time
        if self._try_fold(node):
            return None
        if target is operator.getitem or fname == "getitem":
            src, idx = node.args
            if hasattr(src, "name") and src.name in self.literals:
                idx_v, ok = self._resolve_const(idx)
                assert ok, "literal getitem with graph-tensor index"
                self.literals[node.name] = self.literals[src.name][idx_v]
                return None
            if isinstance(idx, int) and self.kinds.get(
                self.env.get(getattr(src, "name", ""), "")
            ) == "split":
                # select one output of the only multi-output op (split/
                # chunk); x[0] on a PLAIN tensor is real dim-0 indexing
                return self.emit("getitem", name, [self.ref(src)], index=idx)
            return self._tensor_getitem(node, src, idx)
        if fname == "scaled_dot_product_attention":
            return self._sdpa(node)

        def _lit(a):  # resolve traced ints (e.g. x.shape[0]) to values
            if hasattr(a, "name") and a.name in self.literals:
                return self.literals[a.name]
            return a

        is_tensor = lambda a: hasattr(a, "name") and a.name not in self.literals
        node_args = [_lit(a) for a in node.args]
        if fname in self._UNARY and len(node.args) >= 1:
            if fname == "gelu":
                # torch F.gelu defaults to the EXACT erf form
                # (approximate='none'); only an explicit
                # approximate='tanh' selects the tanh approximation
                approx = node.kwargs.get("approximate", "none") == "tanh"
                return self.emit("gelu", name, [self.ref(node.args[0])],
                                 approximate=approx)
            return self.emit(self._UNARY[fname], name, [self.ref(node.args[0])])
        if fname in ("float", "to", "type_as", "type"):
            dtype = None
            if fname == "float":
                dtype = "float32"
            elif fname == "type_as":
                tm = node.args[1].meta.get("tensor_meta")
                dtype = _torch_dtype_str(tm.dtype) if tm is not None else None
            else:
                for arg in list(node.args[1:]) + list(node.kwargs.values()):
                    s = _torch_dtype_str(arg)
                    if s is not None:
                        dtype = s
                        break
            if dtype is None:  # .to(device) etc. — dtype unchanged
                return self.emit("identity", name, [self.ref(node.args[0])])
            return self.emit("cast", name, [self.ref(node.args[0])], dtype=dtype)
        if fname in self._BINARY or fname in self._SCALAR:
            a, b = node_args[0], node_args[1]
            if is_tensor(a) and is_tensor(b):
                if fname not in self._BINARY:
                    raise NotImplementedError(f"tensor-tensor {fname}")
                return self.emit(self._BINARY[fname], name, [self.ref(a), self.ref(b)])
            if is_tensor(a):
                return self.emit(self._SCALAR[fname], name, [self.ref(a)],
                                 scalar=float(b))
            # scalar - tensor / scalar / tensor: normalize
            if fname == "add":
                return self.emit("scalar_add", name, [self.ref(b)], scalar=float(a))
            if fname == "mul":
                return self.emit("scalar_multiply", name, [self.ref(b)], scalar=float(a))
            raise NotImplementedError(f"scalar-first {fname}")
        if fname == "cat":
            tensors = node.args[0]
            axis = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
            return self.emit("concat", name, [self.ref(t) for t in tensors], axis=axis)
        if fname in ("split", "chunk"):
            src = node.args[0]
            sizes = node.args[1]
            axis = node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)
            in_shape = _tensor_shape(src)
            axis = _norm_dim(axis, len(in_shape))
            if fname == "chunk":
                n = int(sizes)
                assert in_shape[axis] % n == 0
                sizes = [in_shape[axis] // n] * n
            elif isinstance(sizes, int):
                total = in_shape[axis]
                sizes = [sizes] * (total // sizes) + ([total % sizes] if total % sizes else [])
            return self.emit("split", name, [self.ref(src)], sizes=list(sizes), axis=axis)
        if fname == "flatten":
            start = node.args[1] if len(node.args) > 1 else node.kwargs.get("start_dim", 0)
            end = node.args[2] if len(node.args) > 2 else node.kwargs.get("end_dim", -1)
            return self.emit("flatten", name, [self.ref(node.args[0])],
                             start_dim=start, end_dim=end,
                             in_shape=_tensor_shape(node.args[0]))
        if fname in ("reshape", "view"):
            shape = node.args[1] if isinstance(node.args[1], (tuple, list)) else list(node.args[1:])
            out_shape = _tensor_shape(node)
            return self.emit("reshape", name, [self.ref(node.args[0])],
                             shape=[int(s) for s in out_shape] if out_shape else list(shape))
        if fname == "permute":
            perm = node.args[1] if isinstance(node.args[1], (tuple, list)) else list(node.args[1:])
            return self.emit("transpose", name, [self.ref(node.args[0])], perm=list(perm))
        if fname == "transpose":
            d0, d1 = node.args[1], node.args[2]
            rank = len(_tensor_shape(node.args[0]))
            perm = list(range(rank))
            d0, d1 = _norm_dim(d0, rank), _norm_dim(d1, rank)
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return self.emit("transpose", name, [self.ref(node.args[0])], perm=perm)
        if fname in ("unsqueeze", "squeeze"):
            out_shape = _tensor_shape(node)
            return self.emit("reshape", name, [self.ref(node.args[0])],
                             shape=[int(s) for s in out_shape])
        if fname == "mean":
            dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
            keep = node.kwargs.get("keepdim", node.args[2] if len(node.args) > 2 else False)
            rank = len(_tensor_shape(node.args[0]))
            if dims is None:
                dims = list(range(rank))
            if isinstance(dims, int):
                dims = [dims]
            dims = [_norm_dim(d, rank) for d in dims]
            return self.emit("mean", name, [self.ref(node.args[0])],
                             dims=dims, keepdims=bool(keep))
        if fname == "softmax":
            axis = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", -1)
            return self.emit("softmax", name, [self.ref(node.args[0])], axis=axis)
        if fname == "dropout":
            rate = node.kwargs.get("p", node.args[1] if len(node.args) > 1 else 0.5)
            return self.emit("dropout", name, [self.ref(node.args[0])], rate=float(rate))
        if fname in ("expand", "expand_as", "broadcast_to"):
            # broadcast is implicit in elementwise consumers; anything
            # shape-sensitive (cat/reshape/matmul/...) would silently see
            # the un-expanded shape, so reject those explicitly
            _ELEMENTWISE_OK = {"add", "sub", "mul", "truediv", "div",
                               "maximum", "minimum", "relu", "sigmoid",
                               "tanh", "gelu", "exp", "log", "pow"}
            nn = self.torch.nn
            _ELEMENTWISE_MODULES = (nn.ReLU, nn.Sigmoid, nn.Tanh, nn.GELU,
                                    nn.ELU, nn.Identity, nn.Dropout)
            for user in node.users:
                if user.op == "call_module":
                    mod = self.gm.get_submodule(user.target)
                    if isinstance(mod, _ELEMENTWISE_MODULES):
                        continue
                    uname = type(mod).__name__
                else:
                    uname = (user.target if isinstance(user.target, str)
                             else getattr(user.target, "__name__", "?")).rstrip("_")
                    if user.op != "output" and uname in _ELEMENTWISE_OK:
                        continue
                raise NotImplementedError(
                    f"expand() feeding non-elementwise consumer {uname!r} "
                    "is not supported (the broadcast would be dropped)"
                )
            return self.emit("identity", name, [self.ref(node.args[0])])
        raise NotImplementedError(f"unsupported torch function/method {fname!r}")


# ---------------------------------------------------------------------------
# Applying records onto an FFModel
# ---------------------------------------------------------------------------

_NCHW_TO_NHWC = (0, 2, 3, 1)
_NHWC_TO_NCHW = (0, 3, 1, 2)


class PyTorchModel:
    """Importer: a traced torch module or a serialized record file.

    Reference surface: python/flexflow/torch/model.py PyTorchModel
    (file or module ctor; ``torch_to_ff(ffmodel, input_tensors)``).
    """

    def __init__(self, source, example_inputs: Optional[Sequence] = None):
        self._module = None
        if isinstance(source, str):
            with open(source) as f:
                lines = f.read().splitlines()
            assert lines and lines[0] == FILE_MAGIC, f"bad file magic in {source}"
            meta = json.loads(lines[1])
            self.records = [OpRecord.from_json(l) for l in lines[2:] if l.strip()]
            self.input_names = meta["inputs"]
            self.output_names = meta["outputs"]
        else:
            self._module = source
            if example_inputs is None:
                self.records = None  # trace lazily in torch_to_ff from ff shapes
                self.input_names = self.output_names = None
            else:
                self._trace(example_inputs)

    def _trace(self, example_inputs: Sequence) -> None:
        tr = _Tracer(self._module, example_inputs)
        tr.run()
        self.records = tr.records
        self.input_names = tr.input_names
        self.output_names = tr.output_names

    # -- emission ---------------------------------------------------------
    def torch_to_ff(self, ffmodel, input_tensors: Sequence) -> List:
        """Build the imported graph on ``ffmodel``; returns output Tensors."""
        if self.records is None:
            import torch

            to_torch = {"float32": torch.float32, "float16": torch.float16,
                        "bfloat16": torch.bfloat16, "float64": torch.float64,
                        "int32": torch.int32, "int64": torch.int64,
                        "bool": torch.bool}
            device = _module_device(self._module)
            zeros = [
                torch.zeros(*t.sizes,
                            dtype=to_torch.get(str(getattr(t.dtype, "value", t.dtype)),
                                               torch.float32),
                            device=device)
                for t in input_tensors
            ]
            self._trace(zeros)
        env: Dict[str, Any] = {}
        it = iter(input_tensors)
        for rec in self.records:
            env[rec.name] = self._apply(ffmodel, rec, env, it)
        return [env[n] for n in self.output_names]

    def _apply(self, ff, rec: OpRecord, env, input_iter):
        a = rec.attrs
        x = [env[i] for i in rec.inputs]
        k = rec.kind
        if k == "input":
            return next(input_iter)
        if k == "linear":
            return ff.dense(x[0], a["out_dim"], use_bias=a["use_bias"], name=rec.name)
        if k == "conv2d":
            t = ff.transpose(x[0], _NCHW_TO_NHWC, name=f"{rec.name}.nhwc")
            y = ff.conv2d(t, a["out_channels"], a["kernel"][0], a["kernel"][1],
                          a["stride"][0], a["stride"][1], a["padding"][0],
                          a["padding"][1], groups=a["groups"],
                          use_bias=a["use_bias"], name=rec.name)
            return ff.transpose(y, _NHWC_TO_NCHW, name=f"{rec.name}.nchw")
        if k == "pool2d":
            t = ff.transpose(x[0], _NCHW_TO_NHWC, name=f"{rec.name}.nhwc")
            y = ff.pool2d(t, a["kernel"][0], a["kernel"][1], a["stride"][0],
                          a["stride"][1], a["padding"][0], a["padding"][1],
                          pool_type=a["pool_type"], name=rec.name)
            return ff.transpose(y, _NHWC_TO_NCHW, name=f"{rec.name}.nchw")
        if k == "batchnorm2d":
            t = ff.transpose(x[0], _NCHW_TO_NHWC, name=f"{rec.name}.nhwc")
            y = ff.batch_norm(t, relu=a["relu"], momentum=a["momentum"], name=rec.name)
            return ff.transpose(y, _NHWC_TO_NCHW, name=f"{rec.name}.nchw")
        if k == "layernorm":
            return ff.layer_norm(x[0], axes=a["axes"],
                                 elementwise_affine=a["elementwise_affine"],
                                 eps=a["eps"], name=rec.name)
        if k == "embedding":
            return ff.embedding(x[0], a["num_entries"], a["out_dim"], name=rec.name)
        if k == "softmax":
            return ff.softmax(x[0], axis=a["axis"], name=rec.name)
        if k == "dropout":
            return ff.dropout(x[0], rate=a["rate"], name=rec.name)
        if k == "flatten":
            shp = list(x[0].sizes)
            start = _norm_dim(a["start_dim"], len(shp))
            end = _norm_dim(a["end_dim"], len(shp))
            merged = 1
            for s in shp[start:end + 1]:
                merged *= s
            out = shp[:start] + [merged] + shp[end + 1:]
            return ff.reshape(x[0], out, name=rec.name)
        if k == "concat":
            return ff.concat(x, axis=a["axis"], name=rec.name)
        if k == "split":
            return ff.split(x[0], a["sizes"], axis=a["axis"], name=rec.name)
        if k == "getitem":
            return x[0][a["index"]]
        if k == "constant":
            import numpy as np

            dtype = a["dtype"]
            if dtype == "bfloat16":  # numpy's own dtypes have no bfloat16
                import ml_dtypes

                dtype = ml_dtypes.bfloat16
            return ff.create_constant(
                np.asarray(a["value"], dtype=dtype), name=rec.name
            )
        if k == "reshape":
            shape = [s if s != -1 else -1 for s in a["shape"]]
            return ff.reshape(x[0], shape, name=rec.name)
        if k == "transpose":
            return ff.transpose(x[0], a["perm"], name=rec.name)
        if k == "mean":
            return ff.mean(x[0], dims=a["dims"], keepdims=a["keepdims"], name=rec.name)
        if k == "cast":
            return ff.cast(x[0], a["dtype"], name=rec.name)
        if k == "batch_matmul":
            return ff.batch_matmul(x[0], x[1], name=rec.name)
        if k == "pow":
            return ff.pow(x[0], a["scalar"], name=rec.name)
        if k in ("scalar_add", "scalar_sub", "scalar_multiply", "scalar_true_divide"):
            return getattr(ff, k)(x[0], a["scalar"], name=rec.name)
        if k == "gelu":
            # exact erf unless the trace explicitly chose tanh
            return ff.gelu(x[0], name=rec.name,
                           approximate=bool(a.get("approximate", False)))
        if k in ("add", "subtract", "multiply", "divide", "max", "min",
                 "relu", "sigmoid", "tanh", "elu", "exp", "log",
                 "rsqrt", "identity"):
            return getattr(ff, k)(*x, name=rec.name)
        raise NotImplementedError(f"record kind {k!r}")


def torch_to_flexflow(module, filename: str, example_inputs: Sequence) -> None:
    """Serialize a torch module's traced graph to ``filename``
    (reference: torch/model.py torch_to_flexflow — two-env workflow:
    trace in one process, apply in another; the JAX package reads the
    same file)."""
    tr = _Tracer(module, example_inputs)
    tr.run()
    with open(filename, "w") as f:
        f.write(FILE_MAGIC + "\n")
        f.write(json.dumps({"inputs": tr.input_names, "outputs": tr.output_names}) + "\n")
        for rec in tr.records:
            f.write(rec.to_json() + "\n")


# ---------------------------------------------------------------------------
# Weight transfer (align/-style parity: reference align/align_utils.py)
# ---------------------------------------------------------------------------


def transfer_torch_weights(torch_module, ffmodel) -> int:
    """Copy trained torch parameters into a compiled FFModel.

    Op names produced by the importer equal fx node names, which equal
    sanitized module paths — so ``layers.0.fc`` ↔ ``layers_0_fc``.
    The module may live on the card and hold bfloat16 tensors: each one
    reaches the host through ``interop.tensor_to_numpy`` and
    ``set_weight`` puts it in the parameter's place and dtype.
    Returns the number of arrays copied.
    """
    import numpy as np

    copied = 0
    params = ffmodel.params
    by_name = {n.replace(".", "_"): m for n, m in torch_module.named_modules()}
    for op_name in list(params.keys()):
        mod = by_name.get(op_name) or by_name.get(op_name.replace(".", "_"))
        if mod is None:
            continue
        import torch.nn as nn

        w = {k: tensor_to_numpy(v) for k, v in mod.state_dict().items()}
        if isinstance(mod, nn.Linear):
            ffmodel.set_weight(op_name, "kernel", np.ascontiguousarray(w["weight"].T))
            copied += 1
            if "bias" in w:
                ffmodel.set_weight(op_name, "bias", w["bias"]); copied += 1
        elif isinstance(mod, nn.Conv2d):
            ffmodel.set_weight(op_name, "kernel",
                               np.ascontiguousarray(w["weight"].transpose(2, 3, 1, 0)))
            copied += 1
            if "bias" in w:
                ffmodel.set_weight(op_name, "bias", w["bias"]); copied += 1
        elif isinstance(mod, nn.Embedding):
            ffmodel.set_weight(op_name, "table", w["weight"]); copied += 1
        elif isinstance(mod, nn.LayerNorm):
            if "weight" in w:
                ffmodel.set_weight(op_name, "gamma", w["weight"])
                ffmodel.set_weight(op_name, "beta", w["bias"])
                copied += 2
        elif isinstance(mod, nn.BatchNorm2d):
            if "weight" in w:  # affine=False has no scale/bias
                ffmodel.set_weight(op_name, "scale", w["weight"])
                ffmodel.set_weight(op_name, "bias", w["bias"])
                copied += 2
            # eval-mode parity needs the trained running statistics too
            if "running_mean" in w:  # track_running_stats=False has none
                ffmodel.set_state_var(f"{op_name}/running_mean", w["running_mean"])
                ffmodel.set_state_var(f"{op_name}/running_var", w["running_var"])
                copied += 2
    return copied
