"""Keras-style layer objects: the JAX package's keras/layers.py (after
FlexFlow's python/flexflow/keras/layers/*).

Each layer is a lightweight config holder, callable on symbolic
``KTensor``s to build a layer graph; ``emit`` lowers onto the port's
FFModel.  Data format is channels_last (NHWC) — the Keras default, and
the framework's native layout.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

_guid = itertools.count()


class KTensor:
    """Symbolic tensor in the keras layer graph."""

    __slots__ = ("shape", "dtype", "layer", "idx", "guid")

    def __init__(self, shape: Tuple[Optional[int], ...], dtype: str = "float32",
                 layer: "Layer" = None, idx: int = 0):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layer = layer
        self.idx = idx
        self.guid = next(_guid)


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Layer:
    """Base layer (reference: keras/layers/base_layer.py)."""

    _name_counts: Dict[str, int] = {}

    def __init__(self, name: Optional[str] = None, input_shape=None):
        base = type(self).__name__.lower()
        self._auto_named = name is None
        if name is None:
            # provisional; models renumber auto names per model at
            # compile time for process-independent weight keys
            i = Layer._name_counts.get(base, 0)
            Layer._name_counts[base] = i + 1
            name = f"{base}_{i}" if i else base
        self.name = name
        self.input_shape = tuple(input_shape) if input_shape else None
        self.inbound: List[KTensor] = []
        self.outputs: List[KTensor] = []

    # -- graph building ---------------------------------------------------
    def __call__(self, inputs):
        if self.inbound:
            # true Keras shares weights on a second call; this frontend
            # would silently emit a second, independent op instead
            raise NotImplementedError(
                f"layer {self.name!r} called twice — shared layers are not "
                "supported; create a new layer instance per call site"
            )
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.inbound = list(ins)
        out_shapes = self.compute_output_shape([t.shape for t in ins])
        self.outputs = [KTensor(s, ins[0].dtype, self, i)
                        for i, s in enumerate(out_shapes)]
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs

    def compute_output_shape(self, input_shapes) -> List[Tuple]:
        return [input_shapes[0]]

    def emit(self, ff, ins):
        raise NotImplementedError(type(self).__name__)


class InputLayer(Layer):
    def __init__(self, shape, dtype="float32", name=None):
        super().__init__(name=name)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.outputs = [KTensor((None,) + self.shape, dtype, self, 0)]

    def emit(self, ff, ins):  # handled by the model, not emitted
        raise AssertionError("InputLayer is materialized by the model")


def Input(shape, dtype="float32", name=None) -> KTensor:
    """Functional-API entry (reference: keras/layers/input_layer.py)."""
    return InputLayer(shape, dtype, name).outputs[0]


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None, **kw):
        super().__init__(**kw)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer

    def compute_output_shape(self, shapes):
        return [shapes[0][:-1] + (self.units,)]

    def emit(self, ff, ins):
        return ff.dense(ins[0], self.units, activation=self.activation,
                        use_bias=self.use_bias,
                        kernel_initializer=self.kernel_initializer,
                        bias_initializer=self.bias_initializer, name=self.name)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, groups=1, use_bias=True, **kw):
        super().__init__(**kw)
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias

    def _pads(self, h, w) -> Tuple[int, int]:
        if self.padding == "same":
            # stride-1 'same'; for strided convs this matches the
            # reference frontend's symmetric-padding approximation
            return (self.kernel_size[0] - 1) // 2, (self.kernel_size[1] - 1) // 2
        return 0, 0

    def compute_output_shape(self, shapes):
        n, h, w, _ = shapes[0]
        ph, pw = self._pads(h, w)
        ho = (h + 2 * ph - self.kernel_size[0]) // self.strides[0] + 1
        wo = (w + 2 * pw - self.kernel_size[1]) // self.strides[1] + 1
        return [(n, ho, wo, self.filters)]

    def emit(self, ff, ins):
        h, w = ins[0].sizes[1], ins[0].sizes[2]
        ph, pw = self._pads(h, w)
        return ff.conv2d(ins[0], self.filters, self.kernel_size[0],
                         self.kernel_size[1], self.strides[0], self.strides[1],
                         ph, pw, activation=self.activation, groups=self.groups,
                         use_bias=self.use_bias, name=self.name)


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", **kw):
        super().__init__(**kw)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = padding

    def _pads(self) -> Tuple[int, int]:
        if self.padding == "same":
            return (self.pool_size[0] - 1) // 2, (self.pool_size[1] - 1) // 2
        return 0, 0

    def compute_output_shape(self, shapes):
        n, h, w, c = shapes[0]
        ph, pw = self._pads()
        ho = (h + 2 * ph - self.pool_size[0]) // self.strides[0] + 1
        wo = (w + 2 * pw - self.pool_size[1]) // self.strides[1] + 1
        return [(n, ho, wo, c)]

    def emit(self, ff, ins):
        ph, pw = self._pads()
        return ff.pool2d(ins[0], self.pool_size[0], self.pool_size[1],
                         self.strides[0], self.strides[1], ph, pw,
                         pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    pool_type = "avg"


class Flatten(Layer):
    def compute_output_shape(self, shapes):
        total = 1
        for s in shapes[0][1:]:
            total *= s
        return [(shapes[0][0], total)]

    def emit(self, ff, ins):
        return ff.flat(ins[0], name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, shapes):
        return [(shapes[0][0],) + self.target_shape]

    def emit(self, ff, ins):
        return ff.reshape(ins[0], (ins[0].sizes[0],) + self.target_shape,
                          name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, seed: int = 0, **kw):
        super().__init__(**kw)
        self.rate = rate
        self.seed = seed

    def emit(self, ff, ins):
        return ff.dropout(ins[0], rate=self.rate, seed=self.seed, name=self.name)


class BatchNormalization(Layer):
    def __init__(self, momentum=0.99, epsilon=1e-3, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.epsilon = epsilon

    def emit(self, ff, ins):
        return ff.batch_norm(ins[0], relu=False, momentum=self.momentum,
                             name=self.name)


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon=1e-3, **kw):
        super().__init__(**kw)
        self.axis = axis if isinstance(axis, (list, tuple)) else (axis,)
        self.epsilon = epsilon

    def emit(self, ff, ins):
        return ff.layer_norm(ins[0], axes=self.axis, eps=self.epsilon,
                             name=self.name)


class Activation(Layer):
    def __init__(self, activation: str, **kw):
        super().__init__(**kw)
        self.activation = activation

    def emit(self, ff, ins):
        fn = getattr(ff, self.activation, None)
        if fn is None:
            raise ValueError(f"unknown activation {self.activation!r}")
        return fn(ins[0], name=self.name)


class ReLU(Activation):
    def __init__(self, **kw):
        Layer.__init__(self, **kw)
        self.activation = "relu"


class Softmax(Layer):
    def __init__(self, axis=-1, **kw):
        super().__init__(**kw)
        self.axis = axis

    def emit(self, ff, ins):
        return ff.softmax(ins[0], axis=self.axis, name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, **kw):
        super().__init__(**kw)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def compute_output_shape(self, shapes):
        return [shapes[0] + (self.output_dim,)]

    def emit(self, ff, ins):
        return ff.embedding(ins[0], self.input_dim, self.output_dim,
                            name=self.name)


class _Merge(Layer):
    ff_op = "add"

    def compute_output_shape(self, shapes):
        return [shapes[0]]

    def emit(self, ff, ins):
        out = ins[0]
        for t in ins[1:]:
            out = getattr(ff, self.ff_op)(out, t,
                                          name=None if len(ins) > 2 else self.name)
        return out


class Add(_Merge):
    ff_op = "add"


class Subtract(_Merge):
    ff_op = "subtract"


class Multiply(_Merge):
    ff_op = "multiply"


class Maximum(_Merge):
    ff_op = "max"


class Minimum(_Merge):
    ff_op = "min"


class Concatenate(Layer):
    def __init__(self, axis=-1, **kw):
        super().__init__(**kw)
        self.axis = axis

    def compute_output_shape(self, shapes):
        out = list(shapes[0])
        ax = self.axis if self.axis >= 0 else len(out) + self.axis
        out[ax] = sum(s[ax] for s in shapes)
        return [tuple(out)]

    def emit(self, ff, ins):
        return ff.concat(list(ins), axis=self.axis, name=self.name)
