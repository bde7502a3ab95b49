"""tf.keras graph-traversal frontend.

The JAX package's frontends/tf_keras.py (after FlexFlow's experimental
keras_exp frontend, python/flexflow/keras_exp/models/model.py —
traverses a real tf.keras Model's layer graph and emits the matching
FFModel calls).  TensorFlow weight layouts already match the
framework's (Dense kernels are (in, out); convs are HWIO NHWC), so
``transfer_tf_weights`` is a straight copy.

TensorFlow is an optional dependency: constructing TFKerasModel
without it raises ImportError; nothing else imports tf.  The
``MultiHeadAttention`` branch is the one frontend path that reaches
``FFModel.multihead_attention``, and with it the flash kernels at
sequences of 512 and more.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["TFKerasModel", "transfer_tf_weights"]


def _pads(padding: str, kernel, strides, in_hw) -> tuple:
    """Symmetric padding reproducing TF 'same' exactly, or raise.

    TF SAME pads total = max((ceil(in/s)-1)*s + k - in, 0) per dim,
    putting the extra pixel on the bottom/right when odd.  Our conv2d
    only supports symmetric padding, so an odd total (strided/even-
    kernel cases) cannot be reproduced — fail loudly instead of
    silently shifting the feature map."""
    if padding != "same":
        return (0, 0)
    out = []
    for i in range(2):
        s, k, n = strides[i], kernel[i], in_hw[i]
        total = max((-(-n // s) - 1) * s + k - n, 0)
        if total % 2:
            raise NotImplementedError(
                f"TF 'same' padding is asymmetric here (kernel={k}, "
                f"stride={s}, size={n}); pad explicitly in the source model")
        out.append(total // 2)
    return tuple(out)


def _act_name(layer):
    """tf layer activation -> framework activation name (None when
    linear) — one place for the idiom the Dense/Conv branches share."""
    act = (layer.activation.__name__
           if layer.activation is not None else None)
    return None if act == "linear" else act


def _conv_act(ff, layer, emit_conv, name):
    """Emit a conv-family layer honoring tf activation semantics: a
    separate EXACT-erf gelu (tf's default form; the fused one is the
    tanh approximation), fused otherwise — ConvOp itself asserts the
    fused activation is supported at BUILD time, so unsupported ones
    fail loudly at import for every caller."""
    act = _act_name(layer)
    if act == "gelu":
        y = emit_conv(None)
        return ff.gelu(y, name=f"{name}.gelu", approximate=False)
    return emit_conv(act)


class TFKerasModel:
    """Importer for a built tf.keras functional/Sequential model."""

    def __init__(self, tf_model):
        try:
            import tensorflow  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("tensorflow is required for TFKerasModel") from e
        self.tf_model = tf_model

    # ------------------------------------------------------------------
    def to_ff(self, ffmodel, input_tensors: Sequence) -> List:
        """Emit the traversed layer graph onto ``ffmodel``; returns the
        output Tensors. ``input_tensors`` bind to tf_model.inputs in
        order."""
        import tensorflow as tf
        from tensorflow.keras import layers as L

        tfm = self.tf_model
        env: Dict[int, object] = {}
        for kt, t in zip(tfm.inputs, input_tensors):
            env[id(kt)] = t

        for layer in tfm.layers:
            if isinstance(layer, L.InputLayer):
                continue
            for node in layer._inbound_nodes:
                ins = []
                kept = node.keras_inputs if hasattr(node, "keras_inputs") else (
                    node.input_tensors)
                for kt in kept:
                    if id(kt) not in env:
                        break
                    ins.append(env[id(kt)])
                else:
                    outs = node.output_tensors if hasattr(node, "output_tensors") \
                        else [node.outputs]
                    if not isinstance(outs, (list, tuple)):
                        outs = [outs]
                    y = self._emit(ffmodel, layer, ins)
                    for kt, t in zip(outs, y if isinstance(y, list) else [y]):
                        env[id(kt)] = t
        missing = [kt for kt in tfm.outputs if id(kt) not in env]
        if missing:
            raise NotImplementedError(
                "could not resolve graph outputs "
                f"{[getattr(kt, 'name', '?') for kt in missing]}: some "
                "layer's inputs were never produced (unsupported layer "
                "ordering or layers shared with another model)"
            )
        return [env[id(kt)] for kt in tfm.outputs]

    # ------------------------------------------------------------------
    def _emit(self, ff, layer, ins):
        from tensorflow.keras import layers as L

        name = layer.name
        if isinstance(layer, L.Dense):
            act = _act_name(layer)
            if act == "gelu":
                # tf.keras gelu defaults to the EXACT erf form; the
                # framework's fused dense-gelu is the tanh approximation
                # — emit a separate exact gelu for bit-parity
                y = ff.dense(ins[0], layer.units, use_bias=layer.use_bias,
                             name=name)
                return ff.gelu(y, name=f"{name}.gelu", approximate=False)
            return ff.dense(ins[0], layer.units, activation=act,
                            use_bias=layer.use_bias, name=name)
        if isinstance(layer, L.DepthwiseConv2D):
            # depthwise = grouped conv with groups == in_channels and
            # out = in * depth_multiplier (MobileNet-family blocks)
            if layer.data_format == "channels_first":
                raise NotImplementedError("channels_first DepthwiseConv2D")
            if tuple(layer.dilation_rate) != (1, 1):
                raise NotImplementedError("dilated DepthwiseConv2D")
            c_in = ins[0].sizes[-1]
            mult = layer.depth_multiplier
            k = layer.kernel_size
            s = layer.strides
            ph, pw = _pads(layer.padding, k, s, ins[0].sizes[1:3])
            return _conv_act(
                ff, layer,
                lambda act: ff.conv2d(
                    ins[0], c_in * mult, k[0], k[1], s[0], s[1], ph, pw,
                    activation=act, groups=c_in,
                    use_bias=layer.use_bias, name=name),
                name)
        if isinstance(layer, L.Conv2D):
            if layer.data_format == "channels_first":
                raise NotImplementedError("channels_first Conv2D")
            if tuple(layer.dilation_rate) != (1, 1):
                raise NotImplementedError("dilated Conv2D")
            k = layer.kernel_size
            s = layer.strides
            ph, pw = _pads(layer.padding, k, s, ins[0].sizes[1:3])
            return _conv_act(
                ff, layer,
                lambda act: ff.conv2d(
                    ins[0], layer.filters, k[0], k[1], s[0], s[1], ph, pw,
                    activation=act, groups=layer.groups,
                    use_bias=layer.use_bias, name=name),
                name)
        if isinstance(layer, (L.MaxPooling2D, L.AveragePooling2D)):
            k = layer.pool_size
            s = layer.strides or k
            ph, pw = _pads(layer.padding, k, s, ins[0].sizes[1:3])
            pt = "max" if isinstance(layer, L.MaxPooling2D) else "avg"
            return ff.pool2d(ins[0], k[0], k[1], s[0], s[1], ph, pw,
                             pool_type=pt, name=name)
        if isinstance(layer, L.GlobalAveragePooling2D):
            if getattr(layer, "data_format",
                       "channels_last") == "channels_first":
                raise NotImplementedError(
                    "channels_first GlobalAveragePooling2D")
            return ff.mean(ins[0], dims=(1, 2),
                           keepdims=getattr(layer, "keepdims", False),
                           name=name)
        if isinstance(layer, L.GlobalMaxPooling2D):
            if getattr(layer, "data_format", "channels_last") == "channels_first":
                raise NotImplementedError("channels_first GlobalMaxPooling2D")
            h, w = ins[0].sizes[1:3]
            t = ff.pool2d(ins[0], h, w, 1, 1, 0, 0, pool_type="max",
                          name=name)
            if getattr(layer, "keepdims", False):
                return t  # already (N, 1, 1, C)
            return ff.flat(t, name=f"{name}.squeeze")
        if isinstance(layer, L.Flatten):
            return ff.flat(ins[0], name=name)
        if isinstance(layer, L.Reshape):
            b = ins[0].sizes[0]
            return ff.reshape(ins[0], (b,) + tuple(layer.target_shape), name=name)
        if isinstance(layer, L.Dropout):
            return ff.dropout(ins[0], rate=layer.rate, name=name)
        if isinstance(layer, L.BatchNormalization):
            return ff.batch_norm(ins[0], relu=False,
                                 momentum=layer.momentum, name=name)
        if isinstance(layer, L.LayerNormalization):
            axes = layer.axis if isinstance(layer.axis, (list, tuple)) else [layer.axis]
            return ff.layer_norm(ins[0], axes=tuple(axes),
                                 eps=layer.epsilon, name=name)
        if isinstance(layer, L.Embedding):
            return ff.embedding(ins[0], layer.input_dim, layer.output_dim,
                                name=name)
        if isinstance(layer, L.Activation):
            act_name = layer.activation.__name__
            if act_name == "gelu":
                return ff.gelu(ins[0], name=name, approximate=False)
            fn = getattr(ff, act_name, None)
            if fn is None:
                raise NotImplementedError(f"activation {act_name!r}")
            return fn(ins[0], name=name)
        if isinstance(layer, L.ReLU):
            return ff.relu(ins[0], name=name)
        if isinstance(layer, L.Softmax):
            axis = layer.axis if isinstance(layer.axis, int) else -1
            return ff.softmax(ins[0], axis=axis, name=name)
        if isinstance(layer, L.MultiHeadAttention):
            # tf call order is (query, VALUE, key); key defaults to value
            q = ins[0]
            v = ins[1] if len(ins) > 1 else ins[0]
            k = ins[2] if len(ins) > 2 else v
            heads = getattr(layer, "num_heads", None) or layer._num_heads
            key_dim = getattr(layer, "key_dim", None) or layer._key_dim
            value_dim = getattr(layer, "value_dim", None) or getattr(
                layer, "_value_dim", None)
            out_shape = getattr(layer, "_output_shape", None)
            e_out = q.sizes[-1]
            if out_shape is not None:
                raise NotImplementedError(
                    "MultiHeadAttention with output_shape= is not supported")
            if value_dim not in (None, key_dim):
                raise NotImplementedError(
                    f"MultiHeadAttention with value_dim={value_dim} != "
                    f"key_dim={key_dim}")
            if heads * key_dim != e_out:
                raise NotImplementedError(
                    f"MultiHeadAttention needs num_heads*key_dim == "
                    f"query dim ({heads}*{key_dim} != {e_out})")
            return ff.multihead_attention(
                q, k, v, embed_dim=e_out, num_heads=heads,
                dropout=float(getattr(layer, "dropout", 0.0) or 0.0),
                bias=getattr(layer, "_use_bias", True), name=name)
        if isinstance(layer, L.Concatenate):
            return ff.concat(list(ins), axis=layer.axis, name=name)
        if isinstance(layer, L.Add):
            out = ins[0]
            for t in ins[1:]:
                out = ff.add(out, t, name=name if len(ins) == 2 else None)
            return out
        if isinstance(layer, L.Subtract):
            return ff.subtract(ins[0], ins[1], name=name)
        if isinstance(layer, L.Multiply):
            out = ins[0]
            for t in ins[1:]:
                out = ff.multiply(out, t, name=name if len(ins) == 2 else None)
            return out
        raise NotImplementedError(f"tf.keras layer {type(layer).__name__}")


def transfer_tf_weights(tf_model, ffmodel) -> int:
    """Copy trained tf.keras weights into a compiled FFModel (layouts
    already match: Dense (in,out), Conv HWIO)."""
    from tensorflow.keras import layers as L

    copied = 0
    for layer in tf_model.layers:
        name = layer.name
        if name not in ffmodel.params:
            continue
        w = layer.get_weights()
        if isinstance(layer, L.DepthwiseConv2D) and w:
            # tf depthwise kernel (kh, kw, C, mult) -> grouped HWIO
            # (kh, kw, 1, C*mult); C-major reshape matches the
            # feature_group_count output-channel ordering
            kh, kw, c, mult = w[0].shape
            ffmodel.set_weight(name, "kernel", w[0].reshape(kh, kw, 1,
                                                            c * mult))
            copied += 1
            if layer.use_bias and len(w) > 1:
                ffmodel.set_weight(name, "bias", w[1])
                copied += 1
        elif isinstance(layer, (L.Dense, L.Conv2D)) and w:
            ffmodel.set_weight(name, "kernel", w[0])
            copied += 1
            if layer.use_bias and len(w) > 1:
                ffmodel.set_weight(name, "bias", w[1])
                copied += 1
        elif isinstance(layer, L.Embedding) and w:
            ffmodel.set_weight(name, "table", w[0])
            copied += 1
        elif isinstance(layer, L.MultiHeadAttention) and w:
            # tf builds query/key/value/output EinsumDense sublayers in
            # that order; kernels are (in, H, dk) / (H, dk, out) —
            # byte-identical to this framework's wq/wk/wv/wo layout
            use_bias = getattr(layer, "_use_bias", True)
            names = (["wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
                     if use_bias else ["wq", "wk", "wv", "wo"])
            for nm, arr in zip(names, w):
                ffmodel.set_weight(name, nm, arr)
                copied += 1
        elif isinstance(layer, L.LayerNormalization) and len(w) == 2:
            ffmodel.set_weight(name, "gamma", w[0])
            ffmodel.set_weight(name, "beta", w[1])
            copied += 2
        elif isinstance(layer, L.BatchNormalization) and len(w) == 4:
            ffmodel.set_weight(name, "scale", w[0])
            ffmodel.set_weight(name, "bias", w[1])
            ffmodel.set_state_var(f"{name}/running_mean", w[2])
            ffmodel.set_state_var(f"{name}/running_var", w[3])
            copied += 4
    return copied
